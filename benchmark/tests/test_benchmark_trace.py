"""The trace reduction on made-up events, the attention spans on the
host, and the metric readers on a made-up record."""

from __future__ import annotations

import importlib.util
import json
import shutil
import subprocess
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import devtrace, roofline, spec

MS = 1_000_000  # ns

# (name, on_device, start, end, correlation, linked, thread)
EVENTS = [
    ("aten::mm", False, 0, 1 * MS, 1, 0, 7),
    ("bench.attn_fwd", False, 1 * MS, 2 * MS, 2, 0, 7),
    ("cudaLaunchKernel", False, 1 * MS, 1 * MS + 10, 1, 2, 7),
    ("bench.attn_bwd", False, 5 * MS, 7 * MS, 3, 0, 9),
    ("aten::mul", False, 5 * MS + 5, 5 * MS + 9, 4, 0, 9),
    ("aten::cumsum", False, 8 * MS, 9 * MS, 5, 0, 7),
    ("bench.attn_fwd", True, 1 * MS, 4 * MS, 106, 2, 0),  # mirrored annotation
    ("nvjet_tst_128x256", True, 1 * MS, 3 * MS, 101, 1, 0),
    ("void fwd::fwd_kernel<128, 128, 128>", True, 3 * MS, 4 * MS, 102, 2, 0),
    ("void at::native::vectorized_elementwise_kernel<4>", True, 5 * MS, 6 * MS, 103, 4, 0),
    ("void dq::dq_kernel<128, 128, 64>", True, 6 * MS, 7 * MS, 104, 3, 0),
    ("void some_kernel<float>", True, 9 * MS, 10 * MS, 105, 5, 0),
]


def test_reduce_made_up_events():
    rec = devtrace.reduce(EVENTS, wall_s=0.010, steps=1)
    assert rec["busy_s"] == pytest.approx(0.006)
    assert rec["kernels"] == 5 and rec["kernels_linked"] == 5
    assert rec["by_class_s"] == pytest.approx(
        {"matmul": 0.002, "attention": 0.003, "other": 0.001})
    assert rec["attention"]["fwd"] == {"calls": 1, "seconds": pytest.approx(0.001)}
    # The elementwise kernel launched inside the backward's span counts
    # with attention's backward.
    assert rec["attention"]["bwd"] == {"calls": 1, "seconds": pytest.approx(0.002)}
    assert rec["unclassified"] == ["void some_kernel<float>"]
    gaps = dict(rec["idle_gaps"])
    assert gaps == {"aten::mul": pytest.approx(0.001), "aten::cumsum": pytest.approx(0.002)}
    assert rec["device_ops"][0] == ["matmul: nvjet_tst_128x256", pytest.approx(0.002)]


def test_spans_enclose_the_attention_backward_on_the_host():
    from tpumon.workload_torch.ops.flash_attention import make_flash_attn

    attn = devtrace.spanned(make_flash_attn())
    q = torch.randn(1, 16, 2, 32, requires_grad=True)
    k = torch.randn(1, 16, 1, 32, requires_grad=True)
    v = torch.randn(1, 16, 1, 32, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        attn(q, k, v).square().sum().backward()
    events = prof.profiler.kineto_results.events()
    spans = {e.name(): e for e in events if e.name().startswith("bench.")}
    assert set(spans) == {"bench.attn_fwd", "bench.attn_bwd"}
    bwd = spans["bench.attn_bwd"]
    inside = [e.name() for e in events
              if e.start_thread_id() == bwd.start_thread_id()
              and bwd.start_ns() <= e.start_ns() <= bwd.start_ns() + bwd.duration_ns()]
    assert "aten::mul" in inside  # the Δ pre-pass
    assert q.grad is not None and k.grad is not None


def _reader(name):
    path = spec.HERE / "metrics" / f"{name}.py"
    s = importlib.util.spec_from_file_location(f"reader_{name}", path)
    module = importlib.util.module_from_spec(s)
    s.loader.exec_module(module)
    return module.read


def _record(trace):
    return {"chips": 1, "tokens_per_step": 1000, "flops_per_step": 989e12,
            "peak_flops": 989e12, "peak_bytes": 3.35e12, "setup_s": 12.5,
            "window": {"steps": 4, "seconds": 8.0, "failed": 0},
            "memory_peak_bytes": 3 * 2**30,
            "attn_shape": {"B": 1, "H": 32, "KV": 8, "S": 4096, "D": 128},
            "trace": trace}


def test_readers_on_a_made_up_record():
    rec = _record(devtrace.reduce(EVENTS, wall_s=0.010, steps=1))
    assert _reader("tokens_per_s")(rec) == 500.0
    assert _reader("peak_mem_gib")(rec) == 3.0
    assert _reader("setup_s")(rec) == 12.5
    assert _reader("step_mfu_pct")(rec) == pytest.approx(50.0)
    assert _reader("device_idle_pct")(rec) == pytest.approx(40.0)
    assert _reader("nongemm_ms_per_step")(rec) == pytest.approx(1.0)
    least = roofline.least_seconds(roofline.attn_fwd_work(1, 32, 8, 4096, 128),
                                   989e12, 3.35e12)
    assert _reader("flash_fwd_roofline")(rec) == pytest.approx(100 * least / 0.001)


@pytest.mark.parametrize("name", ["step_mfu_pct", "device_idle_pct",
                                  "flash_fwd_roofline", "flash_bwd_roofline",
                                  "nongemm_ms_per_step"])
def test_readers_with_nothing_to_read_return_none(name):
    rec = _record(None)
    rec["peak_flops"] = None
    assert _reader(name)(rec) is None


def test_a_checkout_of_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(spec.BENCHMARK_JSON, tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    workload = json.loads(spec.BENCHMARK_JSON.read_text())["workloads"][0]["name"]
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload, "--seed",
         "3000000000", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_an_unknown_workload_gives_no_result():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "no-such-cell",
         "--seed", "1", "--seconds", "1"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 2 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_one_short_run_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "mixtral-8x7b.s4096",
         "--seed", "3000000001", "--seconds", "2", "--trace", "1"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["busy_s"] > 0
