"""A new model family comes in as new files only.

A toy family is written into a copy of the benchmark: its family module,
plain reference, configuration, traffic, cell, one per-layer reader and
the entries for them in ``BENCHMARK.json``. It has what a model such as
DeepSeek-V2-Lite asks of the harness: a configuration key no other file
has (``first_intermediate_size``), a first layer whose weights differ
from the rest, a FLOP count of its own and a reader of a ``workload.*``
span of its own. In that copy, in a process of its own, the cell loads,
the port's step runs through set-up and window on the host and compares
as correct with its reference (the float8 control does not), and the
reader reads its span from a record's span table. No file that was
there before is changed.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import textwrap

from benchmark import spec

SEED = 2**33 + 12345

FAMILY = '''
"""A toy decoder: the dense trunk (``llama.py``) whose first layer has a
feed-forward width of its own (``first_intermediate_size``)."""

import dataclasses

from benchmark.families import llama


@dataclasses.dataclass(frozen=True)
class Sizes(llama.Model):
    first_ffn: int = 0


def sizes(config):
    return Sizes(**llama.trunk(config), first_ffn=config["first_intermediate_size"])


def port_model(m, seq, device):
    from tpumon.workload_torch.models.llama import Block, Llama, LlamaConfig
    from tpumon.workload_torch.spans import traced

    class FirstBlock(Block):
        mlp = traced("first_mlp")(Block.mlp.__wrapped__)

    cfg = llama.check_head_dim(LlamaConfig(**llama.port_fields(m, seq)), m)
    model = Llama(cfg, device)
    model.blocks[0] = FirstBlock(dataclasses.replace(cfg, ffn_dim=m.first_ffn),
                                 device)
    return model


def param_shapes(m):
    D, F = m.dim, m.first_ffn
    shapes = llama.param_shapes(m)
    shapes.update({"blocks.0.w_gate": (D, F), "blocks.0.w_up": (D, F),
                   "blocks.0.w_down": (F, D)})
    return shapes


def train_flops_per_step(m, batch, seq):
    first = 6 * batch * seq * m.dim * (m.first_ffn - m.ffn)
    return 3.0 * (llama.forward_flops(m, batch, seq) + first)


attn_shape = llama.attn_shape
'''

REFERENCE = '''
"""Plain float32 reference of the toy decoder: the decoder's equations,
whose SwiGLU takes each layer's width from that layer's weights."""

from benchmark.reference.decoder import Precision, follow  # noqa: F401
'''

READER = '''
"""Device ms a step in the toy's first feed-forward (``workload.first_mlp``)."""

from benchmark import progspans


def read(rec):
    return progspans.ms_per_step((rec["trace"] or {}).get("program"),
                                 ("first_mlp",))
'''

CONFIG = {
    "source": "a toy for the harness's tests", "family": "toy",
    "reference": "toy", "vocab_size": 512, "hidden_size": 128,
    "num_hidden_layers": 2, "num_attention_heads": 4,
    "num_key_value_heads": 2, "intermediate_size": 256,
    "first_intermediate_size": 384, "rms_norm_eps": 1e-5,
    "rope_theta": 10000.0, "reduced": {}, "departures": [],
}

TRAFFIC = {"seq": 64, "tokens_per_step": 256, "ids": "uniform", "pool": 4,
           "why": "4 rows of 64 tokens"}

LIMITS = {"loss1_gap": 7e-5, "grad_gap": 3e-3, "change_gap": 2e-3}

CELL = {"config": "toy", "traffic": "toy.seq64", "chips": 1, "micro_batch": 2,
        "grad_accum": 2, "attn": "flash", "remat": True, "loss_chunk": 32,
        "mesh": None, "limits": LIMITS, "why": "the toy on the host"}

ENTRIES = {
    "configs": {"name": "toy", "source": "https://example.org/toy",
                "file": "benchmark/configs/toy.json", "reduced": [],
                "why": "a first layer of its own width"},
    "workloads": {"name": "toy.s64", "config": "toy", "traffic": "toy.seq64",
                  "chips": 1, "why": "the toy on the host"},
    "per_layer": {"name": "first_mlp_ms_per_step", "unit": "ms",
                  "better": "lower", "source": "device_trace", "layer": "model",
                  "moves": "tokens_per_s", "workloads": ["toy.s64"]},
}

#: Runs in the copy: loads the cell, measures it, reads the control, the
#: span table of a step traced on the host and a made-up one.
DRIVE = f'''
import json, time
import torch
from torch.profiler import ProfilerActivity, profile
from benchmark import cellrun, compare, devtrace, families, spec
from benchmark.program import Program
from benchmark.run import read_metric

cell = spec.load_cell("toy.s64")
out = {{"family_file": families.of(cell.model).__file__,
        "first_ffn": cell.model.first_ffn,
        "per_layer": [m["name"] for m in cell.per_layer]}}
run = cellrun.measure(cell, {SEED}, 0.1, False, "cpu", time.perf_counter())
record = run["record"]
out.update(correct=run["correct"], numbers={{k: run["numbers"][k] for k in cell.limits}},
           losses=run["losses"], steps=record["window"]["steps"],
           flops=record["flops_per_step"], config=record["config"],
           attn_shape=record["attn_shape"])
ref = cellrun.reference_readings(cell, {SEED}, "cpu")
control = cellrun.reference_readings(cell, {SEED}, "cpu", fp8=True)
out["control_correct"] = compare.decide(compare.readings(control, ref), cell.limits)

prog = Program(cell, {SEED}, "cpu", spans=True)
out["shapes"] = {{n: list(p.shape) for n, p in prog.params.items() if "w_gate" in n}}
prog.step()
with profile(activities=[ProfilerActivity.CPU]) as prof:
    prog.step()
events = [(e.name(), e.device_type() == torch.autograd.DeviceType.CUDA,
           e.start_ns(), e.start_ns() + e.duration_ns(), e.correlation_id(),
           e.linked_correlation_id(), e.start_thread_id())
          for e in prof.profiler.kineto_results.events()]
trace = devtrace.reduce(events, 1.0, 1)
out["spans"] = {{n: e["calls"] for n, e in trace["program"]["spans"].items()
                if "mlp" in n}}
out["read_host"] = read_metric("first_mlp_ms_per_step", {{"trace": trace}})
table = {{"steps": 2, "spans": {{
    "first_mlp": {{"calls": 2, "device_s": 0.004, "by_class_s": {{}}}},
    "first_mlp.bwd": {{"calls": 1, "device_s": 0.006, "by_class_s": {{}}}},
    "mlp": {{"calls": 2, "device_s": 0.5, "by_class_s": {{}}}}}}}}
out["read_made_up"] = read_metric("first_mlp_ms_per_step",
                                  {{"trace": {{"program": table}}}})
out["read_none"] = read_metric("first_mlp_ms_per_step", {{"trace": None}})
print(json.dumps(out))
'''


def _files(root):
    return {p.relative_to(root): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def _write(path, text):
    path.write_text(textwrap.dedent(text).lstrip())


def test_a_new_family_needs_only_new_files(tmp_path):
    shutil.copytree(spec.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _files(spec.HERE)
    bench = json.loads(spec.BENCHMARK_JSON.read_text())
    for group, entry in ENTRIES.items():
        bench[group].append(entry)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    new = tmp_path / "benchmark"
    _write(new / "families" / "toy.py", FAMILY)
    _write(new / "reference" / "toy.py", REFERENCE)
    _write(new / "metrics" / "first_mlp_ms_per_step.py", READER)
    (new / "configs" / "toy.json").write_text(json.dumps(CONFIG))
    (new / "traffic" / "toy.seq64.json").write_text(json.dumps(TRAFFIC))
    (new / "workloads" / "toy.s64.json").write_text(json.dumps(CELL))
    _write(tmp_path / "drive.py", DRIVE)
    # The copy's benchmark first, then the port from this checkout.
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), str(spec.ROOT)]))
    done = subprocess.run([sys.executable, "drive.py"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    out = json.loads(done.stdout.strip().splitlines()[-1])

    assert out["family_file"] == str(new / "families" / "toy.py")
    assert out["first_ffn"] == 384 and out["config"] == CONFIG
    assert out["shapes"] == {"blocks.0.w_gate": [128, 384],
                             "blocks.1.w_gate": [128, 256]}
    assert "first_mlp_ms_per_step" in out["per_layer"]
    assert out["correct"], out["numbers"]
    assert not out["control_correct"]
    assert out["steps"] >= 1 and len(out["losses"]["program"]) == 2
    dense = 3.0 * 2 * (2 * 256 * 128 * 128 * 2 + 2 * 256 * 128 * 64 * 2
                       + 2 * 2 * 4 * 4 * 32 * (64 * 65 // 2) + 6 * 256 * 128 * 256)
    dense += 3.0 * 2 * 256 * 128 * 512
    assert out["flops"] == dense + 3.0 * 6 * 256 * 128 * (384 - 256)
    assert out["attn_shape"] == {"B": 2, "H": 4, "KV": 2, "S": 64, "D": 32}
    # The first layer's feed-forward is in its own span, the other's in
    # the port's: forward and remat's recompute, and the backward.
    assert out["spans"] == {"first_mlp": 4, "first_mlp.bwd": 2, "mlp": 4,
                            "mlp.bwd": 2}
    assert out["read_host"] == 0.0  # no device on the host
    assert out["read_made_up"] == 5.0 and out["read_none"] is None

    assert _files(new).items() >= before.items()
    for group in ENTRIES:
        assert bench[group][:-1] == json.loads(spec.BENCHMARK_JSON.read_text())[group]
