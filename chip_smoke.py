#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one card, end to end.

    python3 chip_smoke.py                      # every phase, one card
    python3 chip_smoke.py --phases env,build,kernels --reps 3

Phases (any failure exits non-zero; no phase's exception is swallowed):

1. env      torch/CUDA versions, device name and capability, nvidia-smi's
            name and power limit, nvcc --version.
2. build    build the three flash kernels from ops/csrc/*.cu and print
            the build seconds and ptxas' register/shared-memory report;
            fails on any spilled register, ignored setmaxnreg or
            serialized wgmma (ptxas' "(C7512)"/"(C7520)" lines).
3. kernels  each kernel against its plain PyTorch version on the card, at
            the main path's attention shape (medium microbatch: B=2,
            S=4096, H=16, KV=4, D=128, causal), at non-causal Sk != S and
            ragged D=64 cases, at a long causal case (S=16384) where the
            JAX package takes its streamed kernels, and at the tile edges
            (S=4000, S=48, MHA). Prints one JSON line per kernel and case:
            errors beside their limits, the kernel's time (CUDA events,
            median), the plain version's, the library call's where one
            computes the same function, and the bound (the least time for
            the same work at the card's peaks); then one line per case for
            the backward as a whole against SDPA's backward.
4. main     tpumon.workload_torch.harness.main on the medium preset
            (--seq 4096 --batch 8 --grad-accum 4 --attn flash --remat
            --loss-chunk 1024 --steps 10 --phase-stats --serve) with the
            launch counters zeroed just before and read just after (they
            must equal the counts the run implies); the metrics page is
            scraped while the run is live and parsed with the lifecycle
            probe; losses must be finite.
5. profile  the same harness.main argv for 3 steps, without --serve and
            --phase-stats, with the timed steps under torch.profiler (CUDA
            activity): one JSON line with the 15 device kernels that take
            the most time per step, the three flash kernels' share of the
            step, and the device's idle share over the profiled steps
            (1 - union of device-activity intervals / wall time). It
            measures only; a failure in it fails the run.

Then it prints the nvidia-smi line, one {"kernels": [...]} JSON line and,
as the last line, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import re
import socket
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

REPO_KERNEL = "tpumon/workload/ops/flash_attention.py"

#: Hopper kernel → (source, TPU kernels it replaces as file:line).
KERNELS = {
    "flash_fwd": (
        "tpumon/workload_torch/ops/csrc/flash_fwd.cu",
        [f"{REPO_KERNEL}:199", f"{REPO_KERNEL}:233"],
    ),
    "flash_dq": (
        "tpumon/workload_torch/ops/csrc/flash_dq.cu",
        [f"{REPO_KERNEL}:407", f"{REPO_KERNEL}:441"],
    ),
    "flash_dkv": (
        "tpumon/workload_torch/ops/csrc/flash_dkv.cu",
        [f"{REPO_KERNEL}:476"],
    ),
}

#: (name, B, S, Sk, H, KV, D, causal). "main" is the medium microbatch of
#: the main path; "long" is in the range where the JAX package streams;
#: the last three hit the tile edges of the wgmma kernels (128-row q- and
#: k-blocks, 64-row q tiles in dK/dV): S not a multiple of 128, S below
#: one tile, and MHA (KV = H).
CASES = [
    ("main", 2, 4096, 4096, 16, 4, 128, True),
    ("rect", 1, 2000, 3000, 16, 4, 128, False),
    ("ragged64", 2, 1000, 1000, 8, 4, 64, True),
    ("long", 1, 16384, 16384, 4, 1, 128, True),
    ("ragged4000", 1, 4000, 4000, 16, 4, 128, True),
    ("small48", 2, 48, 48, 4, 2, 64, True),
    ("mha", 2, 2048, 2048, 8, 8, 128, True),
]

#: Limits: O and lse max-abs; dQ/dK/dV relative L2 (bf16 wgmma products
#: with f32 accumulation against dense f32 math). O carries bf16 output
#: rounding (values near 1 round by up to 2^-8); lse is f32 throughout;
#: the gradients round P and dS to bf16 (about 2.6e-3 relative L2 on an
#: H100, so 1e-2 leaves a margin of ~4x).
LIMITS = {"o": 2e-2, "lse": 1e-4, "grad_rel_l2": 1e-2}

MAIN_ARGV = [
    "--preset", "medium", "--seq", "4096", "--batch", "8",
    "--grad-accum", "4", "--attn", "flash", "--remat",
    "--loss-chunk", "1024", "--steps", "10", "--stats-every", "5",
    "--phase-stats", "--serve",
]

#: Steps the profile phase traces (after the harness's warm-up step).
PROFILE_STEPS = 3

#: Each flash wrapper's device kernel, as its C++ name in ops/csrc appears
#: in a profiler trace.
KERNEL_SYMBOLS = {"flash_fwd": "fwd::fwd_kernel", "flash_dq": "dq::dq_kernel",
                  "flash_dkv": "dkv::dkv_kernel"}


def kernel_class(name: str) -> str:
    """The profile's coarse split of device time: the flash kernels,
    cuBLAS matrix products, aten's elementwise and reduction kernels."""
    if any(symbol in name for symbol in KERNEL_SYMBOLS.values()):
        return "flash"
    if "nvjet" in name or "gemm" in name.lower() or "xmma" in name:
        return "matmul"
    if "elementwise" in name or "reduce_kernel" in name:
        return "elementwise"
    return "other"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def phase_env(torch) -> None:
    cap = torch.cuda.get_device_capability(0)
    print(
        f"env: python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"capability {cap[0]}.{cap[1]} count {torch.cuda.device_count()}",
        flush=True,
    )
    if cap < (9, 0):
        fail(f"capability {cap} is below Hopper (9, 0)")
    print(f"nvidia-smi: {nvidia_smi_line()}", flush=True)
    from tpumon.workload_torch.ops._build import nvcc

    out = subprocess.run(
        [nvcc(), "--version"], capture_output=True, text=True, timeout=60,
        check=True,
    ).stdout.strip().splitlines()
    print(f"nvcc: {out[-1] if out else '?'}", flush=True)


def phase_build() -> None:
    """Build every kernel and fail if ptxas reports spilled registers in
    any instantiation, ignored a setmaxnreg or serialized a wgmma."""
    from tpumon.workload_torch.ops import _build

    t0 = time.perf_counter()
    report = _build.build(tuple(KERNELS))
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({len(report)} compiled)", flush=True)
    bad = []
    for name, info in report.items():
        print(f"build: {name} {info['seconds']:.2f} s", flush=True)
        for line in info["ptxas"]:
            print(f"  {line.strip()}", flush=True)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if spill and (int(spill.group(1)) or int(spill.group(2))):
                bad.append(f"{name}: {line.strip()}")
            # "(C7512) ... wgmma.mma_async instructions are serialized"
            # (or C7520, the same loss from another cause): a wgmma kernel
            # lost its pipelining.
            if any(s in line for s in ("setmaxnreg ignored", "(C7512)",
                                       "instructions are serialized")):
                bad.append(f"{name}: {line.strip()}")
    if bad:
        fail("ptxas: " + "; ".join(bad))


def time_ms(torch, fn, reps: int) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, each between two
    CUDA events, after two warm-up runs."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(B, S, Sk, H, KV, D, causal, kernel, peak_flops, peak_bytes):
    """(bound_ms, bound_by): the larger of the products' operations at
    the bf16 tensor peak and the bytes the function must move (each input
    read once, each output written once) at the HBM rate. Under causal
    only the live (q, k) pairs of this input count."""
    pairs = S * (S + 1) // 2 if causal else S * Sk
    q_bytes, kv_bytes, row_bytes = B * S * H * D * 2, B * Sk * KV * D * 2, B * H * S * 4
    if kernel == "flash_fwd":
        ops = 2 * 2 * B * H * pairs * D
        moved = 2 * q_bytes + 2 * kv_bytes + row_bytes
    elif kernel == "flash_dq":
        ops = 3 * 2 * B * H * pairs * D
        moved = 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes
    else:
        ops = 4 * 2 * B * H * pairs * D
        moved = 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes
    t_ops, t_bytes = ops / peak_flops * 1e3, moved / peak_bytes * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_kernels(torch, reps: int, seed: int) -> dict:
    import torch.nn.functional as F

    from tpumon.workload_torch import flops
    from tpumon.workload_torch.ops import flash_attention as fa

    dev = torch.device("cuda", 0)
    peak_flops = flops.peak_flops_per_device(dev)
    peak_bytes = flops.peak_hbm_bytes_per_device(dev)
    if peak_flops is None or peak_bytes is None:
        fail(f"no published peaks for {torch.cuda.get_device_name(0)!r} "
             "in tpumon/workload_torch/flops.py")
    gen = torch.Generator(device=dev).manual_seed(seed)
    results: dict = {}
    failed = []
    for case, B, S, Sk, H, KV, D, causal in CASES:
        def randn(*shape):
            return torch.randn(
                shape, generator=gen, device=dev, dtype=torch.float32
            ).to(torch.bfloat16)

        q, k, v, do = randn(B, S, H, D), randn(B, Sk, KV, D), randn(B, Sk, KV, D), randn(B, S, H, D)
        shape = {"B": B, "S": S, "Sk": Sk, "H": H, "KV": KV, "D": D,
                 "causal": causal}

        o, lse = fa.flash_fwd(q, k, v, causal)
        ref_o, ref_lse = fa.flash_fwd_reference(q, k, v, causal)
        torch.cuda.synchronize()
        err_o = (o.float() - ref_o.float()).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        # Each backward kernel gets the same inputs as its plain version:
        # the plain forward's lse and Δ, so its error is its own.
        delta = fa.flash_delta(ref_o, do)
        dq = fa.flash_dq(q, k, v, do, ref_lse, delta, causal)
        ref_dq = fa.flash_dq_reference(q, k, v, do, ref_lse, delta, causal)
        dk, dv = fa.flash_dkv(q, k, v, do, ref_lse, delta, causal)
        ref_dk, ref_dv = fa.flash_dkv_reference(q, k, v, do, ref_lse, delta, causal)
        torch.cuda.synchronize()

        def rel_l2(a, b):
            b = b.float()
            return ((a.float() - b).norm() / b.norm().clamp_min(1e-30)).item()

        def max_abs(a, b):
            return (a.float() - b.float()).abs().max().item()

        errs = {
            "flash_fwd": ({"o_max_abs": err_o, "lse_max_abs": err_lse},
                          {"o_max_abs": LIMITS["o"], "lse_max_abs": LIMITS["lse"]},
                          max(err_o, err_lse)),
            "flash_dq": ({"dq_rel_l2": rel_l2(dq, ref_dq)},
                         {"dq_rel_l2": LIMITS["grad_rel_l2"]},
                         max_abs(dq, ref_dq)),
            "flash_dkv": ({"dk_rel_l2": rel_l2(dk, ref_dk),
                           "dv_rel_l2": rel_l2(dv, ref_dv)},
                          {"dk_rel_l2": LIMITS["grad_rel_l2"],
                           "dv_rel_l2": LIMITS["grad_rel_l2"]},
                          max(max_abs(dk, ref_dk), max_abs(dv, ref_dv))),
        }
        calls = {
            "flash_fwd": (lambda: fa.flash_fwd(q, k, v, causal),
                          lambda: fa.flash_fwd_reference(q, k, v, causal)),
            "flash_dq": (lambda: fa.flash_dq(q, k, v, do, ref_lse, delta, causal),
                         lambda: fa.flash_dq_reference(q, k, v, do, ref_lse, delta, causal)),
            "flash_dkv": (lambda: fa.flash_dkv(q, k, v, do, ref_lse, delta, causal),
                          lambda: fa.flash_dkv_reference(q, k, v, do, ref_lse, delta, causal)),
        }
        # Library yardstick for the forward: SDPA on the same inputs in
        # its [B, H, S, D] layout, K/V expanded to H heads outside the
        # timed region. No single library call computes dQ or dK/dV alone.
        qt = q.transpose(1, 2).contiguous()
        kt = k.repeat_interleave(H // KV, dim=2).transpose(1, 2).contiguous()
        vt = v.repeat_interleave(H // KV, dim=2).transpose(1, 2).contiguous()
        library = {"flash_fwd": lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal)}
        for name, (got, limit, worst_abs) in errs.items():
            kernel_fn, plain_fn = calls[name]
            ms = time_ms(torch, kernel_fn, reps)
            plain_ms = time_ms(torch, plain_fn, reps)
            lib = library.get(name)
            library_ms = time_ms(torch, lib, reps) if lib else None
            bound_ms, bound_by = bound(B, S, Sk, H, KV, D, causal, name,
                                       peak_flops, peak_bytes)
            ok = all(got[key] <= limit[key] for key in got)
            if not ok:
                failed.append(f"{name}@{case}: {got} over {limit}")
            row = {
                "case": case, "kernel": name, "shape": shape, "err": got,
                "limit": limit, "max_abs_err": worst_abs, "passed": ok,
                "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "reps": reps,
            }
            emit(row)
            results.setdefault(name, {})[case] = row

        # The backward as a whole: the Δ pre-pass, flash_dq and flash_dkv,
        # beside the library's backward (SDPA forward + backward minus its
        # forward, on the K/V expanded to H heads). No single library call
        # computes dQ or dK/dV alone, so the kernels' rows keep null.
        def backward():
            d = fa.flash_delta(o, do)
            fa.flash_dq(q, k, v, do, lse, d, causal)
            fa.flash_dkv(q, k, v, do, lse, d, causal)

        qg, kg, vg = (t.detach().requires_grad_() for t in (qt, kt, vt))
        dot = do.transpose(1, 2).contiguous()

        def sdpa_fwd_bwd():
            out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
            torch.autograd.grad(out, (qg, kg, vg), dot)

        bwd_ms = time_ms(torch, backward, reps)
        fwd_bwd_ms = time_ms(torch, sdpa_fwd_bwd, reps)
        sdpa_fwd_ms = results["flash_fwd"][case]["library_ms"]
        emit({"case": case, "backward": {
            "ms": bwd_ms, "library_ms": fwd_bwd_ms - sdpa_fwd_ms,
            "sdpa_fwd_bwd_ms": fwd_bwd_ms, "sdpa_fwd_ms": sdpa_fwd_ms,
            "kernels": ["delta (torch)", "flash_dq", "flash_dkv"]},
            "reps": reps})
        del qg, kg, vg, dot
        del q, k, v, do, o, lse, ref_o, ref_lse, delta, dq, ref_dq
        del dk, dv, ref_dk, ref_dv, qt, kt, vt
        torch.cuda.empty_cache()
    if failed:
        fail("kernels disagree with their plain versions: " + "; ".join(failed))
    return results


class _LossRecords(logging.Handler):
    """Collects the harness's final log record, whose args carry the
    first and last losses and the steps/s."""

    def __init__(self) -> None:
        super().__init__()
        self.records: list[logging.LogRecord] = []

    def emit(self, record: logging.LogRecord) -> None:
        if str(record.msg).startswith("loss "):
            self.records.append(record)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_main(torch) -> dict:
    from tpumon.lifecycle.probe import step_snapshot_from_text
    from tpumon.workload_torch import flops, harness
    from tpumon.workload_torch.models.llama import LlamaConfig
    from tpumon.workload_torch.ops import flash_attention as fa

    port = _free_port()
    url = f"http://127.0.0.1:{port}/metrics"
    pages: list[str] = []
    done = threading.Event()

    def scrape() -> None:
        while not done.is_set():
            try:
                with urllib.request.urlopen(url, timeout=5) as resp:
                    text = resp.read().decode()
                if "tpu_step_duration_seconds" in text:
                    pages.append(text)
            except OSError:
                pass  # the server is not up yet, or already closed
            done.wait(0.5)

    records = _LossRecords()
    log = logging.getLogger("tpumon.workload_torch.harness")
    log.addHandler(records)
    scraper = threading.Thread(target=scrape, name="chip-smoke-scrape", daemon=True)
    scraper.start()
    argv = [*MAIN_ARGV, "--metrics-port", str(port)]
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    t0 = time.perf_counter()
    try:
        rc = harness.main(argv)
    finally:
        wall = time.perf_counter() - t0
        counts = dict(fa.launches)
        done.set()
        scraper.join(timeout=30)
        log.removeHandler(records)
    peak_mem = torch.cuda.max_memory_allocated()
    if rc != 0:
        fail(f"harness.main returned {rc}")
    if not records.records:
        fail("harness.main logged no final loss line")
    rec = records.records[-1]
    first, last, steps_per_sec = rec.args[0], rec.args[1], rec.args[2]
    if not all(math.isfinite(x) for x in (first, last)):
        fail(f"non-finite loss: {first} -> {last}")
    if not pages:
        fail("never scraped a page with tpu_step_* from the live run")
    snaps = [step_snapshot_from_text(p) for p in pages]
    snap = snaps[-1]
    # tpu_step_* (counter, duration, terminating, phases) and tpu_serve_*
    # (rate, queue, batch, TTFT, SLO) as the lifecycle plane reads them.
    missing = [key for key in (
        "step", "step_seconds", "terminating", "phases", "loss",
        "serve_requests_per_second", "serve_queue_depth", "serve_batch_size",
        "serve_ttft_seconds", "serve_slo_attainment_ratio",
    ) if key not in snap]
    if missing:
        fail(f"snapshot keys missing from the scraped page: {missing}")
    window_losses = sorted({(s["step"], s["loss"]) for s in snaps if "loss" in s})
    if not all(math.isfinite(loss) for _, loss in window_losses):
        fail(f"non-finite window loss on the page: {window_losses}")
    idle = [name for name, n in counts.items() if n <= 0]
    if idle:
        fail(f"kernels never launched on the main path: {idle}")
    cfg = LlamaConfig.medium()
    batch, seq = 8, 4096
    mfu = flops.mfu(cfg, batch, seq, steps_per_sec, torch.device("cuda", 0))
    # What the counts should be: each layer's attention runs the forward
    # twice under --remat (the pass and its recompute) and each backward
    # kernel once, per microbatch; 11 steps (warm-up + 10) of 4
    # microbatches, plus 2 phase probes of one microbatch (a forward, then
    # a forward and backward).
    L = cfg.n_layers
    expected = {"flash_fwd": 11 * 4 * 2 * L + 2 * 3 * L,
                "flash_dq": 11 * 4 * L + 2 * L, "flash_dkv": 11 * 4 * L + 2 * L}
    if counts != expected:
        fail(f"launch counts {counts} differ from the expected {expected}")
    result = {
        "phase": "main", "argv": argv, "loss_first": first, "loss_last": last,
        "window_losses": window_losses, "steps_per_sec": steps_per_sec,
        "tokens_per_sec": steps_per_sec * batch * seq, "mfu": mfu,
        "max_memory_allocated": peak_mem, "launches": counts,
        "launches_expected": expected,
        "launches_per_step": {"flash_fwd": 4 * 2 * L, "flash_dq": 4 * L,
                              "flash_dkv": 4 * L},
        "wall_s": wall, "snapshot": snap,
    }
    emit(result)
    return result


def profile_summary(spans, wall_s: float, steps: int, top: int = 15) -> dict:
    """Per-step breakdown of a trace. ``spans`` are (name, start_us, end_us)
    of every device activity in ``steps`` steps that took ``wall_s`` on the
    host's clock; the idle share is 1 - (union of the spans / wall)."""
    per_name: dict[str, list] = {}
    busy_us, run_start, run_end = 0.0, None, None
    for name, start, end in sorted(spans, key=lambda s: s[1]):
        entry = per_name.setdefault(name, [0, 0.0])
        entry[0] += 1
        entry[1] += end - start
        if run_end is None or start > run_end:
            if run_end is not None:
                busy_us += run_end - run_start
            run_start, run_end = start, end
        else:
            run_end = max(run_end, end)
    if run_end is not None:
        busy_us += run_end - run_start
    step_ms = wall_s * 1e3 / steps
    flash_ms = {
        kernel: sum(t for name, (_, t) in per_name.items() if symbol in name)
        / 1e3 / steps
        for kernel, symbol in KERNEL_SYMBOLS.items()
    }
    by_class: dict[str, float] = {}
    for name, (_, t) in per_name.items():
        cls = kernel_class(name)
        by_class[cls] = by_class.get(cls, 0.0) + t / 1e3 / steps
    ranked = sorted(per_name.items(), key=lambda item: -item[1][1])[:top]
    return {
        "steps": steps, "step_ms": step_ms,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "idle_share": 1.0 - busy_us / (wall_s * 1e6),
        "ms_per_step_by_class": by_class,
        "top_kernels": [{"name": name[:200], "calls_per_step": calls / steps,
                         "ms_per_step": t / 1e3 / steps}
                        for name, (calls, t) in ranked],
        "flash_ms_per_step": flash_ms,
        "flash_share_of_step": sum(flash_ms.values()) / step_ms,
    }


def phase_profile(torch) -> dict:
    """Trace the timed steps of the main path's argv (3 steps, no serve
    page, no phase probe). The trace brackets the timed steps: the train
    step the harness builds is wrapped to synchronise and start the
    profiler before the first timed step, and to synchronise and stop it
    after the last; the steps themselves run unchanged."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpumon.workload_torch import harness

    argv = [a for a in MAIN_ARGV if a not in ("--phase-stats", "--serve")]
    argv[argv.index("--steps") + 1] = str(PROFILE_STEPS)
    prof = profile(activities=[ProfilerActivity.CUDA])
    make_train_step = harness.make_train_step
    calls = 0
    window: dict[str, float] = {}

    def traced_make_train_step(*args, **kwargs):
        step = make_train_step(*args, **kwargs)

        def traced_step(tokens):
            nonlocal calls
            calls += 1
            if calls == 2:  # the first step after the warm-up
                torch.cuda.synchronize()
                prof.start()
                window["t0"] = time.perf_counter()
            out = step(tokens)
            if calls == 1 + PROFILE_STEPS:
                torch.cuda.synchronize()
                window["t1"] = time.perf_counter()
                prof.stop()
            return out

        return traced_step

    harness.make_train_step = traced_make_train_step
    try:
        rc = harness.main(argv)
    finally:
        harness.make_train_step = make_train_step
    if rc != 0:
        fail(f"profile: harness.main returned {rc}")
    if "t1" not in window:
        fail(f"profile: the harness ran {calls} steps, not 1 + {PROFILE_STEPS}")
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not spans:
        fail("profile: the trace holds no device activity")
    result = {"phase": "profile", "argv": argv,
              **profile_summary(spans, window["t1"] - window["t0"],
                                PROFILE_STEPS)}
    missing = [k for k, ms in result["flash_ms_per_step"].items() if ms <= 0]
    if missing:
        fail(f"profile: no device time for {missing} in the trace")
    emit(result)
    return result


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default="env,build,kernels,main,profile")
    parser.add_argument("--reps", type=int, default=10,
                        help="timed runs per kernel (median reported)")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    # Imported after the card check: the port must be in this checkout.
    import tpumon.workload_torch  # noqa: F401

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    if "env" in phases:
        phase_env(torch)
    if "build" in phases:
        phase_build()
    kernels = phase_kernels(torch, args.reps, args.seed) if "kernels" in phases else {}
    main_run = phase_main(torch) if "main" in phases else None
    if "profile" in phases:
        phase_profile(torch)
    print(f"total: {time.perf_counter() - t0:.1f} s", flush=True)

    line = []
    for name, (source, replaces) in KERNELS.items():
        row = kernels.get(name, {}).get("main", {})
        line.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces[0], "replaces_all": replaces,
            "launches": (main_run or {}).get("launches", {}).get(name, 0),
            "max_abs_err": row.get("max_abs_err"), "ms": row.get("ms"),
            "plain_ms": row.get("plain_ms"), "bound_ms": row.get("bound_ms"),
            "bound_by": row.get("bound_by"), "library_ms": row.get("library_ms"),
            "passed": all(r["passed"] for r in kernels.get(name, {}).values())
            if name in kernels else None,
        })
    print(nvidia_smi_line(), flush=True)  # the card's name and power limit
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
