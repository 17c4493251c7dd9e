"""One run of a cell: set-up (the checked first steps, which are also the
warm-up), the measured window, the traced span, and the reference's
check.

The order is the contract's: the program is built once; its first steps
go through the window's own step on distinct batches and are read for
the check (losses, step 1's gradient norms, the change after the steps
the reference follows); the window then times whole steps; the peak is
read, the program freed, and only then the reference runs, from the
seed, on the same batches.
"""

from __future__ import annotations

import gc
import importlib
import time

import torch

from benchmark import compare, devtrace, families, roofline, seeded
from benchmark.program import Program

#: Steps the reference follows, and the program's set-up runs (and is
#: checked on) before its window: the second is already a warm step.
CHECKED_STEPS = 2

#: Whole steps the traced span covers, after the window.
TRACE_STEPS = 2

#: Tokens the dense reference takes through one pass (rows of the
#: cell's sequence length), so its [H, S, S] scores fit.
REF_TOKENS_PER_PASS = 4096


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def set_up(cell, seed: int, device, spans: bool = False,
           fault: str | None = None, checked: int = CHECKED_STEPS,
           projections: bool | None = None) -> tuple[Program, dict]:
    """The program, run through its ``checked`` first steps, and its
    readings: each step's loss, step 1's gradient norms (and projections,
    by default where the cell compares them), and the change over the
    steps."""
    if projections is None:
        projections = compare.needs_projections(cell.limits)
    t = time.perf_counter()
    prog = Program(cell, seed, device, spans=spans, fault=fault)
    sync(device)
    phases = {"build": time.perf_counter() - t}
    losses, grads, proj, change = [], None, None, None
    for s in range(checked):
        t = time.perf_counter()
        losses.append(float(prog.step()))
        if s == 0:
            grads = prog.grad_norms()
            proj = prog.grad_projections() if projections else None
        if s == checked - 1:
            change = prog.change_norms()
        sync(device)
        phases[f"step{s + 1}"] = time.perf_counter() - t
    return prog, {"losses": losses, "grad_norms": grads, "grad_proj": proj,
                  "change_norms": change, "phases": phases}


def window(prog: Program, seconds: float, device) -> dict:
    """Whole steps until ``seconds`` have passed; the step in flight at
    the deadline finishes, then the card is synchronised."""
    sync(device)
    losses = []
    start = time.perf_counter()
    while True:
        losses.append(prog.step())
        if time.perf_counter() - start >= seconds:
            break
    sync(device)
    elapsed = time.perf_counter() - start
    finite = torch.stack(losses).isfinite()
    return {"steps": len(losses), "seconds": elapsed,
            "failed": int((~finite).sum())}


def free(prog: Program, device) -> None:
    prog.close()
    free_all(device)


def free_all(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def reference_module(cell):
    return importlib.import_module(f"benchmark.reference.{cell.reference}")


def reference_readings(cell, seed: int, device, fp8: bool = False,
                       steps: int = CHECKED_STEPS,
                       projections: bool | None = None, forced=None) -> dict:
    """The reference's readings of its first ``steps`` steps, from the
    seed (with ``forced`` routing: ``decoder.ForcedRouting``)."""
    if projections is None:
        projections = compare.needs_projections(cell.limits)
    ref = reference_module(cell)
    batches = seeded.tokens(seed, cell.pool, cell.batch, cell.seq,
                            cell.model.vocab, device)[:steps]
    rows = max(1, REF_TOKENS_PER_PASS // cell.seq)
    return ref.follow(cell.model, seed, batches, cell.grad_accum, rows,
                      steps, device, ref.Precision(fp8=fp8),
                      projections=projections, forced=forced)


def record_of(cell, device_name: str, setup_s: float, win: dict,
              peak_bytes: int, trace: dict | None) -> dict:
    """What the metric readers read: the run's numbers, and the cell's
    configuration file, sequence length and micro-batch, from which a
    family's own readers work out their own counts."""
    m = cell.model
    family = families.of(m)
    return {
        "chips": cell.chips,
        "config": cell.config,
        "seq": cell.seq,
        "micro_batch": cell.micro_batch,
        "tokens_per_step": cell.tokens_per_step,
        "flops_per_step": family.train_flops_per_step(m, cell.batch, cell.seq),
        "peak_flops": roofline.peak(roofline.PEAK_BF16_FLOPS, device_name),
        "peak_bytes": roofline.peak(roofline.PEAK_HBM_BYTES, device_name),
        "setup_s": setup_s,
        "window": win,
        "memory_peak_bytes": peak_bytes,
        "attn_shape": family.attn_shape(m, cell.micro_batch, cell.seq),
        "trace": trace,
    }


def measure(cell, seed: int, seconds: float, traced: bool, device,
            t0: float, fault: str | None = None) -> dict:
    """One run: set-up, window, optional traced span, reference, check.
    ``t0`` is the process's start on the host clock."""
    prog, prog_readings = set_up(cell, seed, device, spans=traced, fault=fault)
    setup_s = time.perf_counter() - t0
    win = window(prog, seconds, device)
    on_card = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    trace = None
    if traced:
        events, wall = devtrace.capture(
            lambda: [prog.step() for _ in range(TRACE_STEPS)], device)
        trace = devtrace.reduce(events, wall, TRACE_STEPS)
    free(prog, device)
    t_ref = time.perf_counter()
    ref_readings = reference_readings(cell, seed, device)
    numbers = compare.readings(prog_readings, ref_readings)
    name = torch.cuda.get_device_name(device) if on_card else "cpu"
    return {
        "record": record_of(cell, name, setup_s, win, peak, trace),
        "numbers": numbers,
        "correct": compare.decide(numbers, cell.limits) and win["failed"] == 0,
        "reference_s": time.perf_counter() - t_ref,
        "device_name": name,
        "losses": {"program": prog_readings["losses"],
                   "reference": ref_readings["losses"]},
        "phases": prog_readings["phases"],
    }
