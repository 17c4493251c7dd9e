"""The span table of one cell on the card: where the port's own spans
(``workload.*``) put the device time of a traced step.

    python3 benchmark/spantable.py --workload mistral-7b.s4096 --seed 7

Builds the cell's program as ``run.py`` does (with the benchmark's
attention spans), runs its two checked steps and ``--warm`` seconds of
steps, captures two whole steps under the profiler as a traced run does,
and prints one JSON line: the step's wall and busy time, the numbers of
``progspans.METRICS``, the span table by device ms a step, the idle gaps
by span, and the checks that hold the table to the trace record (the
unspanned share of busy time; spanned and unspanned non-products against
``nongemm_ms_per_step``; ``workload.attn_core`` against the attention
seconds). ``--out`` writes the trace record, the span table in it, there
as JSON. No reference runs: this measures where the time goes, not whether
the step is right.

Exits 2 without a line when the cell is unknown or the process sees no
card; 3 when JAX, jaxlib, flax or the JAX package is loaded.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--warm", type=float, default=3.0,
                   help="seconds of steps after the checked ones, before the capture")
    p.add_argument("--out", type=Path, default=None,
                   help="folder for <workload>.<seed>.spans.json")
    return p.parse_args(argv)


def _ms(seconds: float, steps: int) -> float:
    return 1e3 * seconds / steps


def metrics(program: dict | None) -> dict:
    """The numbers of ``progspans.METRICS`` (device ms a step) from a span
    table: what the span metrics' readers give."""
    from benchmark import progspans

    return {name: progspans.ms_per_step(program, spans)
            for name, spans in progspans.METRICS.items()}


def summary(trace: dict, program: dict) -> dict:
    """The line's numbers from one capture's trace record
    (``devtrace.reduce``) and span table (``progspans.reduce``)."""
    from benchmark import progspans
    from benchmark.run import read_metric

    steps = trace["steps"]
    table = program["spans"]
    rec = {"trace": trace}
    nongemm = read_metric("nongemm_ms_per_step", rec)
    nonproduct = _ms(progspans.nonproduct_s(program), steps)
    attention = sum(trace["attention"][d]["seconds"] for d in ("fwd", "bwd"))
    core = sum(table[n]["device_s"] for n in ("attn_core", "attn_core.bwd")
               if n in table)
    ranked = sorted(table.items(), key=lambda kv: -kv[1]["device_s"])
    return {
        "steps": steps,
        "step_wall_ms": _ms(trace["window_s"], steps),
        "busy_ms": _ms(trace["busy_s"], steps),
        "device_idle_pct": read_metric("device_idle_pct", rec),
        "metrics": metrics(program),
        "checks": {
            "unspanned_pct_of_busy": 100.0 * program["unspanned_s"] / trace["busy_s"],
            "nonproduct_ms_per_step": nonproduct,
            "nongemm_ms_per_step": nongemm,
            "nonproduct_over_nongemm": nonproduct / nongemm if nongemm else None,
            "attn_core_ms_per_step": _ms(core, steps),
            "attention_ms_per_step": _ms(attention, steps),
            "attn_core_over_attention": core / attention if attention else None,
        },
        "spans_ms": {name: {"calls": e["calls"],
                            "ms": _ms(e["device_s"], steps),
                            "by_class_ms": {c: _ms(s, steps)
                                            for c, s in e["by_class_s"].items()}}
                     for name, e in ranked},
        "unspanned_by_class_ms": {c: _ms(s, steps) for c, s
                                  in program["unspanned_by_class_s"].items()},
        "idle_by_span_ms": {k: _ms(v, steps) for k, v
                            in program["idle_by_span"].items()},
        "device_ops": trace["device_ops"],
    }


def capture(cell, seed: int, device, warm_s: float) -> dict:
    """The trace record of two steps after the warm-up, with its span table
    under ``program``."""
    from benchmark import cellrun, devtrace

    prog, _ = cellrun.set_up(cell, seed, device, spans=True, projections=False)
    cellrun.window(prog, warm_s, device)
    events, wall = devtrace.capture(
        lambda: [prog.step() for _ in range(cellrun.TRACE_STEPS)], device)
    cellrun.free(prog, device)
    return devtrace.reduce(events, wall, cellrun.TRACE_STEPS)


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark import guard, spec

    guard.check("start-up")
    try:
        cell = spec.load_cell(args.workload)
    except (FileNotFoundError, KeyError, ValueError) as exc:
        print(f"spantable: {exc}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("spantable: no CUDA card", file=sys.stderr)
        return 2
    trace = capture(cell, args.seed, "cuda:0", args.warm)
    line = {"workload": cell.name, "seed": args.seed,
            "device": torch.cuda.get_device_name(0),
            **summary(trace, trace["program"])}
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        with (args.out / f"{cell.name}.{args.seed}.spans.json").open("w") as f:
            json.dump(trace, f)
    guard.check("before the result")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.exit(main())
