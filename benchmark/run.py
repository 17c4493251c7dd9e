"""The benchmark's command: one run of one cell.

    python3 benchmark/run.py --workload mistral-7b.s4096 --seed 7 \
        --seconds 10 --trace 0

Loads the cell by name from ``BENCHMARK.json`` and its files, makes the
weights and the token batches on the card from ``--seed``, runs the
port's train step through its checked first steps and the warm-up
(set-up), times whole steps for ``--seconds``, and with ``--trace 1``
traces a few more. Then it frees the program, runs the plain float32
reference over the checked steps and compares. The last lines on
standard error are each compared number beside its limit; the last line
on standard output is the result, with the cell's end-to-end metrics
(``--trace 0``) or its per-layer metrics (``--trace 1``), each read by
``benchmark/metrics/<name>.py``.

Exits 2 without a result when the cell is unknown, its files are missing,
or the process sees no card or fewer cards than the cell asks for; 3
when JAX, jaxlib, flax or the JAX package is loaded in this process.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


#: Where each per-layer or end-to-end metric's reader lives, by name.
METRICS = ROOT / "benchmark" / "metrics"


def load_reader(name: str):
    """The module ``METRICS/<name>.py``, loaded."""
    path = METRICS / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_metric(name: str, record: dict):
    """The value of metric ``name`` from its reader, or None."""
    return load_reader(name).read(record)


def result_line(cell, run: dict, traced: bool) -> dict:
    record = run["record"]
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = read_metric(m["name"], record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": run["device_name"], "count": cell.chips,
              "memory_peak_bytes": record["memory_peak_bytes"]}
    out = {"correct": run["correct"], "attempted": record["window"]["steps"],
           "failed": record["window"]["failed"], "metrics": metrics,
           "device": device}
    trace = record["trace"]
    if traced:
        device["busy_s"] = trace["busy_s"]
        device["window_s"] = trace["window_s"]
        out["breakdown"] = {"device_ops": trace["device_ops"],
                            "idle_gaps": trace["idle_gaps"]}
        out["unclassified_kernels"] = trace["unclassified"][:20]
        out["device_ms_per_step_by_class"] = {
            cls: 1e3 * s / trace["steps"] for cls, s in trace["by_class_s"].items()}
    out["reference_s"] = run["reference_s"]
    numbers = run["numbers"]
    out["read_not_compared"] = {k: v for k, v in numbers.items()
                                if "_gap" in k and k not in cell.limits}
    out["checks"] = {k: {"value": numbers[k], "limit": limit}
                     for k, limit in cell.limits.items()}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark import guard

    guard.check("start-up")
    from benchmark import spec

    try:
        cell = spec.load_cell(args.workload)
    except (FileNotFoundError, KeyError, ValueError) as exc:
        print(f"benchmark: {exc}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    if cell.chips != 1 or cell.mesh:
        print(f"benchmark: {args.workload}: this harness runs one-card cells",
              file=sys.stderr)
        return 2
    try:
        from tpumon.workload_torch.ops import flash_attention  # noqa: F401
    except ImportError as exc:
        print(f"benchmark: the port is not in this checkout: {exc}", file=sys.stderr)
        return 2
    from benchmark import cellrun

    run = cellrun.measure(cell, args.seed, args.seconds, bool(args.trace),
                          "cuda:0", T0)
    return finish(cell, run, args)


def finish(cell, run: dict, args) -> int:
    """Read the metrics, print the compared numbers and then the result.
    The guard looks last, once every reader is loaded: a reader that
    brings in JAX stops the run before any result is printed."""
    from benchmark import compare, guard

    line = result_line(cell, run, bool(args.trace))
    if args.trace:
        out = Path(tempfile.gettempdir()) / "tpumon-benchmark"
        out.mkdir(parents=True, exist_ok=True)
        with (out / f"{args.workload}.{args.seed}.trace.json").open("w") as f:
            json.dump(run["record"], f)
    print(f"set-up phases (s) {run['phases']}, reference "
          f"{run['reference_s']:.1f} s", file=sys.stderr)
    print(f"losses {run['losses']}", file=sys.stderr)
    for text in compare.lines(run["numbers"], cell.limits):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    guard.check("before the result")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    # Run as a script, the path's first entry is this folder: make it the
    # checkout's root, so ``benchmark`` and ``tpumon`` import as packages
    # and no file here shadows a standard module.
    sys.path[0] = str(ROOT)
    sys.exit(main())
