"""Readings for the limits of ``correct`` and for sizing a cell, on the
card. The benchmark's own runs never run this.

    python3 benchmark/calibrate.py limits --workload mistral-7b.s4096 \
        --seeds 1 2 3 --control-seeds 1 2 3 --fault-seeds 1
    python3 benchmark/calibrate.py sizes --workload mistral-7b.s4096 \
        --micro-batches 4 8 16
    python3 benchmark/calibrate.py routing --workload mixtral-8x7b.s4096 \
        --seeds 1 2 3 --fault-seeds 1 2 3

``limits`` prints one JSON line a reading: for every seed the sound
program's compared numbers against the reference (the lower readings),
for the control seeds the reference computed with float8 products
against the float32 one (the control), for the fault seeds the program
with each fault planted under its step. ``sizes`` runs the set-up of the
cell at each micro-batch (the rest of the batch as accumulation) and
prints the allocator's peak and the seconds of a warm step.

``routing`` is the witness for a mixture-of-experts cell: for every seed
it records the port's top-k choices at each layer and accumulation chunk
of the checked steps, runs the reference once with those choices put in
place of its own (``decoder.ForcedRouting``: its own gates, its own
capacity) and once on its own, and prints both sets of numbers and how
many tokens' choices differ. For the fault seeds it drops every tenth
position of each sequence from the port's dispatch and combine (a
routing fault that a tenth of the tokens feel) and prints the numbers
against the reference.
"""

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def emit(obj, out=None) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    if out is not None:
        with open(out, "a") as f:
            f.write(line + "\n")


def limits(cell, args, device) -> None:
    from benchmark import cellrun, compare

    refs = {}
    steps = args.steps

    def ref_of(seed):
        if seed not in refs:
            t = time.perf_counter()
            refs[seed] = cellrun.reference_readings(cell, seed, device, steps=steps,
                                                    projections=True)
            emit({"kind": "reference", "seed": seed, "seconds": time.perf_counter() - t,
                  **refs[seed]}, args.out)
        return refs[seed]

    def program(seed, fault=None):
        t = time.perf_counter()
        prog, readings = cellrun.set_up(cell, seed, device, fault=fault,
                                        checked=steps, projections=True)
        cellrun.free(prog, device)
        return readings, time.perf_counter() - t

    for seed in args.seeds:
        readings, seconds = program(seed)
        numbers = compare.readings(readings, ref_of(seed))
        emit({"kind": "program", "seed": seed, "setup_s": seconds,
              **readings, **numbers}, args.out)
    for seed in args.fault_seeds:
        for fault in ("half_batch",):
            readings, _ = program(seed, fault)
            emit({"kind": f"fault:{fault}", "seed": seed,
                  **compare.readings(readings, ref_of(seed))}, args.out)
    for seed in args.control_seeds:
        t = time.perf_counter()
        control = cellrun.reference_readings(cell, seed, device, fp8=True,
                                             steps=steps, projections=True)
        emit({"kind": "control:fp8", "seed": seed, **control,
              "seconds": time.perf_counter() - t,
              **compare.readings(control, ref_of(seed))}, args.out)
        refs.pop(seed, None)


@contextlib.contextmanager
def port_routing(record: list | None = None, drop_tenth: bool = False):
    """Wrap the port's ``route_tokens`` (this process only): append each
    call's (router's address, top-k experts [B, S, k]) to ``record``;
    with ``drop_tenth``, zero the dispatch and combine of every tenth
    position."""
    import torch

    from tpumon.workload_torch.models import moe

    original = moe.route_tokens

    def route_tokens(x, router, cfg, mesh=None):
        dispatch, combine, probs = original(x, router, cfg, mesh)
        if record is not None:
            record.append((router.data_ptr(),
                           probs.topk(cfg.top_k, dim=-1).indices.cpu()))
        if drop_tenth:
            keep = torch.arange(x.shape[1], device=x.device) % 10 != 0
            keep = keep.to(dispatch.dtype)[None, :, None, None]
            dispatch, combine = dispatch * keep, combine * keep
        return dispatch, combine, probs

    moe.route_tokens = route_tokens
    try:
        yield
    finally:
        moe.route_tokens = original


def choices_by_layer(record: list, routers: dict, chunks: int) -> tuple[dict, bool]:
    """The recorded choices by layer, one an accumulation chunk in call
    order: a remat's recompute (every second call of a layer) dropped,
    and whether it chose as the forward did."""
    import torch

    by_layer = {i: [] for i in routers.values()}
    for ptr, experts in record:
        by_layer[routers[ptr]].append(experts)
    same = True
    for i, calls in by_layer.items():
        if len(calls) == 2 * chunks:
            same &= all(torch.equal(a, b) for a, b in zip(calls[::2], calls[1::2]))
            by_layer[i] = calls[::2]
        elif len(calls) != chunks:
            raise RuntimeError(f"layer {i}: {len(calls)} routing calls for "
                               f"{chunks} chunks")
    return by_layer, same


def routing(cell, args, device) -> None:
    from benchmark import cellrun, compare
    from benchmark.reference.decoder import ForcedRouting

    steps = args.steps
    for seed in args.seeds:
        record = []
        t = time.perf_counter()
        with port_routing(record):
            prog, readings = cellrun.set_up(cell, seed, device, checked=steps,
                                            projections=True)
        routers = {p.data_ptr(): int(n.split(".")[1])
                   for n, p in prog.params.items() if n.endswith(".router")}
        cellrun.free(prog, device)
        choices, same = choices_by_layer(record, routers, cell.grad_accum * steps)
        setup_s = time.perf_counter() - t
        forced = ForcedRouting(choices)
        ref_forced = cellrun.reference_readings(cell, seed, device, steps=steps,
                                                projections=True, forced=forced)
        ref_own = cellrun.reference_readings(cell, seed, device, steps=steps,
                                             projections=True)
        emit({"kind": "routing", "seed": seed, "setup_s": setup_s,
              "recompute_chose_the_same": same, "flips": forced.flips,
              "tokens": forced.tokens,
              "forced": compare.readings(readings, ref_forced),
              "own": compare.readings(readings, ref_own)}, args.out)
        if seed in args.fault_seeds:
            with port_routing(drop_tenth=True):
                prog, faulty = cellrun.set_up(cell, seed, device, checked=steps,
                                              projections=True)
            cellrun.free(prog, device)
            emit({"kind": "fault:drop_tenth", "seed": seed,
                  **compare.readings(faulty, ref_own)}, args.out)


def sizes(cell, args, device) -> None:
    import torch

    from benchmark import cellrun

    for mb in args.micro_batches:
        trial = dataclasses.replace(cell, micro_batch=mb,
                                    grad_accum=cell.batch // mb)
        torch.zeros(1, device=device)  # the allocator starts lazily
        torch.cuda.reset_peak_memory_stats(torch.device(device))
        try:
            prog, _ = cellrun.set_up(trial, 1, device)
            t = time.perf_counter()
            prog.step()
            cellrun.sync(device)
            step_s = time.perf_counter() - t
            cellrun.free(prog, device)
            emit({"kind": "size", "micro_batch": mb, "grad_accum": trial.grad_accum,
                  "step_s": step_s,
                  "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30},
                 args.out)
        except torch.cuda.OutOfMemoryError as exc:
            emit({"kind": "size", "micro_batch": mb, "oom": str(exc)[:200]}, args.out)
        prog = None
        cellrun.free_all(device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("mode", choices=("limits", "sizes", "routing"))
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--micro-batches", type=int, nargs="*", default=[])
    p.add_argument("--steps", type=int, default=2,
                   help="steps the reference follows (the cell's runs: 2)")
    p.add_argument("--out", default=None, help="also append the lines here")
    args = p.parse_args(argv)
    from benchmark import guard, spec

    cell = spec.load_cell(args.workload)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    {"limits": limits, "sizes": sizes, "routing": routing}[args.mode](
        cell, args, "cuda:0")
    guard.check("calibration")
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.exit(main())
