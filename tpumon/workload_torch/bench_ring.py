"""Ring-attention layout benchmark for the port: contiguous vs zigzag.

The counterpart of ``tpumon/workload/bench_ring.py``. It times one causal
ring-attention forward, and one forward and backward, per sequence length
on a ring of ``--sp`` ranks, for the reference's four configurations:
the contiguous plain ring, the contiguous ring with the flash kernels on
each attended hop (``ring_flash_local``), the zigzag ring
(``zigzag_ring_attention_local``) and the zigzag ring with the flash
kernels on every stripe pair (``zigzag_ring_flash_local``). It prints
one JSON row per (seq, layout) with the reference's keys.

The ranks are started through ``parallel/launch.py``, as the harness
starts a mesh; each holds its contiguous shard of the same seeded bf16
q/k/v, and rank 0's rows are printed by the launching process. Each time
is rank 0's median over ``--iters`` calls after one warm-up call
(``bench_attention``'s timer: CUDA events on the card). When the ranks
share one card they talk over gloo, which stages every hop through host
memory: such a row times host-staged hops, not a ring of cards.
``--platform cpu`` runs the plain versions on the host's clock: a check
of the rows, not a device number.

Run:  python -m tpumon.workload_torch.bench_ring --sp 2 --seq 1024 2048 4096
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

import torch

from tpumon.workload_torch.bench_attention import _time_s
from tpumon.workload_torch.platform import PLATFORMS, resolve_device

LAYOUTS = ("contiguous", "contiguous-flash", "zigzag", "zigzag-flash")


def _validate(n: int, sp: int, batch: int, seqs: tuple[int, ...]) -> int:
    """Check mesh/shape divisibility up front; returns dp.

    Raises ValueError with the real constraint: batch splits over the
    data axis, and the zigzag leg needs an even per-rank sequence shard.
    """
    if n % sp:
        raise ValueError(f"device count {n} must divide by sp {sp}")
    dp = n // sp
    if batch % dp:
        raise ValueError(
            f"batch ({batch}) must divide by dp ({dp} = {n} devices / "
            f"sp {sp}); pass --batch {dp} or reduce --sp"
        )
    bad = [s for s in seqs if s % (2 * sp)]
    if bad:
        raise ValueError(
            f"seq values {bad} must divide by 2*sp ({2 * sp}) for the "
            "zigzag layout's lo/hi stripes"
        )
    return dp


def bench(mesh, *, batch: int = 2, heads: int = 8, kv_heads: int = 4,
          head_dim: int = 128, seqs: tuple[int, ...] = (1024, 2048, 4096),
          iters: int = 5) -> list[dict]:
    """This rank's rows: every rank of ``mesh`` (dp×sp) calls it with the
    same arguments, in lockstep."""
    from tpumon.workload_torch.parallel.ring import make_ring_attn

    device = mesh.device
    dp, sp = mesh.dp, mesh.sp
    rows_per_rank = batch // dp
    results = []
    for seq in seqs:
        gen = torch.Generator(device=device).manual_seed(0)

        def randn(*shape):
            full = torch.randn(shape, generator=gen, device=device,
                               dtype=torch.float32).to(torch.bfloat16)
            b, c = mesh.coords["data"] * rows_per_rank, mesh.coords["seq"] * (seq // sp)
            return full[b:b + rows_per_rank, c:c + seq // sp].contiguous()

        q = randn(batch, seq, heads, head_dim)
        k = randn(batch, seq, kv_heads, head_dim)
        v = randn(batch, seq, kv_heads, head_dim)
        for layout in LAYOUTS:
            attn = make_ring_attn(mesh, zigzag=layout.startswith("zigzag"),
                                  flash=layout.endswith("flash"))
            qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

            def fwd():
                with torch.no_grad():
                    attn(q, k, v)

            def fwd_bwd():
                loss = attn(qg, kg, vg).float().sum()
                torch.autograd.grad(loss, (qg, kg, vg))

            fwd_s = _time_s(fwd, device, iters)
            bwd_s = _time_s(fwd_bwd, device, iters)
            results.append({
                "layout": layout, "platform": device.type, "dp": dp, "sp": sp,
                "batch": batch, "heads": heads, "kv_heads": kv_heads,
                "head_dim": head_dim, "seq": seq,
                "fwd_ms": round(fwd_s * 1e3, 3),
                "fwd_bwd_ms": round(bwd_s * 1e3, 3),
            })
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return results


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="bench_ring")
    parser.add_argument("--sp", type=int, default=4,
                        help="ring ranks (one process each)")
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--heads", type=int, default=8)
    parser.add_argument("--kv-heads", type=int, default=4)
    parser.add_argument("--head-dim", type=int, default=128)
    parser.add_argument("--seq", type=int, nargs="+", default=[1024, 2048, 4096])
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument(
        "--platform", choices=PLATFORMS, default="cuda",
        help="the card (default; raises when there is none; ranks share "
        "it over gloo when they outnumber the cards) or the host cpu",
    )
    return parser


def _rank_process(argv: list[str], env: dict, results) -> None:
    """A spawned rank: :func:`_run_rank` with the launcher's environment; rank
    0 puts its rows on ``results``."""
    os.environ.update(env)
    sys.exit(_run_rank(build_parser().parse_args(argv), results))


def _run_rank(args, results) -> int:
    import torch.distributed as dist

    from tpumon.workload_torch.parallel import mesh as mesh_mod

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    device = mesh_mod.rank_device(args.platform, rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(mesh_mod.backend_for(world, device),
                            init_method="env://", rank=rank, world_size=world)
    try:
        mesh = mesh_mod.make_mesh(world // args.sp, 1, args.sp, device=device)
        rows = bench(mesh, batch=args.batch, heads=args.heads,
                     kv_heads=args.kv_heads, head_dim=args.head_dim,
                     seqs=tuple(args.seq), iters=args.iters)
        if rank == 0:
            results.put((rank, rows))
    finally:
        dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.iters < 1:
        parser.error("--iters must be >= 1")
    try:
        _validate(args.sp, args.sp, args.batch, tuple(args.seq))
    except ValueError as exc:
        parser.error(str(exc))
    from tpumon.workload_torch.parallel import launch

    device = resolve_device(args.platform)  # raises when there is no card
    if device.type == "cuda":
        from tpumon.workload_torch.ops import _build

        _build.build()  # once, before the ranks start
    rc, reports = launch.launch(_rank_process, argv, args.sp)
    for row in reports.get(0, []):
        print(json.dumps(row), flush=True)
    return rc


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    sys.exit(main())
