"""Flash-vs-plain attention benchmark for the port.

The counterpart of ``tpumon/workload/bench_attention.py``: it times the
flash kernels (``ops.flash_attention``) against the plain attention path
of ``models.llama`` (``xla``: K/V heads repeated, f32 masked softmax) and
prints one JSON line per (impl, seq) with the forward and the
forward+backward times, in the reference's row shape. An impl that
cannot run at a size gives a row with ``error`` (and ``oom``) instead.

On the card each time is the median of ``--iters`` calls, each between
two CUDA events, after one warm-up call; ``inner`` is always 1 (the
reference chained calls inside one dispatch to hide a remote transport's
round trip, which a local card does not have). ``--platform cpu`` times
the plain versions on the host's clock: a check of the rows, not a
device number.

The Hopper kernels fix their tiles at compile time, so the reference's
``--sweep-blocks``, ``--block-q`` and ``--block-k`` fail here.

Run:  python -m tpumon.workload_torch.bench_attention --seq 1024 4096
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

from tpumon.workload_torch.models.llama import causal_mask, plain_attention
from tpumon.workload_torch.ops.flash_attention import flash_attention
from tpumon.workload_torch.platform import PLATFORMS, resolve_device


def xla_attention(q, k, v):
    """The plain attention path of ``models.llama`` (the reference bench's
    ``xla`` impl), causal: q [B,S,H,D], k/v [B,S,KV,D] → [B,S,H,D]."""
    return plain_attention(q, k, v, causal_mask(q.shape[1], q.device))


IMPLS = {"xla": xla_attention, "flash": flash_attention}  # both causal


def _time_s(fn, device: torch.device, iters: int) -> float:
    """Median seconds of one call of ``fn`` over ``iters`` calls, after
    one warm-up call."""
    fn()
    samples = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end) / 1e3)
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            samples.append(time.perf_counter() - t0)
    return statistics.median(samples)


def _is_oom(exc: BaseException) -> bool:
    return isinstance(exc, torch.cuda.OutOfMemoryError) or (
        "out of memory" in str(exc).lower()
    )


def _timed_row(base: dict, impl, q, k, v, *, device, iters, attn_flops,
               out) -> dict:
    """Time one impl's forward, then its forward+backward, into a row. An
    impl that fails gives an ``error`` row and keeps a forward time
    already measured (the backward needs more memory: that is the shape
    of an out-of-memory boundary)."""
    row = dict(base)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

    def fwd():
        with torch.no_grad():
            impl(q, k, v)

    def fwd_bwd():
        loss = impl(qg, kg, vg).float().sum()
        torch.autograd.grad(loss, (qg, kg, vg))

    try:
        fwd_s = _time_s(fwd, device, iters)
        row.update(fwd_ms=fwd_s * 1e3, fwd_tflops=attn_flops / fwd_s / 1e12)
        row.update(fwd_bwd_ms=_time_s(fwd_bwd, device, iters) * 1e3)
    except (RuntimeError, ValueError, TypeError) as exc:
        row.update(error=str(exc).strip().split("\n")[0][:200], oom=_is_oom(exc))
    print(json.dumps(row), file=out, flush=True)
    return row


def bench(
    batch: int = 4,
    heads: int = 8,
    kv_heads: int = 4,
    head_dim: int = 128,
    seqs: tuple[int, ...] = (512, 1024, 2048),
    iters: int = 10,
    platform: str = "cuda",
    out=None,
) -> list[dict]:
    """One row per (impl, seq), printed to ``out`` (default: standard
    output) as it is measured, and returned. Inputs are bf16 normals
    from a generator seeded with 0 on the device; the FLOPs count is the
    reference's (scores + probs·V at the full S², forward only)."""
    out = sys.stdout if out is None else out
    device = resolve_device(platform)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    gen = torch.Generator(device=device).manual_seed(0)
    results = []
    for seq in seqs:
        def randn(*shape):
            return torch.randn(
                shape, generator=gen, device=device, dtype=torch.float32
            ).to(torch.bfloat16)

        q = randn(batch, seq, heads, head_dim)
        k, v = randn(batch, seq, kv_heads, head_dim), randn(batch, seq, kv_heads, head_dim)
        attn_flops = 2 * 2 * batch * seq * seq * heads * head_dim
        for name, impl in IMPLS.items():
            base = {
                "impl": name, "platform": device.type, "device_kind": kind,
                "batch": batch, "heads": heads, "kv_heads": kv_heads,
                "head_dim": head_dim, "seq": seq, "inner": 1,
            }
            results.append(_timed_row(
                base, impl, q, k, v, device=device, iters=iters,
                attn_flops=attn_flops, out=out,
            ))
            if device.type == "cuda":
                torch.cuda.empty_cache()
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="bench_attention")
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--heads", type=int, default=8)
    parser.add_argument("--kv-heads", type=int, default=4)
    parser.add_argument("--head-dim", type=int, default=128)
    parser.add_argument("--seq", type=int, nargs="+", default=[512, 1024, 2048])
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument(
        "--platform", choices=PLATFORMS, default="cuda",
        help="the card (default; raises when there is none) or the host cpu",
    )
    # The reference's tiling flags, refused below rather than ignored.
    for flag in ("--sweep-blocks", "--block-q", "--block-k"):
        parser.add_argument(flag, nargs="?", const=True, default=None,
                            help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    for flag in ("sweep_blocks", "block_q", "block_k"):
        if getattr(args, flag) is not None:
            parser.error(
                f"--{flag.replace('_', '-')}: the Hopper kernels fix their "
                "tiles at compile time (ops/flash_attention.py); an H100 "
                "tile chooser is kernel work (ROADMAP.md §2)"
            )
    if args.iters < 1:
        parser.error("--iters must be >= 1")
    bench(
        batch=args.batch, heads=args.heads, kv_heads=args.kv_heads,
        head_dim=args.head_dim, seqs=tuple(args.seq), iters=args.iters,
        platform=args.platform,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
