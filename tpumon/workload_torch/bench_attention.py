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

``--block-q``/``--block-k`` request the flash tiles of all three kernels
(``ops.flash_attention.pick_block``; default: the H100 table,
``default_blocks``). Flash rows carry the reference's ``block_q`` and
``block_k``, the tiles the forward ran, and ``effective_<kernel>``, the
tiles each kernel ran (``effective_blocks``). ``--sweep-blocks`` is the
reference's tiling sweep over the compiled tiles (:func:`sweep_blocks`).

Run:  python -m tpumon.workload_torch.bench_attention --seq 1024 4096
      python -m tpumon.workload_torch.bench_attention --sweep-blocks --seq 4096
"""

from __future__ import annotations

import argparse
import functools
import json
import statistics
import sys
import time

import torch

from tpumon.workload_torch.models.llama import causal_mask, plain_attention
from tpumon.workload_torch.ops.flash_attention import (
    TILES,
    effective_blocks,
    flash_attention,
)
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


def _setup(batch, heads, kv_heads, head_dim, platform):
    """(device, kind, inputs(seq) → (q, k, v, attn_flops)): bf16 normals
    from a generator seeded with 0 on the device; the FLOPs count is the
    reference's (scores + probs·V at the full S², forward only)."""
    device = resolve_device(platform)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    gen = torch.Generator(device=device).manual_seed(0)

    def inputs(seq):
        def randn(*shape):
            return torch.randn(
                shape, generator=gen, device=device, dtype=torch.float32
            ).to(torch.bfloat16)

        q = randn(batch, seq, heads, head_dim)
        k, v = randn(batch, seq, kv_heads, head_dim), randn(batch, seq, kv_heads, head_dim)
        return q, k, v, 2 * 2 * batch * seq * seq * heads * head_dim

    return device, kind, inputs


def _tile_keys(batch, heads, kv_heads, head_dim, seq, block_q, block_k) -> dict:
    """A flash row's tiles: the reference's ``block_q``/``block_k`` (the
    forward kernel's effective tiles) and ``effective_<kernel>`` for each
    kernel (:func:`ops.flash_attention.effective_blocks`, causal)."""
    eff = effective_blocks(batch, heads, kv_heads, seq, seq, head_dim, True,
                           block_q, block_k)
    return {"block_q": eff["flash_fwd"][0], "block_k": eff["flash_fwd"][1],
            **{f"effective_{name}": list(tiles) for name, tiles in eff.items()}}


def bench(
    batch: int = 4,
    heads: int = 8,
    kv_heads: int = 4,
    head_dim: int = 128,
    seqs: tuple[int, ...] = (512, 1024, 2048),
    iters: int = 10,
    platform: str = "cuda",
    block_q: int | None = None,
    block_k: int | None = None,
    out=None,
) -> list[dict]:
    """One row per (impl, seq), printed to ``out`` (default: standard
    output) as it is measured, and returned; the flash rows run at
    ``block_q``/``block_k`` (None: the H100 table) and record the tiles
    each kernel ran."""
    out = sys.stdout if out is None else out
    device, kind, inputs = _setup(batch, heads, kv_heads, head_dim, platform)
    impls = dict(IMPLS, flash=functools.partial(
        flash_attention, block_q=block_q, block_k=block_k))
    results = []
    for seq in seqs:
        q, k, v, attn_flops = inputs(seq)
        for name, impl in impls.items():
            base = {
                "impl": name, "platform": device.type, "device_kind": kind,
                "batch": batch, "heads": heads, "kv_heads": kv_heads,
                "head_dim": head_dim, "seq": seq, "inner": 1,
            }
            if name == "flash":
                base.update(_tile_keys(batch, heads, kv_heads, head_dim, seq,
                                       block_q, block_k))
            results.append(_timed_row(
                base, impl, q, k, v, device=device, iters=iters,
                attn_flops=attn_flops, out=out,
            ))
            if device.type == "cuda":
                torch.cuda.empty_cache()
    return results


def sweep_blocks(
    batch: int = 4,
    heads: int = 8,
    kv_heads: int = 4,
    head_dim: int = 128,
    seqs: tuple[int, ...] = (4096,),
    iters: int = 3,
    blocks: tuple[int, ...] = TILES,
    platform: str = "cuda",
    out=None,
) -> list[dict]:
    """The flash tiling sweep: one row per (seq, block_q, block_k) over
    ``blocks``², forward and forward+backward timed, as the reference's
    ``sweep_blocks``; a tiling that fails gives an error row. Rows carry
    the requested ``block_q``/``block_k``, the forward's
    ``effective_block_q``/``effective_block_k`` and each kernel's
    ``effective_<kernel>``; a request whose effective tiles (all three
    kernels') were already timed is skipped, as in the reference."""
    out = sys.stdout if out is None else out
    device, kind, inputs = _setup(batch, heads, kv_heads, head_dim, platform)
    results = []
    for seq in seqs:
        q, k, v, attn_flops = inputs(seq)
        seen: set = set()
        for bq in blocks:
            for bk in blocks:
                tiles = _tile_keys(batch, heads, kv_heads, head_dim, seq, bq, bk)
                eff = tuple(tuple(tiles[f"effective_{name}"])
                            for name in ("flash_fwd", "flash_dq", "flash_dkv"))
                if eff in seen:
                    continue
                seen.add(eff)
                base = {
                    "impl": "flash", "platform": device.type,
                    "device_kind": kind, "batch": batch, "heads": heads,
                    "kv_heads": kv_heads, "head_dim": head_dim, "seq": seq,
                    "block_q": bq, "block_k": bk,
                    "effective_block_q": tiles["block_q"],
                    "effective_block_k": tiles["block_k"],
                    **{key: value for key, value in tiles.items()
                       if key.startswith("effective_")},
                    "inner": 1,
                }
                impl = functools.partial(flash_attention, block_q=bq, block_k=bk)
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
    parser.add_argument(
        "--block-q", type=int, default=None,
        help="flash q-block rows, all three kernels (default: the H100 "
        "table, ops.flash_attention.default_blocks; rows record the tiles "
        "each kernel ran)",
    )
    parser.add_argument(
        "--block-k", type=int, default=None,
        help="flash k-block rows, all three kernels (default: the H100 table)",
    )
    parser.add_argument(
        "--sweep-blocks", action="store_true",
        help=f"tiling sweep mode: time the flash kernels at every "
        f"(block_q, block_k) in {set(TILES)}^2 per --seq instead of the "
        "flash-vs-plain comparison",
    )
    args = parser.parse_args(argv)
    if args.iters < 1:
        parser.error("--iters must be >= 1")
    for flag in ("block_q", "block_k"):
        if getattr(args, flag) is not None and getattr(args, flag) < 1:
            parser.error(f"--{flag.replace('_', '-')} must be >= 1")
    shape = dict(batch=args.batch, heads=args.heads, kv_heads=args.kv_heads,
                 head_dim=args.head_dim, seqs=tuple(args.seq),
                 iters=args.iters, platform=args.platform)
    if args.sweep_blocks:
        sweep_blocks(**shape)
    else:
        bench(**shape, block_q=args.block_q, block_k=args.block_k)
    return 0


if __name__ == "__main__":
    sys.exit(main())
