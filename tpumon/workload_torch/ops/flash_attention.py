"""Flash attention for the port: three hand-written Hopper kernels.

The counterpart of ``tpumon/workload/ops/flash_attention.py``, with the
same public API: :func:`flash_attention`, :func:`flash_attention_with_lse`
and :func:`make_flash_attn`, [B, S, H, D] in and out, lse [B, H, S] f32,
grouped-query K/V [B, Sk, KV, D] shared by index math (q-head h reads
kv-head (h·KV)//H), and ``causal=False`` with Sk ≠ S for blockwise
composition.

The five Pallas kernels of the reference become three CUDA kernels
(``ops/csrc/``), because on Hopper K/V tiles always stream through shared
memory and the TPU's resident/streamed split has no reason to exist:

- ``flash_fwd``  ← ``_fwd_kernel_resident`` + ``_fwd_kernel_streamed``
- ``flash_dq``   ← ``_dq_kernel_resident`` + ``_dq_kernel_streamed``
- ``flash_dkv``  ← ``_dkv_kernel`` (``flash_dkv.cu``; at q·k width 192,
  ``flash_dkv_mla.cu``)

Each wrapper checks its inputs and then, for a tensor on the card,
launches its kernel or raises; it counts the launch in :data:`launches`.
For tensors on the CPU it computes the same function with its plain
PyTorch version (``*_reference``, dense f32 math), which is also what the
kernels are held against on the card. The kernels are compiled for
head dims 64, 128 and 192; a narrower head dim that is a multiple of 8
(the tiny preset's 32) runs on the next of them with zero columns, still
one launch a call (:func:`kernel_width`, :func:`_on_width`). V may be
narrower than q and k (DeepSeek-V2's latent attention: q·k width 192, v
width 128): each kernel runs v at the width :data:`WIDTHS` gives for its
compiled q·k width, v and dO padded up to it and O and dV sliced back,
which is exact. At 192 flash_fwd and flash_dq run v at 192 and flash_dkv
at 128, in one launch at DeepSeek-V2's true widths; a wider v is refused
there. The softmax scale defaults to
1/√D of the q·k width; ``scale`` sets another (YaRN's mscale² / √D) on
the functions, and :func:`softmax_scale` is the one way a model sets it
for an ``attn_impl``, whose call takes q, k and v only. The Δ pre-pass
(rowsum(dO·O) minus the lse cotangent) is plain torch, as XLA fused it
outside Pallas.

Tiles: ``block_q``/``block_k`` keep the reference's meaning (q rows and
k rows of a tile) on every entry point. Each kernel is compiled for tiles
of 64 and 128 rows (:data:`TILES`; ``flash_fwd``/``flash_dq``: block_q q
rows a CTA, block_k k rows a ring stage; ``flash_dkv``: block_k k rows a
CTA, q rows a stage capped by its registers, as the reference's dK/dV
grid). A request is clamped to a compiled tile (:func:`pick_block`) and
to each kernel's compiled set (:data:`COMPILED`); ``None`` takes the
H100 table (:func:`default_blocks`); :func:`effective_blocks` says what
each kernel runs, and :data:`tile_launches` counts launches by tiles.
The plain versions check a request and compute the same dense math.

The TPU-only knobs of the reference (``interpret``, ``resident``) are not
ported: on Hopper K/V tiles always stream, and the kernels have no
interpret mode.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

# Finite stand-in for -inf: masked logits underflow to exp(x - m) == 0
# without ever forming inf - inf (the reference's constant).
NEG_BIG = -1e30

#: Head dims the CUDA kernels are compiled for (small/medium: 64/128,
#: llama3_8b: 128, DeepSeek-V2's q·k width: 192). A smaller head dim that
#: is a multiple of 8 (tiny's 32) runs on the next of them with zero
#: columns (:func:`kernel_width`). The plain versions take any.
HEAD_DIMS = (64, 128, 192)

#: Tile rows the kernels are compiled for: the values a ``block_q`` or
#: ``block_k`` request is clamped to (:func:`pick_block`).
TILES = (64, 128)

#: kernel -> kernel head dim -> the (block_q, block_k) pairs its C entry
#: takes (``ops/csrc/*.cu`` dispatch the same). flash_dq leaves out
#: 128 x 128 (ptxas spilled it at both head dims; ``csrc/flash_dq.cu``),
#: and at D = 192 takes 64 x 64 only (its registers and shared memory).
#: flash_fwd at D = 192 leaves out 128 x 128 (over the shared memory).
#: flash_dkv takes both block_q and streams each at its q-row cap
#: (:data:`WIDTHS`); at D = 192 its k tile is 64 rows.
_ALL_PAIRS = tuple((bq, bk) for bq in TILES for bk in TILES)
_NOT_128x128 = tuple(p for p in _ALL_PAIRS if p != (128, 128))
COMPILED: dict[str, dict[int, tuple[tuple[int, int], ...]]] = {
    "flash_fwd": {64: _ALL_PAIRS, 128: _ALL_PAIRS, 192: _NOT_128x128},
    "flash_dq": {64: _NOT_128x128, 128: _NOT_128x128, 192: ((64, 64),)},
    "flash_dkv": {64: _ALL_PAIRS, 128: _ALL_PAIRS,
                  192: tuple(p for p in _ALL_PAIRS if p[1] == 64)},
}


class Width(NamedTuple):
    """A kernel at one compiled q·k width: v's width (v and dO padded up
    to it, a wider one refused), its C entry, and its q rows a stage
    whatever block_q asks (its registers' cap; 128 caps nothing)."""
    v: int
    entry: str
    q_rows: int


#: kernel -> compiled q·k width -> :class:`Width`. flash_dkv runs v = D
#: at 64 and 128 (``csrc/flash_dkv.cu``; at 128 the dK launch caps q rows
#: at 32) and v = 128 at 192 in one launch (``csrc/flash_dkv_mla.cu``:
#: DeepSeek-V2's true widths); the others run v as wide as q·k.
WIDTHS: dict[str, dict[int, Width]] = {
    "flash_fwd": {D: Width(D, "flash_fwd", 128) for D in HEAD_DIMS},
    "flash_dq": {D: Width(D, "flash_dq", 128) for D in HEAD_DIMS},
    "flash_dkv": {64: Width(64, "flash_dkv", 64), 128: Width(128, "flash_dkv", 32),
                  192: Width(128, "flash_dkv_mla", 64)},
}

#: SMs of an H100: a grid below one wave of them leaves SMs idle.
H100_SMS = 132

#: Kernel launches since the last :func:`reset_launches`, one count per
#: wrapper, raised only where the wrapper launches its kernel.
launches: dict[str, int] = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}

#: The same launches by tiles, ``"<kernel>[<block_q>x<block_k>]"`` with
#: the tiles the kernel ran (:func:`effective_blocks`), and
#: ``"<kernel>[<block_q>x<block_k>,v<Dv>]"`` where :data:`WIDTHS` runs v
#: narrower than q·k.
tile_launches: dict[str, int] = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
    tile_launches.clear()


# ---------------------------------------------------------------------------
# Tile selection
# ---------------------------------------------------------------------------


def pick_block(requested: int) -> int:
    """The compiled tile a ``block_q``/``block_k`` request runs at: the
    largest of :data:`TILES` not above it, and at least the smallest
    (256 → 128, 100 → 64, 32 → 64). Raises below 1.

    The reference's ``_pick_block`` clamps to a divisor of the length,
    because a Pallas block must tile the array; the Hopper kernels mask
    their ragged edges themselves, so here only the compiled set bounds a
    tile."""
    if requested < 1:
        raise ValueError(f"flash attention: block size {requested} is below 1")
    return max((t for t in TILES if t <= requested), default=TILES[0])


def _grid(rows: int, heads: int, B: int, tile: int) -> int:
    return B * heads * -(-rows // tile)


def default_blocks(B: int, H: int, KV: int, S: int, Sk: int, D: int,
                   causal: bool = True) -> dict[str, tuple[int, int]]:
    """The H100 table: kernel -> (block_q, block_k) for a shape.

    A kernel's CTA tile is 128 rows unless its grid at 128 rows falls
    below one wave of :data:`H100_SMS` CTAs, then 64 (flash_fwd and
    flash_dq: B·H·⌈S/128⌉ q-blocks; flash_dkv: B·KV·⌈Sk/128⌉ k-blocks).
    The streamed tile: flash_fwd's k tile equals its q tile (64 × 128 was
    never the fastest pair), flash_dq's stays 64 k rows (128 × 128 is not
    compiled, 64 × 128 never clearly faster), flash_dkv's q rows are its
    register cap. From the tile table of ``chip_smoke.py``'s kernels
    phase on an H100 80GB HBM3 at 700 W (PERF.md, "Tile table"): 64-row
    dK/dV tiles cut flash_dkv at ``tp2`` (64 CTAs at 128 rows) from 0.916
    to 0.593 ms and at the ring's ``zz`` from 0.252 to 0.182, while at
    ``main`` (256 CTAs) 128 rows stay faster (0.990 against 1.191). ``D``
    and ``causal`` do not move the rule.
    """
    del D, causal
    q_tile = 128 if _grid(S, H, B, 128) >= H100_SMS else 64
    k_tile = 128 if _grid(Sk, KV, B, 128) >= H100_SMS else 64
    return {"flash_fwd": (q_tile, q_tile), "flash_dq": (q_tile, 64),
            "flash_dkv": (64, k_tile)}


def _requested(name: str, B, H, KV, S, Sk, D, causal, block_q, block_k):
    """(block_q, block_k) that kernel ``name`` is asked for: each request
    through :func:`pick_block`, the default table where it is None, then
    clamped to the largest pair the kernel is compiled for at its width."""
    width = kernel_width(D)
    default = default_blocks(B, H, KV, S, Sk, width, causal)[name]
    bq = default[0] if block_q is None else pick_block(block_q)
    bk = default[1] if block_k is None else pick_block(block_k)
    pairs = COMPILED[name][width]
    bq = max((p for p, _ in pairs if p <= bq), default=min(p for p, _ in pairs))
    bk = max((p for q_, p in pairs if q_ == bq and p <= bk),
             default=min(p for q_, p in pairs if q_ == bq))
    return bq, bk


def effective_blocks(B: int, H: int, KV: int, S: int, Sk: int, D: int,
                     causal: bool = True, block_q: int | None = None,
                     block_k: int | None = None) -> dict[str, tuple[int, int]]:
    """kernel -> the (block_q, block_k) it runs on the card for this shape
    and request (``D`` the caller's head dim, padded as the wrappers pad
    it): :func:`default_blocks` where a request is None, else
    :func:`pick_block` of it, clamped to the kernel's compiled pairs and
    to its q-row cap (:data:`WIDTHS`)."""
    width = kernel_width(D)
    out = {}
    for name in launches:
        bq, bk = _requested(name, B, H, KV, S, Sk, D, causal, block_q, block_k)
        out[name] = (min(bq, WIDTHS[name][width].q_rows), bk)
    return out


def _check_request(block_q, block_k) -> None:
    """What the plain versions do with a tile request: check it."""
    for block in (block_q, block_k):
        if block is not None:
            pick_block(block)


# ---------------------------------------------------------------------------
# Plain versions (dense f32; the CPU path and the on-card yardstick)
# ---------------------------------------------------------------------------


def _expand(t: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, Sk, KV, D] → f32 [B, Sk, H, D]: q-head h reads kv-head (h·KV)//H."""
    return t.float().repeat_interleave(heads // t.shape[2], dim=2)


def _mask(s: torch.Tensor, causal: bool) -> torch.Tensor:
    if not causal:
        return s
    S, Sk = s.shape[-2], s.shape[-1]
    live = torch.ones(S, Sk, dtype=torch.bool, device=s.device).tril()
    return s.masked_fill(~live, NEG_BIG)


def _scale(q, scale: float | None) -> float:
    return 1.0 / math.sqrt(q.shape[3]) if scale is None else scale


def flash_fwd_reference(q, k, v, causal: bool = True, scale: float | None = None):
    """Plain version of ``flash_fwd``: (O [B,S,H,D] in q's dtype,
    lse [B,H,S] f32). p is cast to v's dtype before the second product,
    as the kernels do. ``scale`` defaults to 1/√D."""
    H = q.shape[2]
    s = torch.einsum(
        "bqhd,bkhd->bhqk", q.float() * _scale(q, scale), _expand(k, H)
    )
    s = _mask(s, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), _expand(v, H))
    out = acc / denom.permute(0, 2, 1, 3)
    return out.to(q.dtype), (m + torch.log(denom)).squeeze(-1)


def _p_ds(q, k, v, do, lse, delta, causal, scale):
    """P and scale·dS, dense f32 [B,H,S,Sk], from the forward's lse."""
    H, scale = q.shape[2], _scale(q, scale)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), _expand(k, H)) * scale
    p = torch.exp(_mask(s, causal) - lse.float()[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), _expand(v, H))
    return p, p * (dp - delta.float()[..., None]) * scale


def flash_dq_reference(q, k, v, do, lse, delta, causal: bool = True,
                       scale: float | None = None):
    """Plain version of ``flash_dq``: dQ [B,S,H,D] in q's dtype."""
    _, ds = _p_ds(q, k, v, do, lse, delta, causal, scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, _expand(k, q.shape[2]))
    return dq.to(q.dtype)


def flash_dkv_reference(q, k, v, do, lse, delta, causal: bool = True,
                        scale: float | None = None):
    """Plain version of ``flash_dkv``: (dK [B,Sk,KV,D], dV [B,Sk,KV,Dv])
    in k's and v's dtypes, summed over each kv-head's group of q-heads."""
    B, Sk, KV, D = k.shape
    group = q.shape[2] // KV
    p, ds = _p_ds(q, k, v, do, lse, delta, causal, scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dk = dk.reshape(B, Sk, KV, group, D).sum(dim=3)
    dv = dv.reshape(B, Sk, KV, group, v.shape[3]).sum(dim=3)
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_shapes(q, k, v, causal: bool) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes [B, S, H, D] tensors")
    B, S, H, D = q.shape
    if (k.shape[:3] != v.shape[:3] or k.shape[0] != B or k.shape[3] != D
            or not 0 < v.shape[3] <= D):
        raise ValueError(
            f"k must be [B, Sk, KV, D] and v [B, Sk, KV, Dv ≤ D] matching q "
            f"{tuple(q.shape)}; got k {tuple(k.shape)}, v {tuple(v.shape)}"
        )
    KV, Sk = k.shape[2], k.shape[1]
    if H % KV:
        raise ValueError(f"q heads ({H}) must be a multiple of kv heads ({KV})")
    if causal and Sk != S:
        raise ValueError(
            f"causal flash attention needs matching seq lengths (q {S}, "
            f"k {Sk}); rectangular attention must be causal=False"
        )


def _on_cpu(*tensors) -> bool:
    devices = {t.device.type for t in tensors}
    if devices == {"cpu"}:
        return True
    if devices != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(
            f"flash attention inputs must share one CPU or CUDA device; "
            f"got {sorted(str(t.device) for t in tensors)}"
        )
    return False


def _check_kernel_inputs(named: dict[str, torch.Tensor], kernel: str) -> None:
    """What CUDA kernel ``kernel`` takes: contiguous, 16-byte aligned
    tensors, bf16 for q/k/v/dO, f32 for lse/delta, head_dim in HEAD_DIMS
    (after :func:`_on_width` padded a narrower one), v and dO at the
    width :data:`WIDTHS` gives there."""
    for name, t in named.items():
        want = torch.float32 if name in ("lse", "delta") else torch.bfloat16
        if t.dtype != want:
            raise TypeError(f"flash kernel: {name} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"flash kernel: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash kernel: {name} must be 16-byte aligned")
    D = named["q"].shape[3]
    if D not in HEAD_DIMS:
        raise ValueError(
            f"flash kernel: head_dim {D} not compiled (takes {HEAD_DIMS})"
        )
    v_width = WIDTHS[kernel][D].v
    widths = sorted({named[n].shape[3] for n in ("v", "do") if n in named})
    if widths != [v_width]:
        raise ValueError(f"flash kernel: {kernel} at q·k width {D} takes v and "
                         f"dO {v_width} wide (WIDTHS; the wrappers pad a "
                         f"narrower v), got {widths}")


#: The C entries' code for a tile pair they are not compiled for
#: (``hopper::TILE_ERROR``).
TILE_ERROR = 20000


def _launch(name: str, D: int, device: torch.device, effective: tuple[int, int],
            *args) -> None:
    """Launch kernel ``name`` at compiled q·k width ``D`` through the C
    entry :data:`WIDTHS` gives there, with the entry's ``args``, and count
    it under the ``effective`` tiles it runs (and v's width where that is
    not ``D``)."""
    from tpumon.workload_torch.ops._build import load

    width = WIDTHS[name][D]
    fn = getattr(load(width.entry), width.entry)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err == TILE_ERROR:
        raise RuntimeError(f"{name}: the requested tile pair is not compiled")
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: error {err} (a cudaError_t, or 10000 + "
            "the CUresult of a refused TMA tensor map)"
        )
    launches[name] += 1
    key = f"{name}[{effective[0]}x{effective[1]}"
    key += "]" if width.v == D else f",v{width.v}]"
    tile_launches[key] = tile_launches.get(key, 0) + 1


def kernel_width(D: int) -> int:
    """The compiled head dim a call of head dim ``D`` runs on: ``D``
    itself when it is one of :data:`HEAD_DIMS`, else the next of them
    above it for a ``D`` that is a multiple of 8 (:func:`_on_width` pads
    the columns). Raises for any other ``D``."""
    if D in HEAD_DIMS:
        return D
    if 0 < D < HEAD_DIMS[-1] and D % 8 == 0:
        return next(width for width in HEAD_DIMS if width > D)
    raise ValueError(
        f"flash kernel: head_dim {D} not compiled (takes {HEAD_DIMS}, and "
        f"multiples of 8 below {HEAD_DIMS[-1]} padded to the next of them)"
    )


def _pad(t: torch.Tensor, width: int) -> torch.Tensor:
    return t if t.shape[3] == width else F.pad(t, (0, width - t.shape[3]))


def _on_width(name, run, q, k, v, *rest, causal: bool,
              scale: float | None = None):
    """``run(q, k, v, *rest, causal, scale)`` at kernel ``name``'s widths:
    q and k padded with zero columns to the compiled q·k width
    (:func:`kernel_width` of D), v and dO (the first of ``rest``, in the
    backward) to the v width :data:`WIDTHS` gives there, ``scale`` 1/√D of
    the true D unless given, and each [B, S, heads, width] output sliced
    back to its own width: O and dV to v's width Dv, dQ and dK to D. The
    padding is exact: zero columns add nothing to QKᵀ or dO·Vᵀ, so P, lse
    and Δ are unchanged, and the padded columns of O = P·V, dQ = dS·K,
    dK = dSᵀ·Q and dV = Pᵀ·dO are zeros that the slice drops. A v wider
    than the table's is refused."""
    D, Dv = q.shape[3], v.shape[3]
    width = kernel_width(D)
    v_width = WIDTHS[name][width].v
    if Dv > v_width:
        raise ValueError(f"flash kernel: {name} at q·k width {width} runs v up "
                         f"to {v_width} wide (WIDTHS), not {Dv}")
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    q, k, v = _pad(q, width), _pad(k, width), _pad(v, v_width)
    rest = (_pad(rest[0], v_width), *rest[1:]) if rest else rest
    out = run(q, k, v, *rest, causal, scale)
    if not rest:
        widths = (Dv, None)  # O, lse
    elif isinstance(out, tuple):
        widths = (D, Dv)  # dK, dV
    else:
        widths = (D,)  # dQ

    def cut(t, w):
        return t if w is None or t.shape[3] == w else t[..., :w].contiguous()

    if isinstance(out, tuple):
        return tuple(map(cut, out, widths))
    return cut(out, widths[0])


def _dims(q, k):
    B, S, H, D = q.shape
    return B, H, k.shape[2], S, k.shape[1], D


def _tiles(name, q, k, causal, block_q, block_k):
    """(requested, effective) tiles of kernel ``name`` for this call."""
    return _tiles_of(name, *_dims(q, k), bool(causal), block_q, block_k)


@functools.lru_cache(maxsize=1024)
def _tiles_of(name, B, H, KV, S, Sk, D, causal, block_q, block_k):
    """:func:`_tiles` by shape, cached: the choice is pure, and a launch
    at a small shape costs about as much as this Python."""
    dims = (B, H, KV, S, Sk, D, causal)
    tiles = _requested(name, *dims, block_q, block_k)
    return tiles, effective_blocks(*dims, block_q, block_k)[name]


def _fwd_kernel(q, k, v, causal, scale, *, block_q=None, block_k=None):
    _check_kernel_inputs({"q": q, "k": k, "v": v}, "flash_fwd")
    B, H, KV, S, Sk, D = _dims(q, k)
    tiles, eff = _tiles("flash_fwd", q, k, causal, block_q, block_k)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    _launch(
        "flash_fwd", D, q.device, eff, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), lse.data_ptr(), B, H, KV, S, Sk, D, *tiles, scale,
        int(causal),
    )
    return out, lse


def _dq_kernel(q, k, v, do, lse, delta, causal, scale, *, block_q=None,
               block_k=None):
    _check_kernel_inputs(
        {"q": q, "k": k, "v": v, "do": do, "lse": lse, "delta": delta}, "flash_dq"
    )
    B, H, KV, S, Sk, D = _dims(q, k)
    tiles, eff = _tiles("flash_dq", q, k, causal, block_q, block_k)
    dq = torch.empty_like(q)
    _launch(
        "flash_dq", D, q.device, eff, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        B, H, KV, S, Sk, D, *tiles, scale, int(causal),
    )
    return dq


def _dkv_kernel(q, k, v, do, lse, delta, causal, scale, *, block_q=None,
                block_k=None):
    """dK, dV from the C entry :data:`WIDTHS` gives at q's width, on v and
    dO at the width it runs."""
    _check_kernel_inputs(
        {"q": q, "k": k, "v": v, "do": do, "lse": lse, "delta": delta}, "flash_dkv"
    )
    B, H, KV, S, Sk, D = _dims(q, k)
    tiles, eff = _tiles("flash_dkv", q, k, causal, block_q, block_k)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("flash_dkv", D, q.device, eff, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, H, KV, S, Sk, D, v.shape[3],
            *tiles, scale, int(causal))
    return dk, dv


def flash_fwd(q, k, v, causal: bool = True, *, scale: float | None = None,
              block_q: int | None = None, block_k: int | None = None):
    """(O [B,S,H,Dv], lse [B,H,S] f32) — kernel ``flash_fwd`` on the card
    at the tiles of :func:`effective_blocks`, :func:`flash_fwd_reference`
    for CPU tensors. ``scale`` defaults to 1/√D."""
    _check_shapes(q, k, v, causal)
    _check_request(block_q, block_k)
    if _on_cpu(q, k, v):
        return flash_fwd_reference(q, k, v, causal, scale)
    run = functools.partial(_fwd_kernel, block_q=block_q, block_k=block_k)
    return _on_width("flash_fwd", run, q, k, v, causal=causal, scale=scale)


def flash_dq(q, k, v, do, lse, delta, causal: bool = True, *,
             scale: float | None = None, block_q: int | None = None,
             block_k: int | None = None):
    """dQ [B,S,H,D] — kernel ``flash_dq`` on the card at the tiles of
    :func:`effective_blocks`, :func:`flash_dq_reference` for CPU
    tensors."""
    _check_shapes(q, k, v, causal)
    _check_request(block_q, block_k)
    if _on_cpu(q, k, v, do, lse, delta):
        return flash_dq_reference(q, k, v, do, lse, delta, causal, scale)
    run = functools.partial(_dq_kernel, block_q=block_q, block_k=block_k)
    return _on_width("flash_dq", run, q, k, v, do, lse, delta, causal=causal,
                     scale=scale)


def flash_dkv(q, k, v, do, lse, delta, causal: bool = True, *,
              scale: float | None = None, block_q: int | None = None,
              block_k: int | None = None):
    """(dK [B,Sk,KV,D], dV [B,Sk,KV,Dv]) — kernel ``flash_dkv`` on the
    card at the tiles of :func:`effective_blocks` and the widths of
    :data:`WIDTHS`, :func:`flash_dkv_reference` for CPU tensors."""
    _check_shapes(q, k, v, causal)
    _check_request(block_q, block_k)
    if _on_cpu(q, k, v, do, lse, delta):
        return flash_dkv_reference(q, k, v, do, lse, delta, causal, scale)
    run = functools.partial(_dkv_kernel, block_q=block_q, block_k=block_k)
    return _on_width("flash_dkv", run, q, k, v, do, lse, delta, causal=causal,
                     scale=scale)


def flash_delta(out, g_out, g_lse=None):
    """Δ [B,H,S] f32 = rowsum(dO·O), minus the lse cotangent when the
    caller differentiates lse too: dS = P∘(dP − Δ) + g_lse·P =
    P∘(dP − (Δ − g_lse)), so the kernels never change."""
    delta = (g_out.float() * out.float()).sum(dim=-1).transpose(1, 2)
    if g_lse is not None:
        delta = delta - g_lse.float()
    return delta.contiguous()


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


class _FlashLse(torch.autograd.Function):
    """(O, lse) with the flash backward: Δ pre-pass, then dQ and dK/dV
    from their kernels, recomputing P from the saved lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k, scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        kw = {"scale": scale, "block_q": block_q, "block_k": block_k}
        out, lse = flash_fwd(q, k, v, causal, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.kw = causal, kw
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        g_out = g_out.contiguous()
        delta = flash_delta(out, g_out, g_lse)
        dq = flash_dq(q, k, v, g_out, lse, delta, ctx.causal, **ctx.kw)
        dk, dv = flash_dkv(q, k, v, g_out, lse, delta, ctx.causal, **ctx.kw)
        return dq, dk, dv, None, None, None, None


def flash_attention_with_lse(q, k, v, *, causal: bool = True,
                             scale: float | None = None,
                             block_q: int | None = None,
                             block_k: int | None = None):
    """Flash attention returning ``(out [B,S,H,Dv], lse [B,H,S] f32)``,
    q and k of width D, v of width Dv ≤ D, scores scaled by ``scale``
    (default 1/√D).

    Both outputs are differentiable: the lse cotangent folds into the
    backward's Δ (:func:`flash_delta`), so two partials over the same
    queries and different keys merge exactly (lse = logaddexp(lse_a,
    lse_b); out = out_a·e^{lse_a−lse} + out_b·e^{lse_b−lse}).
    ``block_q``/``block_k`` reach all three kernels, the backward's too,
    as the reference's custom VJP passes them (None: the H100 table,
    :func:`default_blocks`).
    """
    _check_shapes(q, k, v, causal)
    return _FlashLse.apply(q, k, v, causal, block_q, block_k, scale)


def flash_attention(q, k, v, *, causal: bool = True, scale: float | None = None,
                    block_q: int | None = None, block_k: int | None = None):
    """Flash attention over [B, S, H, D] tensors (model layout); K/V may
    carry fewer heads than Q (grouped-query, never materialized), and V
    fewer columns. ``scale``, ``block_q``/``block_k`` as in
    :func:`flash_attention_with_lse`."""
    out, _ = flash_attention_with_lse(q, k, v, causal=causal, scale=scale,
                                      block_q=block_q, block_k=block_k)
    return out


#: The scale :func:`softmax_scale` sets for the impls' calls.
_SCALE: contextvars.ContextVar = contextvars.ContextVar("flash_softmax_scale",
                                                        default=None)


@contextlib.contextmanager
def softmax_scale(scale: float):
    """Inside the block, an ``attn_impl`` of :func:`make_flash_attn`
    scales the scores by ``scale``; outside any, by 1/√D. This is the only
    way an impl learns a model's scale: its call takes q, k and v only
    (the benchmark's spans wrap it as such), so a model whose scale is not
    1/√D (DeepSeek-V2: YaRN's mscale² / √192) sets it around the call."""
    token = _SCALE.set(float(scale))
    try:
        yield
    finally:
        _SCALE.reset(token)


def make_flash_attn(*, causal: bool = True, block_q: int | None = None,
                    block_k: int | None = None):
    """``attn_impl`` factory for :meth:`models.llama.Llama.forward`; the
    tiles default to the H100 table (:func:`default_blocks`), the scale to
    :func:`softmax_scale`'s, else 1/√D."""

    def attn(q, k, v):
        return flash_attention(q, k, v, causal=causal, scale=_SCALE.get(),
                               block_q=block_q, block_k=block_k)

    return attn


__all__ = [
    "COMPILED",
    "HEAD_DIMS",
    "NEG_BIG",
    "TILES",
    "WIDTHS",
    "default_blocks",
    "effective_blocks",
    "flash_attention",
    "flash_attention_with_lse",
    "flash_delta",
    "flash_dkv",
    "flash_dkv_reference",
    "flash_dq",
    "flash_dq_reference",
    "flash_fwd",
    "flash_fwd_reference",
    "kernel_width",
    "launches",
    "make_flash_attn",
    "pick_block",
    "reset_launches",
    "softmax_scale",
    "tile_launches",
]
