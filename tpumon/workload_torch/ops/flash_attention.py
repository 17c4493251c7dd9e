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
- ``flash_dkv``  ← ``_dkv_kernel``

Each wrapper checks its inputs and then, for a tensor on the card,
launches its kernel or raises; it counts the launch in :data:`launches`.
For tensors on the CPU it computes the same function with its plain
PyTorch version (``*_reference``, dense f32 math), which is also what the
kernels are held against on the card. The Δ pre-pass (rowsum(dO·O) minus
the lse cotangent) is plain torch, as XLA fused it outside Pallas.

The TPU-only knobs of the reference (``interpret``, ``resident``,
``block_q``/``block_k`` and its tuned tile tables) are not ported: each
kernel fixes its own tiles for Hopper (``flash_fwd``: 128 q rows by 128
k rows; ``flash_dq``: 128 q rows by 64 k rows; ``flash_dkv``: 128 k rows
by 32 or 64 q rows), and its source says why.
"""

from __future__ import annotations

import math

import torch

# Finite stand-in for -inf: masked logits underflow to exp(x - m) == 0
# without ever forming inf - inf (the reference's constant).
NEG_BIG = -1e30

#: Head dims the CUDA kernels are compiled for (small/medium: 64/128,
#: llama3_8b: 128). The plain versions take any.
HEAD_DIMS = (64, 128)

#: Kernel launches since the last :func:`reset_launches`, one count per
#: wrapper, raised only where the wrapper launches its kernel.
launches: dict[str, int] = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


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


def flash_fwd_reference(q, k, v, causal: bool = True):
    """Plain version of ``flash_fwd``: (O [B,S,H,D] in q's dtype,
    lse [B,H,S] f32). p is cast to v's dtype before the second product,
    as the kernels do."""
    H, D = q.shape[2], q.shape[3]
    s = torch.einsum(
        "bqhd,bkhd->bhqk", q.float() * (1.0 / math.sqrt(D)), _expand(k, H)
    )
    s = _mask(s, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), _expand(v, H))
    out = acc / denom.permute(0, 2, 1, 3)
    return out.to(q.dtype), (m + torch.log(denom)).squeeze(-1)


def _p_ds(q, k, v, do, lse, delta, causal):
    """P and scale·dS, dense f32 [B,H,S,Sk], from the forward's lse."""
    H, D = q.shape[2], q.shape[3]
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), _expand(k, H)) * scale
    p = torch.exp(_mask(s, causal) - lse.float()[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), _expand(v, H))
    return p, p * (dp - delta.float()[..., None]) * scale


def flash_dq_reference(q, k, v, do, lse, delta, causal: bool = True):
    """Plain version of ``flash_dq``: dQ [B,S,H,D] in q's dtype."""
    _, ds = _p_ds(q, k, v, do, lse, delta, causal)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, _expand(k, q.shape[2]))
    return dq.to(q.dtype)


def flash_dkv_reference(q, k, v, do, lse, delta, causal: bool = True):
    """Plain version of ``flash_dkv``: (dK, dV) [B,Sk,KV,D] in k's and
    v's dtypes, summed over each kv-head's group of q-heads."""
    B, Sk, KV, D = k.shape
    group = q.shape[2] // KV
    p, ds = _p_ds(q, k, v, do, lse, delta, causal)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dk = dk.reshape(B, Sk, KV, group, D).sum(dim=3)
    dv = dv.reshape(B, Sk, KV, group, D).sum(dim=3)
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_shapes(q, k, v, causal: bool) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes [B, S, H, D] tensors")
    B, S, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(
            f"k/v must be [B, Sk, KV, D] matching q {tuple(q.shape)}; got "
            f"k {tuple(k.shape)}, v {tuple(v.shape)}"
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


def _check_kernel_inputs(named: dict[str, torch.Tensor]) -> None:
    """What the CUDA kernels take: contiguous, 16-byte aligned tensors,
    bf16 for q/k/v/dO, f32 for lse/delta, head_dim in HEAD_DIMS."""
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


def _launch(name: str, device: torch.device, *args) -> None:
    from tpumon.workload_torch.ops._build import load

    fn = getattr(load(name), name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: error {err} (a cudaError_t, or 10000 + "
            "the CUresult of a refused TMA tensor map)"
        )
    launches[name] += 1


def _dims(q, k):
    B, S, H, D = q.shape
    return B, H, k.shape[2], S, k.shape[1], D, 1.0 / math.sqrt(D)


def flash_fwd(q, k, v, causal: bool = True):
    """(O [B,S,H,D], lse [B,H,S] f32) — kernel ``flash_fwd`` on the card,
    :func:`flash_fwd_reference` for CPU tensors."""
    _check_shapes(q, k, v, causal)
    if _on_cpu(q, k, v):
        return flash_fwd_reference(q, k, v, causal)
    _check_kernel_inputs({"q": q, "k": k, "v": v})
    B, H, KV, S, Sk, D, scale = _dims(q, k)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    _launch(
        "flash_fwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), lse.data_ptr(), B, H, KV, S, Sk, D, scale, int(causal),
    )
    return out, lse


def flash_dq(q, k, v, do, lse, delta, causal: bool = True):
    """dQ [B,S,H,D] — kernel ``flash_dq`` on the card,
    :func:`flash_dq_reference` for CPU tensors."""
    _check_shapes(q, k, v, causal)
    if _on_cpu(q, k, v, do, lse, delta):
        return flash_dq_reference(q, k, v, do, lse, delta, causal)
    _check_kernel_inputs(
        {"q": q, "k": k, "v": v, "do": do, "lse": lse, "delta": delta}
    )
    B, H, KV, S, Sk, D, scale = _dims(q, k)
    dq = torch.empty_like(q)
    _launch(
        "flash_dq", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        B, H, KV, S, Sk, D, scale, int(causal),
    )
    return dq


def flash_dkv(q, k, v, do, lse, delta, causal: bool = True):
    """(dK, dV) [B,Sk,KV,D] — kernel ``flash_dkv`` on the card,
    :func:`flash_dkv_reference` for CPU tensors."""
    _check_shapes(q, k, v, causal)
    if _on_cpu(q, k, v, do, lse, delta):
        return flash_dkv_reference(q, k, v, do, lse, delta, causal)
    _check_kernel_inputs(
        {"q": q, "k": k, "v": v, "do": do, "lse": lse, "delta": delta}
    )
    B, H, KV, S, Sk, D, scale = _dims(q, k)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch(
        "flash_dkv", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, H, KV, S, Sk, D, scale, int(causal),
    )
    return dk, dv


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
    def forward(ctx, q, k, v, causal):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        g_out = g_out.contiguous()
        delta = flash_delta(out, g_out, g_lse)
        dq = flash_dq(q, k, v, g_out, lse, delta, ctx.causal)
        dk, dv = flash_dkv(q, k, v, g_out, lse, delta, ctx.causal)
        return dq, dk, dv, None


def flash_attention_with_lse(q, k, v, *, causal: bool = True):
    """Flash attention returning ``(out [B,S,H,D], lse [B,H,S] f32)``.

    Both outputs are differentiable: the lse cotangent folds into the
    backward's Δ (:func:`flash_delta`), so two partials over the same
    queries and different keys merge exactly (lse = logaddexp(lse_a,
    lse_b); out = out_a·e^{lse_a−lse} + out_b·e^{lse_b−lse}).
    """
    _check_shapes(q, k, v, causal)
    return _FlashLse.apply(q, k, v, causal)


def flash_attention(q, k, v, *, causal: bool = True):
    """Flash attention over [B, S, H, D] tensors (model layout); K/V may
    carry fewer heads than Q (grouped-query, never materialized)."""
    out, _ = flash_attention_with_lse(q, k, v, causal=causal)
    return out


def make_flash_attn(*, causal: bool = True):
    """``attn_impl`` factory for :meth:`models.llama.Llama.forward`."""

    def attn(q, k, v):
        return flash_attention(q, k, v, causal=causal)

    return attn


__all__ = [
    "HEAD_DIMS",
    "NEG_BIG",
    "flash_attention",
    "flash_attention_with_lse",
    "flash_delta",
    "flash_dkv",
    "flash_dkv_reference",
    "flash_dq",
    "flash_dq_reference",
    "flash_fwd",
    "flash_fwd_reference",
    "launches",
    "make_flash_attn",
    "reset_launches",
]
