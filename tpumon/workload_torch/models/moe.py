"""Mixture-of-Experts decoder, ported to PyTorch (single device).

The counterpart of ``tpumon/workload/models/moe.py``: GShard/Switch-style
top-k routing with renormalized gates and a static per-(batch-row,
expert) capacity, dispatch and combine as dense einsums over that
capacity axis (overflow tokens are dropped: their combine weight is
zero), and the GShard auxiliary load-balancing loss returned beside the
logits. The same config fields and presets, the same parameter names and
shapes (expert banks ``[E, D, F]``, router ``[D, E]``, attention weights
in the JAX ``[in, out]`` layout), f32 master weights cast to
``cfg.dtype`` at each product.

Attention is the dense model's (``models.llama.attention``), so
``attn_impl`` (the flash kernels) plugs in as it does there. The routing
and expert products are plain large einsums that the reference also
leaves to the compiler; they carry no hand kernel.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from tpumon.workload_torch.models import llama as _llama
from tpumon.workload_torch.ops.core import rms_norm, rope_freqs


@dataclass(frozen=True)
class MoeConfig:
    vocab: int = 512
    dim: int = 128
    n_layers: int = 2
    n_heads: int = 4
    n_kv_heads: int = 2
    ffn_dim: int = 256
    max_seq: int = 128
    n_experts: int = 4
    top_k: int = 2
    capacity_factor: float = 2.0
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @classmethod
    def tiny(cls) -> "MoeConfig":
        return cls()

    @classmethod
    def small(cls) -> "MoeConfig":
        """The dense ``LlamaConfig.small`` trunk with an 8-expert top-2
        bank per layer (0.153 B parameters); head_dim 64."""
        return cls(
            vocab=8192, dim=512, n_layers=8, n_heads=8, n_kv_heads=4,
            ffn_dim=1408, max_seq=4096, n_experts=8, top_k=2,
        )

    def capacity(self, seq: int) -> int:
        """Static per-(batch-row, expert) token capacity."""
        return max(
            1, math.ceil(self.top_k * seq * self.capacity_factor / self.n_experts)
        )


#: Per-layer parameter names, in the reference's ``params["layers"]`` order.
LAYER_PARAMS = (
    "attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "router", "w_gate",
    "w_up", "w_down",
)


def _layer_shapes(cfg: MoeConfig) -> dict[str, tuple[int, ...]]:
    D, F_, E = cfg.dim, cfg.ffn_dim, cfg.n_experts
    H, KV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "attn_norm": (D,),
        "wq": (D, H * HD),
        "wk": (D, KV * HD),
        "wv": (D, KV * HD),
        "wo": (H * HD, D),
        "mlp_norm": (D,),
        "router": (D, E),
        "w_gate": (E, D, F_),
        "w_up": (E, D, F_),
        "w_down": (E, F_, D),
    }


def _route(probs: torch.Tensor, top_k: int, capacity: int):
    """probs [B,S,E] → (dispatch [B,S,E,C] of 0/1, combine [B,S,E,C]).

    Slot-by-slot top-k with a running per-expert fill count, so slot j
    respects the tokens slot j-1 already placed. ``argmax`` takes the
    first maximum, as ``jnp.argmax`` does, and ``amax`` splits its
    gradient between tied maxima, as ``jnp.max`` does.
    """
    B, S, E = probs.shape
    p = probs
    gates, onehots = [], []
    for _ in range(top_k):
        gates.append(p.amax(dim=-1))
        oh = F.one_hot(p.argmax(dim=-1), E).to(probs.dtype)  # [B,S,E]
        onehots.append(oh)
        p = p * (1.0 - oh)  # mask the chosen expert for the next slot

    denom = sum(gates) + 1e-9  # renormalize gate mass over the k slots
    fill = probs.new_zeros((B, 1, E))
    dispatch = probs.new_zeros((B, S, E, capacity))
    combine = probs.new_zeros((B, S, E, capacity))
    for g, oh in zip(gates, onehots):
        # Position of each token in its chosen expert's buffer: exclusive
        # cumsum over the sequence plus what earlier slots already placed.
        # The counts are whole numbers below 2^24, so the f32 cumsum is
        # exact in any summation order.
        pos_e = torch.cumsum(oh, dim=1) - oh + fill  # [B,S,E]
        pos = (pos_e * oh).sum(dim=-1).to(torch.int64)  # [B,S]
        keep = (pos < capacity) & (oh.sum(dim=-1) > 0)
        pos_oh = F.one_hot(pos.clamp(max=capacity - 1), capacity).to(probs.dtype)
        d = oh[..., None] * pos_oh[:, :, None, :] * keep[..., None, None]
        dispatch = dispatch + d
        combine = combine + (g / denom)[..., None, None] * d
        fill = fill + oh.sum(dim=1, keepdim=True)
    return dispatch, combine


def route_tokens(x, router, cfg: MoeConfig):
    """Router in f32, softmax, then top-k routing: x [B,S,D] →
    (dispatch [B,S,E,C], combine [B,S,E,C], probs [B,S,E] f32)."""
    probs = torch.softmax(x.float() @ router, dim=-1)
    dispatch, combine = _route(probs, cfg.top_k, cfg.capacity(x.shape[1]))
    return dispatch, combine, probs


def expert_ffn(x, dispatch, combine, w_gate, w_up, w_down, cfg: MoeConfig):
    """Dispatch → expert SwiGLU → combine, as dense einsums over the
    static capacity axis in ``cfg.dtype``: x [B,S,D], dispatch/combine
    [B,S,E,C], banks [E,D,F] / [E,F,D] → out [B,S,D]."""
    dtype = cfg.dtype
    xin = torch.einsum("bsec,bsd->ebcd", dispatch.to(dtype), x)
    gate = torch.einsum("ebcd,edf->ebcf", xin, w_gate.to(dtype))
    up = torch.einsum("ebcd,edf->ebcf", xin, w_up.to(dtype))
    y = torch.einsum("ebcf,efd->ebcd", F.silu(gate) * up, w_down.to(dtype))
    return torch.einsum("bsec,ebcd->bsd", combine.to(dtype), y)


class MoeBlock(nn.Module):
    """One layer: x + attn(norm(x)), then + moe(norm(x)); returns the
    layer's output and its aux loss."""

    def __init__(self, cfg: MoeConfig, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        for name, shape in _layer_shapes(cfg).items():
            setattr(self, name, _llama._param(shape, device))

    def moe_mlp(self, x):
        """x [B,S,D] → (out [B,S,D], GShard aux loss, a f32 scalar)."""
        cfg = self.cfg
        dispatch, combine, probs = route_tokens(x, self.router, cfg)
        # E · Σ_e mean-fraction-routed(e) · mean-prob(e).
        frac = dispatch.sum(dim=-1).mean(dim=(0, 1))  # [E]
        aux = cfg.n_experts * (frac / cfg.top_k * probs.mean(dim=(0, 1))).sum()
        out = expert_ffn(
            x, dispatch, combine, self.w_gate, self.w_up, self.w_down, cfg
        )
        return out, aux

    def forward(self, h, freqs, mask, attn_impl=None):
        h = h + _llama.attention(
            self, rms_norm(h, self.attn_norm), freqs, mask, attn_impl
        )
        out, aux = self.moe_mlp(rms_norm(h, self.mlp_norm))
        return h + out, aux


class Moe(nn.Module):
    """The MoE decoder. Parameters are allocated uninitialized: build it
    with :func:`init_params` or :func:`from_jax_params`."""

    def __init__(self, cfg: MoeConfig, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        self.embed = _llama._param((cfg.vocab, cfg.dim), device)
        self.blocks = nn.ModuleList(
            MoeBlock(cfg, device) for _ in range(cfg.n_layers)
        )
        self.final_norm = _llama._param((cfg.dim,), device)
        self.unembed = _llama._param((cfg.dim, cfg.vocab), device)

    def forward(self, tokens: torch.Tensor, attn_impl=None, remat: bool = False):
        """tokens [B, S] → (logits [B, S, vocab] f32, aux loss f32 scalar,
        the mean over layers).

        ``remat=True`` checkpoints each layer's whole body, routing
        included, as the reference's ``jax.checkpoint(block)``: the
        [B,S,E,C] dispatch/combine tensors are the model's largest
        activations, and the backward recomputes them.
        """
        cfg = self.cfg
        S = tokens.shape[1]
        x = self.embed.to(cfg.dtype)[tokens]
        freqs = rope_freqs(cfg.head_dim, cfg.max_seq, device=x.device)
        mask = _llama.causal_mask(S, x.device) if attn_impl is None else None
        aux = x.new_zeros((), dtype=torch.float32)
        for block in self.blocks:
            if remat:
                x, layer_aux = checkpoint(
                    block, x, freqs, mask, attn_impl, use_reentrant=False
                )
            else:
                x, layer_aux = block(x, freqs, mask, attn_impl)
            aux = aux + layer_aux
        x = rms_norm(x, self.final_norm)
        return (x @ self.unembed.to(cfg.dtype)).float(), aux / cfg.n_layers


def init_params(cfg: MoeConfig, generator: torch.Generator, device=None) -> Moe:
    """A :class:`Moe` with the reference's initialization: normal(0.02)
    f32 weights, ones for the norms. ``device`` defaults to the
    generator's device."""
    device = generator.device if device is None else torch.device(device)
    return _llama.init_weights(Moe(cfg, device), generator)


def from_jax_params(cfg: MoeConfig, tree, device=None) -> Moe:
    """Build a :class:`Moe` from the reference's parameter pytree as numpy
    arrays, with the layer keys of :data:`LAYER_PARAMS`."""
    return _llama.load_jax_tree(Moe(cfg, device), tree, LAYER_PARAMS)
