"""Mixture-of-Experts decoder, ported to PyTorch.

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
leaves to the compiler; they carry no hand kernel. The routing, the
dispatch, the experts and the combine each run in a span of their own
(``spans.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from tpumon.workload_torch.models import llama as _llama
from tpumon.workload_torch.ops.core import cast, rms_norm
from tpumon.workload_torch.parallel import mesh as mesh_mod
from tpumon.workload_torch.spans import traced


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


def route_tokens(x, router, cfg: MoeConfig, mesh=None):
    """Router in f32, softmax, then top-k routing: x [B,S,D] →
    (dispatch [B,S,E,C], combine [B,S,E,C], probs [B,S,E] f32).

    On a ``mesh`` the probabilities that enter the routing pass through
    :func:`parallel.mesh.copy_to_expert` (each expert rank's combine uses
    only its experts' gates, so their gradient sums over expert); the
    returned ``probs`` are the raw ones, whose use in the aux loss is whole
    on every rank. Under sp, x holds the rank's S/sp rows: the
    probabilities are gathered over seq first, so the capacity and the
    capacity cumsum see the whole sequence as on one device, and
    dispatch/combine come back as this rank's rows of that routing."""
    probs = torch.softmax(x.float() @ router, dim=-1)
    whole = mesh_mod.gather_seq(mesh_mod.copy_to_expert(probs, mesh), mesh)
    dispatch, combine = _route(whole, cfg.top_k, cfg.capacity(whole.shape[1]))
    if whole.shape[1] != x.shape[1]:
        start = mesh.coords["seq"] * x.shape[1]
        dispatch = dispatch[:, start:start + x.shape[1]]
        combine = combine[:, start:start + x.shape[1]]
    return dispatch, combine, probs


def expert_ffn(x, dispatch, combine, w_gate, w_up, w_down, cfg: MoeConfig,
               mesh=None):
    """Dispatch → expert SwiGLU → combine, as dense einsums over the
    static capacity axis in ``cfg.dtype``: x [B,S,D], dispatch/combine
    [B,S,E',C], banks [E',D,F'] / [E',F',D] → out [B,S,D].

    Under tp the banks hold the rank's slice of the FFN dim: x enters as a
    column split's input, and the experts' outputs sum over model before
    the combine, so the replicated router's gradient through the combine
    weights is whole on the rank's experts. Under ep, E' = E/ep are the
    rank's experts (dispatch/combine sliced to them): x's gradient sums
    over expert, and so do the outputs (``_moe_mlp_local``'s psum over
    expert). Under sp each rank runs the experts on its own rows only;
    the capacity slots of the other ranks' tokens hold zeros, which the
    SwiGLU maps to zeros."""
    dtype = cfg.dtype
    x = mesh_mod.copy_to_model(mesh_mod.copy_to_expert(x, mesh), mesh)
    xin = _dispatch(dispatch, x, dtype)
    y = mesh_mod.reduce_from_model(_experts(xin, w_gate, w_up, w_down, dtype), mesh)
    return mesh_mod.reduce_from_expert(_combine(combine, y, dtype), mesh)


@traced("dispatch")
def _dispatch(dispatch, x, dtype):
    """Tokens x [B,S,D] into the experts' capacity slots [E',B,C,D]."""
    return torch.einsum("bsec,bsd->ebcd", dispatch.to(dtype), x)


@traced("experts")
def _experts(xin, w_gate, w_up, w_down, dtype):
    """The SwiGLU of each expert bank on its slots [E',B,C,D]."""
    gate = torch.einsum("ebcd,edf->ebcf", xin, cast(w_gate, dtype))
    up = torch.einsum("ebcd,edf->ebcf", xin, cast(w_up, dtype))
    return torch.einsum("ebcf,efd->ebcd", F.silu(gate) * up, cast(w_down, dtype))


@traced("combine")
def _combine(combine, y, dtype):
    """The experts' slots y [E',B,C,D] back to the tokens [B,S,D], by
    their gates."""
    return torch.einsum("bsec,ebcd->bsd", combine.to(dtype), y)


def check_ep(cfg: MoeConfig, ep: int) -> None:
    """Raise unless ``ep`` splits the experts evenly."""
    if cfg.n_experts % ep:
        raise ValueError(
            f"n_experts ({cfg.n_experts}) must divide by ep ({ep})")


def _ep(mesh) -> int:
    return 1 if mesh is None else mesh.ep


class MoeBlock(nn.Module):
    """One layer: x + attn(norm(x)), then + moe(norm(x)); returns the
    layer's output and its aux loss."""

    def __init__(self, cfg: MoeConfig, device=None, mesh=None) -> None:
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        for name, shape in _layer_shapes(cfg).items():
            shape = mesh_mod.local_shape(
                name, shape, mesh_mod.MOE_PARAM_SPECS, _llama._tp(mesh), _ep(mesh))
            setattr(self, name, _llama._param(shape, device))

    @traced("router")
    def route_sums(self, x):
        """x [B,S,D] → (dispatch, combine) of the rank's experts and the
        aux loss's statistics as token sums over the rank's rows: [2E]
        f32, the tokens routed to each expert, then each expert's summed
        probability. Sums, not means, so that a pipeline adds them up over
        its microbatches (``_moe_mlp_local``)."""
        cfg, mesh = self.cfg, self.mesh
        dispatch, combine, probs = route_tokens(x, self.router, cfg, mesh)
        sums = torch.cat([dispatch.sum(dim=-1).sum(dim=(0, 1)),  # [E]
                          probs.sum(dim=(0, 1))])
        if _ep(mesh) > 1:
            # This rank's experts: a slice of the routing, not a collective.
            local = cfg.n_experts // mesh.ep
            start = mesh.coords["expert"] * local
            dispatch = dispatch[:, :, start:start + local]
            combine = combine[:, :, start:start + local]
        return dispatch, combine, sums

    def experts(self, x, dispatch, combine):
        return expert_ffn(x, dispatch, combine, self.w_gate, self.w_up,
                          self.w_down, self.cfg, self.mesh)

    def moe_mlp(self, x):
        """x [B,S,D] → (out [B,S,D], GShard aux loss, a f32 scalar). The
        aux loss is taken before the experts run, so that a remat's
        recompute stops before the combine's sum over expert."""
        dispatch, combine, sums = self.route_sums(x)
        aux = aux_loss(sums / (x.shape[0] * x.shape[1]), self.cfg, self.mesh)
        return self.experts(x, dispatch, combine), aux

    def moe_mlp_sums(self, x):
        """x [B,S,D] → (out [B,S,D], the aux statistics' token sums [2E])."""
        dispatch, combine, sums = self.route_sums(x)
        return self.experts(x, dispatch, combine), sums

    @traced("layer")
    def forward_sums(self, h, freqs, mask, attn_impl=None):
        """The layer's output and its aux statistics (``moe_mlp_sums``)."""
        h = h + _llama.attention(
            self, rms_norm(h, self.attn_norm), freqs, mask, attn_impl
        )
        out, sums = self.moe_mlp_sums(rms_norm(h, self.mlp_norm))
        return h + out, sums

    @traced("layer")
    def forward(self, h, freqs, mask, attn_impl=None):
        h = h + _llama.attention(
            self, rms_norm(h, self.attn_norm), freqs, mask, attn_impl
        )
        out, aux = self.moe_mlp(rms_norm(h, self.mlp_norm))
        return h + out, aux


@traced("router")
def aux_loss(means: torch.Tensor, cfg: MoeConfig, mesh=None) -> torch.Tensor:
    """The GShard aux loss E · Σ_e fraction-routed(e) / k · mean-prob(e)
    from the rank's means ``[..., 2E]`` (``moe_mlp_sums`` over its token
    count), summed over any leading (layer) dims. Both statistics are
    means over the whole batch: on a mesh they average over the data×seq
    ranks (the rows are equal shards) first."""
    if mesh is not None:
        means = mesh_mod.mean_over_data_seq(means, mesh)
    frac, prob = means.split(cfg.n_experts, dim=-1)
    return cfg.n_experts * (frac / cfg.top_k * prob).sum()


class Moe(nn.Module):
    """The MoE decoder. Parameters are allocated uninitialized: build it
    with :func:`init_params` or :func:`from_jax_params`. ``mesh`` makes it
    the rank's slice, as :class:`models.llama.Llama`'s does, with the
    expert banks split on E over expert and on the FFN dim over model,
    and the router replicated (``moe_param_specs``); ``layers`` makes it
    one pipeline stage's, as there."""

    def __init__(self, cfg: MoeConfig, device=None, mesh=None,
                 layers=None) -> None:
        super().__init__()
        tp = _llama._tp(mesh)
        _llama.check_tp(cfg, tp)
        check_ep(cfg, _ep(mesh))
        self.cfg = cfg
        self.mesh = mesh
        specs = mesh_mod.MOE_PARAM_SPECS
        self.embed = _llama._param(
            mesh_mod.local_shape("embed", (cfg.vocab, cfg.dim), specs, tp), device)
        self.blocks = _llama.make_blocks(lambda: MoeBlock(cfg, device, mesh),
                                         cfg.n_layers, layers)
        self.final_norm = _llama._param((cfg.dim,), device)
        self.unembed = _llama._param(
            mesh_mod.local_shape("unembed", (cfg.dim, cfg.vocab), specs, tp), device)

    def forward(self, tokens: torch.Tensor, attn_impl=None, remat: bool = False):
        """tokens [B, S] → (logits [B, S, vocab] f32 (the rank's vocabulary
        columns under tp), aux loss f32 scalar, the mean over layers).

        ``remat=True`` checkpoints each layer's whole body, routing
        included, as the reference's ``jax.checkpoint(block)``: the
        [B,S,E,C] dispatch/combine tensors are the model's largest
        activations, and the backward recomputes them.
        """
        _llama._check_whole(self)
        cfg = self.cfg
        S = tokens.shape[1]
        x = _llama.embed_tokens(self, tokens)
        freqs = _llama.rank_freqs(self, S, x.device)
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
        return _llama.unembed_logits(self, x), aux / cfg.n_layers


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
