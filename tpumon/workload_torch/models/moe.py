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

Beside the capacity path, and unused by :class:`Moe`, is a dropless
dispatch over a held share of the experts (:func:`dropless_experts`:
sort the (token, choice) pairs by expert, gather their rows, grouped
products, scatter-add the gated rows back), which DeepSeek-V2's layers
run (``models/deepseek_v2.py``), in the spans ``permute``, ``experts``
and ``unpermute``, counted in :data:`dropless_counts`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import ClassVar

import torch
from torch import nn
from torch.nn import functional as F

from tpumon.workload_torch import flops
from tpumon.workload_torch.models import llama as _llama
from tpumon.workload_torch.models.family import Family, register
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

    #: The weight of the aux loss in the train step's loss (the reference's
    #: constant; a class value, so that the fields stay the reference's).
    aux_weight: ClassVar[float] = 0.01

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


# ---------------------------------------------------------------------------
# Dropless dispatch over a held share of the experts (DeepSeek-V2's layer;
# the capacity path above is Mixtral's)
# ---------------------------------------------------------------------------

#: Since the last :func:`reset_dropless_counts`: the rows the dropless
#: dispatch gave each held expert (by its global index), and its host
#: reads of the per-expert counts (one a call: a layer's forward, and
#: again in remat's recompute).
dropless_counts: dict = {"rows": {}, "host_reads": 0}


def reset_dropless_counts() -> None:
    dropless_counts["rows"] = {}
    dropless_counts["host_reads"] = 0


def sort_by_expert(experts: torch.Tensor, start: int, held: int):
    """experts [T, k] (global expert ids) → (order [T·k], counts [held]):
    the flat (token, choice) pairs sorted by expert, stably (token order
    within an expert), those of experts outside the held range
    [start, start + held) after all the others; and each held expert's
    count of pairs."""
    local = experts.reshape(-1) - start
    local = torch.where((local >= 0) & (local < held), local, held)
    order = torch.argsort(local, stable=True)
    counts = torch.bincount(local, minlength=held + 1)[:held]
    return order, counts


@traced("permute")
def _permute(x, experts, start: int, held: int):
    """x [T, D], experts [T, k] → (rows [n, D]: the token of each held
    pair, grouped by expert; tokens [n]; pairs [n], the flat (token,
    choice) index of each row; sizes: each held expert's n, read on the
    host once)."""
    k = experts.shape[1]
    order, counts = sort_by_expert(experts, start, held)
    sizes = counts.tolist()
    dropless_counts["host_reads"] += 1
    rows = dropless_counts["rows"]
    for e, n in enumerate(sizes):
        rows[start + e] = rows.get(start + e, 0) + n
    pairs = order[:sum(sizes)]
    tokens = pairs // k
    return x[tokens], tokens, pairs, sizes


@traced("experts")
def _grouped_swiglu(rows, sizes, w_gate, w_up, w_down, dtype):
    """Each held expert's SwiGLU on its rows as grouped products
    (``torch._grouped_mm``, with autograd, on the card and on the host):
    rows [n, D] grouped by expert with ``sizes`` rows each, banks
    [E', D, F] / [E', F, D] → [n, D]."""
    wg, wu, wd = (cast(w, dtype) for w in (w_gate, w_up, w_down))
    offs = torch.tensor(sizes, device=rows.device).cumsum(0).to(torch.int32)
    gate = torch._grouped_mm(rows, wg, offs=offs)
    up = torch._grouped_mm(rows, wu, offs=offs)
    return torch._grouped_mm(F.silu(gate) * up, wd, offs=offs)


@traced("unpermute")
def _unpermute(y, tokens, pairs, gates, n_tokens: int, dtype):
    """Each row y [n, D] times its pair's gate, summed into its token
    (f32 accumulation): → [n_tokens, D] in ``dtype``."""
    w = gates.reshape(-1)[pairs]
    out = y.new_zeros((n_tokens, y.shape[1]), dtype=torch.float32)
    return out.index_add(0, tokens, y.float() * w[:, None]).to(dtype)


def dropless_experts(x, experts, gates, w_gate, w_up, w_down, start: int,
                     dtype):
    """The held experts' part of a routed layer, with no capacity and no
    dropped token: x [T, D], experts [T, k] (global ids over every routed
    expert) and gates [T, k] f32, banks of the E' experts held, from
    ``start`` on → [T, D] in ``dtype``. Pairs of experts not held add
    nothing; the rows' order is a stable sort by expert
    (:func:`sort_by_expert`), the products grouped, the gated rows
    scatter-added back."""
    rows, tokens, pairs, sizes = _permute(x, experts, start, w_gate.shape[0])
    y = _grouped_swiglu(rows, sizes, w_gate, w_up, w_down, dtype)
    return _unpermute(y, tokens, pairs, gates, x.shape[0], dtype)


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
        its microbatches."""
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

    def moe_mlp(self, x, sums: bool = False):
        """x [B,S,D] → (out [B,S,D], GShard aux loss, a f32 scalar), or
        with ``sums`` (out, the aux statistics' token sums [2E]). The aux
        loss is taken before the experts run, so that a remat's recompute
        stops before the combine's sum over expert."""
        dispatch, combine, stats = self.route_sums(x)
        if not sums:
            stats = aux_loss(stats / (x.shape[0] * x.shape[1]), self.cfg, self.mesh)
        return expert_ffn(x, dispatch, combine, self.w_gate, self.w_up,
                          self.w_down, self.cfg, self.mesh), stats

    @traced("layer")
    def forward(self, h, freqs, mask, attn_impl=None, sums: bool = False):
        """The layer's output and its aux loss (with ``sums``: statistics)."""
        h = h + _llama.attention(
            self, rms_norm(h, self.attn_norm), freqs, mask, attn_impl
        )
        out, stats = self.moe_mlp(rms_norm(h, self.mlp_norm), sums)
        return h + out, stats

    def forward_sums(self, h, freqs, mask, attn_impl=None):
        """A pipeline stage's call (``parallel.pipeline``)."""
        return self.forward(h, freqs, mask, attn_impl, sums=True)


@traced("router")
def aux_loss(means: torch.Tensor, cfg: MoeConfig, mesh=None) -> torch.Tensor:
    """The GShard aux loss E · Σ_e fraction-routed(e) / k · mean-prob(e)
    from the rank's means ``[..., 2E]`` (:meth:`MoeBlock.moe_mlp`'s sums
    over its token count), summed over any leading (layer) dims. Both statistics are
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
        _llama.check_tp(cfg, _llama._tp(mesh))
        check_ep(cfg, _ep(mesh))
        _llama.decoder_params(self, cfg, lambda i: MoeBlock(cfg, device, mesh),
                              device, mesh, layers, mesh_mod.MOE_PARAM_SPECS)

    def forward(self, tokens: torch.Tensor, attn_impl=None, remat: bool = False):
        """tokens [B, S] → (logits [B, S, vocab] f32 (the rank's vocabulary
        columns under tp), aux loss f32 scalar, the mean over layers).

        ``remat=True`` checkpoints each layer's whole body, routing
        included, as the reference's ``jax.checkpoint(block)``: the
        [B,S,E,C] dispatch/combine tensors are the model's largest
        activations, and the backward recomputes them.
        """
        return _llama.trunk(self, tokens, attn_impl, remat,
                            aux_layers=self.cfg.n_layers)

    def aux_of_sums(self, sums: torch.Tensor, tokens: int) -> torch.Tensor:
        """The aux loss of a pipeline stage's layers from their token sums
        ``[layers, 2E]`` over the rank's ``tokens``
        (``parallel.pipeline``)."""
        return aux_loss(sums / tokens, self.cfg, self.mesh)


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


def check(cfg: MoeConfig, *, sp: int = 1, pp: int = 1, ep: int = 1,
          loss_chunk: int = 0, **_) -> None:
    """What the MoE model does not run: the dense model's fused unembed,
    an expert count that ``ep`` does not divide, and the pipeline under
    sp (routing's capacity cumsum runs over the whole sequence)."""
    if loss_chunk:
        raise ValueError(
            "loss_chunk fuses the dense model's unembed into the loss; "
            "it does not compose with MoE"
        )
    check_ep(cfg, ep)
    if pp > 1 and sp > 1:
        raise ValueError("pp with MoE composes with dp/ep/tp only (sp=1)")


FAMILY = register(Family(
    name="moe", config=MoeConfig,
    presets={"tiny": MoeConfig.tiny, "small": MoeConfig.small},
    model=Moe, init_params=init_params, from_jax_params=from_jax_params,
    forward_flops=flops.forward_flops, check=check,
    param_specs=mesh_mod.MOE_PARAM_SPECS,
))
