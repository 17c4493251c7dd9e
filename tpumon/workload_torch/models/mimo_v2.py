"""MiMo-V2-Flash decoder (Xiaomi's hybrid sliding-window MoE), in PyTorch.

The JAX package has no counterpart; the plain float32 reference is
``benchmark/reference/mimo_v2.py``. Weights are f32 masters cast to
``cfg.dtype`` at each product, in the ``[in, out]`` layout, as in
``models/llama.py``.

- Two kinds of attention layer, by ``layer_types`` (the published
  ``hybrid_layer_pattern``: 0 full, 1 sliding window). Both are grouped-
  query attention at q·k width ``head_dim`` and v width ``v_head_dim``,
  scaled by 1/√(q·k width), with RoPE on the first ``rotary_dim`` columns
  of each q and k head (read in place as strided views by ``rope_qk``)
  and v scaled by ``value_scale``. Full layers: ``n_kv_heads`` kv heads,
  θ ``rope_theta``, every earlier key. Window layers: ``swa_n_kv_heads``
  kv heads, θ ``swa_rope_theta``, the last ``sliding_window`` keys, and
  one learnable sink logit a head (``sinks``, f32, no value) in each
  row's softmax. On ``attn_impl`` the window and the sinks reach the
  flash kernels through ``attention_window``; the plain path computes
  the same in f32.
- Layers whose ``moe_layers`` entry is 0 end in a dense SwiGLU; the
  others in a sigmoid-routed mixture: s = sigmoid(x·W_router) in f32
  over every routed expert, the top-k of s + ``e_score_correction_bias``
  (a buffer) chosen, gated by their s over the k's sum (``noaux_tc``),
  and the routed experts this model holds (``expert_start``,
  ``experts_held``: one card's share under expert parallelism) run on the
  tokens routed to them with no capacity (``models.moe.dropless_experts``).
  There is no balance loss: after each optimizer step the train step
  runs :func:`update_bias` (the family's ``after_step``), which moves
  each expert's bias by ``bias_update_rate`` toward the mean load:
  b_i += γ·sign(mean − load_i), over the loads of every routed expert on
  this model's tokens of the step.

Departures: RoPE turns split halves of the rotary columns (the port's
``rope_qk``); the part of the experts not held is left out, as on a card
of an expert-parallel job before its exchange (this model has none); the
multi-token-prediction layers are not built. Every region runs in a span
(``spans.py``): ``qkv`` (the projections and v's scale), ``rope``,
``attn_core`` (full layers) and ``swa_core`` (window layers), ``attn_out``,
``mlp`` (the dense layer), ``router``, ``permute``, ``experts``,
``unpermute``, and ``balance`` (the bias update, outside the gradient).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn
from tpumon.workload_torch import spans
from tpumon.workload_torch.flops import window_pairs
from tpumon.workload_torch.models import llama as _llama
from tpumon.workload_torch.models import moe as _moe
from tpumon.workload_torch.models.family import Family, register
from tpumon.workload_torch.ops.core import cast, rms_norm, rope_freqs, rope_qk
from tpumon.workload_torch.ops.flash_attention import NEG_BIG, attention_window
from tpumon.workload_torch.spans import traced

#: The published layer pattern of MiMo-V2-Flash's 48 layers (0 full, 1
#: sliding window) and which of them are MoE layers (``moe_layer_freq``).
PUBLISHED_PATTERN = (0, 1, 1, 1, 1, 0) + (1, 1, 1, 1, 1, 0) * 7
PUBLISHED_MOE = (0,) + (1,) * 47


@dataclass(frozen=True)
class MimoV2Config:
    """The published ``config.json`` keys, under the port's names, the
    expert share this model holds (experts ``expert_start`` … +
    ``experts_held``, all of them when None), the router bias's update
    rate γ, and AdamW's learning rate (``harness.build_optimizer``)."""
    vocab: int = 512  # vocab_size
    dim: int = 64  # hidden_size
    n_heads: int = 4  # num_attention_heads (= swa_num_attention_heads)
    n_kv_heads: int = 1  # num_key_value_heads: the full layers'
    swa_n_kv_heads: int = 2  # swa_num_key_value_heads
    head_dim: int = 48  # q·k width (= swa_head_dim)
    v_head_dim: int = 32  # (= swa_v_head_dim)
    rotary_dim: int = 16  # partial_rotary_factor × head_dim, the first columns
    rope_theta: float = 5e6  # full layers
    swa_rope_theta: float = 1e4
    sliding_window: int = 8
    value_scale: float = 0.707  # attention_value_scale
    layer_types: tuple[int, ...] = (0, 1, 1, 0)  # hybrid_layer_pattern
    moe_layers: tuple[int, ...] = (0, 1, 1, 1)  # moe_layer_freq
    ffn_dim: int = 128  # intermediate_size: the dense layers
    moe_ffn_dim: int = 32  # moe_intermediate_size
    n_routed_experts: int = 8
    top_k: int = 3  # num_experts_per_tok
    bias_update_rate: float = 1e-3  # γ of the noaux_tc bias update
    rms_eps: float = 1e-5  # layernorm_epsilon
    max_seq: int = 128
    expert_start: int = 0
    experts_held: int | None = None
    learning_rate: float = 1e-3
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self) -> None:
        if len(self.layer_types) != len(self.moe_layers):
            raise ValueError("MimoV2Config: layer_types and moe_layers must "
                             "name the same layers")
        if not set(self.layer_types) <= {0, 1} or not set(self.moe_layers) <= {0, 1}:
            raise ValueError("MimoV2Config: layer_types and moe_layers hold 0s "
                             "and 1s")
        if self.rotary_dim % 2 or not 0 < self.rotary_dim <= self.head_dim:
            raise ValueError(f"MimoV2Config: rotary_dim {self.rotary_dim} must "
                             f"be even and within head_dim {self.head_dim}")
        if self.sliding_window < 1:
            raise ValueError("MimoV2Config: sliding_window must be >= 1")
        if not 0 <= self.expert_start < self.expert_start + self.held <= self.n_routed_experts:
            raise ValueError(
                f"MimoV2Config: experts {self.expert_start}…"
                f"{self.expert_start + self.held - 1} are not among the "
                f"{self.n_routed_experts} routed experts")

    @property
    def n_layers(self) -> int:
        return len(self.layer_types)

    @property
    def held(self) -> int:
        """Routed experts this model holds."""
        return self.n_routed_experts if self.experts_held is None else self.experts_held

    def is_swa(self, layer: int) -> bool:
        return self.layer_types[layer] == 1

    def is_moe(self, layer: int) -> bool:
        return self.moe_layers[layer] == 1

    def kv_heads(self, layer: int) -> int:
        return self.swa_n_kv_heads if self.is_swa(layer) else self.n_kv_heads

    @classmethod
    def tiny(cls) -> "MimoV2Config":
        """The CPU tests' size: dim 64, 4 heads at q·k 48 (16 rotary) and
        v 32, a full layer with 1 kv head, two window layers of 8 keys
        with 2 kv heads and sinks, a full layer again; layer 0 dense, the
        others 8 experts top-3."""
        return cls()

    @classmethod
    def v2_flash_share(cls) -> "MimoV2Config":
        """MiMo-V2-Flash at its published widths, 7 of its 48 layers (layer
        0, dense and full, and one period of 5 window layers and a full
        one, all MoE: published layers 0 and 6-11), as one card of an
        EP32 job holds them: the router over all 256 experts, the routed
        experts 0-7, and an eighth of the vocabulary (19,072 of 152,576);
        2.222 B parameters. Trained at 2.2e-5, where DeepSeek-V3's
        schedule for the same sigmoid routing ends (a tenth of its 2.2e-4
        peak, arXiv:2412.19437), the rule DeepSeek-V2-Lite's cell follows:
        on random weights a larger rate swings the routing within the
        checked steps."""
        return cls(
            vocab=19072, dim=4096, n_heads=64, n_kv_heads=4, swa_n_kv_heads=8,
            head_dim=192, v_head_dim=128, rotary_dim=64, rope_theta=5e6,
            swa_rope_theta=1e4, sliding_window=128,
            layer_types=(0,) + PUBLISHED_PATTERN[6:12],
            moe_layers=(0,) + PUBLISHED_MOE[6:12], ffn_dim=16384,
            moe_ffn_dim=2048, n_routed_experts=256, top_k=8, max_seq=32768,
            expert_start=0, experts_held=8, learning_rate=2.2e-5,
        )


def layer_shapes(cfg: MimoV2Config, layer: int) -> dict[str, tuple[int, ...]]:
    """Every weight of layer ``layer``, in order: [in, out] matrices, the
    sinks [H] where the layer has them, expert banks [E', in, out]."""
    D, H, KV = cfg.dim, cfg.n_heads, cfg.kv_heads(layer)
    shapes = {
        "attn_norm": (D,),
        "wq": (D, H * cfg.head_dim),
        "wk": (D, KV * cfg.head_dim),
        "wv": (D, KV * cfg.v_head_dim),
        "wo": (H * cfg.v_head_dim, D),
    }
    if cfg.is_swa(layer):  # add_swa_attention_sink_bias, not the full layers'
        shapes["sinks"] = (H,)
    shapes["mlp_norm"] = (D,)
    if not cfg.is_moe(layer):
        shapes.update(w_gate=(D, cfg.ffn_dim), w_up=(D, cfg.ffn_dim),
                      w_down=(cfg.ffn_dim, D))
        return shapes
    E, F_ = cfg.held, cfg.moe_ffn_dim
    shapes.update(router=(D, cfg.n_routed_experts), w_gate=(E, D, F_),
                  w_up=(E, D, F_), w_down=(E, F_, D))
    return shapes


@traced("qkv")
def _qkv(x, wq, wk, wv, cfg: MimoV2Config):
    """x [B,S,D] → q [B,S,H,Dqk], k [B,S,KV,Dqk], v [B,S,KV,Dv] × the
    value scale, the heads read off the weights' widths."""
    B, S, _ = x.shape
    q = (x @ cast(wq, cfg.dtype)).reshape(B, S, -1, cfg.head_dim)
    k = (x @ cast(wk, cfg.dtype)).reshape(B, S, -1, cfg.head_dim)
    v = (x @ cast(wv, cfg.dtype)).reshape(B, S, -1, cfg.v_head_dim)
    return q, k, v * cfg.value_scale


def _partial_rope(q, k, table, rotary: int):
    """q and k with their first ``rotary`` columns turned by ``table``,
    read as strided views; the other columns as they are."""
    q_rot, k_rot = rope_qk(q[..., :rotary], k[..., :rotary], table)
    return (torch.cat([q_rot, q[..., rotary:]], dim=-1),
            torch.cat([k_rot, k[..., rotary:]], dim=-1))


def plain_attention(q, k, v, window: int = 0, sinks=None):
    """The plain attention core: q, k [B,S,·,Dqk], v [B,S,KV,Dv] →
    [B,S,H,Dv] in v's dtype. Scores in f32 at 1/√Dqk, causal, within the
    last ``window`` keys (0: all), softmax over them and the sink logit
    ``sinks`` [H] where given; probabilities cast to v's dtype before the
    second product, as ``models.llama.plain_attention``."""
    S, H, D = q.shape[1], q.shape[2], q.shape[3]
    rep = H // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(D)
    i = torch.arange(S, device=q.device)[:, None]
    j = torch.arange(S, device=q.device)[None, :]
    live = (j <= i) & ((j > i - window) if window else True)
    scores = scores.masked_fill(~live, NEG_BIG)
    if sinks is not None:
        sink = sinks.float()[None, :, None, None].expand(*scores.shape[:3], 1)
        probs = torch.softmax(torch.cat([scores, sink], dim=-1), dim=-1)[..., :S]
    else:
        probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


@traced("attn_core")
def _full_core(q, k, v, attn_impl):
    """A full layer's causal attention on ``attn_impl``, else
    :func:`plain_attention`."""
    if attn_impl is None:
        return plain_attention(q, k, v)
    return attn_impl(q, k, v)


@traced("swa_core")
def _swa_core(q, k, v, sinks, attn_impl, window: int):
    """A window layer's attention over each query's last ``window`` keys,
    with its sinks: on ``attn_impl`` (the window and the sinks set with
    ``attention_window`` around its call), else :func:`plain_attention`."""
    if attn_impl is None:
        return plain_attention(q, k, v, window, sinks)
    with attention_window(window, sinks):
        return attn_impl(q, k, v)


def attention(layer: nn.Module, x, table, attn_impl=None):
    """A layer's attention sublayer on the normed input x [B,S,D]."""
    cfg = layer.cfg
    q, k, v = _qkv(x, layer.wq, layer.wk, layer.wv, cfg)
    q, k = _partial_rope(q, k, table, cfg.rotary_dim)
    if layer.swa:
        out = _swa_core(q, k, v, layer.sinks, attn_impl, cfg.sliding_window)
    else:
        out = _full_core(q, k, v, attn_impl)
    return _llama._attn_out(out, layer.wo, cfg.dtype)


@traced("router")
def route(x, router, bias, load, cfg: MimoV2Config):
    """x [B,S,D] → (gates [B,S,k] f32, experts [B,S,k]): s = sigmoid(x·W)
    in f32 over every routed expert, the top-k of s + ``bias`` chosen,
    gated by their s over the k's sum (``routed_scaling_factor`` null). Adds
    each expert's count of choices to ``load`` (outside the gradient);
    remat's recompute adds the same counts again, which leaves
    :func:`update_bias`'s signs as they are."""
    scores = torch.sigmoid(x.float() @ router)
    experts = (scores + bias).topk(cfg.top_k, dim=-1).indices
    top = scores.gather(-1, experts)
    gates = top / top.sum(dim=-1, keepdim=True)
    with torch.no_grad():
        load += torch.bincount(experts.reshape(-1), minlength=load.shape[0])
    return gates, experts


#: The dense layers' SwiGLU.
_dense = traced("mlp")(_llama.swiglu)


class Block(nn.Module):
    """Layer ``index``: x + attention(norm(x)) of its kind, then + the
    dense SwiGLU or the routed experts of norm(x); returns the layer's
    output and no aux loss. An MoE layer holds its router bias
    (``e_score_correction_bias``, a buffer the optimizer never sees) and
    the step's expert loads (``load``)."""

    def __init__(self, cfg: MimoV2Config, index: int, device=None) -> None:
        super().__init__()
        self.cfg, self.swa, self.moe = cfg, cfg.is_swa(index), cfg.is_moe(index)
        for name, shape in layer_shapes(cfg, index).items():
            setattr(self, name, _llama._param(shape, device))
        if self.moe:
            E = cfg.n_routed_experts
            self.register_buffer("e_score_correction_bias",
                                 torch.zeros(E, dtype=torch.float32, device=device))
            self.register_buffer("load", torch.zeros(E, dtype=torch.int64,
                                                     device=device),
                                 persistent=False)

    def moe_mlp(self, x):
        """x [B,S,D] → the held routed experts' part."""
        cfg = self.cfg
        B, S, D = x.shape
        gates, experts = route(x, self.router, self.e_score_correction_bias,
                               self.load, cfg)
        routed = _moe.dropless_experts(
            x.reshape(B * S, D), experts.reshape(B * S, -1),
            gates.reshape(B * S, -1), self.w_gate, self.w_up, self.w_down,
            cfg.expert_start, cfg.dtype)
        return routed.reshape(B, S, D)

    @traced("layer")
    def forward(self, h, freqs, mask, attn_impl=None):
        eps = self.cfg.rms_eps
        table = freqs[int(self.swa)]
        h = h + attention(self, rms_norm(h, self.attn_norm, eps), table, attn_impl)
        x = rms_norm(h, self.mlp_norm, eps)
        if self.moe:
            return h + self.moe_mlp(x), None
        return h + _dense(x, self.w_gate, self.w_up, self.w_down, self.cfg.dtype), None


class MimoV2(nn.Module):
    """The decoder, on one device (no mesh). Parameters are allocated
    uninitialised: build it with :func:`init_params`."""

    def __init__(self, cfg: MimoV2Config, device=None) -> None:
        super().__init__()
        _llama.decoder_params(self, cfg, lambda i: Block(cfg, i, device), device)

    def forward(self, tokens: torch.Tensor, attn_impl=None, remat: bool = False):
        """tokens [B, S] → logits [B, S, vocab] f32. ``remat`` checkpoints
        each layer, routing included."""
        return _llama.trunk(self, tokens, attn_impl, remat, freqs=_rope_tables,
                            eps=self.cfg.rms_eps)


def _rope_tables(model: MimoV2, seq: int, device) -> torch.Tensor:
    """The rotary angles of both layer kinds, [2, rows, rotary/2]: the full
    layers' (θ ``rope_theta``) at 0, the window layers' at 1, at least
    ``seq`` rows; each block takes its kind's."""
    cfg = model.cfg
    rows = max(seq, cfg.max_seq)
    return torch.stack([rope_freqs(cfg.rotary_dim, rows, theta, device=device)
                        for theta in (cfg.rope_theta, cfg.swa_rope_theta)])


@torch.no_grad()
def update_bias(model: MimoV2) -> None:
    """The ``noaux_tc`` balance step, run after each optimizer step: every
    MoE layer's bias b_i += γ·sign(mean load − load_i) over the loads its
    router counted since the last call, which it then clears. The signs
    are those of Σ load − E·load_i, exact in integers, and the same
    whatever the number of passes that counted (remat counts twice)."""
    with spans.span("balance"):
        for block in model.blocks:
            if not block.moe:
                continue
            load = block.load
            step = torch.sign(load.sum() - load.shape[0] * load)
            block.e_score_correction_bias.add_(
                step.to(torch.float32), alpha=model.cfg.bias_update_rate)
            load.zero_()


def init_params(cfg: MimoV2Config, generator: torch.Generator,
                device=None) -> MimoV2:
    """A :class:`MimoV2` with normal(0.02) f32 weights (the sinks among
    them) and ones for the norms (``models.llama.init_weights``); the
    router biases start at 0. ``device`` defaults to the generator's."""
    device = generator.device if device is None else torch.device(device)
    return _llama.init_weights(MimoV2(cfg, device), generator)


def from_jax_params(cfg: MimoV2Config, tree, device=None) -> MimoV2:
    """Refused: the JAX package has no MiMo-V2."""
    raise ValueError("MiMo-V2 has no JAX counterpart: params must be a "
                     "MimoV2 module or None")


def forward_flops(cfg: MimoV2Config, batch: int, seq: int) -> float:
    """Matmul FLOPs of one forward, counted as ``flops.forward_flops``
    counts the others (2·m·n·k a product): each layer's q, k, v and output
    projections at its kind's kv heads; the full layers' core at the full
    S² and the window layers' at their windowed pairs
    (``flops.window_pairs``), scores at the q·k width and probs·V at the v
    width; the dense layers' SwiGLU; the MoE layers' router and the held
    experts' expected share of the top-k (k · held / E a token); the
    unembed."""
    T, D, H = batch * seq, cfg.dim, cfg.n_heads
    Dqk, Dv = cfg.head_dim, cfg.v_head_dim
    total = 2 * T * D * cfg.vocab
    for i in range(cfg.n_layers):
        KV = cfg.kv_heads(i)
        total += 2 * T * D * (H * Dqk + KV * (Dqk + Dv)) + 2 * T * H * Dv * D
        pairs = window_pairs(seq, cfg.sliding_window) if cfg.is_swa(i) else seq * seq
        total += 2 * batch * H * pairs * (Dqk + Dv)
        if cfg.is_moe(i):
            total += 2 * T * D * cfg.n_routed_experts
            total += 6 * T * D * cfg.moe_ffn_dim * cfg.top_k * cfg.held / cfg.n_routed_experts
        else:
            total += 6 * T * D * cfg.ffn_dim
    return float(total)


def check(cfg: MimoV2Config, *, dp: int = 1, tp: int = 1, sp: int = 1,
          pp: int = 1, ep: int = 1, loss_chunk: int = 0, **_) -> None:
    """MiMo-V2 runs on one device, as one card's share of its experts:
    raise for a mesh (its exchange and splits are not written) and for
    ``loss_chunk`` (the dense model's fused unembed)."""
    axes = {"dp": dp, "tp": tp, "sp": sp, "pp": pp, "ep": ep}
    meshed = [f"{axis}={n}" for axis, n in axes.items() if n > 1]
    if meshed:
        raise ValueError(f"MiMo-V2 runs on one device; it takes no mesh "
                         f"({', '.join(meshed)})")
    if loss_chunk:
        raise ValueError("loss_chunk fuses the dense model's unembed into the "
                         "loss; it does not compose with MiMo-V2")


FAMILY = register(Family(
    name="mimo_v2", config=MimoV2Config,
    presets={"tiny": MimoV2Config.tiny,
             "v2-flash-share": MimoV2Config.v2_flash_share},
    own_presets=("v2-flash-share",),
    model=MimoV2, init_params=init_params, from_jax_params=from_jax_params,
    forward_flops=forward_flops, check=check, after_step=update_bias,
))
