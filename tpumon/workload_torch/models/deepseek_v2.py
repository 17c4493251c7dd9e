"""DeepSeek-V2 decoder (DeepSeek-V2-Lite's architecture), in PyTorch.

The JAX package has no counterpart; the plain float32 reference is
``benchmark/reference/deepseek_v2.py``. Weights are f32 masters cast to
``cfg.dtype`` at each product, in the ``[in, out]`` layout, as in
``models/llama.py``.

- Multi-head latent attention (MLA), with no q compression
  (``q_lora_rank`` None): q is one product to H × (nope + rope) columns;
  a down-projection gives a latent of ``kv_lora_rank`` columns and one
  rope key of ``qk_rope_head_dim`` columns that every head shares; the
  latent goes through its RMSNorm and an up-projection to each head's
  k_nope and v. YaRN's RoPE turns the rope columns of q and of the shared
  key; attention runs at q·k width nope + rope and v width
  ``v_head_dim``, scaled by YaRN's mscale² / √(q·k width), on ``attn_impl``
  (the flash kernels at width 192: v padded for the forward and dQ,
  unpadded in flash_dkv's one launch) or the plain path.
- The first ``first_k_dense`` layers end in a dense SwiGLU; every other
  layer in DeepSeekMoE: an f32 softmax router over every routed expert,
  greedy top-k, gates the chosen probabilities (not renormalised) ×
  ``routed_scaling_factor``; the shared experts, one SwiGLU of
  ``n_shared_experts`` × the expert width, on every token; and the routed
  experts this model holds (``expert_start``, ``experts_held``: one
  card's share under expert parallelism) on the tokens routed to them,
  with no capacity (``models.moe.dropless_experts``). The part of the
  experts not held is left out, as on a card of an expert-parallel job
  before its exchange; this model has no exchange.
- The sequence-level balance loss (``seq_aux``) over every routed expert:
  α · Σ_i f_i · P_i per sequence, f_i = E/(k·S) × the count of expert i
  among the sequence's choices, P_i its mean probability; the mean over
  sequences, then over the MoE layers, weighted by ``aux_loss_alpha`` in
  the train step's loss (``aux_weight``).

Departure: RoPE turns split halves of the rope columns (the port's
``apply_rope``), where the published weights pair interleaved columns; the
two differ by a fixed permutation of the rope columns of ``wq`` and
``wkv_a``. Every region runs in a span (``spans.py``): ``qkv`` (q's
product), ``latent`` (the kv down-projection and its split, the latent
norm's call, the up-projection, the shared key's broadcast and the q/k
assembly), ``attn_core``, ``attn_out``, ``mlp`` (the dense layer),
``router``, ``permute``, ``experts``, ``unpermute``, ``shared``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn
from tpumon.workload_torch.models import llama as _llama
from tpumon.workload_torch.models import moe as _moe
from tpumon.workload_torch.models.family import Family, register
from tpumon.workload_torch.ops.core import (
    apply_rope,
    cast,
    rms_norm,
    yarn_freqs,
    yarn_mscale,
)
from tpumon.workload_torch.ops.flash_attention import softmax_scale
from tpumon.workload_torch.spans import traced


@dataclass(frozen=True)
class DeepseekV2Config:
    """The published ``config.json`` keys, under the port's names, the
    expert share this model holds: experts ``expert_start`` … +
    ``experts_held`` (all of them when None), and AdamW's learning rate
    (``harness.build_optimizer``; the port's 1e-3 by default)."""
    vocab: int = 512  # vocab_size
    dim: int = 64  # hidden_size
    n_layers: int = 3  # num_hidden_layers
    n_heads: int = 4  # num_attention_heads (= num_key_value_heads)
    q_lora_rank: int | None = None
    kv_lora_rank: int = 32
    qk_nope_head_dim: int = 32
    qk_rope_head_dim: int = 16
    v_head_dim: int = 32
    ffn_dim: int = 128  # intermediate_size: the dense layers
    moe_ffn_dim: int = 32  # moe_intermediate_size
    n_routed_experts: int = 8
    n_shared_experts: int = 2
    top_k: int = 3  # num_experts_per_tok
    first_k_dense: int = 1  # first_k_dense_replace
    norm_topk_prob: bool = False
    routed_scaling_factor: float = 1.0
    aux_loss_alpha: float = 0.001
    seq_aux: bool = True
    rms_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_factor: float = 40.0  # rope_scaling: YaRN
    original_max_seq: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 0.707
    mscale_all_dim: float = 0.707
    max_seq: int = 128
    expert_start: int = 0
    experts_held: int | None = None
    learning_rate: float = 1e-3
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self) -> None:
        unsupported = {
            "q_lora_rank": self.q_lora_rank is not None,
            "norm_topk_prob": self.norm_topk_prob,
            "seq_aux": not self.seq_aux,
            # Equal, the rotary table's own YaRN factor is 1.
            "mscale": self.mscale != self.mscale_all_dim,
        }
        for key, bad in unsupported.items():
            if bad:
                raise ValueError(f"DeepseekV2Config: {key}={getattr(self, key)!r} "
                                 "is not supported (DeepSeek-V2-Lite's is)")
        if not 0 <= self.expert_start < self.expert_start + self.held <= self.n_routed_experts:
            raise ValueError(
                f"DeepseekV2Config: experts {self.expert_start}…"
                f"{self.expert_start + self.held - 1} are not among the "
                f"{self.n_routed_experts} routed experts")

    @property
    def held(self) -> int:
        """Routed experts this model holds."""
        return self.n_routed_experts if self.experts_held is None else self.experts_held

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def shared_ffn_dim(self) -> int:
        return self.n_shared_experts * self.moe_ffn_dim

    @property
    def n_moe_layers(self) -> int:
        return self.n_layers - self.first_k_dense

    @property
    def softmax_scale(self) -> float:
        """YaRN's mscale² / √(q·k width)."""
        return yarn_mscale(self.rope_factor, self.mscale_all_dim) ** 2 / math.sqrt(
            self.qk_head_dim)

    @property
    def aux_weight(self) -> float:
        """The balance loss's weight in the train step's loss."""
        return self.aux_loss_alpha

    @classmethod
    def tiny(cls) -> "DeepseekV2Config":
        """The CPU tests' size: dim 64, 4 heads of 32 + 16 rotary (v 32),
        latent 32, 8 experts top-3 and 2 shared, layer 0 dense and two MoE
        layers."""
        return cls()

    @classmethod
    def v2_lite_share(cls) -> "DeepseekV2Config":
        """DeepSeek-V2-Lite at its published widths and depth (27 layers), as
        one card of an EP8 job holds it: the router over all 64 experts, the
        routed experts 0–7, and an eighth of the vocabulary (12,800 of
        102,400); 2.744 B parameters. Trained at 4.2e-5, where the published
        schedule ends (a tenth of its 4.2e-4 peak) and a continued
        pretraining of the released weights resumes."""
        return cls(
            vocab=12800, dim=2048, n_layers=27, n_heads=16, kv_lora_rank=512,
            qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
            ffn_dim=10944, moe_ffn_dim=1408, n_routed_experts=64,
            n_shared_experts=2, top_k=6, first_k_dense=1, max_seq=4096,
            expert_start=0, experts_held=8, learning_rate=4.2e-5,
        )


def attention_shapes(cfg: DeepseekV2Config) -> dict[str, tuple[int, ...]]:
    """A layer's attention weights and norms, [in, out] matrices."""
    D, H = cfg.dim, cfg.n_heads
    return {
        "attn_norm": (D,),
        "wq": (D, H * cfg.qk_head_dim),
        "wkv_a": (D, cfg.kv_lora_rank + cfg.qk_rope_head_dim),
        "kv_norm": (cfg.kv_lora_rank,),
        "wkv_b": (cfg.kv_lora_rank, H * (cfg.qk_nope_head_dim + cfg.v_head_dim)),
        "wo": (H * cfg.v_head_dim, D),
        "mlp_norm": (D,),
    }


def layer_shapes(cfg: DeepseekV2Config, moe: bool) -> dict[str, tuple[int, ...]]:
    """Every weight of a dense (``moe`` False) or an MoE layer, in order."""
    D, F_, E, Fs = cfg.dim, cfg.moe_ffn_dim, cfg.held, cfg.shared_ffn_dim
    shapes = attention_shapes(cfg)
    if not moe:
        shapes.update(w_gate=(D, cfg.ffn_dim), w_up=(D, cfg.ffn_dim),
                      w_down=(cfg.ffn_dim, D))
        return shapes
    shapes.update(router=(D, cfg.n_routed_experts), w_gate=(E, D, F_),
                  w_up=(E, D, F_), w_down=(E, F_, D), shared_gate=(D, Fs),
                  shared_up=(D, Fs), shared_down=(Fs, D))
    return shapes


def mla(layer: nn.Module, x, freqs, mask, attn_impl=None):
    """A layer's latent attention on the normed input x [B,S,D]."""
    cfg = layer.cfg
    q = _q_proj(x, layer.wq, cfg.dtype, cfg.qk_head_dim)
    q, k, v = _latent(q, x, layer.wkv_a, layer.kv_norm, layer.wkv_b, freqs, cfg)
    out = _mla_core(q, k, v, mask, attn_impl, cfg.softmax_scale)
    return _llama._attn_out(out, layer.wo, cfg.dtype)


@traced("qkv")
def _q_proj(x, wq, dtype, qk_head_dim):
    """x [B,S,D] → q [B,S,H,nope + rope]."""
    B, S, _ = x.shape
    return (x @ cast(wq, dtype)).reshape(B, S, -1, qk_head_dim)


@traced("latent")
def _latent(q, x, wkv_a, kv_norm, wkv_b, freqs, cfg: DeepseekV2Config):
    """q [B,S,H,nope + rope] and x [B,S,D] → (q, k [B,S,H,nope + rope],
    v [B,S,H,v]): the latent and the shared rope key from one product, the
    latent's norm, the up-projection to each head's k_nope and v, RoPE on
    the rope columns, and q and k assembled."""
    B, S, _ = x.shape
    nope, rope, R = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.kv_lora_rank
    latent, k_pe = (x @ cast(wkv_a, cfg.dtype)).split([R, rope], dim=-1)
    kv = rms_norm(latent, kv_norm, cfg.rms_eps) @ cast(wkv_b, cfg.dtype)
    k_nope, v = kv.reshape(B, S, -1, nope + cfg.v_head_dim).split(
        [nope, cfg.v_head_dim], dim=-1)
    H = k_nope.shape[2]
    q_nope, q_pe = q.split([nope, rope], dim=-1)
    q_pe = apply_rope(q_pe, freqs[:S])
    k_pe = apply_rope(k_pe.reshape(B, S, 1, rope), freqs[:S])
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe.expand(B, S, H, rope)], dim=-1)
    return q, k, v


@traced("attn_core")
def _mla_core(q, k, v, mask, attn_impl, scale: float):
    """Causal attention q, k [B,S,H,Dqk], v [B,S,H,Dv] → [B,S,H,Dv],
    scores scaled by ``scale``: on ``attn_impl`` (its call takes q, k, v;
    the flash kernels read the scale from :func:`softmax_scale`), else in
    f32 with the additive ``mask`` and the probabilities in v's dtype, as
    ``models.llama.plain_attention``."""
    if attn_impl is not None:
        with softmax_scale(scale):
            return attn_impl(q, k, v)
    S = q.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    probs = torch.softmax(scores * scale + mask[:S, :S], dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


@traced("router")
def route(x, router, cfg: DeepseekV2Config):
    """x [B,S,D] → (gates [B,S,k] f32, experts [B,S,k], the layer's
    sequence-level balance loss before its weight): an f32 softmax over
    every routed expert, greedy top-k, the chosen probabilities ×
    ``routed_scaling_factor``."""
    probs = torch.softmax(x.float() @ router, dim=-1)
    top, experts = probs.topk(cfg.top_k, dim=-1)
    return top * cfg.routed_scaling_factor, experts, seq_aux_loss(probs, experts)


def seq_aux_loss(probs: torch.Tensor, experts: torch.Tensor) -> torch.Tensor:
    """Σ_i f_i · P_i of each sequence, averaged over the sequences: probs
    [B,S,E], experts [B,S,k]; f_i = E/(k·S) × the count of expert i among
    the sequence's choices (no gradient), P_i the mean of its
    probability."""
    B, S, E = probs.shape
    k = experts.shape[-1]
    picks = experts.reshape(B, S * k)
    counts = probs.new_zeros((B, E)).scatter_add_(1, picks, probs.new_ones(picks.shape))
    return (counts * (E / (k * S)) * probs.mean(dim=1)).sum(dim=1).mean()


#: The dense layers' SwiGLU, and the shared experts' (one SwiGLU of
#: ``n_shared_experts`` × the expert width on every token).
_dense = traced("mlp")(_llama.swiglu)
_shared = traced("shared")(_llama.swiglu)


class Block(nn.Module):
    """One layer: x + mla(norm(x)), then + the dense SwiGLU or DeepSeekMoE
    of norm(x); returns the layer's output and its balance loss (0 for a
    dense layer)."""

    def __init__(self, cfg: DeepseekV2Config, moe: bool, device=None) -> None:
        super().__init__()
        self.cfg, self.moe = cfg, moe
        for name, shape in layer_shapes(cfg, moe).items():
            setattr(self, name, _llama._param(shape, device))

    def moe_mlp(self, x):
        """x [B,S,D] → (shared + the held routed experts' part, the
        balance loss)."""
        cfg = self.cfg
        B, S, D = x.shape
        gates, experts, aux = route(x, self.router, cfg)
        routed = _moe.dropless_experts(
            x.reshape(B * S, D), experts.reshape(B * S, -1),
            gates.reshape(B * S, -1), self.w_gate, self.w_up, self.w_down,
            cfg.expert_start, cfg.dtype)
        out = _shared(x, self.shared_gate, self.shared_up, self.shared_down, cfg.dtype)
        return out + routed.reshape(B, S, D), aux

    @traced("layer")
    def forward(self, h, freqs, mask, attn_impl=None):
        eps = self.cfg.rms_eps
        h = h + mla(self, rms_norm(h, self.attn_norm, eps), freqs, mask, attn_impl)
        x = rms_norm(h, self.mlp_norm, eps)
        if not self.moe:
            out = _dense(x, self.w_gate, self.w_up, self.w_down, self.cfg.dtype)
            return h + out, h.new_zeros((), dtype=torch.float32)
        out, aux = self.moe_mlp(x)
        return h + out, aux


class DeepseekV2(nn.Module):
    """The decoder, on one device (no mesh). Parameters are allocated
    uninitialised: build it with :func:`init_params`."""

    def __init__(self, cfg: DeepseekV2Config, device=None) -> None:
        super().__init__()
        _llama.decoder_params(self, cfg, lambda i: Block(cfg, i >= cfg.first_k_dense,
                                                         device), device)

    def forward(self, tokens: torch.Tensor, attn_impl=None, remat: bool = False):
        """tokens [B, S] → (logits [B, S, vocab] f32, the balance loss f32,
        the mean over the MoE layers). ``remat`` checkpoints each layer,
        routing included."""
        cfg = self.cfg
        return _llama.trunk(self, tokens, attn_impl, remat, freqs=_yarn_table,
                            eps=cfg.rms_eps, aux_layers=max(cfg.n_moe_layers, 1))


def _yarn_table(model: DeepseekV2, seq: int, device) -> torch.Tensor:
    """YaRN's RoPE table of the rope columns, at least ``seq`` rows."""
    cfg = model.cfg
    return yarn_freqs(cfg.qk_rope_head_dim, max(seq, cfg.max_seq), cfg.rope_theta,
                      cfg.rope_factor, cfg.original_max_seq, cfg.beta_fast,
                      cfg.beta_slow, device=device)


def init_params(cfg: DeepseekV2Config, generator: torch.Generator,
                device=None) -> DeepseekV2:
    """A :class:`DeepseekV2` with normal(0.02) f32 weights and ones for the
    norms (``models.llama.init_weights``). ``device`` defaults to the
    generator's device."""
    device = generator.device if device is None else torch.device(device)
    return _llama.init_weights(DeepseekV2(cfg, device), generator)


def from_jax_params(cfg: DeepseekV2Config, tree, device=None) -> DeepseekV2:
    """Refused: the JAX package has no DeepSeek-V2."""
    raise ValueError("DeepSeek-V2 has no JAX counterpart: params must be "
                     "a DeepseekV2 module or None")


def forward_flops(cfg: DeepseekV2Config, batch: int, seq: int) -> float:
    """Matmul FLOPs of one forward, counted as ``flops.forward_flops``
    counts the others (attention at the full S², 2·m·n·k a product): each
    layer's latent attention (q, the kv down- and up-projections, the
    scores at the q·k width, probs·V at the v width, the output), the
    dense layers' SwiGLU, the MoE layers' router, shared experts and the
    held experts' expected share of the top-k (k · held / E a token), and
    the unembed."""
    T, D, H = batch * seq, cfg.dim, cfg.n_heads
    proj = 2 * T * D * H * cfg.qk_head_dim
    proj += 2 * T * D * (cfg.kv_lora_rank + cfg.qk_rope_head_dim)
    proj += 2 * T * cfg.kv_lora_rank * H * (cfg.qk_nope_head_dim + cfg.v_head_dim)
    proj += 2 * T * H * cfg.v_head_dim * D
    attn = 2 * batch * seq * seq * H * (cfg.qk_head_dim + cfg.v_head_dim)
    dense = 6 * T * D * cfg.ffn_dim
    moe = 6 * T * D * cfg.shared_ffn_dim + 2 * T * D * cfg.n_routed_experts
    moe += 6 * T * D * cfg.moe_ffn_dim * cfg.top_k * cfg.held / cfg.n_routed_experts
    layers = cfg.n_layers * (proj + attn) + cfg.first_k_dense * dense
    return float(layers + cfg.n_moe_layers * moe + 2 * T * D * cfg.vocab)


def check(cfg: DeepseekV2Config, *, dp: int = 1, tp: int = 1, sp: int = 1,
          pp: int = 1, ep: int = 1, loss_chunk: int = 0, **_) -> None:
    """DeepSeek-V2 runs on one device, as one card's share of its experts:
    raise for a mesh (its exchange and splits are not written) and for
    ``loss_chunk`` (the dense model's fused unembed)."""
    axes = {"dp": dp, "tp": tp, "sp": sp, "pp": pp, "ep": ep}
    meshed = [f"{axis}={n}" for axis, n in axes.items() if n > 1]
    if meshed:
        raise ValueError(f"DeepSeek-V2 runs on one device; it takes no mesh "
                         f"({', '.join(meshed)})")
    if loss_chunk:
        raise ValueError("loss_chunk fuses the dense model's unembed into the "
                         "loss; it does not compose with DeepSeek-V2")


FAMILY = register(Family(
    name="deepseek_v2", config=DeepseekV2Config,
    presets={"tiny": DeepseekV2Config.tiny,
             "v2-lite-share": DeepseekV2Config.v2_lite_share},
    own_presets=("v2-lite-share",),
    model=DeepseekV2, init_params=init_params, from_jax_params=from_jax_params,
    forward_flops=forward_flops, check=check,
))
