"""DeepSeek-V2 (DeepSeek-V2-Lite): the port's ``models.deepseek_v2.DeepseekV2``.

Multi-head latent attention in every layer (q·k width nope + rope, v
width ``v_head_dim``, a latent of ``kv_lora_rank`` with its RMSNorm, one
rope key shared by the heads, YaRN); the first ``first_k_dense_replace``
layers end in a dense SwiGLU, the others in DeepSeekMoE: a softmax router
over every routed expert, greedy top-k with gates not renormalised, the
shared experts, and the routed experts this card holds.

A configuration holds every routed expert, or, with ``expert_share``, a
card's share of them: ``n_routed_experts`` then counts the experts held
here (a key in ``reduced``), ``expert_share`` the router's width (the
published count) and the first expert held. ``learning_rate`` is AdamW's
(the port's 1e-3 when absent), for the program and the reference alike.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from benchmark.flops import causal_pairs


@dataclass(frozen=True)
class Sizes:
    """The sizes the program and the reference share, from a config file."""
    family: str
    vocab: int
    dim: int
    n_layers: int
    n_heads: int
    kv_lora_rank: int
    qk_nope: int
    qk_rope: int
    v_head: int
    ffn: int  # the dense layers' SwiGLU
    moe_ffn: int  # an expert's SwiGLU
    n_routed: int  # the router's width: every routed expert
    held: int  # routed experts held here
    expert_start: int
    n_shared: int
    top_k: int
    first_dense: int
    routed_scale: float
    aux_alpha: float
    eps: float
    rope_theta: float
    rope_factor: float
    original_max: int
    beta_fast: float
    beta_slow: float
    mscale_all_dim: float
    lr: float  # AdamW's learning rate

    @property
    def qk_head(self) -> int:
        return self.qk_nope + self.qk_rope

    @property
    def shared_ffn(self) -> int:
        return self.n_shared * self.moe_ffn


def sizes(config: dict) -> Sizes:
    rope = config["rope_scaling"]
    if rope["type"] != "yarn" or rope["mscale"] != rope["mscale_all_dim"]:
        raise ValueError("families/deepseek_v2.py: rope_scaling must be YaRN "
                         "with mscale equal to mscale_all_dim")
    share = config.get("expert_share", {})
    return Sizes(
        family=config["family"],
        vocab=config["vocab_size"],
        dim=config["hidden_size"],
        n_layers=config["num_hidden_layers"],
        n_heads=config["num_attention_heads"],
        kv_lora_rank=config["kv_lora_rank"],
        qk_nope=config["qk_nope_head_dim"],
        qk_rope=config["qk_rope_head_dim"],
        v_head=config["v_head_dim"],
        ffn=config["intermediate_size"],
        moe_ffn=config["moe_intermediate_size"],
        n_routed=share.get("router_width", config["n_routed_experts"]),
        held=config["n_routed_experts"],
        expert_start=share.get("expert_start", 0),
        n_shared=config["n_shared_experts"],
        top_k=config["num_experts_per_tok"],
        first_dense=config["first_k_dense_replace"],
        routed_scale=float(config["routed_scaling_factor"]),
        aux_alpha=float(config["aux_loss_alpha"]),
        eps=float(config["rms_norm_eps"]),
        rope_theta=float(config["rope_theta"]),
        rope_factor=float(rope["factor"]),
        original_max=int(rope["original_max_position_embeddings"]),
        beta_fast=float(rope["beta_fast"]),
        beta_slow=float(rope["beta_slow"]),
        mscale_all_dim=float(rope["mscale_all_dim"]),
        lr=float(config.get("learning_rate", 1e-3)),
    )


def port_model(m: Sizes, seq: int, device):
    from tpumon.workload_torch.models.deepseek_v2 import DeepseekV2, DeepseekV2Config

    cfg = DeepseekV2Config(
        vocab=m.vocab, dim=m.dim, n_layers=m.n_layers, n_heads=m.n_heads,
        kv_lora_rank=m.kv_lora_rank, qk_nope_head_dim=m.qk_nope,
        qk_rope_head_dim=m.qk_rope, v_head_dim=m.v_head, ffn_dim=m.ffn,
        moe_ffn_dim=m.moe_ffn, n_routed_experts=m.n_routed,
        n_shared_experts=m.n_shared, top_k=m.top_k, first_k_dense=m.first_dense,
        routed_scaling_factor=m.routed_scale, aux_loss_alpha=m.aux_alpha,
        rms_eps=m.eps, rope_theta=m.rope_theta, rope_factor=m.rope_factor,
        original_max_seq=m.original_max, beta_fast=m.beta_fast,
        beta_slow=m.beta_slow, mscale=m.mscale_all_dim,
        mscale_all_dim=m.mscale_all_dim, max_seq=seq,
        expert_start=m.expert_start, experts_held=m.held, learning_rate=m.lr,
        dtype=torch.bfloat16)
    return DeepseekV2(cfg, device)


def layer_shapes(m: Sizes, moe: bool) -> dict[str, tuple[int, ...]]:
    """One layer's weights, [in, out] matrices, expert banks [E', in, out]."""
    D, H = m.dim, m.n_heads
    shapes = {
        "attn_norm": (D,),
        "wq": (D, H * m.qk_head),
        "wkv_a": (D, m.kv_lora_rank + m.qk_rope),
        "kv_norm": (m.kv_lora_rank,),
        "wkv_b": (m.kv_lora_rank, H * (m.qk_nope + m.v_head)),
        "wo": (H * m.v_head, D),
        "mlp_norm": (D,),
    }
    if not moe:
        shapes.update(w_gate=(D, m.ffn), w_up=(D, m.ffn), w_down=(m.ffn, D))
        return shapes
    E, F, Fs = m.held, m.moe_ffn, m.shared_ffn
    shapes.update(router=(D, m.n_routed), w_gate=(E, D, F), w_up=(E, D, F),
                  w_down=(E, F, D), shared_gate=(D, Fs), shared_up=(D, Fs),
                  shared_down=(Fs, D))
    return shapes


def param_shapes(m: Sizes) -> dict[str, tuple[int, ...]]:
    shapes = {"embed": (m.vocab, m.dim)}
    for i in range(m.n_layers):
        layer = layer_shapes(m, moe=i >= m.first_dense)
        shapes.update({f"blocks.{i}.{k}": s for k, s in layer.items()})
    shapes.update(final_norm=(m.dim,), unembed=(m.dim, m.vocab))
    return shapes


def forward_flops(m: Sizes, batch: int, seq: int) -> float:
    """Matmul FLOPs of one forward, 2·m·n·k a product at the true widths:
    each layer's latent attention (q, the kv down- and up-projections, the
    output) and its causal core (scores at the q·k width, probs·V at the v
    width, over the S(S+1)/2 pairs); the dense layers' SwiGLU; each MoE
    layer's router, shared experts and the held experts' expected share
    of the top-k (k · held / E a token, no padding); the unembed."""
    T, D, H = batch * seq, m.dim, m.n_heads
    proj = 2 * T * D * H * m.qk_head + 2 * T * D * (m.kv_lora_rank + m.qk_rope)
    proj += 2 * T * m.kv_lora_rank * H * (m.qk_nope + m.v_head)
    proj += 2 * T * H * m.v_head * D
    core = 2 * batch * H * causal_pairs(seq) * (m.qk_head + m.v_head)
    dense = 6 * T * D * m.ffn
    moe = 2 * T * D * m.n_routed + 6 * T * D * m.shared_ffn
    moe += 6 * T * D * m.moe_ffn * m.top_k * m.held / m.n_routed
    n_moe = m.n_layers - m.first_dense
    return float(m.n_layers * (proj + core) + m.first_dense * dense
                 + n_moe * moe + 2 * T * D * m.vocab)


def train_flops_per_step(m: Sizes, batch: int, seq: int) -> float:
    """Forward and backward (2× the forward) of one optimizer step."""
    return 3.0 * forward_flops(m, batch, seq)


def attn_shape(m: Sizes, micro_batch: int, seq: int) -> None:
    """None: the flash rooflines' shape has one head width; the MLA
    rooflines (``metrics/mla_*_roofline.py``) count from the record's
    configuration."""
    return None
