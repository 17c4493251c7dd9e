"""The dense decoder (Llama, Mistral): the port's ``models.llama.Llama``.

Every layer alike: RMSNorm, grouped-query attention with RoPE, RMSNorm,
SwiGLU. The MoE family (``moe.py``) shares the trunk and these sizes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from benchmark.flops import causal_pairs


@dataclass(frozen=True)
class Model:
    """The sizes the program and the reference share, from a config file;
    the MoE family fills the expert fields."""
    family: str
    vocab: int
    dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    ffn: int
    eps: float
    rope_theta: float
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 0.0
    aux_coef: float = 0.0

    @property
    def moe(self) -> bool:
        return self.n_experts > 0

    def capacity(self, seq: int) -> int:
        """Token slots an expert takes from one sequence (the port's static
        capacity: ⌈k·S·factor / E⌉)."""
        return max(1, math.ceil(self.top_k * seq * self.capacity_factor
                                / self.n_experts))


def trunk(config: dict) -> dict:
    """The fields of :class:`Model` that every decoder's file gives."""
    dim, heads = config["hidden_size"], config["num_attention_heads"]
    return dict(
        family=config["family"],
        vocab=config["vocab_size"],
        dim=dim,
        n_layers=config["num_hidden_layers"],
        n_heads=heads,
        n_kv_heads=config["num_key_value_heads"],
        head_dim=config.get("head_dim") or dim // heads,
        ffn=config["intermediate_size"],
        eps=float(config["rms_norm_eps"]),
        rope_theta=float(config["rope_theta"]),
    )


def sizes(config: dict) -> Model:
    return Model(**trunk(config))


def port_fields(m: Model, seq: int) -> dict:
    """The port config's fields that both decoders share."""
    return dict(vocab=m.vocab, dim=m.dim, n_layers=m.n_layers,
                n_heads=m.n_heads, n_kv_heads=m.n_kv_heads, ffn_dim=m.ffn,
                max_seq=seq, dtype=torch.bfloat16)


def check_head_dim(cfg, m: Model):
    """``cfg``, once its derived head_dim is the configuration's."""
    if cfg.head_dim != m.head_dim:
        raise ValueError(f"the port derives head_dim {cfg.head_dim}, the "
                         f"configuration states {m.head_dim}")
    return cfg


def port_model(m: Model, seq: int, device):
    from tpumon.workload_torch.models.llama import Llama, LlamaConfig

    return Llama(check_head_dim(LlamaConfig(**port_fields(m, seq)), m), device)


def attention_shapes(m: Model) -> dict[str, tuple[int, ...]]:
    """A layer's norm and attention weights, [in, out] matrices."""
    D, HD = m.dim, m.head_dim
    return {
        "attn_norm": (D,),
        "wq": (D, m.n_heads * HD),
        "wk": (D, m.n_kv_heads * HD),
        "wv": (D, m.n_kv_heads * HD),
        "wo": (m.n_heads * HD, D),
        "mlp_norm": (D,),
    }


def decoder_shapes(m: Model, layer: dict) -> dict[str, tuple[int, ...]]:
    """The embedding, ``layer``'s weights in every layer, the final norm
    and the unembedding, in the order of the flat weights."""
    shapes = {"embed": (m.vocab, m.dim)}
    for i in range(m.n_layers):
        shapes.update({f"blocks.{i}.{k}": s for k, s in layer.items()})
    shapes.update(final_norm=(m.dim,), unembed=(m.dim, m.vocab))
    return shapes


def param_shapes(m: Model) -> dict[str, tuple[int, ...]]:
    D, F = m.dim, m.ffn
    layer = attention_shapes(m)
    layer.update(w_gate=(D, F), w_up=(D, F), w_down=(F, D))
    return decoder_shapes(m, layer)


def decoder_flops(m: Model, batch: int, seq: int, ffn: int) -> float:
    """Matmul FLOPs of one forward of ``batch`` sequences of ``seq``
    tokens: every layer's projections, causal attention and ``ffn``
    FLOPs of feed-forward, then the unembedding. 2·m·n·k a product."""
    B, S, D = batch, seq, m.dim
    H, KV, HD = m.n_heads, m.n_kv_heads, m.head_dim
    qkvo = 2 * B * S * D * (H * HD) * 2 + 2 * B * S * D * (KV * HD) * 2
    attn = 2 * 2 * B * H * HD * causal_pairs(S)  # scores and probs·V
    unembed = 2 * B * S * D * m.vocab
    return float(m.n_layers * (qkvo + attn + ffn) + unembed)


def forward_flops(m: Model, batch: int, seq: int) -> float:
    return decoder_flops(m, batch, seq, 6 * batch * seq * m.dim * m.ffn)


def train_flops_per_step(m: Model, batch: int, seq: int) -> float:
    """Forward and backward (2× the forward) of one optimizer step."""
    return 3.0 * forward_flops(m, batch, seq)


def attn_shape(m: Model, micro_batch: int, seq: int) -> dict:
    return {"B": micro_batch, "H": m.n_heads, "KV": m.n_kv_heads, "S": seq,
            "D": m.head_dim}
