"""Model FLOPs of one optimizer step: the frozen count ``step_mfu_pct``
reads.

Copied from the port's ``flops.py`` with three changes: causal attention
counts the S(S+1)/2 query-key pairs its inputs need, not S²; the MoE
counts the top-k experts' products and the router only, with no
capacity padding and no dispatch or combine products; nothing
recomputed is counted (backward = 2× forward, whatever remat runs).
2·m·n·k a product.
"""

from __future__ import annotations


def causal_pairs(seq: int) -> int:
    """Query-key pairs of causal attention over ``seq`` positions."""
    return seq * (seq + 1) // 2


def forward_flops(m, batch: int, seq: int) -> float:
    """Matmul FLOPs of one forward of ``batch`` sequences of ``seq``
    tokens through model ``m`` (``spec.Model``)."""
    B, S, D = batch, seq, m.dim
    H, KV, HD = m.n_heads, m.n_kv_heads, m.head_dim
    qkvo = 2 * B * S * D * (H * HD) * 2 + 2 * B * S * D * (KV * HD) * 2
    attn = 2 * 2 * B * H * HD * causal_pairs(S)  # scores and probs·V
    if m.moe:
        ffn = 6 * B * S * D * m.ffn * m.top_k + 2 * B * S * D * m.n_experts
    else:
        ffn = 6 * B * S * D * m.ffn
    unembed = 2 * B * S * D * m.vocab
    return float(m.n_layers * (qkvo + attn + ffn) + unembed)


def train_flops_per_step(m, batch: int, seq: int) -> float:
    """Forward and backward (2× the forward) of one optimizer step."""
    return 3.0 * forward_flops(m, batch, seq)
