"""The mixture of experts (Mixtral): the port's ``models.moe.Moe``.

The dense trunk (``llama.py``) with, in every layer, a router and banks
of SwiGLU experts in place of the one SwiGLU, under the port's static
capacity and GShard's load-balancing loss.
"""

from __future__ import annotations

from benchmark.families import llama
from benchmark.families.llama import Model


def sizes(config: dict) -> Model:
    return Model(
        **llama.trunk(config),
        n_experts=config["num_local_experts"],
        top_k=config["num_experts_per_tok"],
        capacity_factor=float(config["capacity_factor"]),
        aux_coef=float(config["router_aux_loss_coef"]),
    )


def port_model(m: Model, seq: int, device):
    from tpumon.workload_torch.models.moe import Moe, MoeConfig

    cfg = MoeConfig(**llama.port_fields(m, seq), n_experts=m.n_experts,
                    top_k=m.top_k, capacity_factor=m.capacity_factor)
    return Moe(llama.check_head_dim(cfg, m), device)


def param_shapes(m: Model) -> dict[str, tuple[int, ...]]:
    """Expert banks [E, in, out]."""
    D, F, E = m.dim, m.ffn, m.n_experts
    layer = llama.attention_shapes(m)
    layer.update(router=(D, E), w_gate=(E, D, F), w_up=(E, D, F),
                 w_down=(E, F, D))
    return llama.decoder_shapes(m, layer)


def forward_flops(m: Model, batch: int, seq: int) -> float:
    """The top-k experts' products and the router only: no capacity
    padding, no dispatch or combine products."""
    tokens = batch * seq
    ffn = 6 * tokens * m.dim * m.ffn * m.top_k + 2 * tokens * m.dim * m.n_experts
    return llama.decoder_flops(m, batch, seq, ffn)


def train_flops_per_step(m: Model, batch: int, seq: int) -> float:
    return 3.0 * forward_flops(m, batch, seq)


attn_shape = llama.attn_shape
