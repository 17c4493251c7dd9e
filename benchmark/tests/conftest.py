"""Shared pieces of the benchmark's tests: tiny cells on the host."""

from __future__ import annotations

import gc

import pytest
import torch

from benchmark import families, spec

#: Limits of the tiny cells, set as a cell's are: above the port's
#: readings and below the float8 control's at this size and seed.
TINY_LIMITS = {
    False: {"loss1_gap": 7e-5, "grad_gap": 3e-3, "change_gap": 2e-3},
    True: {"loss1_gap": 6e-5, "grad_gap": 4e-3, "change_gap": 1.8e-3,
           "proj_gap_median": 5e-2},
}


def tiny_config(moe: bool = False, capacity_factor: float = 2.0) -> dict:
    """A configuration file's keys at a width a CPU run holds: 2 layers,
    dim 128, head_dim 32."""
    config = {"family": "moe" if moe else "llama", "reference": "decoder",
              "vocab_size": 512, "hidden_size": 128, "num_hidden_layers": 2,
              "num_attention_heads": 4, "num_key_value_heads": 2,
              "head_dim": 32, "intermediate_size": 256, "rms_norm_eps": 1e-5,
              "rope_theta": 10000.0}
    if moe:
        config.update(num_local_experts=4, num_experts_per_tok=2,
                      capacity_factor=capacity_factor, router_aux_loss_coef=0.01)
    return config


def tiny_cell(moe: bool = False, capacity_factor: float = 2.0) -> spec.Cell:
    """A cell of :func:`tiny_config`: 4 rows of 64 tokens in 2 chunks, or
    for the MoE 8 rows of 128 (fewer tokens and a routing flip from
    rounding outweighs the control's float8)."""
    rows, seq = (8, 128) if moe else (4, 64)
    config = tiny_config(moe, capacity_factor)
    m = families.load(config["family"]).sizes(config)
    return spec.Cell(
        name="tiny", chips=1, model=m, config=config, reference="decoder",
        seq=seq, tokens_per_step=rows * seq, pool=4, micro_batch=rows // 2,
        grad_accum=2, attn="flash", remat=True,
        loss_chunk=0 if moe else 32, mesh=None, limits=dict(TINY_LIMITS[moe]),
        end_to_end=(), per_layer=())


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided here, at run time).
    Afterwards the test's cached blocks go back to the card, so that a
    later test's run in a process of its own finds the card's memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    yield "cuda:0"
    gc.collect()
    torch.cuda.empty_cache()
