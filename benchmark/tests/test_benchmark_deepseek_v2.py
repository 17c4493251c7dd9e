"""The DeepSeek-V2 family on the host, after ``test_benchmark_new_family.py``:
its module loads by the configuration's ``family``, its weights are the
port's parameters by name and shape, and a toy cell of its configuration
(every key of ``configs/deepseek-v2-lite.json``, the widths cut to a CPU's
size, 4 of 8 routed experts held from the third on) runs through
``cellrun.measure`` and compares as correct with its reference, while the
float8 control fails the toy's limits. The MLA rooflines' counts and the
span readers are checked on made-up records.

The toy's limits sit between the port's readings (bf16 products on the
host) and the control's at this size and seed, as a cell's do: port
loss1 4.4e-6, grad 2.2e-3, change 1.2e-3, proj median 8.7e-3; control
1.6e-5, 1.8e-2, 4.6e-3, 9.0e-2.
"""

from __future__ import annotations

import dataclasses
import json
import math
import time

import pytest

from benchmark import cellrun, compare, families, mla_work, spec
from benchmark.program import Program
from benchmark.run import read_metric

SEED = 2**33 + 5

LIMITS = {"loss1_gap": 9e-6, "grad_gap": 6e-3, "change_gap": 2.5e-3,
          "proj_gap_median": 3e-2}


def toy_config() -> dict:
    config = json.loads((spec.HERE / "configs" / "deepseek-v2-lite.json").read_text())
    config.update(vocab_size=512, hidden_size=64, num_hidden_layers=3,
                  num_attention_heads=4, num_key_value_heads=4, kv_lora_rank=32,
                  qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
                  intermediate_size=128, moe_intermediate_size=32,
                  n_routed_experts=4, num_experts_per_tok=3)
    config["expert_share"] = {"router_width": 8, "expert_start": 2}
    return config


def toy_cell() -> spec.Cell:
    config = toy_config()
    rows, seq = 8, 128
    return spec.Cell(
        name="toy", chips=1, model=families.load("deepseek_v2").sizes(config),
        config=config, reference="deepseek_v2", seq=seq,
        tokens_per_step=rows * seq, pool=4, micro_batch=rows // 2, grad_accum=2,
        attn="flash", remat=True, loss_chunk=0, mesh=None, limits=dict(LIMITS),
        end_to_end=(), per_layer=())


def test_the_cell_loads_its_family_and_published_widths():
    cell = spec.load_cell("deepseek-v2-lite.s4096")
    m = cell.model
    assert families.of(m).__name__ == "benchmark.families.deepseek_v2"
    assert (m.dim, m.n_heads, m.qk_head, m.v_head, m.kv_lora_rank, m.qk_rope,
            m.ffn, m.moe_ffn, m.shared_ffn, m.top_k) == (
        2048, 16, 192, 128, 512, 64, 10944, 1408, 2816, 6)
    # All 27 layers; one EP8 card's share: routed experts 0-7 of 64.
    assert (m.n_layers, m.n_routed, m.held, m.expert_start, m.vocab) == (27, 64, 8, 0, 12800)
    assert m.aux_alpha == 0.001 and m.routed_scale == 1.0 and m.first_dense == 1
    # AdamW at the published schedule's last rate, in the program and the
    # reference alike.
    assert m.lr == 4.2e-5
    prog_cfg = families.of(m).port_model(
        dataclasses.replace(m, n_layers=2, vocab=64), 16, "meta").cfg
    assert prog_cfg.learning_rate == 4.2e-5
    assert set(cell.config["reduced"]) == {"n_routed_experts", "vocab_size"}
    assert cell.config["reduced"]["n_routed_experts"]["published"] == 64
    assert cell.config["reduced"]["vocab_size"]["published"] == 102400
    shapes = families.of(m).param_shapes(m)
    assert sum(math.prod(s) for s in shapes.values()) == cell.config["parameters"] == 2_743_987_712
    assert {m["name"] for m in cell.per_layer} >= {
        "mla_fwd_roofline", "mla_bwd_roofline", "latent_ms_per_step",
        "permute_ms_per_step"}


def test_param_shapes_are_the_port_s_parameters():
    cell = toy_cell()
    prog = Program(cell, SEED, "cpu")
    have = {n: tuple(p.shape) for n, p in prog.params.items()}
    assert have == families.of(cell.model).param_shapes(cell.model)
    assert have["blocks.1.w_gate"] == (4, 64, 32) and have["blocks.1.router"] == (64, 8)
    prog.close()


def test_a_toy_cell_is_correct_and_the_control_is_not():
    cell = toy_cell()
    run = cellrun.measure(cell, SEED, 0.1, False, "cpu", time.perf_counter())
    assert run["correct"], {k: run["numbers"][k] for k in cell.limits}
    assert run["record"]["window"]["steps"] >= 1
    ref = cellrun.reference_readings(cell, SEED, "cpu")
    control = cellrun.reference_readings(cell, SEED, "cpu", fp8=True)
    numbers = compare.readings(control, ref)
    assert not compare.decide(numbers, cell.limits)
    assert all(numbers[k] > limit for k, limit in cell.limits.items())


def test_flops_of_one_step():
    cell = toy_cell()
    m, B, S = cell.model, 8, 128
    T, pairs = B * S, S * (S + 1) // 2
    proj = 2 * T * (64 * 4 * 48 + 64 * 48 + 32 * 4 * 64 + 4 * 32 * 64)
    core = 2 * B * 4 * pairs * (48 + 32)
    dense = 6 * T * 64 * 128
    moe = 2 * T * 64 * 8 + 6 * T * 64 * 64 + 6 * T * 64 * 32 * 3 * 4 / 8
    want = 3.0 * (3 * (proj + core) + dense + 2 * moe + 2 * T * 64 * 512)
    assert families.of(m).train_flops_per_step(m, B, S) == pytest.approx(want, rel=1e-12)
    assert families.of(m).attn_shape(m, 4, S) is None


def test_the_mla_rooflines_count_the_true_widths():
    rec = {"config": toy_config(), "micro_batch": 2, "seq": 128,
           "peak_flops": 1e12, "peak_bytes": 1e12,
           "trace": {"attention": {"fwd": {"calls": 6, "seconds": 0.5},
                                   "bwd": {"calls": 3, "seconds": 0.5}}}}
    dims = mla_work.shape(rec)
    assert dims == {"B": 2, "H": 4, "S": 128, "Dqk": 48, "Dv": 32}
    pairs = 128 * 129 // 2
    fwd = 2 * 2 * 4 * pairs * (48 + 32)
    bwd = 2 * 2 * 4 * pairs * (3 * 48 + 2 * 32)
    assert mla_work.fwd_work(**dims)[0] == fwd and mla_work.bwd_work(**dims)[0] == bwd
    assert mla_work.fwd_work(**dims)[1] == 2 * 2 * 128 * 4 * (2 * 48 + 2 * 32) + 4 * 2 * 4 * 128
    assert read_metric("mla_fwd_roofline", rec) == pytest.approx(
        100 * 6 * max(fwd, mla_work.fwd_work(**dims)[1]) / 1e12 / 0.5)
    assert read_metric("mla_bwd_roofline", rec) == pytest.approx(
        100 * 3 * max(bwd, mla_work.bwd_work(**dims)[1]) / 1e12 / 0.5)
    # Another family's record, or no trace: nothing to read.
    other = dataclasses.replace(spec.load_cell("mistral-7b.s4096"))
    assert read_metric("mla_fwd_roofline", {**rec, "config": other.config}) is None
    assert read_metric("mla_bwd_roofline", {**rec, "trace": None}) is None


def test_the_span_readers_read_their_spans():
    table = {"steps": 2, "spans": {
        "latent": {"calls": 4, "device_s": 0.01, "by_class_s": {}},
        "latent.bwd": {"calls": 2, "device_s": 0.03, "by_class_s": {}},
        "permute": {"calls": 4, "device_s": 0.002, "by_class_s": {}},
        "unpermute.bwd": {"calls": 2, "device_s": 0.004, "by_class_s": {}},
        "experts": {"calls": 4, "device_s": 0.5, "by_class_s": {}}}}
    rec = {"trace": {"program": table}}
    assert read_metric("latent_ms_per_step", rec) == pytest.approx(20.0)
    assert read_metric("permute_ms_per_step", rec) == pytest.approx(3.0)
    # A parent's record without these spans, or no trace: nothing.
    bare = {"trace": {"program": {"steps": 2, "spans": {}}}}
    assert read_metric("latent_ms_per_step", bare) is None
    assert read_metric("permute_ms_per_step", {"trace": None}) is None
