"""The MiMo-V2 family on the host, after ``test_benchmark_deepseek_v2.py``:
its module loads by the configuration's ``family``, its weights are the
port's parameters by name and shape, and a toy cell of its configuration
(every key of ``configs/mimo-v2-flash.json``, the widths cut to a CPU's
size: 4 layers, the dense full layer 0, two window layers of 16 keys
with sinks, a full MoE layer; 4 of 8 routed experts held from the third
on) runs through
``cellrun.measure`` and compares as correct with its reference, while
the float8 control fails the toy's limits. The window's pairs, the
hybrid rooflines' counts and the span readers are checked on made-up
records.

The toy's limits sit between the port's readings (bf16 products on the
host) and the control's at this size and seed, as a cell's do: port
loss1 5.3e-6, grad 3.0e-3, change 2.5e-3, proj median 9.3e-3; control
1.9e-4, 9.4e-3, 6.3e-3, 0.10.
"""

from __future__ import annotations

import dataclasses
import json
import math
import time

import pytest

from benchmark import cellrun, compare, families, hybrid_work, spec
from benchmark.program import Program
from benchmark.run import read_metric

SEED = 2**33 + 7

LIMITS = {"loss1_gap": 2e-5, "grad_gap": 6e-3, "change_gap": 4e-3,
          "proj_gap_median": 4e-2}


def toy_config() -> dict:
    config = json.loads((spec.HERE / "configs" / "mimo-v2-flash.json").read_text())
    config.update(vocab_size=512, hidden_size=64, num_hidden_layers=4,
                  num_attention_heads=4, swa_num_attention_heads=4,
                  num_key_value_heads=1, swa_num_key_value_heads=2,
                  head_dim=48, swa_head_dim=48, v_head_dim=32, swa_v_head_dim=32,
                  sliding_window=16, sliding_window_size=16,
                  intermediate_size=128, moe_intermediate_size=32,
                  n_routed_experts=4, num_experts_per_tok=3,
                  layers_run=[0, 6, 7, 11], learning_rate=1e-3)
    config["expert_share"] = {"router_width": 8, "expert_start": 2}
    return config


def toy_cell(limits=LIMITS) -> spec.Cell:
    config = toy_config()
    rows, seq = 8, 64
    return spec.Cell(
        name="toy", chips=1, model=families.load("mimo_v2").sizes(config),
        config=config, reference="mimo_v2", seq=seq,
        tokens_per_step=rows * seq, pool=4, micro_batch=rows // 2, grad_accum=2,
        attn="flash", remat=True, loss_chunk=0, mesh=None, limits=dict(limits),
        end_to_end=(), per_layer=())


def test_the_cell_loads_its_family_and_published_widths():
    cell = spec.load_cell("mimo-v2-flash.s32768")
    m = cell.model
    assert families.of(m).__name__ == "benchmark.families.mimo_v2"
    assert (m.dim, m.n_heads, m.kv_full, m.kv_swa, m.qk_head, m.v_head, m.rotary,
            m.window, m.ffn, m.moe_ffn, m.top_k) == (
        4096, 64, 4, 8, 192, 128, 64, 128, 16384, 2048, 8)
    # Layer 0 and one period (published layers 6-11): 5 window layers and
    # a full one, all MoE; one EP32 card's share: experts 0-7 of 256.
    assert m.layer_types == (0, 1, 1, 1, 1, 1, 0)
    assert m.moe_layers == (0, 1, 1, 1, 1, 1, 1)
    assert (m.n_routed, m.held, m.expert_start, m.vocab) == (256, 8, 0, 19072)
    assert (m.theta_full, m.theta_swa, m.value_scale) == (5e6, 1e4, 0.707)
    assert m.gamma == 1e-3 and m.has_sink(1) and not m.has_sink(0)
    assert m.lr == 2.2e-5
    prog_cfg = families.of(m).port_model(dataclasses.replace(m, vocab=64), 16,
                                         "meta").cfg
    assert prog_cfg.learning_rate == 2.2e-5 and prog_cfg.bias_update_rate == 1e-3
    assert set(cell.config["reduced"]) == {"num_hidden_layers", "n_routed_experts",
                                           "vocab_size"}
    assert len(cell.config["hybrid_layer_pattern"]) == 48
    shapes = families.of(m).param_shapes(m)
    assert sum(math.prod(s) for s in shapes.values()) == cell.config["parameters"] == 2_221_994_304
    assert cell.seq == 32768 and cell.batch == 2
    assert {m["name"] for m in cell.per_layer} >= {
        "swa_ms_per_step", "swa_roofline", "hybrid_fwd_roofline",
        "hybrid_bwd_roofline", "step_mfu_pct", "device_idle_pct"}


def test_param_shapes_are_the_port_s_parameters():
    cell = toy_cell()
    prog = Program(cell, SEED, "cpu")
    have = {n: tuple(p.shape) for n, p in prog.params.items()}
    assert have == families.of(cell.model).param_shapes(cell.model)
    assert have["blocks.1.sinks"] == (4,) and "blocks.0.sinks" not in have
    assert have["blocks.1.wk"] == (64, 2 * 48) and have["blocks.0.wk"] == (64, 48)
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


@pytest.mark.parametrize("seq,window", [(1, 1), (5, 1), (5, 3), (64, 16),
                                        (64, 64), (64, 100), (300, 128)])
def test_window_pairs_count_the_live_pairs(seq, window):
    brute = sum(1 for i in range(seq) for j in range(seq) if i - window < j <= i)
    assert hybrid_work.window_pairs(seq, window) == brute
    assert families.load("mimo_v2").window_pairs(seq, window) == brute


def test_flops_of_one_step():
    cell = toy_cell()
    m, B, S = cell.model, 8, 64
    T = B * S
    full, swa = S * (S + 1) // 2, hybrid_work.window_pairs(S, 16)
    assert swa == 16 * 17 // 2 + 48 * 16
    proj = {1: 2 * T * 64 * (4 * 48 + 1 * 80) + 2 * T * 4 * 32 * 64,
            2: 2 * T * 64 * (4 * 48 + 2 * 80) + 2 * T * 4 * 32 * 64}
    core = {1: 2 * B * 4 * full * 80, 2: 2 * B * 4 * swa * 80}
    moe = 2 * T * 64 * 8 + 6 * T * 64 * 32 * 3 * 4 / 8
    dense = 6 * T * 64 * 128
    # layers_run [0, 6, 7, 11]: full and dense, window, window, full; the
    # last three MoE.
    want = 3.0 * (2 * (proj[1] + core[1]) + 2 * (proj[2] + core[2]) + dense
                  + 3 * moe + 2 * T * 64 * 512)
    assert families.of(m).train_flops_per_step(m, B, S) == pytest.approx(want, rel=1e-12)
    assert families.of(m).attn_shape(m, 4, S) is None


def _record(calls_full=(4, 2), calls_swa=(8, 4), seconds=(0.5, 0.5)):
    spans = {"attn_core": {"calls": calls_full[0], "device_s": 0.1},
             "attn_core.bwd": {"calls": calls_full[1], "device_s": 0.2},
             "swa_core": {"calls": calls_swa[0], "device_s": 0.01},
             "swa_core.bwd": {"calls": calls_swa[1], "device_s": 0.03}}
    attn = {"fwd": {"calls": calls_full[0] + calls_swa[0], "seconds": seconds[0]},
            "bwd": {"calls": calls_full[1] + calls_swa[1], "seconds": seconds[1]}}
    return {"config": toy_config(), "micro_batch": 2, "seq": 64,
            "peak_flops": 1e12, "peak_bytes": 1e12,
            "trace": {"attention": attn, "program": {"steps": 2, "spans": spans}}}


def test_the_hybrid_rooflines_count_each_kind_at_its_pairs():
    rec = _record()
    kinds = hybrid_work.kinds(rec)
    full, swa = 64 * 65 // 2, hybrid_work.window_pairs(64, 16)
    assert kinds == {"full": (2, 4, 1, 64, 48, 32, full),
                     "swa": (2, 4, 2, 64, 48, 32, swa)}
    fwd = {k: hybrid_work.fwd_work(*v) for k, v in kinds.items()}
    bwd = {k: hybrid_work.bwd_work(*v) for k, v in kinds.items()}
    assert fwd["swa"][0] == 2 * 2 * 4 * swa * 80
    assert bwd["full"][0] == 2 * 2 * 4 * full * (3 * 48 + 2 * 32)
    assert fwd["full"][1] == 2 * 2 * 64 * (4 * 80 + 1 * 80) + 4 * 2 * 4 * 64
    assert bwd["swa"][1] == 2 * 2 * 64 * (4 * 160 + 2 * 2 * 80) + 8 * 2 * 4 * 64

    def least(work):
        return max(work) / 1e12

    assert read_metric("hybrid_fwd_roofline", rec) == pytest.approx(
        100 * (4 * least(fwd["full"]) + 8 * least(fwd["swa"])) / 0.5)
    assert read_metric("hybrid_bwd_roofline", rec) == pytest.approx(
        100 * (2 * least(bwd["full"]) + 4 * least(bwd["swa"])) / 0.5)
    assert read_metric("swa_roofline", rec) == pytest.approx(
        100 * (8 * least(fwd["swa"]) + 4 * least(bwd["swa"])) / 0.04)
    # A window call counted at causal pairs reads higher: the pairs matter.
    assert fwd["swa"][0] < hybrid_work.fwd_work(*kinds["full"][:6], full)[0]


def test_the_hybrid_readers_read_nothing_elsewhere():
    rec = _record()
    # The span table's calls do not add up to the benchmark's own count.
    rec["trace"]["attention"]["fwd"]["calls"] += 1
    assert read_metric("hybrid_fwd_roofline", rec) is None
    other = spec.load_cell("mistral-7b.s4096")
    for name in ("hybrid_fwd_roofline", "hybrid_bwd_roofline", "swa_roofline"):
        assert read_metric(name, {**_record(), "config": other.config}) is None
        assert read_metric(name, {**_record(), "trace": None}) is None
    bare = _record()
    bare["trace"]["program"] = {"steps": 2, "spans": {}}
    assert read_metric("swa_roofline", bare) is None


def test_the_swa_span_reader_reads_its_spans():
    rec = _record()
    assert read_metric("swa_ms_per_step", rec) == pytest.approx(20.0)
    assert read_metric("swa_ms_per_step", {"trace": {"program": {
        "steps": 2, "spans": {}}}}) is None
    assert read_metric("swa_ms_per_step", {"trace": None}) is None


def test_the_reference_s_query_blocks_leave_its_loss_and_gradients_alone(monkeypatch):
    """The reference's attention in blocks of 7 query rows (window layers
    then span blocks, full layers many) against one block a sequence:
    the loss and every gradient agree to float32's rounding."""
    import torch

    from benchmark.reference import mimo_v2 as ref
    from benchmark.reference.decoder import Precision

    cell = toy_cell()
    m = cell.model
    batch = torch.randint(0, m.vocab, (2, 41), generator=torch.Generator().manual_seed(2))
    results = []
    for rows in (ref.QUERY_BLOCK, 7):
        monkeypatch.setattr(ref, "QUERY_BLOCK", rows)
        f = ref.MimoFollower(m, SEED, "cpu", Precision())
        loss = f.step(batch, 1, 1)
        results.append((loss, f.grad.clone(),
                        {i: load.clone() for i, load in f.load.items()}))
    (loss_a, grad_a, load_a), (loss_b, grad_b, load_b) = results
    assert loss_b == pytest.approx(loss_a, abs=1e-6)
    torch.testing.assert_close(grad_b, grad_a, rtol=0, atol=1e-7)
    assert all(torch.equal(load_a[i], load_b[i]) for i in load_a)
