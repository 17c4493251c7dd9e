"""The port's collective counters (``tpumon/workload_torch/collective_counters.py``),
the counterpart of ``tpumon/workload/hlo_counters.py``.

The families must carry the reference's names and labels (those
``tpumon/families.py`` registers), be absent until they have a sample, and
parse; the counts a mesh run issues must equal the formula written beside
the counters (``expected_per_step``/``expected_per_probe``), on every
rank; ``--hlo-raw-dump`` writes one JSON line per recorded call.
"""

import json

import pytest

torch = pytest.importorskip("torch")

from tpumon.workload_torch.collective_counters import (  # noqa: E402
    RAW_LIMIT,
    CollectiveCounters,
    CountersCollector,
    expected_per_probe,
    expected_per_step,
)
from tpumon.workload_torch.models.llama import LlamaConfig  # noqa: E402
from tpumon.workload_torch.models.moe import MoeConfig  # noqa: E402
from tpumon.workload_torch.parallel import checks, launch  # noqa: E402

CPU = torch.device("cpu")


def _render(counters) -> str:
    from prometheus_client import generate_latest
    from prometheus_client.registry import CollectorRegistry

    registry = CollectorRegistry()
    registry.register(CountersCollector(counters))
    return generate_latest(registry).decode()


def test_families_absent_until_sampled_then_parse_with_registered_names():
    from prometheus_client.parser import text_string_to_metric_families

    from tpumon.families import WORKLOAD_FAMILIES

    counters = CollectiveCounters()
    assert _render(counters) == ""  # absent, not zero
    for op, nbytes in (("all-reduce", 64), ("all-reduce", 32), ("all-gather", 16)):
        with counters.span(op, nbytes, CPU):
            pass
    parsed = {f.name: f for f in text_string_to_metric_families(_render(counters))}
    names = {name + "_total" for name in parsed}
    assert names == {
        "workload_collective_ops_total", "workload_hlo_log_events_total",
        "workload_collective_op_latency_microseconds_total",
        "workload_collective_op_latency_samples_total",
        "workload_collective_op_bytes_total",
    }
    assert names <= set(WORKLOAD_FAMILIES)

    def by_op(name):
        return {s.labels["op"]: s.value for s in parsed[name].samples
                if s.name.endswith("_total")}

    assert by_op("workload_collective_ops") == {"all-reduce": 2, "all-gather": 1}
    assert by_op("workload_collective_op_bytes") == {"all-reduce": 96, "all-gather": 16}
    assert by_op("workload_collective_op_latency_samples") == {"all-reduce": 2, "all-gather": 1}
    assert all(v >= 0 for v in by_op("workload_collective_op_latency_microseconds").values())
    events = [s.value for s in parsed["workload_hlo_log_events"].samples
              if s.name.endswith("_total")]
    assert events == [3]


def test_unknown_op_is_refused():
    with pytest.raises(ValueError, match="unknown collective op"):
        with CollectiveCounters().span("broadcast", 4, CPU):
            pass


def test_raw_dump_writes_one_line_per_call(tmp_path):
    path = tmp_path / "raw.jsonl"
    counters = CollectiveCounters(raw_path=str(path), rank=3)
    for n in range(RAW_LIMIT + 5):
        with counters.span("all-gather" if n % 2 else "all-reduce", 8 * n, CPU):
            pass
    counters.close()
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert len(lines) == RAW_LIMIT  # the reference's cap
    assert [line["op"] for line in lines[:3]] == ["all-reduce", "all-gather", "all-reduce"]
    assert [line["bytes"] for line in lines[:3]] == [0, 8, 16]
    assert all(line["rank"] == 3 and line["us"] >= 0 for line in lines)


#: name -> (cfg, dp, tp, run kwargs, windowed with the phase probe).
CASES = {
    "dense_plain": (LlamaConfig.tiny(), 2, 2, {}, False),
    "dense_all": (LlamaConfig.tiny(), 2, 2, dict(
        remat=True, loss_chunk=16, grad_accum=2, zero1=True,
        with_grad_norm=True), False),
    "dense_dp4_zero1": (LlamaConfig.tiny(), 4, 1, dict(zero1=True), False),
    "dense_probe": (LlamaConfig.tiny(), 2, 2, dict(
        remat=True, loss_chunk=16, zero1=True, stats_every=1,
        phase_stats=True), True),
    "moe_remat": (MoeConfig.tiny(), 2, 2, dict(remat=True, grad_accum=2), False),
    "moe_probe": (MoeConfig.tiny(), 2, 2, dict(
        grad_accum=2, stats_every=1, phase_stats=True), True),
}
STEPS, BATCH, SEQ = 2, 4, 32


@pytest.fixture(scope="module")
def counted(tmp_path_factory):
    jobs = [dict(cfg=cfg, dp=dp, tp=tp, stats=windowed,
                 kwargs=dict(steps=STEPS, batch=BATCH, seq=SEQ, **kw))
            for cfg, dp, tp, kw, windowed in CASES.values()]
    ranks = launch.spawn(checks.run_jobs, 4,
                         str(tmp_path_factory.mktemp("counted") / "rendezvous"),
                         (jobs,))
    return {name: [r[i] for r in ranks] for i, name in enumerate(CASES)}


@pytest.mark.parametrize("case", CASES)
def test_counts_equal_the_formula(counted, case):
    """Every rank issues the formula's collectives: the warm-up and the
    timed steps, plus one phase probe a window."""
    cfg, dp, tp, kw, windowed = CASES[case]
    shape = dict(n_layers=cfg.n_layers, dp=dp, tp=tp, remat=kw.get("remat", False),
                 loss_chunk=kw.get("loss_chunk", 0), seq=SEQ,
                 zero1=kw.get("zero1", False), moe=isinstance(cfg, MoeConfig))
    step = expected_per_step(grad_accum=kw.get("grad_accum", 1),
                             grad_norm=kw.get("with_grad_norm", False), **shape)
    probe = expected_per_probe(**shape)
    probes = STEPS if windowed else 0
    want = {op: (STEPS + 1) * step[op] + probes * probe[op] for op in step}
    want = {op: n for op, n in want.items() if n}
    for rank in counted[case]:
        assert rank["counts"] == want


def test_formula_at_the_card_path():
    """The medium train step of ``chip_smoke.py``'s mesh phase, per rank
    and step: 4 chunks × (fwd 1 + 24 + 8, bwd 24 + 1 + 8 + 12, data 1)
    all-reduces plus the grad norm's one, and ZeRO-1's one all-gather."""
    cfg = LlamaConfig.medium()
    step = expected_per_step(n_layers=cfg.n_layers, dp=2, tp=2, grad_accum=4,
                             remat=True, loss_chunk=1024, seq=4096, zero1=True,
                             grad_norm=True)
    assert step == {"all-reduce": 4 * (33 + 45 + 1) + 1, "all-gather": 1}


#: (formula arguments beyond the common ones, expected per step). L = 12
#: layers, one microbatch unless said. Permutes per attention call: the
#: hops (n on the contiguous plain ring, n - 1 otherwise), plus under
#: zigzag 4 for each carrier that moves this rank's stripes; the backward
#: transposes them all, and --remat recomputes them once more.
RING_CASES = {
    # 4 hops fwd + 4 bwd a layer; the bucket over data×seq.
    "contiguous_xla_sp4": (dict(sp=4, sp_layout="contiguous", attn="xla"),
                           {"all-reduce": 1, "all-gather": 0, "collective-permute": 12 * 8}),
    # The flash ring skips the hop home: 3 + 3.
    "contiguous_flash_sp4": (dict(sp=4, sp_layout="contiguous", attn="flash"),
                             {"all-reduce": 1, "all-gather": 0, "collective-permute": 12 * 6}),
    "contiguous_flash_sp4_remat": (dict(sp=4, sp_layout="contiguous", attn="flash",
                                        remat=True),
                                   {"all-reduce": 1, "all-gather": 0,
                                    "collective-permute": 12 * 9}),
    # sp=2 zigzag: 1 hop + q, k, v, out on the odd carrier (the even one
    # maps every rank to itself): 5 fwd, 5 bwd.
    "zigzag_flash_sp2": (dict(sp=2, sp_layout="zigzag", attn="flash"),
                         {"all-reduce": 1, "all-gather": 0, "collective-permute": 12 * 10}),
    # sp=4 zigzag: rank 0's even carrier and rank 2's odd one are local.
    "zigzag_xla_sp4_rank0": (dict(sp=4, sp_layout="zigzag", attn="xla", seq_coord=0),
                             {"all-reduce": 1, "all-gather": 0, "collective-permute": 12 * 14}),
    "zigzag_xla_sp4_rank1": (dict(sp=4, sp_layout="zigzag", attn="xla", seq_coord=1),
                             {"all-reduce": 1, "all-gather": 0, "collective-permute": 12 * 22}),
    "zigzag_xla_sp4_rank2": (dict(sp=4, sp_layout="zigzag", attn="xla", seq_coord=2),
                             {"all-reduce": 1, "all-gather": 0, "collective-permute": 12 * 14}),
    # dp=2×sp=2: one bucket a chunk over data×seq, 2 chunks.
    "dp2_sp2_accum2": (dict(dp=2, sp=2, sp_layout="contiguous", attn="flash", grad_accum=2),
                       {"all-reduce": 2, "all-gather": 0,
                        "collective-permute": 2 * 12 * 2}),
    # No sp: no permute key, and no bucket on one data rank.
    "no_sp": (dict(tp=2), {"all-reduce": 1 + 24 + 2 + 24 + 1, "all-gather": 0}),
}


@pytest.mark.parametrize("case", RING_CASES)
def test_ring_formula_cases(case):
    kw, want = RING_CASES[case]
    args = dict(n_layers=12, dp=1, tp=1, grad_accum=1, remat=False, loss_chunk=0,
                seq=4096, zero1=False, grad_norm=False)
    args.update(kw)
    assert expected_per_step(**args) == want


def test_ring_formula_at_the_card_path():
    """The medium train step of ``chip_smoke.py``'s ring phase at
    tp=2×sp=2 zigzag flash with --remat, per rank and step: 4 chunks ×
    (fwd 1 + 24 + 2, bwd 24 + 1 + 12, data×seq 1) all-reduces plus the
    grad norm's one, and 4 × 12 × (5 + 5 + 5) permutes; a probe issues
    2 × 60 + 120 permutes."""
    cfg = LlamaConfig.medium()
    shape = dict(n_layers=cfg.n_layers, dp=1, tp=2, remat=True, loss_chunk=0,
                 seq=4096, zero1=False, sp=2, sp_layout="zigzag", attn="flash")
    for coord in (0, 1):
        step = expected_per_step(grad_accum=4, grad_norm=True, seq_coord=coord, **shape)
        assert step == {"all-reduce": 4 * (27 + 37 + 1) + 1, "all-gather": 0,
                        "collective-permute": 4 * 12 * 15}
        probe = expected_per_probe(seq_coord=coord, **shape)
        assert probe == {"all-reduce": 2 * 27 + 37 + 1, "all-gather": 0,
                         "collective-permute": 240}


#: (formula arguments beyond the common ones, expected per step) of the
#: MoE model: moe-small's L = 8 layers, E = 8 experts, one microbatch of
#: B = 1 row at seq 4096 and D = 512 unless said, so s = 4096 / sp
#: positions a rank. Per MoE layer: under ep, the combine's sum over
#: expert forward ([B,s,D] bf16, 4 MiB at sp = 1) and the gradients of the
#: expert products' input ([B,s,D] bf16) and of the routed probabilities
#: ([B,s,E] f32, 128 KiB) backward; under sp, the router probabilities'
#: all-gather ([B,s,E] f32 from each rank, 64 KiB at sp = 2); when
#: dp·sp > 1 the data×seq mean of the aux statistics ([2E] f32, 64 B).
#: --remat runs the gather and the mean again, not the sum over expert.
EXPERT_CASES = {
    # The chip path: 4 chunks × (fwd 8 + 8, bwd 16 + 8, the 0.34 GB
    # bucket 1) + the grad norm's expert all-reduce.
    "dp2_ep2_remat_accum4": (dict(dp=2, ep=2, grad_accum=4, remat=True, grad_norm=True),
                             {"all-reduce": 4 * (16 + 24 + 1) + 1, "all-gather": 0}),
    # Dryrun cell 3 at moe-small depth: tp's 1 + 16 + 2 and 16 + 1 beside
    # ep's 8 and 16; no bucket on one data rank.
    "ep2_tp2": (dict(tp=2, ep=2), {"all-reduce": 19 + 8 + 17 + 16, "all-gather": 0}),
    # Dryrun cell 4: the gather (8 + 8 under remat), the aux mean over the
    # seq group (8 + 8), ep's 8 + 16, the bucket; the plain contiguous
    # ring's 2 hops a layer, forward, recompute and backward.
    "ep2_sp2_remat": (dict(sp=2, ep=2, remat=True),
                      {"all-reduce": 16 + 24 + 1, "all-gather": 16,
                       "collective-permute": 8 * 2 * 3}),
    # MoE at dp=2×sp=2, ep = 1: the gather, the aux mean, the bucket.
    "dp2_sp2": (dict(dp=2, sp=2), {"all-reduce": 8 + 1, "all-gather": 8,
                                   "collective-permute": 8 * 2 * 2}),
    # ep with ZeRO-1: the update's all-gather over data, once a step.
    "dp2_ep2_zero1": (dict(dp=2, ep=2, zero1=True), {"all-reduce": 16 + 16 + 1,
                                                     "all-gather": 1}),
}


@pytest.mark.parametrize("case", EXPERT_CASES)
def test_expert_formula_cases(case):
    kw, want = EXPERT_CASES[case]
    args = dict(n_layers=8, dp=1, tp=1, grad_accum=1, remat=False, loss_chunk=0,
                seq=4096, zero1=False, grad_norm=False, moe=True)
    args.update(kw)
    assert expected_per_step(**args) == want


def test_expert_probe_formula_at_the_card_path():
    """A phase probe of the chip path at dp=2×ep=2 with --remat: two
    forwards (8 + 8 each) and one backward (16 + 8), and the bucket."""
    probe = expected_per_probe(n_layers=8, dp=2, tp=1, ep=2, moe=True, remat=True,
                               loss_chunk=0, seq=4096, zero1=False)
    assert probe == {"all-reduce": 2 * 16 + 24 + 1, "all-gather": 0}


#: (formula arguments beyond the common ones, expected per step) of the
#: pipelined step (``parallel/pipeline.py``): L = 12 layers at seq 4096
#: unless said, T ticks of a chunk of lpg = L / (pp·v) layers, M
#: microbatches of mb rows. On every stage: T hops of the [mb,s,D]
#: activations forward and T − 1 backward (the last tick's hop feeds
#: nothing), the stage pair (the finished microbatches' [b,s,D] summed
#: over stage forward, the pipe input's gradient [b,s,D] backward), and
#: each tick's body collectives T·lpg times, bubble ticks included.
PIPE_CASES = {
    # GPipe, M = 2, pp = 2: T = 3; only the stage pair and the hops.
    "gpipe_pp2_m2": (dict(pp=2, microbatches=2),
                     {"all-reduce": 2, "all-gather": 0, "collective-permute": 3 + 2}),
    # GPipe, M = 8, pp = 4: T = M + pp − 1 = 11.
    "gpipe_pp4_m8": (dict(pp=4, microbatches=8),
                     {"all-reduce": 2, "all-gather": 0, "collective-permute": 11 + 10}),
    # The chip path without remat: pp=2×tp=2, v = 2, M = 8: T = 17, lpg =
    # 3. Forward the embedding 1, the row splits 2·17·3 = 102 of [1,s,D],
    # the loss's 2, the stage sum 1; backward the column splits' 102, the
    # unembed's input 1, the pipe input's 1.
    "interleave2_tp2_m8": (dict(pp=2, tp=2, microbatches=8, interleave=2),
                           {"all-reduce": 106 + 104, "all-gather": 0,
                            "collective-permute": 17 + 16}),
    # remat recomputes a tick's chunk of lpg = 6 layers and stops before
    # the last layer's w_down all-reduce: 2·6 − 1 = 11 a tick, T = 3.
    "remat_tp2_gpipe": (dict(pp=2, tp=2, microbatches=2, remat=True),
                        {"all-reduce": (1 + 36 + 2 + 1) + (36 + 1 + 33 + 1),
                         "all-gather": 0, "collective-permute": 5}),
    # pp=2×sp=2 zigzag flash, GPipe, M = 2: T·lpg = 18 attention calls of
    # 5 permutes forward and 5 backward, the hops, the stage pair and the
    # bucket over seq.
    "sp2_zigzag_flash": (dict(pp=2, sp=2, microbatches=2, sp_layout="zigzag",
                              attn="flash"),
                         {"all-reduce": 3, "all-gather": 0,
                          "collective-permute": 18 * 10 + 5}),
}

#: The same for moe-small (L = 8, E = 8) under pp. lpg = 4 at GPipe pp =
#: 2, T = 3 at M = 2: per tick and layer under ep the combine's sum over
#: expert forward ([mb,s,D] bf16) and two gradients backward; under
#: remat the chunk's sums over expert again but its last layer's (3 a
#: tick); the data mean of the stage's token sums (f32 [4·2E], when
#: dp > 1) and the stage sum of its aux loss (f32 scalar) forward.
MOE_PIPE_CASES = {
    "dp2_pp2_ep2_remat": (dict(dp=2, pp=2, ep=2, microbatches=2, remat=True,
                               grad_norm=True),
                          {"all-reduce": (1 + 2 + 12) + (1 + 24 + 9) + 1 + 2,
                           "all-gather": 0, "collective-permute": 5}),
    # Under tp a chunk's recompute runs all 2·lpg row splits (the
    # combine's input is an MoE layer's last saved tensor).
    "pp2_tp2_remat": (dict(pp=2, tp=2, microbatches=2, remat=True),
                      {"all-reduce": (1 + 24 + 2 + 1 + 1) + (24 + 1 + 24 + 1),
                       "all-gather": 0, "collective-permute": 5}),
}


@pytest.mark.parametrize("case", [*PIPE_CASES, *MOE_PIPE_CASES])
def test_pipeline_formula_cases(case):
    moe = case in MOE_PIPE_CASES
    kw, want = (MOE_PIPE_CASES if moe else PIPE_CASES)[case]
    args = dict(n_layers=8 if moe else 12, dp=1, tp=1, grad_accum=1, remat=False,
                loss_chunk=0, seq=4096, zero1=False, grad_norm=False, moe=moe)
    args.update(kw)
    assert expected_per_step(**args) == want


def test_pipeline_formula_at_the_card_path():
    """The medium train step of ``chip_smoke.py``'s pipe phase at
    pp=2×tp=2, interleave 2, 8 microbatches of one row, with --remat and
    the grad norm, per rank and step: 17 ticks × 3 layers; forward 106
    all-reduces, backward 189 (the recompute's 17 × 5 among them), the
    grad norm's over model and stage; 17 hops forward and 16 backward. A
    probe: two forwards and one backward."""
    cfg = LlamaConfig.medium()
    shape = dict(n_layers=cfg.n_layers, dp=1, tp=2, pp=2, microbatches=8,
                 interleave=2, remat=True, loss_chunk=0, seq=4096, zero1=False,
                 attn="flash")
    assert expected_per_step(grad_accum=1, grad_norm=True, **shape) == {
        "all-reduce": 106 + 189 + 2, "all-gather": 0, "collective-permute": 33}
    assert expected_per_probe(**shape) == {
        "all-reduce": 2 * 106 + 189, "all-gather": 0, "collective-permute": 2 * 17 + 16}
