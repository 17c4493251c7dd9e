"""The plain float32 reference against the port, at a tiny width on the
host, and the check's verdict on sound runs, on faults and on the
control."""

from __future__ import annotations

import json
import time

import pytest
import torch

from benchmark import cellrun, compare, families, seeded, spec
from benchmark.reference import decoder
from benchmark.tests.conftest import tiny_cell

SEED = 2**33 + 12345  # beyond 32 bits, as a check's seeds may be


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_port_matches_reference(moe):
    run = cellrun.measure(tiny_cell(moe), SEED, 0.1, False, "cpu",
                          time.perf_counter())
    assert run["correct"], run["numbers"]
    losses = run["losses"]
    assert losses["program"] == pytest.approx(losses["reference"], rel=1e-3)


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
@pytest.mark.parametrize("fault", ["frozen", "half_batch"])
def test_a_fault_under_the_step_is_not_correct(moe, fault):
    run = cellrun.measure(tiny_cell(moe), SEED, 0.1, False, "cpu",
                          time.perf_counter(), fault=fault)
    assert not run["correct"], run["numbers"]


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_the_fp8_control_is_not_correct(moe):
    cell = tiny_cell(moe)
    ref = cellrun.reference_readings(cell, SEED, "cpu")
    control = cellrun.reference_readings(cell, SEED, "cpu", fp8=True)
    numbers = compare.readings(control, ref)
    assert not compare.decide(numbers, cell.limits), numbers


def test_capacity_drops_in_the_tiny_moe():
    cell = tiny_cell(moe=True, capacity_factor=0.5)
    probs = torch.softmax(torch.randn(2, cell.seq, 4) * 3, dim=-1)
    _, _, kept = decoder.route(probs, cell.model, cell.seq)
    assert not kept.all()
    capacity = cell.model.capacity(cell.seq)
    experts = probs.topk(2, dim=-1).indices
    for row in range(2):
        for e in range(4):
            assert int(((experts[row] == e) & kept[row]).sum()) <= capacity


def test_routing_matches_the_port_at_a_tight_capacity():
    from tpumon.workload_torch.models.moe import _route

    cell = tiny_cell(moe=True, capacity_factor=0.5)
    probs = torch.softmax(torch.randn(2, cell.seq, 4) * 3, dim=-1)
    dispatch, combine = _route(probs, 2, cell.model.capacity(cell.seq))
    experts, gates, kept = decoder.route(probs, cell.model, cell.seq)
    ours = torch.zeros(2, cell.seq, 4)
    ours.scatter_add_(-1, experts, gates * kept)
    torch.testing.assert_close(combine.sum(-1), ours)
    assert torch.equal(dispatch.sum(-1).bool(),
                       torch.zeros(2, cell.seq, 4).scatter(-1, experts, kept.float()).bool())


class _OwnChoices(decoder.ForcedRouting):
    """Records the reference's own top-k choices and keeps them."""

    def __init__(self, layers):
        super().__init__({i: [] for i in range(layers)})
        self.seen = {i: [] for i in range(layers)}

    def experts(self, layer, probs):
        chosen = probs.topk(2, dim=-1).indices
        self.seen[layer].append(chosen)
        return chosen


def test_forcing_the_references_own_routing_changes_nothing():
    cell = tiny_cell(moe=True, capacity_factor=0.5)
    # One step: the embedding's backward sums in a thread order of its
    # own, so a second step's weights, and so its routing, may differ.
    own = _OwnChoices(cell.model.n_layers)
    first = cellrun.reference_readings(cell, SEED, "cpu", steps=1, forced=own)
    again = decoder.ForcedRouting(own.seen)
    second = cellrun.reference_readings(cell, SEED, "cpu", steps=1, forced=again)
    assert again.flips == {0: 0, 1: 0}
    assert again.tokens == {0: cell.tokens_per_step, 1: cell.tokens_per_step}
    assert all(not q for q in again.queue.values())
    assert second["losses"] == first["losses"]
    numbers = compare.readings(second, first)
    assert numbers["proj_gap_max"] < 1e-6 and numbers["grad_gap"] < 1e-6


def test_a_forced_choice_is_counted_and_routed():
    m = tiny_cell(moe=True).model
    probs = torch.softmax(torch.randn(1, 16, 4), dim=-1)
    flipped = probs.topk(2, dim=-1).indices.clone()
    # The two experts token 3 did not choose: a set of its own, whatever
    # the draw.
    own = flipped[0, 3].tolist()
    flipped[0, 3] = torch.tensor([e for e in range(4) if e not in own])
    forced = decoder.ForcedRouting({0: [flipped]})
    experts, gates, _ = decoder.route(probs, m, 16, forced.experts(0, probs))
    assert torch.equal(experts, flipped)
    assert forced.flips == {0: 1} and forced.tokens == {0: 16}
    torch.testing.assert_close(gates.sum(-1), torch.ones(1, 16))


def test_the_routing_witness_on_the_host():
    from benchmark import calibrate

    lines = []
    args = type("Args", (), dict(seeds=[SEED], fault_seeds=[SEED], steps=2,
                                 out=None))()
    emit = calibrate.emit
    try:
        calibrate.emit = lambda obj, out=None: lines.append(obj)
        calibrate.routing(tiny_cell(moe=True), args, "cpu")
    finally:
        calibrate.emit = emit
    witness, fault = lines
    assert witness["recompute_chose_the_same"]
    cell = tiny_cell(moe=True)
    assert witness["tokens"] == {0: 2 * cell.tokens_per_step,
                                 1: 2 * cell.tokens_per_step}
    assert compare.decide(witness["forced"], cell.limits), witness["forced"]
    assert witness["forced"]["proj_gap_median"] < witness["own"]["proj_gap_median"]
    assert not compare.decide(fault, cell.limits), fault


def test_projections_only_where_a_cell_compares_them():
    dense = cellrun.reference_readings(tiny_cell(), SEED, "cpu")
    assert dense["grad_proj"] is None
    assert "proj_gap_median" not in compare.readings(dense, dense)
    moe = cellrun.reference_readings(tiny_cell(moe=True), SEED, "cpu")
    assert set(moe["grad_proj"]) == set(moe["grad_norms"])


def test_weights_draw_again_chunk_by_chunk(monkeypatch):
    monkeypatch.setattr(seeded, "CHUNK", 1000)
    m = tiny_cell().model
    params = {n: torch.empty(s) for n, s in families.of(m).param_shapes(m).items()}
    seeded.fill(m, SEED, params)
    assert len(seeded.chunks(m)) > 10
    assert all(v == 0.0 for v in seeded.change_norms(m, SEED, params).values())
    f = decoder.Follower(m, SEED, "cpu")
    for name, p in params.items():
        torch.testing.assert_close(f.views(f.theta)[name], p, rtol=0, atol=0)


def test_tokens_depend_on_the_seed_only():
    a = seeded.tokens(SEED, 3, 2, 8, 100)
    assert torch.equal(a, seeded.tokens(SEED, 3, 2, 8, 100))
    assert not torch.equal(a, seeded.tokens(SEED + 1, 3, 2, 8, 100))
    assert len({tuple(r.tolist()) for r in a.reshape(6, -1)}) == 6


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [
    w["name"] for w in json.loads(spec.BENCHMARK_JSON.read_text())["workloads"]])
def test_the_control_at_the_cells_size_is_not_correct(card, workload):
    """The float8 control at each cell's own size, on the card, on three
    seeds (``calibrate.py limits`` reads the same, with the readings)."""
    cell = spec.load_cell(workload)
    for seed in (3000000101, 3000000102, 3000000103):
        ref = cellrun.reference_readings(cell, seed, card)
        control = cellrun.reference_readings(cell, seed, card, fp8=True)
        assert not compare.decide(compare.readings(control, ref), cell.limits)
