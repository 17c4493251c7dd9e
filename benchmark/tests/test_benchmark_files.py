"""BENCHMARK.json and the files it names: present, loadable, within the
contract's limits."""

from __future__ import annotations

import json
import re

import pytest

from benchmark import compare, spec

BENCH = json.loads(spec.BENCHMARK_JSON.read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    # A full check of 24 cells fits in 43,200 s.
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_loads(workload):
    cell = spec.load_cell(workload, BENCH)
    assert cell.micro_batch * cell.grad_accum * cell.seq == cell.tokens_per_step
    assert cell.chips in (1, 4)
    assert cell.limits and set(cell.limits) <= set(compare.NUMBERS)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer


def test_names_units_and_files():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
                path = spec.HERE / "metrics" / f"{entry['name']}.py"
                assert path.is_file(), f"no reader for {entry['name']}"
    assert len(names) == len(set(names))
    for config in BENCH["configs"]:
        assert (spec.ROOT / config["file"]).is_file()
        body = json.loads((spec.ROOT / config["file"]).read_text())
        # Every key run at another value than the source's: the cuts, and
        # the departures the port forces (each beside its published value).
        departed = {d["key"]: d for d in body["departures"] if isinstance(d, dict)}
        for key, d in departed.items():
            assert body[key] == d["as_run"] != d["published"], key
        assert set(config["reduced"]) == set(body["reduced"]) | set(departed)


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    moves = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in moves and m["layer"]
