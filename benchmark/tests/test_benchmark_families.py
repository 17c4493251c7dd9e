"""The family modules against the numbers the harness gave before it
found a model by its family: the seeded weights' flat layout, the model
FLOPs, the attention shape and the port's config, for every cell."""

from __future__ import annotations

import dataclasses
import hashlib
import json
import re

import pytest
import torch

from benchmark import cellrun, families, seeded, spec

BENCH = json.loads(spec.BENCHMARK_JSON.read_text())

#: Per configuration: weights, their sum of elements, the sha256 of the
#: layout as JSON ([name, shape, offset] a weight), the first and last
#: entries, and the chunks of the flat weights.
LAYOUTS = {
    "mistral-7b": dict(
        n=75, total=2007044096, chunks=8,
        sha="e8c0f3a54e2e37f0bfbeca4d28b42a4bebdcb1c91edaaf9f40ed9ccdaaa7038f",
        first=[("embed", (32000, 4096), 0),
               ("blocks.0.attn_norm", (4096,), 131072000),
               ("blocks.0.wq", (4096, 4096), 131076096)],
        last=[("blocks.7.w_down", (14336, 4096), 1817247744),
              ("final_norm", (4096,), 1875968000),
              ("unembed", (4096, 32000), 1875972096)]),
    "mixtral-8x7b": dict(
        n=23, total=3164688384, chunks=12,
        sha="01a225c3ef6862d87f6011ab8b4a7c255b5eb0133d2a8a7854fa3c0a07906a00",
        first=[("embed", (32000, 4096), 0),
               ("blocks.0.attn_norm", (4096,), 131072000),
               ("blocks.0.wq", (4096, 4096), 131076096)],
        last=[("blocks.1.w_down", (8, 14336, 4096), 2563850240),
              ("final_norm", (4096,), 3033612288),
              ("unembed", (4096, 32000), 3033616384)]),
}

#: Per cell: model FLOPs a step and the attention call's shape.
CELLS = {
    "mistral-7b.s4096": (790424306319360.0,
                         {"B": 16, "H": 32, "KV": 8, "S": 4096, "D": 128}),
    "mixtral-8x7b.s4096": (187412508573696.0,
                           {"B": 4, "H": 32, "KV": 8, "S": 4096, "D": 128}),
    "mistral-7b.s1024": (750841887719424.0,
                         {"B": 64, "H": 32, "KV": 8, "S": 1024, "D": 128}),
}

_TRUNK = dict(vocab=32000, dim=4096, n_heads=32, n_kv_heads=8, ffn_dim=14336,
              dtype=torch.bfloat16)

#: Per cell: the port config's fields.
PORT_CONFIGS = {
    "mistral-7b.s4096": dict(_TRUNK, n_layers=8, max_seq=4096),
    "mixtral-8x7b.s4096": dict(_TRUNK, n_layers=2, max_seq=4096, n_experts=8,
                               top_k=2, capacity_factor=2.0),
    "mistral-7b.s1024": dict(_TRUNK, n_layers=8, max_seq=1024),
}


def _sizes(name):
    config = json.loads((spec.HERE / "configs" / f"{name}.json").read_text())
    return families.load(config["family"]).sizes(config)


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_the_seeded_layout_is_pinned(name):
    want = LAYOUTS[name]
    m = _sizes(name)
    layout = seeded.layout(m)
    blob = json.dumps([[n, list(s), o] for n, s, o in layout])
    assert len(layout) == want["n"]
    assert seeded.total(m) == want["total"]
    assert len(seeded.chunks(m)) == want["chunks"]
    assert layout[:3] == want["first"] and layout[-3:] == want["last"]
    assert hashlib.sha256(blob.encode()).hexdigest() == want["sha"]


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_flops_and_attention_shape_are_pinned(workload):
    flops, shape = CELLS[workload]
    cell = spec.load_cell(workload, BENCH)
    family = families.of(cell.model)
    assert family.train_flops_per_step(cell.model, cell.batch, cell.seq) == flops
    assert family.attn_shape(cell.model, cell.micro_batch, cell.seq) == shape
    record = cellrun.record_of(cell, "NVIDIA H100 80GB HBM3", 1.0,
                               {"steps": 1, "seconds": 1.0, "failed": 0}, 1, None)
    assert record["flops_per_step"] == flops and record["attn_shape"] == shape
    assert record["config"] == cell.config and record["config"]["family"]
    assert (record["seq"], record["micro_batch"]) == (cell.seq, cell.micro_batch)


@pytest.mark.parametrize("workload", sorted(PORT_CONFIGS))
def test_the_port_model_is_pinned(workload):
    """Built on the meta device (no memory): its config's fields, and its
    parameters by name and shape (the port lists the model's own before
    its layers; the flat weights keep the family's order)."""
    cell = spec.load_cell(workload, BENCH)
    family = families.of(cell.model)
    model = family.port_model(cell.model, cell.seq, torch.device("meta"))
    assert dataclasses.asdict(model.cfg) == PORT_CONFIGS[workload]
    have = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert have == family.param_shapes(cell.model)


def test_a_family_is_found_only_as_its_module():
    assert families.load("llama").__name__ == "benchmark.families.llama"
    for name in ("no_such_family", "../spec", "llama.py", ""):
        with pytest.raises(FileNotFoundError):
            families.load(name)


def test_a_config_with_an_unknown_family_does_not_load(monkeypatch):
    real = spec._load

    def load(path):
        body = real(path)
        return dict(body, family="no_such_family") if path.parent.name == "configs" else body

    monkeypatch.setattr(spec, "_load", load)
    with pytest.raises(FileNotFoundError):
        spec.load_cell(BENCH["workloads"][0]["name"], BENCH)


@pytest.mark.parametrize("module", ["spec", "program", "seeded", "flops",
                                    "cellrun"])
def test_the_harness_names_no_family(module):
    text = (spec.HERE / f"{module}.py").read_text()
    assert not re.search(r"llama|moe|mixtral|mistral", text, re.IGNORECASE)
