"""A cell, found by name: its ``BENCHMARK.json`` entry and the files that
entry names.

- ``configs/<config>.json``: the model's sizes as run (the published
  ``config.json`` keys), ``family`` (its module ``families/<family>.py``,
  which reads the sizes from the file) and ``reference``;
- ``traffic/<traffic>.json``: the batch a step trains on (sequence
  length, tokens a step, how ids are drawn, the pool of distinct
  batches);
- ``workloads/<cell>.json``: how the program runs the cell (micro-batch,
  accumulation, attention, remat, loss chunk, mesh) and the limits of
  the correctness check.

A later change adds a cell, a configuration or a traffic mix as new
files and new entries; nothing here names one.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

from benchmark import families

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK_JSON = ROOT / "BENCHMARK.json"


def _load(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    with path.open() as f:
        return json.load(f)


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    model: object  # what the family's ``sizes`` returned
    config: dict  # the configuration file, as run
    reference: str
    seq: int
    tokens_per_step: int
    pool: int
    micro_batch: int
    grad_accum: int
    attn: str
    remat: bool
    loss_chunk: int
    mesh: dict | None
    limits: dict
    end_to_end: tuple
    per_layer: tuple

    @property
    def batch(self) -> int:
        """Sequences a step trains on."""
        return self.tokens_per_step // self.seq


def _metrics_of(entries: list, workload: str) -> tuple:
    return tuple(m for m in entries
                 if "workloads" not in m or workload in m["workloads"])


def load_cell(workload: str, bench: dict | None = None) -> Cell:
    """The cell named ``workload`` in ``BENCHMARK.json`` (or ``bench``)."""
    bench = _load(BENCHMARK_JSON) if bench is None else bench
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(entries)})")
    entry = entries[workload]
    config = _load(HERE / "configs" / f"{entry['config']}.json")
    traffic = _load(HERE / "traffic" / f"{entry['traffic']}.json")
    layout = _load(HERE / "workloads" / f"{workload}.json")
    for key in ("config", "traffic", "chips"):
        if layout[key] != entry[key]:
            raise ValueError(f"workloads/{workload}.json says {key}="
                             f"{layout[key]!r}, BENCHMARK.json {entry[key]!r}")
    from benchmark.compare import NUMBERS

    if not layout["limits"] or set(layout["limits"]) - set(NUMBERS):
        raise ValueError(f"workloads/{workload}.json: limits must name some "
                         f"of {NUMBERS}")
    if traffic["ids"] != "uniform":
        raise ValueError(f"traffic/{entry['traffic']}.json: ids "
                         f"{traffic['ids']!r}: the generator draws 'uniform'")
    seq, tokens = traffic["seq"], traffic["tokens_per_step"]
    batch = tokens // seq
    mb, accum = layout["micro_batch"], layout["grad_accum"]
    if batch * seq != tokens or mb * accum != batch:
        raise ValueError(f"{workload}: {tokens} tokens a step at seq {seq} "
                         f"is not micro_batch {mb} × grad_accum {accum} rows")
    model = families.load(config["family"]).sizes(config)
    if getattr(model, "family", None) != config["family"]:
        raise ValueError(f"families/{config['family']}.py: sizes() must give "
                         f"an object whose family is {config['family']!r}")
    return Cell(
        name=workload, chips=entry["chips"], model=model, config=config,
        reference=config["reference"], seq=seq, tokens_per_step=tokens,
        pool=traffic["pool"], micro_batch=mb, grad_accum=accum,
        attn=layout["attn"], remat=bool(layout["remat"]),
        loss_chunk=layout["loss_chunk"], mesh=layout.get("mesh"),
        limits=layout["limits"],
        end_to_end=_metrics_of(bench["end_to_end"], workload),
        per_layer=_metrics_of(bench["per_layer"], workload),
    )
