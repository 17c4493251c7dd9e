"""Model families, one module each: ``families/<family>.py``, found by the
``family`` key of a configuration file.

A family module gives five functions, and the harness asks nothing else
of a model:

- ``sizes(config)``: the run sizes from the configuration file's dict, as
  run: any object with a ``family`` attribute naming its module and a
  ``vocab`` that the token ids are drawn from. The reference the
  configuration names gets it, as the other four do;
- ``port_model(sizes, seq, device)``: the port's ``nn.Module``, built
  through the port's own classes, with its parameters uninitialised;
- ``param_shapes(sizes)``: every weight of the port's model by name and
  shape, in the order of the flat index space the seeded weights are
  drawn over (``seeded.layout``), which fixes every weight's values;
- ``train_flops_per_step(sizes, batch, seq)``: the frozen model FLOPs of
  one optimizer step, which ``step_mfu_pct`` reads;
- ``attn_shape(sizes, micro_batch, seq)``: the attention call's shape
  (``B``, ``H``, ``KV``, ``S``, ``D``) that the flash rooflines read, or
  None where the family has no such attention.

A new family is a new module here, with its configuration, its plain
reference, traffic, cell and readers as new files beside the others.
"""

from __future__ import annotations

import importlib
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load(family: str):
    """The module ``families/<family>.py``."""
    if not (family.isidentifier() and (HERE / f"{family}.py").is_file()):
        raise FileNotFoundError(f"no family module {HERE / f'{family}.py'}")
    return importlib.import_module(f"{__name__}.{family}")


def of(sizes):
    """The family module of run sizes that its ``sizes`` returned."""
    return load(sizes.family)
