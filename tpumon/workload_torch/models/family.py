"""The port's model families: one :class:`Family` record each, which its
module (``models/llama.py``, ``moe.py``, ``deepseek_v2.py``,
``mimo_v2.py``) registers on
import. The harness, the pipeline and ``flops.py`` read the record, not
the config's class: a new family comes in as its module and its record.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Any, Callable


@dataclass(frozen=True)
class Family:
    """One decoder family.

    ``presets`` maps a ``--preset`` name to a config factory, the default
    first; ``own_presets`` are those that another ``--model`` refuses
    rather than ignores. ``model(cfg, device, mesh, layers)`` allocates a
    family that takes a mesh (``param_specs``, the mesh's parameter
    specs; None for one that runs on one device: ``model(cfg, device)``).
    ``init_params(cfg, generator)`` is the seeded model, and
    ``from_jax_params(cfg, tree, device)`` loads the JAX package's
    parameter tree (it raises for a family with no JAX counterpart).
    ``forward_flops(cfg, batch, seq)`` counts one forward's matmul FLOPs.
    ``check(cfg, *, dp, tp, sp, pp, ep, seq, sp_layout, loss_chunk,
    grad_accum)`` raises a ValueError for a run the family cannot do.
    ``after_step(model)``, where a family gives one, is a state change
    outside the gradient that the train step runs after each optimizer
    step (MiMo-V2's router bias update)."""

    name: str
    config: type
    presets: dict[str, Callable[[], Any]]
    model: type
    init_params: Callable
    from_jax_params: Callable
    forward_flops: Callable
    check: Callable
    param_specs: dict | None = None
    own_presets: tuple[str, ...] = ()
    after_step: Callable | None = None


#: The registered families by ``--model`` name, in registration order.
REGISTRY: dict[str, Family] = {}

#: The port's own family modules, imported before the registry is read.
_MODULES = ("llama", "moe", "deepseek_v2", "mimo_v2")


def register(family: Family) -> Family:
    REGISTRY[family.name] = family
    return family


def families() -> dict[str, Family]:
    """Every registered family by ``--model`` name."""
    for module in _MODULES:
        importlib.import_module(f"{__package__}.{module}")
    return REGISTRY


def of(cfg) -> Family:
    """The family of config ``cfg``, by its exact class."""
    for family in families().values():
        if type(cfg) is family.config:
            return family
    raise TypeError(f"no model family takes a {type(cfg).__name__}")
