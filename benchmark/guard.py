"""The import guard: the benchmark measures the PyTorch port, never the
JAX package beside it.

Names are compared by whole dotted components, never as string
prefixes: the port, ``tpumon.workload_torch``, begins with the JAX
package's name as a string.
"""

from __future__ import annotations

import sys

#: Top-level modules that may not be loaded.
FORBIDDEN_TOP = ("jax", "jaxlib", "flax")

#: Dotted packages (compared component by component) that may not be
#: loaded: the JAX package of this repository.
FORBIDDEN_PACKAGES = (("tpumon", "workload"),)


def forbidden(name: str) -> bool:
    """Whether module ``name`` is JAX, jaxlib, flax or the JAX package."""
    parts = tuple(name.split("."))
    if parts[0] in FORBIDDEN_TOP:
        return True
    return any(parts[:len(p)] == p for p in FORBIDDEN_PACKAGES)


def loaded_forbidden(modules=None) -> list[str]:
    """The forbidden modules among ``modules`` (default ``sys.modules``)."""
    modules = sys.modules if modules is None else modules
    return sorted(name for name in list(modules) if forbidden(name))


def check(where: str) -> None:
    """Exit with code 3, naming what was found on standard error, when a
    forbidden module is loaded in this process."""
    found = loaded_forbidden()
    if found:
        print(f"benchmark: {where}: forbidden modules loaded: "
              f"{', '.join(found[:20])}", file=sys.stderr, flush=True)
        sys.exit(3)
