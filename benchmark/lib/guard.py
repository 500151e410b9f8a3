"""The import guard: no module of JAX, its libraries or the JAX package
may be loaded in a run. Names are compared by their top-level part, the
text before the first dot, whole: `kalman_hydra_tpu_torch` is the port
and passes; `kalman_hydra_tpu` is the JAX package and does not."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "kalman_hydra_tpu"})


def offenders(modules=None) -> list:
    """The forbidden top-level names among `modules` (default: the names
    in sys.modules), sorted."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)
