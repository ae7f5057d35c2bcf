"""What the measured process may not have loaded: the JAX stack and the JAX
package that the port was made from. Names are compared by their top-level
part (before the first dot) whole, so ``nbody_tpu_torch`` is not
``nbody_tpu``."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "nbody_tpu"})


def forbidden_loaded(modules: Iterable[str] = None) -> List[str]:
    """Sorted top-level names of loaded modules that are forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)
