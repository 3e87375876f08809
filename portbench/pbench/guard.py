"""The run must not have loaded JAX or the JAX package.  Each loaded
module's top-level name (the part of its name before the first dot) is
compared whole, so the port ``repro_torch`` is not taken for ``repro``."""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})

__all__ = ["FORBIDDEN", "forbidden_loaded"]


def forbidden_loaded(names: Iterable[str] = None) -> List[str]:
    names = list(sys.modules) if names is None else list(names)
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})
