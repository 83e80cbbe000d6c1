"""The check that a run loaded neither JAX nor the JAX package.

A module counts by its top-level name, the part before the first dot,
compared whole: `repro_torch` is the program and passes, `repro` is the
JAX package and fails.
"""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among `modules` (default:
    `sys.modules`), sorted."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names}
                  & set(FORBIDDEN))
