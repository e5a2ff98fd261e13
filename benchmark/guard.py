"""The import guard: the benchmark measures the PyTorch port alone.

No module of the process may have the top-level name of JAX, its
libraries or the JAX package.  Names are compared whole, up to the first
dot: the port, ``superbblas_tpu_torch``, begins with the JAX package's
name and is not it.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "superbblas_tpu"})


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (``sys.modules``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)
