"""superbblas_tpu_torch: the PyTorch/CUDA port of superbblas_tpu.

It holds the local dense engine, label-driven copy, permute, reduce and
contraction (``labels``, ``ops``; the 4-D transpose is a hand-written
kernel), and the Wilson-Dirac normal-equation CG solve in the
structure-of-arrays layout: split-complex tensors (``cplx``), the SoA
stencil operator (``bsr``), the Wilson model and its solve (``models``),
the stencil kernel with its plain PyTorch version (``ops``), the
even-odd packed solve (``models.eo_packed``) and the Krylov solvers
(``solvers``).  It imports torch and numpy, never jax.
"""

from . import labels, cplx, ops, bsr, models, solvers  # noqa: I001  (dependency order)
from .bsr import (BSROperator, bsr_cast_storage, bsr_from_stencil, bsr_get_preferred_layout,
                  bsr_krylov)
from .labels import ContractionPlan
from .ops import local_contraction, local_copy, local_permute

__all__ = ["labels", "cplx", "bsr", "models", "ops", "solvers", "BSROperator",
           "bsr_cast_storage", "bsr_from_stencil", "bsr_get_preferred_layout", "bsr_krylov",
           "ContractionPlan", "local_contraction", "local_copy", "local_permute"]
