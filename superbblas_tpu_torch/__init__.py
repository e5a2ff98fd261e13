"""superbblas_tpu_torch: the PyTorch/CUDA port of superbblas_tpu.

It holds the local dense engine, label-driven copy, permute, reduce and
contraction (``labels``, ``ops``; the 4-D transpose is a hand-written
kernel), and the Wilson-Dirac normal-equation CG solve in the
structure-of-arrays layout: split-complex tensors (``cplx``), the
block-sparse operators (``bsr``: SoA and AoS stencils, and the gather
plans of ``create_bsr``/``create_kron_bsr``), the Wilson model and its
solve (``models``),
the stencil kernel with its plain PyTorch version (``ops``), the
even-odd packed solve (``models.eo_packed``) and the Krylov solvers
(``solvers``), the batched dense factorisations (``dense``, on
``torch.linalg``), the S3T checkpoint format (``storage``, with the host
plan engine of ``native``) and the utilities (``flags``, ``context``,
``aot``: CUDA-graph capture and ``torch.export``; ``utils``: tracker,
caches, test oracles) and the distributed layer (``parallel``: meshes,
partitions, halos, the sharded stencil, copy/contraction, redistribution,
overlap, CA powers, the sharded gather, on ``torch.distributed``; the
sharded checkpoints are in ``storage``).  It imports torch and numpy,
never jax.
"""

from . import flags, labels, cplx, utils, ops, bsr, models, solvers  # noqa: I001  (dependency order)
from . import aot, context, dense, native, parallel, storage
from .bsr import (BSROperator, bsr_cast_storage, bsr_from_stencil, bsr_get_preferred_layout,
                  bsr_krylov, create_bsr, create_kron_bsr)
from .dense import cholesky, gesm, inversion, trsm
from .labels import ContractionPlan
from .ops import local_contraction, local_copy, local_permute
from .parallel import (Partition, basic_partitioning, contraction, copy, make_hole, make_mesh,
                       partition_sharding, partitioning_distributed_procs, reshard)

__all__ = ["aot", "bsr", "context", "cplx", "dense", "native", "storage", "flags", "labels",
           "models", "ops", "solvers", "utils", "BSROperator",
           "bsr_cast_storage", "bsr_from_stencil", "bsr_get_preferred_layout", "bsr_krylov",
           "create_bsr", "create_kron_bsr", "ContractionPlan", "cholesky", "trsm", "gesm",
           "inversion", "local_contraction", "local_copy", "local_permute", "parallel",
           "Partition", "basic_partitioning", "contraction", "copy", "make_hole", "make_mesh",
           "partition_sharding", "partitioning_distributed_procs", "reshard"]
