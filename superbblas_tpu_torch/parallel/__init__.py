"""The distributed layer on ``torch.distributed`` (counterpart of
``superbblas_tpu/parallel/``).

A mesh is a ``DeviceMesh`` whose axis names are lattice labels
(``make_mesh``, ``make_multihost_mesh``), a sharded array is a
``DTensor`` (a ``cplx.CArray`` of two), and ``NamedSharding`` /
``PartitionSpec`` carry the JAX package's fields (``mesh.py``).
Partitions (``partition.py``) translate to shardings where they are
grids and drive the explicit redistribution plans otherwise
(``redistribute.py``).  Every exchange — halos, redistribution, the
masked copy — is ``dist.all_to_all_single`` with per-peer split sizes
(NCCL on the card, gloo on the CPU).  The kernels run on each rank's
local shard: the SoA stencil K1 through ``apply_stencil_soa_sharded``,
the AoS stencil and gather modes through ``bsr_krylov_overlap`` /
``bsr_krylov_ca`` / ``apply_gather_sharded`` (K3/E1).  The package's
ordinary entry points (``bsr.apply_stencil_soa``, ``bsr.bsr_krylov``,
the model applies and solves, ``local_copy``, ``local_permute``,
``local_contraction``) send DTensor operands here (``dispatch.py``).
"""

from .partition import (
    Factors23,
    Partition,
    basic_partitioning,
    box_minus,
    make_hole,
    partitioning_distributed_procs,
    subtract_interval,
)
from .mesh import (NamedSharding, PartitionSpec, RankGrid, SingleDeviceSharding, make_mesh,
                   partition_sharding, sharding_of, sharding_partition)
from .dist import contraction, copy, reshard
from .halo import crop_halos, exchange_halos
from .overlap import bsr_krylov_overlap
from .powers import bsr_krylov_ca
from .multihost import initialize_distributed, make_multihost_mesh
from .gather_sharded import (apply_gather_overlap,
                             apply_gather_sharded,
                             make_gather_halo_plan)
from .stencil_sharded import apply_stencil_soa_sharded
from .redistribute import (
    make_plan,
    may_need_communications,
    pack_global,
    redistribute_auto,
    redistribute_explicit,
    unpack_global,
)

__all__ = [
    "Factors23",
    "Partition",
    "basic_partitioning",
    "box_minus",
    "make_hole",
    "partitioning_distributed_procs",
    "subtract_interval",
    "make_mesh",
    "partition_sharding",
    "sharding_partition",
    "contraction",
    "copy",
    "reshard",
    "crop_halos",
    "exchange_halos",
    "bsr_krylov_overlap",
    "bsr_krylov_ca",
    "initialize_distributed",
    "make_multihost_mesh",
    "apply_gather_overlap",
    "apply_gather_sharded",
    "apply_stencil_soa_sharded",
    "make_gather_halo_plan",
    "make_plan",
    "may_need_communications",
    "pack_global",
    "redistribute_auto",
    "redistribute_explicit",
    "unpack_global",
    "NamedSharding",
    "PartitionSpec",
    "RankGrid",
    "SingleDeviceSharding",
    "sharding_of",
]
