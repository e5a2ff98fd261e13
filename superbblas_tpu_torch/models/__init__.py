"""Lattice operators (Wilson, coarse), their solves and multigrid."""

from .wilson import (adjoint_operator, apply_wilson, apply_wilson_dagger,
                     cg_solve, cg_step, gamma_matrices, random_su3_links,
                     wilson_offsets, wilson_operator)
from .even_odd import checkerboard_masks, schur_cg  # noqa: I001  (after wilson)
from .eo_packed import (apply_hopping_packed_soa, cb_pack_soa, cb_unpack_soa,
                        eo_solve_packed_soa, hopping_packed_soa)
from .coarse import apply_coarse, coarse_operator
from . import multigrid

__all__ = ["gamma_matrices", "random_su3_links", "wilson_offsets",
           "wilson_operator", "apply_wilson", "adjoint_operator",
           "apply_wilson_dagger", "cg_step", "cg_solve",
           "checkerboard_masks", "schur_cg",
           "cb_pack_soa", "cb_unpack_soa", "hopping_packed_soa",
           "apply_hopping_packed_soa", "eo_solve_packed_soa",
           "coarse_operator", "apply_coarse", "multigrid"]
