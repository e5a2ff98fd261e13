"""Lattice operators (Wilson, twisted mass, staggered, clover and its
even-odd Schur form, domain wall and Moebius, coarse), their solves and
multigrid."""

from .wilson import (adjoint_operator, apply_wilson, apply_wilson_dagger,
                     cg_solve, cg_step, gamma_matrices, random_su3_links,
                     twisted_mass_operator, wilson_offsets, wilson_operator)
from .staggered import apply_staggered, eta_phases, staggered_operator
from .clover import CloverOperator, apply_clover, clover_field_strength, wilson_clover_operator
from .domain_wall import (DomainWallSoAOperator, apply_domain_wall, domain_wall_operator,
                          mobius_operator)
from .even_odd import checkerboard_masks, eo_solve, schur_cg, schur_matvec  # noqa: I001
from .eo_packed import (apply_hopping_packed, apply_hopping_packed_soa, cb_pack, cb_pack_soa,
                        cb_unpack, cb_unpack_soa, eo_solve_packed, eo_solve_packed_soa,
                        hopping_packed, hopping_packed_soa)
from .clover_eo import (CloverEOOperator, apply_schur, clover_eo_operator, eo_prepare,
                        eo_reconstruct, eo_solve_clover_soa)
from .coarse import apply_coarse, coarse_operator
from . import multigrid
from .multigrid import (build_hierarchy, build_prolongator, chebyshev_smoother,
                        coarse_bsr_operator, coarse_matrix, symmetric_two_grid_preconditioner,
                        two_grid_error_contraction, two_grid_preconditioner,
                        vcycle_preconditioner)

__all__ = ["gamma_matrices", "random_su3_links", "wilson_offsets",
           "wilson_operator", "apply_wilson", "adjoint_operator",
           "apply_wilson_dagger", "cg_step", "cg_solve", "twisted_mass_operator",
           "apply_staggered", "eta_phases", "staggered_operator",
           "CloverOperator", "apply_clover", "clover_field_strength",
           "wilson_clover_operator",
           "apply_domain_wall", "DomainWallSoAOperator", "domain_wall_operator",
           "mobius_operator",
           "checkerboard_masks", "eo_solve", "schur_matvec", "schur_cg",
           "cb_pack", "cb_unpack", "hopping_packed", "apply_hopping_packed",
           "eo_solve_packed", "cb_pack_soa", "cb_unpack_soa", "hopping_packed_soa",
           "apply_hopping_packed_soa", "eo_solve_packed_soa",
           "CloverEOOperator", "clover_eo_operator", "apply_schur", "eo_prepare",
           "eo_reconstruct", "eo_solve_clover_soa",
           "coarse_operator", "apply_coarse", "multigrid",
           "build_prolongator", "build_hierarchy", "chebyshev_smoother",
           "vcycle_preconditioner", "coarse_matrix", "coarse_bsr_operator",
           "two_grid_error_contraction", "symmetric_two_grid_preconditioner",
           "two_grid_preconditioner"]
