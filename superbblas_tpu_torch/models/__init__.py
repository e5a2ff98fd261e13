"""Lattice operators (Wilson, twisted mass, staggered, clover, domain wall
and Moebius, coarse), their solves and multigrid."""

from .wilson import (adjoint_operator, apply_wilson, apply_wilson_dagger,
                     cg_solve, cg_step, gamma_matrices, random_su3_links,
                     twisted_mass_operator, wilson_offsets, wilson_operator)
from .staggered import apply_staggered, eta_phases, staggered_operator
from .clover import CloverOperator, apply_clover, clover_field_strength, wilson_clover_operator
from .domain_wall import (DomainWallSoAOperator, apply_domain_wall, domain_wall_operator,
                          mobius_operator)
from .even_odd import checkerboard_masks, schur_cg  # noqa: I001  (after wilson)
from .eo_packed import (apply_hopping_packed_soa, cb_pack_soa, cb_unpack_soa,
                        eo_solve_packed_soa, hopping_packed_soa)
from .coarse import apply_coarse, coarse_operator
from . import multigrid

__all__ = ["gamma_matrices", "random_su3_links", "wilson_offsets",
           "wilson_operator", "apply_wilson", "adjoint_operator",
           "apply_wilson_dagger", "cg_step", "cg_solve", "twisted_mass_operator",
           "apply_staggered", "eta_phases", "staggered_operator",
           "CloverOperator", "apply_clover", "clover_field_strength",
           "wilson_clover_operator",
           "apply_domain_wall", "DomainWallSoAOperator", "domain_wall_operator",
           "mobius_operator",
           "checkerboard_masks", "schur_cg",
           "cb_pack_soa", "cb_unpack_soa", "hopping_packed_soa",
           "apply_hopping_packed_soa", "eo_solve_packed_soa",
           "coarse_operator", "apply_coarse", "multigrid"]
