"""Kernels with their plain PyTorch versions (stencil, permute and its tile
sweep, batched small GEMM, bf16 roll-plus-add, CG's fused updates, the
domain-wall s5 pass), and
the local tensor engine (copy, permute, reduce, contraction) built on
them."""

from . import (batched_gemm, cg_update, contract, copy, dw_s5, permute, reduce, roll_add,
               stencil)
from .batched_gemm import (batched_gemm_route, batched_gemm_rowpack, batched_small_gemm,
                           batched_small_gemm_reference)
from .contract import local_contraction
from .copy import local_copy, local_permute
from .permute import (maybe_permute, permute_4d, permute_4d_reference, permute_4d_tiled,
                      permute_eligible)
from .reduce import label_sum, scal, select
from .stencil import (aos_to_soa, soa_eligible, soa_to_aos, stencil_matvec_soa,
                      stencil_matvec_soa_reference, stencil_matvec_soa_rt,
                      stencil_matvec_soa_stream, stencil_matvec_soa_xin)

__all__ = ["batched_gemm", "cg_update", "contract", "copy", "dw_s5", "permute", "reduce",
           "roll_add", "stencil",
           "batched_small_gemm", "batched_gemm_rowpack", "batched_small_gemm_reference",
           "batched_gemm_route",
           "local_contraction", "local_copy", "local_permute",
           "label_sum", "select", "scal",
           "permute_4d", "permute_4d_reference", "permute_eligible", "maybe_permute",
           "permute_4d_tiled",
           "stencil_matvec_soa", "stencil_matvec_soa_reference", "stencil_matvec_soa_rt",
           "stencil_matvec_soa_xin", "stencil_matvec_soa_stream",
           "soa_eligible", "aos_to_soa", "soa_to_aos"]
