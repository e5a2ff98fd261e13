"""Kernels with their plain PyTorch versions, and the local tensor engine
(copy, permute, reduce, contraction) built on them."""

from . import contract, copy, permute, reduce, stencil
from .contract import local_contraction
from .copy import local_copy, local_permute
from .permute import maybe_permute, permute_4d, permute_4d_reference, permute_eligible
from .reduce import label_sum, scal, select
from .stencil import (aos_to_soa, soa_eligible, soa_to_aos, stencil_matvec_soa,
                      stencil_matvec_soa_reference, stencil_matvec_soa_stream,
                      stencil_matvec_soa_xin)

__all__ = ["contract", "copy", "permute", "reduce", "stencil",
           "local_contraction", "local_copy", "local_permute",
           "label_sum", "select", "scal",
           "permute_4d", "permute_4d_reference", "permute_eligible", "maybe_permute",
           "stencil_matvec_soa", "stencil_matvec_soa_reference",
           "stencil_matvec_soa_xin", "stencil_matvec_soa_stream",
           "soa_eligible", "aos_to_soa", "soa_to_aos"]
