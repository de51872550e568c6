"""Plain PyTorch oracles for the port's kernels (reference:
``repro.kernels.ref``), in the stacked layout the kernels read:

  cp_inner_ref : x_factors (B, N, d, Rx), p_factors (N, K, d, Rp) -> (B, K)
  tt_inner_ref : x_cores (B, N, Rx, d, Rx), p_cores (N, K, Rp, d, Rp)
                 -> (B, K)  (boundary ranks zero-padded; chain from e_00)
  combine_ref  : codes (B, L, K) int, mults (K,) uint32 -> (B, L) uint32

uint32 values are int64 tensors in [0, 2^32).
"""

from __future__ import annotations

import torch

from repro_torch.core.contractions import tt_chain
from repro_torch.kernels.epilogues import U32_MASK, mul_u32


def cp_inner_ref(x_factors: torch.Tensor,
                 p_factors: torch.Tensor) -> torch.Tensor:
    """Batched <P_k, X_z> for CP x CP (no scales): product of Grams."""
    h = None
    for m in range(x_factors.shape[1]):
        g = torch.einsum("zdr,kdq->zkrq", x_factors[:, m], p_factors[m])
        h = g if h is None else h * g
    return h.sum(dim=(2, 3))


def tt_inner_ref(x_cores: torch.Tensor,
                 p_cores: torch.Tensor) -> torch.Tensor:
    """Batched <T_k, X_z> for TT x TT (no scales) in the padded layout:
    the chain from e_00, S[0, 0] at the end."""
    n = x_cores.shape[1]
    return tt_chain([x_cores[:, m, None] for m in range(n)],
                    [p_cores[m] for m in range(n)])


def combine_ref(codes: torch.Tensor, mults: torch.Tensor) -> torch.Tensor:
    """(..., L, K) int codes -> (..., L) uint32 radix bucket keys."""
    u = codes.to(torch.int64) & U32_MASK
    return mul_u32(u, mults.to(torch.int64)).sum(-1) & U32_MASK
