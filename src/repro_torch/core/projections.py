"""Tensorized random projections (paper §3.4, Definitions 8 and 9).

    f_CP(R)(X)_k = <P_k, X>,  P_k ~ CP_Rad(R)
    f_TT(R)(X)_k = <T_k, X>,  T_k ~ TT_Rad(R)

The K projection tensors are stored stacked, per mode a (K, d_n, R) factor
stack or a (K, r_{n-1}, d_n, r_n) core stack, as in the reference package.
The LSH families hash the raw <P, X> (no 1/sqrt(K)), so ``normalize``
defaults to False.

``project_batch`` is the plain batched contraction of CP projections on CP
inputs and of TT projections on TT inputs (the reference's
``_project_cp_on_cp_batch`` / ``_project_tt_on_tt_batch``), through the
format's ``pair_inners``. The hash path
does not call it: it runs through ``repro_torch.kernels.ops.fused_hash``
(the K3 / K4 kernels on the card, their plain versions on the CPU). It
stays as the format-level oracle the tests hold both against. The
cross-format pairs are queued (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from repro_torch.core.tensor_formats import CPTensor, TTTensor, _tt_core_shapes


@dataclasses.dataclass(frozen=True)
class CPProjection:
    """K stacked CP_Rad(R) projection tensors (Definitions 6, 8)."""

    factors: tuple[torch.Tensor, ...]  # each (K, d_n, R)
    scale: float                       # 1/sqrt(R) [* 1/sqrt(K)]

    @property
    def num_hashes(self) -> int:
        return self.factors[0].shape[0]

    @property
    def rank(self) -> int:
        return self.factors[0].shape[-1]

    @property
    def dims(self) -> tuple[int, ...]:
        return tuple(f.shape[1] for f in self.factors)

    @property
    def leaves(self) -> tuple[torch.Tensor, ...]:
        return self.factors

    input_format = CPTensor

    def stacked(self, num_tables: int) -> torch.Tensor:
        """The K3 layout (N, L, K, d, R), stacked once per family."""
        from repro_torch.kernels.ops import _stack_cp_proj
        return _stack_cp_proj(self, num_tables).contiguous()


@dataclasses.dataclass(frozen=True)
class TTProjection:
    """K stacked TT_Rad(R) projection tensors (Definitions 7, 9)."""

    cores: tuple[torch.Tensor, ...]    # each (K, r_{n-1}, d_n, r_n)
    scale: float                       # 1/sqrt(R^(N-1)) [* 1/sqrt(K)]

    @property
    def num_hashes(self) -> int:
        return self.cores[0].shape[0]

    @property
    def ranks(self) -> tuple[int, ...]:
        """(r_0, r_1, ..., r_N)."""
        return (tuple(c.shape[1] for c in self.cores)
                + (self.cores[-1].shape[3],))

    @property
    def rank(self) -> int:
        return max(self.ranks)

    @property
    def dims(self) -> tuple[int, ...]:
        return tuple(c.shape[2] for c in self.cores)

    @property
    def leaves(self) -> tuple[torch.Tensor, ...]:
        return self.cores

    input_format = TTTensor

    def stacked(self, num_tables: int) -> torch.Tensor:
        """The K4 layout (N, L, K, Rp, d, Rp), stacked once per family."""
        from repro_torch.kernels.ops import _stack_tt_proj
        return _stack_tt_proj(self, num_tables).contiguous()


def sample_cp_projection(gen: torch.Generator, num_hashes: int,
                         dims: Sequence[int], rank: int,
                         normalize: bool = False) -> CPProjection:
    """K Rademacher CP projections, made on the generator's device."""
    factors = tuple(
        2.0 * torch.randint(0, 2, (num_hashes, d, rank), generator=gen,
                            device=gen.device).float() - 1.0
        for d in dims)
    scale = 1.0 / math.sqrt(rank)
    if normalize:  # the 1/sqrt(K) of Definition 8
        scale /= math.sqrt(num_hashes)
    return CPProjection(factors=factors, scale=scale)


def sample_tt_projection(gen: torch.Generator, num_hashes: int,
                         dims: Sequence[int], rank: int,
                         normalize: bool = False) -> TTProjection:
    """K Rademacher TT projections, made on the generator's device."""
    cores = tuple(
        2.0 * torch.randint(0, 2, (num_hashes,) + s, generator=gen,
                            device=gen.device).float() - 1.0
        for s in _tt_core_shapes(dims, rank))
    scale = 1.0 / math.sqrt(rank ** (len(dims) - 1))
    if normalize:
        scale /= math.sqrt(num_hashes)
    return TTProjection(cores=cores, scale=scale)


def project_batch(p, xs) -> torch.Tensor:
    """Apply a CP (TT) projection family to a batch of CP (TT) tensors ->
    (B, K): <P_k, X_z> over (B, 1) x (K,) leading axes."""
    if not isinstance(xs, p.input_format):
        raise NotImplementedError(
            f"project_batch covers CP on CP and TT on TT; {type(p).__name__} "
            f"on {type(xs).__name__} is queued in ROADMAP.md (cross-format "
            "pairs, dense corpora)")
    return xs.index((slice(None), None)).pair_inners(
        p.input_format(p.leaves, p.scale))
