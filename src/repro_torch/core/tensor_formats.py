"""CP tensor format (paper §3.3, Definitions 4 and 6) in PyTorch.

A tensor X in R^{d_1 x ... x d_N} in CP format is

    X = scale * sum_r  a_r^(1) o a_r^(2) o ... o a_r^(N)          (Def. 4)

with factor matrices A^(n) in R^{d_n x R}. A *batch* of CP tensors keeps a
leading batch axis on every factor: (B, d_n, R) per mode, the layout of the
reference package's batched pytrees.

Sampling takes an explicit ``torch.Generator`` where the reference takes a
``jax.random`` key; the two give different numbers from one seed, so tests
hand both packages the same numpy arrays (``repro_torch.convert``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch


@dataclasses.dataclass(frozen=True)
class CPTensor:
    """Rank-R CP decomposition tensor (paper Definition 4); factors are
    (d_n, R) per mode, or (B, d_n, R) for a batch."""

    factors: tuple[torch.Tensor, ...]
    scale: float = 1.0

    @property
    def rank(self) -> int:
        return self.factors[0].shape[-1]

    @property
    def dims(self) -> tuple[int, ...]:
        return tuple(f.shape[-2] for f in self.factors)

    @property
    def device(self) -> torch.device:
        return self.factors[0].device

    def index(self, idx) -> "CPTensor":
        """Select along the leading batch axis of every factor."""
        return CPTensor(tuple(f[idx] for f in self.factors), self.scale)

    def to(self, device) -> "CPTensor":
        return CPTensor(tuple(f.to(device) for f in self.factors), self.scale)


def _shape(batch: int | None, *shape: int) -> tuple[int, ...]:
    return shape if batch is None else (batch,) + shape


def cp_rademacher(gen: torch.Generator, dims: Sequence[int], rank: int,
                  batch: int | None = None) -> CPTensor:
    """CP-Rademacher tensor, P ~ CP_Rad(R) (paper Definition 6):
    P = (1/sqrt(R)) [[A^(1), ..., A^(N)]], A^(n)[i,j] iid +-1 w.p. 1/2.
    Made on the generator's device."""
    factors = tuple(
        2.0 * torch.randint(0, 2, _shape(batch, d, rank), generator=gen,
                            device=gen.device).float() - 1.0
        for d in dims)
    return CPTensor(factors, scale=1.0 / math.sqrt(rank))


def cp_random_data(gen: torch.Generator, dims: Sequence[int], rank: int,
                   batch: int | None = None) -> CPTensor:
    """Random *data* tensors in rank-R^ CP format: N(0, 1)/sqrt(d_n) factor
    entries, scale 1 (the reference's ``cp_random_data``); ``batch`` makes
    B of them at once. Made on the generator's device."""
    factors = tuple(
        torch.randn(_shape(batch, d, rank), generator=gen,
                    device=gen.device) / math.sqrt(d)
        for d in dims)
    return CPTensor(factors, scale=1.0)


def cp_to_dense(x: CPTensor) -> torch.Tensor:
    """Materialize one CP tensor: X = scale * sum_r (x)_n a_r^(n). Test
    oracle only: O(d^N) memory."""
    acc = x.factors[0]                                    # (d1, R)
    for f in x.factors[1:]:
        acc = acc[..., None, :] * f                       # (..., d_k, R)
    return x.scale * acc.sum(dim=-1)
