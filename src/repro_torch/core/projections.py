"""Tensorized random projections (paper §3.4, Definition 8), CP kind.

    f_CP(R)(X)_k = <P_k, X>,  P_k ~ CP_Rad(R)

The K projection tensors are stored stacked, per mode a (K, d_n, R) factor
stack, as in the reference package. The LSH families hash the raw <P, X>
(no 1/sqrt(K)), so ``normalize`` defaults to False.

``project_batch`` is the plain batched contraction of CP projections on a
batch of CP inputs (the reference's ``_project_cp_on_cp_batch``). The hash
path does not call it: it runs through ``repro_torch.kernels.ops.fused_hash``
(the K3 kernel on the card, its plain version on the CPU). It stays as the
format-level oracle the tests hold both against.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from repro_torch.core.tensor_formats import CPTensor


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


def _project_cp_on_cp_batch(p: CPProjection, xs: CPTensor) -> torch.Tensor:
    """(B, K) values of <P_k, X_z>, X in CP format. O(B K N d R R^)."""
    h = None
    for a, f in zip(xs.factors, p.factors):               # (B, d, R^), (K, d, R)
        g = torch.einsum("zir,kiq->zkrq", a, f)           # per-mode Gram
        h = g if h is None else h * g
    return (xs.scale * p.scale) * h.sum(dim=(2, 3))


def project_batch(p: CPProjection, xs: CPTensor) -> torch.Tensor:
    """Apply a CP projection family to a batch of CP tensors -> (B, K)."""
    if isinstance(p, CPProjection) and isinstance(xs, CPTensor):
        return _project_cp_on_cp_batch(p, xs)
    raise NotImplementedError(
        f"project_batch covers CP projections on CP inputs; "
        f"{type(p).__name__} on {type(xs).__name__} is queued in ROADMAP.md "
        "(modules 2-4: TT and dense formats)")
