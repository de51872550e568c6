"""Closed-form collision probabilities and rank conditions from the paper
(reference: ``repro.core.theory``).

Tests and ``chip_smoke.py`` hold the empirical collision rates of the hash
families against these (Theorems 4, 6, 8 and 10). Phi is the standard
normal CDF, ``torch.special.ndtr``.
"""

from __future__ import annotations

import math

import torch


def e2lsh_collision_prob(r, w: float) -> torch.Tensor:
    """p(r) = Pr[h(x) = h(y)] for ||x - y|| = r (paper Eq. 3.4 / 4.17 /
    4.33). Closed form of int_0^w (1/r) f(t/r) (1 - t/w) dt with f the
    folded standard normal density (Datar et al. 2004):

        p(r) = 1 - 2 Phi(-w/r) - (2 r / (sqrt(2 pi) w)) (1 - exp(-w^2 / 2r^2))

    float32, as the reference computes it."""
    r = torch.as_tensor(r, dtype=torch.float32)
    t = w / r
    return (1.0 - 2.0 * torch.special.ndtr(-t)
            - (2.0 / (math.sqrt(2.0 * math.pi) * t))
            * (1.0 - torch.exp(-(t * t) / 2.0)))


def srp_collision_prob(cosine) -> torch.Tensor:
    """Pr[h(x) = h(y)] = 1 - theta/pi (paper Eq. 3.2 / 4.58 / 4.81)."""
    c = torch.clamp(torch.as_tensor(cosine), -1.0, 1.0)
    return 1.0 - torch.arccos(c) / math.pi


def cp_rank_condition(n_modes: int, dim: int, rank: int) -> float:
    """Ratio sqrt(R) N^(4/5) / d^((3N-8)/10) with d the per-mode dimension
    (Theorem 3/4 side condition, alpha = 5). The LSH guarantee needs this
    ratio -> 0 as the tensor grows; small values indicate the asymptotic
    regime. (Exponent on total size D = d^N is (3N-8)/(10N).)"""
    total = float(dim) ** n_modes
    return (math.sqrt(rank) * n_modes ** 0.8
            / total ** ((3 * n_modes - 8) / (10.0 * n_modes)))


def tt_rank_condition(n_modes: int, dim: int, rank: int) -> float:
    """Ratio sqrt(R^(N-1)) N^(4/5) / D^((3N-8)/10N) (Theorem 5/6
    condition)."""
    total = float(dim) ** n_modes
    return (math.sqrt(float(rank) ** (n_modes - 1)) * n_modes ** 0.8
            / total ** ((3 * n_modes - 8) / (10.0 * n_modes)))
