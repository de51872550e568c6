"""Inner products, norms and distances of dense / CP / TT tensors, in format.

The CP x CP and TT x TT inner products are the reference's
(``repro.core.contractions``):

    <X, Y> = sx*sy * sum_{r,q} prod_n (A_x^(n)T A_y^(n))[r, q]      (CP)

per-mode Grams, a Hadamard product across modes in mode order, one sum,
then the scale product; and the TT transfer-matrix chain

    S <- ones(1, 1);  S <- sum_i Gx[:, i, :]^T S Gy[:, i, :] per mode;
    <X, Y> = sx*sy * S                                               (TT)

``gram_sum`` and ``tt_chain`` take leading axes that broadcast, so one code
serves a single pair, a batch of pairs and a (queries x items) matrix; the
format classes' ``pair_inners`` call them. Distance and cosine keep the
reference's expansion order: sqrt(max(<x,x> + <y,y> - 2<x,y>, 0)) and
<x,y> / (||x|| ||y||).
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch

if TYPE_CHECKING:
    from repro_torch.core.tensor_formats import CPTensor, TTTensor


def inner_dense_dense(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.dot(x.reshape(-1), y.reshape(-1))


def gram_sum(xfactors, yfactors) -> torch.Tensor:
    """sum_{r,q} prod_n (A_x^(n)T A_y^(n))[r, q] of paired factors (..., d,
    R) per mode whose leading axes broadcast -> (...) values, before
    scales: the Grams in mode order, one sum."""
    h = None
    for fx, fy in zip(xfactors, yfactors):
        g = torch.einsum("...dr,...dq->...rq", fx, fy)
        h = g if h is None else h * g
    return h.sum(dim=(-2, -1))


def inner_cp_cp(x: CPTensor, y: CPTensor) -> torch.Tensor:
    """<X, Y> for CP tensors (over leading batch axes that broadcast): sum
    of the Hadamard product of per-mode Grams. Cost O(N d R^ R)."""
    return (x.scale * y.scale) * gram_sum(x.factors, y.factors)


def tt_chain(xcores, ycores) -> torch.Tensor:
    """sum over the TT chain of paired cores, before scales: cores
    (..., r, d, r') per mode whose leading axes broadcast -> (...) values.
    Per mode S'[c, e] = sum_{a, i, b} Gx[a, i, c] S[a, b] Gy[b, i, e],
    contracted over a first, then over (b, i) (the reference's order)."""
    s = None
    for gx, gy in zip(xcores, ycores):
        if s is None:               # S = ones(1, 1): the first cores' row 0
            s = torch.einsum("...ic,...ie->...ce", gx[..., 0, :, :],
                             gy[..., 0, :, :])
            continue
        t = torch.einsum("...ab,...aic->...bic", s, gx)
        s = torch.einsum("...bic,...bie->...ce", t, gy)
    return s[..., 0, 0]


def inner_tt_tt(x: TTTensor, y: TTTensor) -> torch.Tensor:
    """<X, Y> for two TT tensors via the transfer-matrix chain. Cost
    O(N d max{R^, R}^3)."""
    return (x.scale * y.scale) * tt_chain(x.cores, y.cores)


def inner(x, y) -> torch.Tensor:
    """<x, y> for two CP, two TT or two dense tensors. The mixed pairs come
    with the cross-format and dense items of ROADMAP.md."""
    if isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor):
        return inner_dense_dense(x, y)
    if type(x) is not type(y):
        raise NotImplementedError(
            f"inner of {type(x).__name__} and {type(y).__name__} is queued "
            "in ROADMAP.md (cross-format pairs, dense corpora)")
    return x.pair_inners(y)


def norm(x) -> torch.Tensor:
    """Frobenius norm ||X||_F in format (paper §3.3)."""
    return torch.sqrt(torch.clamp(inner(x, x), min=0.0))


def distance(x, y) -> torch.Tensor:
    """||X - Y||_F (paper Eq. 3.5) via ||X||^2 + ||Y||^2 - 2<X,Y>."""
    d2 = inner(x, x) + inner(y, y) - 2.0 * inner(x, y)
    return torch.sqrt(torch.clamp(d2, min=0.0))


def cosine_similarity(x, y) -> torch.Tensor:
    """cos(theta) = <X,Y> / (||X||_F ||Y||_F) (paper Eq. 3.6), in format."""
    return inner(x, y) / (norm(x) * norm(y))
