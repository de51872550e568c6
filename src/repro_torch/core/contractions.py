"""Inner products, norms and distances of dense / CP tensors, in format.

The CP x CP inner product is the reference's (``repro.core.contractions``):

    <X, Y> = sx*sy * sum_{r,q} prod_n (A_x^(n)T A_y^(n))[r, q]

per-mode Grams, a Hadamard product across modes in mode order, one sum,
then the scale product. Distance and cosine keep the reference's
expansion order: sqrt(max(<x,x> + <y,y> - 2<x,y>, 0)) and
<x,y> / (||x|| ||y||).
"""

from __future__ import annotations

import torch

from repro_torch.core.tensor_formats import CPTensor


def inner_dense_dense(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.dot(x.reshape(-1), y.reshape(-1))


def inner_cp_cp(x: CPTensor, y: CPTensor) -> torch.Tensor:
    """<X, Y> for two CP tensors: sum of the Hadamard product of per-mode
    Grams. Cost O(N d R^ R)."""
    h = None
    for fx, fy in zip(x.factors, y.factors):
        g = fx.T @ fy                                     # (R^, R)
        h = g if h is None else h * g
    return (x.scale * y.scale) * h.sum()


def inner(x, y) -> torch.Tensor:
    """<x, y> for two CP tensors or two dense tensors. The mixed and TT
    pairs come with the dense and TT corpora (ROADMAP.md)."""
    if isinstance(x, CPTensor) and isinstance(y, CPTensor):
        return inner_cp_cp(x, y)
    if isinstance(x, CPTensor) or isinstance(y, CPTensor):
        raise NotImplementedError(
            "inner of a CP and a dense tensor is queued in ROADMAP.md "
            "(dense corpora)")
    return inner_dense_dense(x, y)


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
