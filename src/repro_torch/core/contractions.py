"""Inner products, norms and distances of dense / CP / TT tensors, in format.

Costs, as in the reference (paper Remarks 1-6):

  <CP, CP>     O(N d R^ R)      per-mode Grams
  <CP, TT>     O(N d max{R^,R}^3)  the chain with an (R^ x r) state
  <TT, TT>     O(N d R^3)       the transfer-matrix chain
  <dense, CP>  O(R d^N)         mode-by-mode contraction, rank axis kept
  <dense, TT>  O(R^2 d^N)       cores swept left to right
  <dense, dense> O(d^N)         the naive method's primitive

The CP x CP and TT x TT inner products are the reference's
(``repro.core.contractions``):

    <X, Y> = sx*sy * sum_{r,q} prod_n (A_x^(n)T A_y^(n))[r, q]      (CP)

per-mode Grams, a Hadamard product across modes in mode order, one sum,
then the scale product; and the TT transfer-matrix chain

    S <- ones(1, 1);  S <- sum_i Gx[:, i, :]^T S Gy[:, i, :] per mode;
    <X, Y> = sx*sy * S                                               (TT)

and, across formats, each CP rank's rank-1 term through the TT chain
(``cp_tt_chain``, the reference's ``inner_cp_tt``).

``gram_sum``, ``tt_chain``, ``cp_tt_chain`` and the dense contractions
(``dense_cp_sum``, ``dense_tt_sum``) take leading axes that broadcast, so
one code serves a single pair, a batch of pairs and a (queries x items)
matrix; the format classes' ``pair_inners`` call the same-format ones and
``pair_inners`` here dispatches on the (x, y) pair of formats, x first as
in the reference's ``inner(q, y)``. Distance and cosine keep the
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


def dense_pair_inners(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """<x, y> of flat rows (..., D) whose leading axes broadcast -> (...).
    A (A, 1, D) x (1, C, D) pair (every query against every item) is one
    matrix product; otherwise a batched dot, neither expanding the rows."""
    if (x.dim() == y.dim() == 3 and x.shape[1] == 1 and y.shape[0] == 1):
        return x[:, 0] @ y[0].T
    return torch.einsum("...d,...d->...", x, y)


_MODES = "abcdefghijklmnopqrstuvw"


def dense_cp_sum(x: torch.Tensor, factors) -> torch.Tensor:
    """sum_r prod_n <x, a_r^(n)> of dense x (..., d_1, ..., d_N) and CP
    factors (..., d_n, R) whose leading axes broadcast -> (...), before the
    CP scale: one mode at a time, keeping the rank axis (the reference's
    tensordot over mode 1, then ``ri...,ir->r...`` per mode), then the sum
    over the rank. O(R d^N)."""
    n = len(factors)
    m = _MODES[:n]
    t = torch.einsum(f"...{m},...{m[0]}z->...z{m[1:]}", x, factors[0])
    for k, f in enumerate(factors[1:], start=1):
        t = torch.einsum(f"...z{m[k:]},...{m[k]}z->...z{m[k + 1:]}", t, f)
    return t.sum(dim=-1)


def dense_tt_sum(x: torch.Tensor, cores) -> torch.Tensor:
    """<x, G> of dense x (..., d_1, ..., d_N) and TT cores (..., r, d_n, r')
    whose leading axes broadcast -> (...), before the TT scale: the cores
    swept left to right through x (the reference's ``ai...,air->r...``).
    O(R^2 d^N)."""
    n = len(cores)
    m = _MODES[:n]
    t = torch.einsum(f"...{m},...{m[0]}z->...z{m[1:]}", x,
                     cores[0][..., 0, :, :])
    for k, c in enumerate(cores[1:], start=1):
        t = torch.einsum(f"...y{m[k:]},...y{m[k]}z->...z{m[k + 1:]}", t, c)
    return t[..., 0]


def inner_dense_cp(x: torch.Tensor, y: CPTensor) -> torch.Tensor:
    """<X, Y> for dense X (d_1, ..., d_N), CP Y: contract one mode at a
    time, keeping the rank axis. O(R d^N); never forms the d^N projection
    vector of the naive method."""
    return y.scale * dense_cp_sum(x, y.factors)


def inner_dense_tt(x: torch.Tensor, y: TTTensor) -> torch.Tensor:
    """<X, Y> for dense X (d_1, ..., d_N), TT Y: sweep the cores left to
    right. O(R^2 d^N)."""
    return y.scale * dense_tt_sum(x, y.cores)


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


def cp_tt_chain(factors, cores) -> torch.Tensor:
    """sum over the chain of CP factors (..., d, R^) and TT cores (..., r,
    d, r') per mode whose leading axes broadcast -> (...) values, before
    scales: for each CP rank its rank-1 term goes through the TT chain with
    an (R^ x r) state, S'[q, b] = sum_i A[i, q] sum_a S[q, a] G[a, i, b]
    (the reference's ``ra,aib,ir->rb``, the state and the core contracted
    first), then the sum over the ranks."""
    s = None
    for a, g in zip(factors, cores):
        if s is None:               # S = ones(R^, 1): the first core's row 0
            t = g[..., 0, :, :].unsqueeze(-3)                   # (.., 1, d, b)
        else:
            t = torch.einsum("...qa,...aib->...qib", s, g)  # (.., R^, d, b)
        s = torch.einsum("...qib,...iq->...qb", t, a)
    return s.sum(dim=(-2, -1))


def inner_cp_tt(x: CPTensor, y: TTTensor) -> torch.Tensor:
    """<X, Y> for X in CP format and Y in TT format (over leading batch axes
    that broadcast). Cost O(N d max{R^, R}^3): the paper's CP-E2LSH on TT
    inputs and TT-E2LSH on CP inputs."""
    return (x.scale * y.scale) * cp_tt_chain(x.factors, y.cores)


def _dense_data(x):
    """A dense operand's array (a plain tensor or a ``DenseTensor``), or
    None for a CP or TT one."""
    if isinstance(x, torch.Tensor):
        return x
    return x.data if x.layout == "dense" else None


def pair_inners(x, y) -> torch.Tensor:
    """<x, y> over leading batch axes that broadcast, for any pair of
    formats (CP, TT or ``DenseTensor``), scales applied: the same-format
    pairs through the format's own ``pair_inners``, dense x CP through
    ``dense_cp_sum``, dense x TT through ``dense_tt_sum`` and CP x TT
    through ``cp_tt_chain``, in either order."""
    if x.layout == y.layout:
        return x.pair_inners(y)
    if x.layout == "dense" or y.layout == "dense":
        dense, other = (x, y) if x.layout == "dense" else (y, x)
        if other.layout == "cp":
            return other.scale * dense_cp_sum(dense.data, other.factors)
        return other.scale * dense_tt_sum(dense.data, other.cores)
    cp, tt = (x, y) if x.layout == "cp" else (y, x)
    return inner_cp_tt(cp, tt)


def inner(x, y) -> torch.Tensor:
    """<x, y> over {dense, CP, TT} x {dense, CP, TT}. A dense operand is a
    plain tensor or a ``DenseTensor``."""
    dx, dy = _dense_data(x), _dense_data(y)
    if dx is not None and dy is not None:
        return inner_dense_dense(dx, dy)
    if dx is not None or dy is not None:
        dense, other = (dx, y) if dx is not None else (dy, x)
        if other.layout == "cp":
            return inner_dense_cp(dense, other)
        return inner_dense_tt(dense, other)
    return pair_inners(x, y)


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
