"""Tensorized random projections (paper §3.4, Definitions 8 and 9) and the
naive method's dense one (paper §2).

    f_CP(R)(X)_k = <P_k, X>,  P_k ~ CP_Rad(R)
    f_TT(R)(X)_k = <T_k, X>,  T_k ~ TT_Rad(R)
    f(X)_k       = <M_k, vec(X)>, M a (K, prod d) Gaussian matrix

The K projection tensors are stored stacked, per mode a (K, d_n, R) factor
stack or a (K, r_{n-1}, d_n, r_n) core stack, as in the reference package.
The LSH families hash the raw <P, X> (no 1/sqrt(K)), so ``normalize``
defaults to False.

``project_batch`` gives (B, K) values for every pair the reference's
does:

  * CP on CP, TT on TT: the format's ``pair_inners``, the oracle the tests
    hold K3 / K4 against (the hash path runs those kernels,
    ``repro_torch.kernels.ops.fused_hash``);
  * CP on TT inputs and TT on CP inputs: each CP rank's rank-1 term through
    the TT chain (``contractions.cp_tt_chain``; the reference's
    ``_project_cp_on_tt_batch`` / ``_project_tt_on_cp_batch``), an (R^ x r)
    state per (row, hash);
  * CP or TT on dense inputs: the K projection tensors densified once per
    projection (``materialized``, cached) and one (B, prod d) x (prod d, K)
    matrix product, or, when the densified stack would pass
    ``MATERIALIZE_LIMIT``, the mode-by-mode chain (the reference's
    ``_project_cp_on_dense_batch`` / ``_project_tt_on_dense_batch``);
  * the dense projection on any input: CP and TT inputs densified, then one
    matrix product (``_project_dense_on_any_batch``, the paper's reshape
    baseline).

These dense and cross-format pairs are the hash path itself (the reference
computes them in XLA, outside any Pallas kernel): fp32 matrix products and
contractions with TF32 off (``import repro_torch`` turns it off). Each runs
over fixed chunks of rows
(``chunk_rows``, the last zero-padded), so every row's value comes from a
product of the same shape whatever the batch: a corpus hashed 65,536 items
at a time and the same items queried 1,024 at a time get the same raw
values bit for bit, and an item queried as itself lands in its own buckets.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Sequence

import torch

from repro_torch.core.contractions import cp_tt_chain
from repro_torch.core.tensor_formats import (CPTensor, DenseTensor, TTTensor,
                                             _tt_core_shapes, batch_of_one)

# Above this many elements of peak intermediate (K * prod d * R, the
# densified stack with its rank axis) the projections are not materialized
# and the mode-by-mode chain runs instead (the reference's limit).
MATERIALIZE_LIMIT = 1 << 24
# Rows of one matrix product of the dense pairs; the chain takes as many
# rows as keep its (rows, K, R, d_2 ... d_N) intermediate near CHAIN_FLOATS.
MATMUL_ROWS = 1024
CHAIN_FLOATS = 1 << 26


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
    layout = "cp"

    def storage_size(self) -> int:
        """O(K N d R) stored scalars (paper Remark 1)."""
        return sum(f.numel() for f in self.factors)

    def with_leaves(self, leaves) -> "CPProjection":
        return CPProjection(tuple(leaves), self.scale)

    def single(self, k: int) -> CPTensor:
        """The k-th projection tensor P_k as a plain ``CPTensor``."""
        return CPTensor(tuple(f[k] for f in self.factors), scale=self.scale)

    def stacked(self, num_tables: int) -> torch.Tensor:
        """The K3 layout (N, L, K, d, R), stacked once per family."""
        from repro_torch.kernels.ops import _stack_cp_proj
        return _stack_cp_proj(self, num_tables).contiguous()

    @functools.cached_property
    def materialized(self) -> torch.Tensor | None:
        """(K, prod d) densified projections, scale applied, made once
        (None above ``MATERIALIZE_LIMIT``)."""
        return _materialize_cp(self) if _can_materialize(self) else None


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
    layout = "tt"

    def storage_size(self) -> int:
        """O(K N d R^2) stored scalars (paper Remark 2)."""
        return sum(c.numel() for c in self.cores)

    def with_leaves(self, leaves) -> "TTProjection":
        return TTProjection(tuple(leaves), self.scale)

    def single(self, k: int) -> TTTensor:
        """The k-th projection tensor T_k as a plain ``TTTensor``."""
        return TTTensor(tuple(c[k] for c in self.cores), scale=self.scale)

    def stacked(self, num_tables: int) -> torch.Tensor:
        """The K4 layout (N, L, K, Rp, d, Rp), stacked once per family."""
        from repro_torch.kernels.ops import _stack_tt_proj
        return _stack_tt_proj(self, num_tables).contiguous()

    @functools.cached_property
    def materialized(self) -> torch.Tensor | None:
        """(K, prod d) densified projections, scale applied, made once
        (None above ``MATERIALIZE_LIMIT``)."""
        return _materialize_tt(self) if _can_materialize(self) else None


@dataclasses.dataclass(frozen=True)
class DenseProjection:
    """The naive method's K projections (paper §2): a (K, prod d_n)
    Gaussian matrix applied to the reshaped tensor."""

    matrix: torch.Tensor               # (K, prod(dims))
    dims: tuple[int, ...]
    scale: float = 1.0

    @property
    def num_hashes(self) -> int:
        return self.matrix.shape[0]

    @property
    def leaves(self) -> tuple[torch.Tensor, ...]:
        return (self.matrix,)

    input_format = DenseTensor
    layout = "dense"
    rank = 1

    def storage_size(self) -> int:
        """O(K d^N) stored scalars: exponential in N."""
        return self.matrix.numel()

    def with_leaves(self, leaves) -> "DenseProjection":
        (matrix,) = tuple(leaves)
        return DenseProjection(matrix, self.dims, self.scale)


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


def sample_dense_projection(gen: torch.Generator, num_hashes: int,
                            dims: Sequence[int],
                            normalize: bool = False) -> DenseProjection:
    """K Gaussian rows of the naive method's (K, prod d) matrix, made on
    the generator's device."""
    m = torch.randn((num_hashes, math.prod(dims)), generator=gen,
                    device=gen.device)
    scale = 1.0 / math.sqrt(num_hashes) if normalize else 1.0
    return DenseProjection(matrix=m, dims=tuple(dims), scale=scale)


# ---------------------------------------------------------------------------
# Materialization (the dense-input path)
# ---------------------------------------------------------------------------


def _materialize_cp(p: CPProjection) -> torch.Tensor:
    """All K projection tensors densified at once -> (K, prod d), the
    reference's einsum chain and scale."""
    acc = p.factors[0]                                    # (K, d_1, R)
    for f in p.factors[1:]:
        acc = torch.einsum("k...r,kir->k...ir", acc, f)
    return (p.scale * acc.sum(dim=-1)).reshape(p.num_hashes, -1)


def _materialize_tt(p: TTProjection) -> torch.Tensor:
    """All K projection tensors densified at once -> (K, prod d)."""
    acc = p.cores[0][:, 0]                                # (K, d_1, r_1)
    for c in p.cores[1:]:
        acc = torch.einsum("k...a,kaib->k...ib", acc, c)
    return (p.scale * acc[..., 0]).reshape(p.num_hashes, -1)


def _can_materialize(p) -> bool:
    return p.num_hashes * math.prod(p.dims) * p.rank <= MATERIALIZE_LIMIT


# ---------------------------------------------------------------------------
# Batched application: (B, ...) inputs -> (B, K) values
# ---------------------------------------------------------------------------


def chunk_rows(p, xs=None) -> int:
    """Rows of one fixed-shape product of ``p`` on ``xs``: ``MATMUL_ROWS``
    for a matrix product, fewer for the chain (its intermediate holds
    K * R * prod d / d_1 floats a row) and for a cross-format pair (K * R^ *
    d * r a row). Depends on the shapes and ranks only."""
    if xs is not None and xs.layout not in ("dense", p.layout):
        per_row = p.num_hashes * p.rank * xs.rank * max(p.dims)
    elif isinstance(p, DenseProjection) or p.materialized is not None:
        return MATMUL_ROWS
    else:
        per_row = p.num_hashes * p.rank * math.prod(p.dims[1:])
    return max(1, min(MATMUL_ROWS, CHAIN_FLOATS // per_row))


def _by_chunks(fn, xs, rows: int, k: int) -> torch.Tensor:
    """``fn`` over ``xs`` in chunks of exactly ``rows`` rows (the last one
    zero-padded, every chunk a fresh contiguous copy unless it is a full,
    16-byte aligned slice), so that each product has one shape and one
    alignment whatever B is -> the (B, K) rows."""
    n = xs.leaves[0].shape[0]
    out = []
    for s in range(0, n, rows):
        part = xs.index(slice(s, min(s + rows, n)))
        m = part.leaves[0].shape[0]
        if m < rows or any(not a.is_contiguous() or a.data_ptr() % 16
                           for a in part.leaves):
            part = part.with_leaves(
                torch.cat([a.float(), a.new_zeros((rows - m,) + a.shape[1:],
                                                  dtype=torch.float32)])
                for a in part.leaves)
        out.append(fn(part)[:m])
    if not out:
        return xs.leaves[0].new_zeros((0, k), dtype=torch.float32)
    return torch.cat(out)


def densify_batch(xs) -> torch.Tensor:
    """A batch of any format -> (B, prod d) dense rows (scale applied)."""
    if xs.layout == "dense":
        return xs.flat
    if xs.layout == "cp":
        acc = xs.factors[0]                               # (B, d_1, R)
        for f in xs.factors[1:]:
            acc = torch.einsum("z...r,zir->z...ir", acc, f)
        return (xs.scale * acc.sum(dim=-1)).reshape(acc.shape[0], -1)
    acc = xs.cores[0][:, 0]                               # (B, d_1, r_1)
    for c in xs.cores[1:]:
        acc = torch.einsum("z...a,zaib->z...ib", acc, c)
    return (xs.scale * acc[..., 0]).reshape(acc.shape[0], -1)


def _project_on_dense_chunk(p, xs: DenseTensor) -> torch.Tensor:
    """(rows, K) values of a CP or TT projection on dense rows: the
    materialized stack's matrix product, or the mode-by-mode chain."""
    m = p.materialized
    if m is not None:
        return xs.flat @ m.T
    x = xs.data
    if p.layout == "cp":
        t = torch.einsum("zi...,kir->zkr...", x, p.factors[0])
        for f in p.factors[1:]:
            t = torch.einsum("zkri...,kir->zkr...", t, f)
        return p.scale * t.sum(dim=2)
    t = torch.einsum("zi...,kair->zkr...", x, p.cores[0])   # a == 1
    for core in p.cores[1:]:
        t = torch.einsum("zkai...,kair->zkr...", t, core)
    return p.scale * t.reshape(t.shape[0], p.num_hashes)


def _project_dense_on_chunk(p: DenseProjection, xs) -> torch.Tensor:
    """(rows, K) naive-method values: densify, one matrix product."""
    return p.scale * (densify_batch(xs) @ p.matrix.T)


def _project_cross_chunk(p, xs) -> torch.Tensor:
    """(rows, K) values of a CP projection on TT rows or a TT projection on
    CP rows: the chain with an (R^ x r) state per (row, hash)."""
    proj = [a[None] for a in p.leaves]                    # (1, K, ...)
    rows = [a[:, None] for a in xs.leaves]                # (rows, 1, ...)
    cp, tt = (proj, rows) if p.layout == "cp" else (rows, proj)
    return (xs.scale * p.scale) * cp_tt_chain(cp, tt)


def project_batch(p, xs) -> torch.Tensor:
    """Apply a projection family to a batch (leading axis on every leaf)
    -> (B, K) values (see the module docstring for the pairs)."""
    if isinstance(p, DenseProjection):
        return _by_chunks(functools.partial(_project_dense_on_chunk, p), xs,
                          MATMUL_ROWS, p.num_hashes)
    if xs.layout == "dense":
        return _by_chunks(functools.partial(_project_on_dense_chunk, p), xs,
                          chunk_rows(p), p.num_hashes)
    if xs.layout != p.layout:
        return _by_chunks(functools.partial(_project_cross_chunk, p), xs,
                          chunk_rows(p, xs), p.num_hashes)
    return xs.index((slice(None), None)).pair_inners(
        p.input_format(p.leaves, p.scale))


def project(p, x) -> torch.Tensor:
    """Apply a projection family to one tensor -> (K,) values: the
    batch-of-1 case of ``project_batch`` (a dense tensor may come as a
    plain (d_1, ..., d_N) tensor)."""
    return project_batch(p, batch_of_one(x))[0]
