"""Dense, CP and TT tensor formats (paper §3.3, Definitions 4-7) in PyTorch.

A tensor X in R^{d_1 x ... x d_N} in CP format is

    X = scale * sum_r  a_r^(1) o a_r^(2) o ... o a_r^(N)          (Def. 4)

with factor matrices A^(n) in R^{d_n x R}; in TT format it is

    X[i_1, ..., i_N] = scale * G_1[:, i_1, :] G_2[:, i_2, :] ... G_N[:, i_N, :]
                                                                  (Def. 5)

with cores G_n in R^{r_{n-1} x d_n x r_n}, r_0 = r_N = 1. A *batch* keeps a
leading batch axis on every factor or core: (B, d_n, R) or (B, r_{n-1}, d_n,
r_n) per mode, the layout of the reference package's batched pytrees. A
dense batch is a plain (B, d_1, ..., d_N) float32 tensor, as the reference
takes it; ``as_batch`` wraps it once, at the entry points, in a
``DenseTensor`` (scale 1), so that the segments, the index and the kernels'
wrappers treat the three formats alike.

Each format class is the one place that knows its format: ``layout`` (the
name the kernels' wrappers key on), ``row_floats`` (one item's floats at its
true ranks), ``stack`` (the kernels' layout, ``repro_torch.kernels.ops``),
``pair_inners`` / ``self_inners`` (the in-format inner products of
``repro_torch.core.contractions``), ``inner_length`` (the longest fp32 sum
of one inner product, for the rounding bounds), ``abs``, ``with_leaves``
(the same format over other leaves) and ``kernel_shape`` (the (N, d, R)
that K1 reads off the stacked layout). Callers use these and do not test
the type.

Sampling takes an explicit ``torch.Generator`` where the reference takes a
``jax.random`` key; the two give different numbers from one seed, so tests
hand both packages the same numpy arrays (``repro_torch.convert``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from repro_torch.core import contractions


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

    def storage_size(self) -> int:
        """Number of stored scalars: O(N d R) (paper Remark 3)."""
        return sum(f.numel() for f in self.factors)

    @property
    def leaves(self) -> tuple[torch.Tensor, ...]:
        return self.factors

    layout = "cp"

    @property
    def row_floats(self) -> int:
        """Floats of one item: sum_n d_n * R."""
        return sum(f.shape[-2] * f.shape[-1] for f in self.factors)

    def abs(self) -> "CPTensor":
        return CPTensor(tuple(f.abs() for f in self.factors), abs(self.scale))

    def pair_inners(self, other: "CPTensor") -> torch.Tensor:
        """<X, Y> over leading batch axes that broadcast, scales applied."""
        return contractions.inner_cp_cp(self, other)

    def self_inners(self) -> torch.Tensor:
        return self.pair_inners(self)

    def inner_length(self, rank: int) -> int:
        """The longest fp32 sum in one inner product with a CP tensor of
        rank ``rank``: d + N + R*R (the d-long dots, the N-fold product, the
        R*R-term sum)."""
        return (max(self.dims) + len(self.factors)
                + max(self.rank, rank) ** 2)

    def with_leaves(self, leaves) -> "CPTensor":
        return CPTensor(tuple(leaves), self.scale)

    def stack(self) -> tuple["CPTensor", torch.Tensor]:
        """-> (this batch with factors that view ``stacked``, stacked (B, N,
        d, R) float32): the kernels' layout (``ops.stack_cp``)."""
        from repro_torch.kernels.ops import stack_cp
        return stack_cp(self)

    @staticmethod
    def kernel_shape(stacked: torch.Tensor) -> tuple[int, int, int]:
        """(N, d, R) of a stacked (..., N, d, R) batch."""
        return stacked.shape[-3], stacked.shape[-2], stacked.shape[-1]


@dataclasses.dataclass(frozen=True)
class TTTensor:
    """Rank-R tensor-train tensor (paper Definition 5); cores are
    (r_{n-1}, d_n, r_n) per mode with r_0 = r_N = 1, or (B, r_{n-1}, d_n,
    r_n) for a batch."""

    cores: tuple[torch.Tensor, ...]
    scale: float = 1.0

    @property
    def ranks(self) -> tuple[int, ...]:
        """(r_0, r_1, ..., r_N)."""
        return (tuple(c.shape[-3] for c in self.cores)
                + (self.cores[-1].shape[-1],))

    @property
    def rank(self) -> int:
        return max(self.ranks)

    @property
    def dims(self) -> tuple[int, ...]:
        return tuple(c.shape[-2] for c in self.cores)

    @property
    def device(self) -> torch.device:
        return self.cores[0].device

    @property
    def leaves(self) -> tuple[torch.Tensor, ...]:
        return self.cores

    def index(self, idx) -> "TTTensor":
        """Select along the leading batch axis of every core."""
        return TTTensor(tuple(c[idx] for c in self.cores), self.scale)

    def to(self, device) -> "TTTensor":
        return TTTensor(tuple(c.to(device) for c in self.cores), self.scale)

    def storage_size(self) -> int:
        """Number of stored scalars: O(N d R^2) (paper Remark 5)."""
        return sum(c.numel() for c in self.cores)

    layout = "tt"

    @property
    def row_floats(self) -> int:
        """Floats of one item at its true ranks: sum_n r_{n-1} d_n r_n."""
        return sum(c.shape[-3] * c.shape[-2] * c.shape[-1]
                   for c in self.cores)

    def abs(self) -> "TTTensor":
        return TTTensor(tuple(c.abs() for c in self.cores), abs(self.scale))

    def pair_inners(self, other: "TTTensor") -> torch.Tensor:
        """<X, Y> over leading batch axes that broadcast, scales applied."""
        return contractions.inner_tt_tt(self, other)

    def self_inners(self) -> torch.Tensor:
        return self.pair_inners(self)

    def inner_length(self, rank: int) -> int:
        """The longest fp32 sum in one inner product with a TT tensor of
        rank ``rank``: N * (R + d*R) + 2 with R the larger rank (a chain
        step's two contractions, in either order; ``kernels.parity``)."""
        r = max(self.rank, rank)
        return len(self.cores) * (r + max(self.dims) * r) + 2

    def with_leaves(self, leaves) -> "TTTensor":
        return TTTensor(tuple(leaves), self.scale)

    def stack(self) -> tuple["TTTensor", torch.Tensor]:
        """-> (this batch with cores that view ``stacked`` at their true
        ranks, stacked (B, N, R, d, R) float32): the kernels' layout
        (``ops.stack_tt``)."""
        from repro_torch.kernels.ops import stack_tt
        return stack_tt(self)

    @staticmethod
    def kernel_shape(stacked: torch.Tensor) -> tuple[int, int, int]:
        """(N, d, R) of a stacked (..., N, R, d, R) batch."""
        return stacked.shape[-4], stacked.shape[-2], stacked.shape[-1]


@dataclasses.dataclass(frozen=True)
class DenseTensor:
    """A dense tensor, or a batch of them, in R^{d_1 x ... x d_N}: ``data``
    (..., d_1, ..., d_N) with the ``dims`` last. The reference passes such
    arrays as they are; the port wraps them once (``as_batch``) so that
    they answer the format methods the CP and TT classes answer. Scale 1,
    rank 1; the kernels' layout is the flat (B, prod d) float32 row."""

    data: torch.Tensor
    dims: tuple[int, ...]

    scale = 1.0
    rank = 1
    layout = "dense"

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def leaves(self) -> tuple[torch.Tensor, ...]:
        return (self.data,)

    @property
    def row_floats(self) -> int:
        """Floats of one item: prod_n d_n."""
        return math.prod(self.dims)

    @property
    def flat(self) -> torch.Tensor:
        """``data`` with the mode dims flattened: (..., prod d)."""
        return self.data.reshape(self.data.shape[:self.data.dim()
                                                 - len(self.dims)] + (-1,))

    def index(self, idx) -> "DenseTensor":
        """Select along the leading batch axes."""
        return DenseTensor(self.data[idx], self.dims)

    def to(self, device) -> "DenseTensor":
        return DenseTensor(self.data.to(device), self.dims)

    def with_leaves(self, leaves) -> "DenseTensor":
        (data,) = tuple(leaves)
        return DenseTensor(data, self.dims)

    def abs(self) -> "DenseTensor":
        return DenseTensor(self.data.abs(), self.dims)

    def pair_inners(self, other: "DenseTensor") -> torch.Tensor:
        """<X, Y> over leading batch axes that broadcast."""
        return contractions.dense_pair_inners(self.flat, other.flat)

    def self_inners(self) -> torch.Tensor:
        return self.pair_inners(self)

    def inner_length(self, rank: int) -> int:
        """The longest fp32 sum in one inner product: prod d."""
        return self.row_floats

    def stack(self) -> tuple["DenseTensor", torch.Tensor]:
        """-> (this batch as a view of ``stacked``, stacked (B, prod d)
        float32 contiguous): K1's layout. No copy when ``data`` is already
        contiguous float32."""
        stacked = self.flat.float().contiguous()
        return DenseTensor(stacked.view(self.data.shape), self.dims), stacked

    @staticmethod
    def kernel_shape(stacked: torch.Tensor) -> tuple[int, int, int]:
        """(N, d, R) = (1, prod d, 1) of a stacked (..., prod d) batch:
        K1 reads a dense row as one mode of rank 1."""
        return 1, stacked.shape[-1], 1


def as_batch(x, n_modes: int | None = None):
    """A plain (B, d_1, ..., d_N) tensor -> ``DenseTensor`` (its mode dims
    all but the first, or the last ``n_modes``); a CP, TT or dense format
    object is returned as it is. The port's entry points call it once on
    what the caller passes."""
    if not isinstance(x, torch.Tensor):
        return x
    n = x.dim() - 1 if n_modes is None else int(n_modes)
    return DenseTensor(x, tuple(x.shape[x.dim() - n:]))


def batch_of_one(x):
    """One CP, TT or dense tensor (a plain (d_1, ..., d_N) tensor or a
    ``DenseTensor``) -> a batch of one: a leading axis of size 1 on every
    leaf, as the reference's ``tree_index(x, None)``."""
    if isinstance(x, torch.Tensor):
        return DenseTensor(x[None], tuple(x.shape))
    return x.index(None)


def stack_items(items):
    """Single items of one format (each as ``batch_of_one`` takes it: a
    plain (d_1, ..., d_N) tensor or a ``DenseTensor``, or a CP or TT
    tensor) -> one batch, item i its row i. Tensors are stacked on the
    first item's device; CP and TT items must share their scale."""
    first = items[0]
    if isinstance(first, torch.Tensor):
        return DenseTensor(torch.stack([torch.as_tensor(x, device=first.device)
                                        for x in items]), tuple(first.shape))
    if any(x.scale != first.scale for x in items):
        raise ValueError("stack_items: items of different scales")
    dev = first.leaves[0].device
    return first.with_leaves(
        torch.stack([leaf.to(dev) for leaf in leaves])
        for leaves in zip(*(x.leaves for x in items)))


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


def cp_gaussian(gen: torch.Generator, dims: Sequence[int], rank: int,
                batch: int | None = None) -> CPTensor:
    """CP-Gaussian tensor, P ~ CP_N(R) (paper Definition 6): N(0, 1)
    factor entries, scale 1/sqrt(R). Made on the generator's device."""
    factors = tuple(torch.randn(_shape(batch, d, rank), generator=gen,
                                device=gen.device)
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


def _tt_core_shapes(dims: Sequence[int],
                    rank: int) -> list[tuple[int, int, int]]:
    """(r_{n-1}, d_n, r_n) per mode: boundary ranks 1, interior ``rank``."""
    n = len(dims)
    return [(1 if i == 0 else rank, d, 1 if i == n - 1 else rank)
            for i, d in enumerate(dims)]


def tt_rademacher(gen: torch.Generator, dims: Sequence[int], rank: int,
                  batch: int | None = None) -> TTTensor:
    """TT-Rademacher tensor, T ~ TT_Rad(R) (paper Definition 7):
    T = (1/sqrt(R^(N-1))) <<G_1, ..., G_N>>, core entries iid +-1 w.p. 1/2.
    Made on the generator's device."""
    cores = tuple(
        2.0 * torch.randint(0, 2, _shape(batch, *s), generator=gen,
                            device=gen.device).float() - 1.0
        for s in _tt_core_shapes(dims, rank))
    return TTTensor(cores, scale=1.0 / math.sqrt(rank ** (len(dims) - 1)))


def tt_gaussian(gen: torch.Generator, dims: Sequence[int], rank: int,
                batch: int | None = None) -> TTTensor:
    """TT-Gaussian tensor, T ~ TT_N(R) (paper Definition 7): N(0, 1) core
    entries, scale 1/sqrt(R^(N-1)). Made on the generator's device."""
    cores = tuple(torch.randn(_shape(batch, *s), generator=gen,
                              device=gen.device)
                  for s in _tt_core_shapes(dims, rank))
    return TTTensor(cores, scale=1.0 / math.sqrt(rank ** (len(dims) - 1)))


def tt_random_data(gen: torch.Generator, dims: Sequence[int], rank: int,
                   batch: int | None = None) -> TTTensor:
    """Random *data* tensors in rank-R^ TT format: N(0, 1) core entries
    over (r_{n-1} d_n)^(1/4), scale 1 (the reference's ``tt_random_data``);
    ``batch`` makes B of them at once. Made on the generator's device."""
    cores = tuple(
        torch.randn(_shape(batch, *s), generator=gen, device=gen.device)
        / math.sqrt(s[0] * s[1]) ** 0.5
        for s in _tt_core_shapes(dims, rank))
    return TTTensor(cores, scale=1.0)


def cp_to_dense(x: CPTensor) -> torch.Tensor:
    """Materialize one CP tensor: X = scale * sum_r (x)_n a_r^(n). Test
    oracle only: O(d^N) memory."""
    acc = x.factors[0]                                    # (d1, R)
    for f in x.factors[1:]:
        acc = acc[..., None, :] * f                       # (..., d_k, R)
    return x.scale * acc.sum(dim=-1)


def cp_to_tt(x: CPTensor) -> TTTensor:
    """A CP tensor (or batch) of rank R -> the same tensor in TT format,
    exactly: the first core is the first factor (1, d, R), the last the last
    factor transposed (R, d, 1), and each interior core is diagonal in its
    two rank axes, G[r, i, r] = A[i, r]. TT rank R; every entry is one
    product of factor entries, so no rounding is added. A one-mode tensor
    is the vector sum_r A[:, r], one (1, d, 1) core (its fp32 sum the only
    rounding). Scale kept."""
    n, r = len(x.factors), x.rank
    if n == 1:
        f = x.factors[0]
        core = f.sum(-1).reshape(f.shape[:-2] + (1, f.shape[-2], 1))
        return TTTensor((core.contiguous(),), x.scale)
    cores = []
    for k, f in enumerate(x.factors):
        lead, d = f.shape[:-2], f.shape[-2]
        if k == 0:
            core = f.reshape(lead + (1, d, r))
        elif k == n - 1:
            core = f.transpose(-1, -2).reshape(lead + (r, d, 1))
        else:
            core = f.new_zeros(lead + (r, d, r))
            idx = torch.arange(r, device=f.device)
            core[..., idx, :, idx] = f.movedim(-1, 0)
        cores.append(core.contiguous())
    return TTTensor(tuple(cores), x.scale)


def tt_to_dense(x: TTTensor) -> torch.Tensor:
    """Materialize one TT tensor by sequential core contraction. Test
    oracle only: O(d^N) memory."""
    acc = x.cores[0].reshape(x.cores[0].shape[1], x.cores[0].shape[2])
    for core in x.cores[1:]:
        acc = torch.tensordot(acc, core, dims=([-1], [0]))  # (..., d_k, r_k)
    return x.scale * acc.reshape(acc.shape[:-1])


def dense_to_tt(x: torch.Tensor, max_rank: int, eps: float = 0.0) -> TTTensor:
    """TT-SVD (Oseledets 2011): one dense tensor -> TT format, on its own
    device (the reference's ``dense_to_tt``). Each unfolding keeps
    ``min(max_rank, len(s))`` singular values, or with ``eps`` > 0 those
    above ``eps * s[0]`` (at least one, at most ``max_rank``); the last
    unfolding's ``s V^T`` is the last core. Scale 1."""
    dims = tuple(x.shape)
    n = len(dims)
    cores = []
    r_prev = 1
    c = x.reshape(r_prev * dims[0], -1)
    for i in range(n - 1):
        u, s, vt = torch.linalg.svd(c, full_matrices=False)
        if eps > 0.0:
            r = max(1, min(max_rank, int((s > eps * s[0]).sum())))
        else:
            r = min(max_rank, s.shape[0])
        u, s, vt = u[:, :r], s[:r], vt[:r]
        cores.append(u.reshape(r_prev, dims[i], r))
        c = s[:, None] * vt
        if i + 1 < n - 1:
            c = c.reshape(r * dims[i + 1], -1)
        r_prev = r
    cores.append(c.reshape(r_prev, dims[-1], 1))
    return TTTensor(tuple(core.contiguous() for core in cores), scale=1.0)


def khatri_rao(mats: Sequence[torch.Tensor]) -> torch.Tensor:
    """Column-wise Khatri-Rao product of (d_n, R) matrices -> (prod d_n, R),
    the first matrix's rows slowest (the reference's ``khatri_rao``)."""
    out = mats[0]
    for m in mats[1:]:
        out = (out[:, None, :] * m[None, :, :]).reshape(-1, m.shape[1])
    return out


def cp_als(x: torch.Tensor, rank: int, iters: int = 25,
           generator: torch.Generator | None = None) -> CPTensor:
    """Plain ALS fit of a rank-``rank`` CP model to one small dense tensor
    (the reference's ``cp_als``, for tests and examples: the paper takes
    its inputs as given in CP format). The initial factors are standard
    normals from ``generator`` (by default one seeded with 0), made on the
    generator's device and moved to ``x``'s. Each sweep updates mode n
    from the Hadamard product of the other factors' Grams and the MTTKRP,
    ``solve(G^T, M^T)^T``, in the reference's order. The MTTKRP pairs the
    row-major unfolding (the other modes in order, the last fastest) with
    the Khatri-Rao product of the other factors in that same order; the
    reference takes them in reverse order (Kolda's, for a column-major
    unfolding) against its row-major one, which fits no exact tensor
    (ROADMAP.md, R5). Scale 1."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    dims = tuple(x.shape)
    n = len(dims)
    factors = [torch.randn((d, rank), generator=generator,
                           device=generator.device, dtype=x.dtype).to(x.device)
               for d in dims]

    def unfold(t, mode):
        return torch.movedim(t, mode, 0).reshape(dims[mode], -1)

    for _ in range(iters):
        for mode in range(n):
            others = [factors[m] for m in range(n) if m != mode]
            g = torch.ones((rank, rank), dtype=x.dtype, device=x.device)
            for f in others:
                g = g * (f.T @ f)
            mttkrp = unfold(x, mode) @ khatri_rao(others)
            factors[mode] = torch.linalg.solve(g.T, mttkrp.T).T
    return CPTensor(tuple(f.contiguous() for f in factors), scale=1.0)
