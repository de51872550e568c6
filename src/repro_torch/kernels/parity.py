"""The tolerances the port holds its kernels and its plain versions to.

Two fp32 implementations of one sum round differently when they add in
another order (a CUDA kernel, a cuBLAS or CPU matmul, XLA). These bounds are
the standard rounding-error bound of a sum of n products, gamma_n * S with
gamma_n = n * 2^-24 and S the same sum over absolute values, doubled
because both sides round:

  * K3 raw values: n = d + N + Rx*Rp (the d-long dots, the N-fold product,
    the Rx*Rp-term sum), S = |scale| * sum_{r,q} prod_n sum_d |x| |p|.
  * K4 raw values (``tt_raw_bound``): each mode's step
    S'[c, e] = sum_{a, i, b} Gx[a, i, c] S[a, b] Gp[b, i, e] is two
    contractions, one of length Rx (over a) and one of length d*Rp (over
    (b, i)) in the reference's order, Rp and d*Rx in the kernel's (S Gp
    first). A computed dot of length n differs from the exact one by at
    most gamma_n times the same dot over absolute values, and the N steps
    compose, so the computed chain is within gamma_n of the exact one with
    n = N * max(Rx + d*Rp, Rp + d*Rx) + 2 (the scale multiply and one
    spare), and S is the same chain on |cores| times |scale|.
  * Dense raw values (``dense_bound``): one dot of D = prod d products per
    value, the naive kinds' matrix or the materialized CP / TT stack
    against the dense row, n = D, S = sum_j |x_j| |m_j| (times |scale|);
    the re-rank of dense rows is the same sum, D long
    (``DenseTensor.inner_length``).
  * Cross-format values (``cross_length``): a dense operand against CP or
    TT rows is contracted mode by mode in the plain version (d-long sums
    per mode, then the rank sum: N * d + R for CP, N * (d + R) for TT) and
    as one prod d-long dot of the densified operand in K1 (whose entries
    are an N-fold product and an R-term sum, or an N-step chain of R-long
    sums), so n = prod d + N * (d + R) + R + 2 covers both; CP x TT
    (the rank-1 terms through the TT chain, per mode an r-long and a
    d-long contraction, in either order, then the R^-term sum) takes
    n = N * (R + d * R) + R + 2 with R the larger rank, as the TT chain
    does plus the rank sum. The CP projection on TT inputs and the TT one
    on CP inputs (``cross_raw_bound``) are that CP x TT sum; S is the same
    contraction over absolute values.
  * Codes: a code may differ only where the value lies within that bound of
    a bucket edge (E2LSH) or of 0 (SRP); keys may differ only in the tables
    holding such a code.
  * Re-rank scores: the bound of qq + yy - 2 qy (or of qy, qq, yy for
    cosine) carried through the square root / the division.
  * Sampled sets (``sample_mismatches``): equal in "uniform" (integer
    keys); in "weighted" a member may be drawn on one side only where its
    perturbed logit, log(mult) - log(-log(u)) in fp32 (each log within an
    ulp of the exact one on either side), lies within 2 ulps of the last
    drawn member's.

Used by the CPU tests (port against the reference), by the card tests and
by ``chip_smoke.py`` (kernel against plain version).
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import contractions
from repro_torch.kernels.epilogues import div_w
from repro_torch.kernels.ref import cp_inner_ref, tt_inner_ref

U = 2.0 ** -24


def raw_bound(x_factors: torch.Tensor, p_factors: torch.Tensor,
              scale: float) -> torch.Tensor:
    """(B, L, K) absolute bound on the difference of two fp32 evaluations
    of K3's raw values; x (B, N, d, Rx), p (N, L, K, d, Rp) stacked."""
    b, n, d, rx = x_factors.shape
    _, l, k, _, rp = p_factors.shape
    s = abs(scale) * cp_inner_ref(x_factors.abs(),
                                  p_factors.abs().reshape(n, l * k, d, rp))
    return 2.0 * (d + n + rx * rp) * U * s.reshape(b, l, k)


def tt_raw_bound(x_cores: torch.Tensor, p_cores: torch.Tensor,
                 scale: float) -> torch.Tensor:
    """(B, L, K) absolute bound on the difference of two fp32 evaluations
    of K4's raw values; x (B, N, Rx, d, Rx), p (N, L, K, Rp, d, Rp)
    stacked."""
    b, n, rx, d, _ = x_cores.shape
    _, l, k, rp, _, _ = p_cores.shape
    s = abs(scale) * tt_inner_ref(x_cores.abs(),
                                  p_cores.abs().reshape(n, l * k, rp, d, rp))
    length = n * max(rx + d * rp, rp + d * rx) + 2
    return 2.0 * length * U * s.reshape(b, l, k)


def dense_bound(x: torch.Tensor, m: torch.Tensor,
                scale: float = 1.0) -> torch.Tensor:
    """(B, K) absolute bound on the difference of two fp32 evaluations of
    the dense raw values scale * x @ m.T; x (B, D) rows, m (K, D):
    2 D u |scale| sum_j |x_j| |m_j|."""
    s = abs(scale) * (x.abs().double() @ m.abs().double().T)
    return (2.0 * x.shape[-1] * U * s).float()


def cross_length(x, y) -> int:
    """The longest fp32 sum of one <x, y> of two formats that differ (see
    the module docstring): dense x CP or TT, either order, prod d + N * (d
    + R) + R + 2; CP x TT, either order, N * (R + d * R) + R + 2 with R the
    larger rank."""
    n, d, r = len(x.dims), max(x.dims), max(x.rank, y.rank)
    if "dense" in (x.layout, y.layout):
        return math.prod(x.dims) + n * (d + r) + r + 2
    return n * (r + d * r) + r + 2


def pair_length(x, y) -> int:
    """The longest fp32 sum of one <x, y> for any pair of formats: the
    format's ``inner_length`` for a same-format pair, else
    ``cross_length``."""
    if x.layout == y.layout:
        return x.inner_length(y.rank)
    return cross_length(x, y)


def cross_raw_bound(p, xs) -> torch.Tensor:
    """(B, K) absolute bound on the difference of two fp32 evaluations of a
    CP projection's raw values on TT inputs or a TT projection's on CP
    inputs (``projections.project_batch``): 2 n u |scale| times the same
    contraction over absolute values, n = ``cross_length``."""
    from repro_torch.core.projections import project_batch
    s = project_batch(p.with_leaves(a.abs() for a in p.leaves),
                      xs.abs()).abs()
    proj = p.input_format(p.leaves, p.scale)
    return 2.0 * cross_length(proj, xs) * U * s


def family_raw_bound(family, xs) -> torch.Tensor:
    """(B, L*K) absolute bound on the difference of two fp32 evaluations
    of ``family``'s raw values on the batch ``xs``, for any pair of
    formats: ``raw_bound`` / ``tt_raw_bound`` where K3 / K4 hash it, the
    naive kinds' dense matrix product over the densified rows (``prod d``
    terms, after a densify of N + R roundings for CP or TT inputs), and
    ``cross_raw_bound`` for the other pairs."""
    from repro_torch.core.projections import densify_batch
    p = family.projection
    b = xs.leaves[0].shape[0]
    if family.uses_kernel(xs.layout):
        bound = raw_bound if xs.layout == "cp" else tt_raw_bound
        return bound(family.stack(xs), family.stacked_projection,
                     xs.scale * p.scale).reshape(b, -1)
    if p.layout == "dense":
        s = abs(p.scale) * (densify_batch(xs.abs()).double()
                            @ p.matrix.abs().double().T)
        length = math.prod(p.dims)
        if xs.layout != "dense":
            length += len(p.dims) * (max(p.dims) + xs.rank) + xs.rank + 2
        return (2.0 * length * U * s).float()
    return cross_raw_bound(p, xs)


def boundary_codes(v: torch.Tensor, bound: torch.Tensor, kind: str,
                   offsets: torch.Tensor | None = None,
                   w: float = 1.0) -> torch.Tensor:
    """(B, L, K) bool: codes that another rounding of ``v`` within
    ``bound`` could flip (E2LSH: next to a bucket edge; SRP: next to 0)."""
    if kind.endswith("srp"):
        return v.abs() <= bound
    t = div_w(v + offsets.reshape(v.shape[1:])[None], w)
    frac = t - torch.floor(t)
    # the division rounds once more: half an ulp of t, in value units
    slack = bound + w * U * t.abs()
    return (frac * w <= slack) | ((1.0 - frac) * w <= slack)


def key_mismatches(keys_a: torch.Tensor, keys_b: torch.Tensor,
                   boundary: torch.Tensor) -> tuple[int, int]:
    """-> (key cells that differ outside boundary tables, key cells whose
    table holds a boundary code)."""
    near = boundary.any(dim=-1)
    differ = keys_a != keys_b
    return int((differ & ~near).sum()), int(near.sum())


def rerank_bound(metric: str, queries, corpus, ids: torch.Tensor,
                 scores: torch.Tensor) -> torch.Tensor:
    """(B, topk) bound on the difference of two fp32 evaluations of the
    re-rank score of each result (0 where ``ids`` is -1). The inner
    products carry the raw bounds' lengths (``pair_length``: the format's
    ``inner_length`` for a same-format pair, CP: d + N + R*R; TT: N * (R +
    d*R) + 2 with R the larger rank, either contraction order; across
    formats ``cross_length``), qq in the queries' format, yy in the
    corpus's and qy across the two, and the score expression 4 more
    roundings."""
    valid = ids >= 0
    sub = corpus.index(torch.where(valid, ids, 0).long())  # (B, k) rows
    qb = queries.index((slice(None), None))
    qa, ya = qb.abs(), sub.abs()
    s_qq, s_yy = qa.self_inners(), ya.self_inners()
    s_qy = contractions.pair_inners(qa, ya)
    qq, yy = qb.self_inners(), sub.self_inners()
    length = max(pair_length(queries, corpus),
                 queries.inner_length(queries.rank),
                 corpus.inner_length(corpus.rank))
    gamma = 2.0 * (length + 4) * U
    s = torch.where(valid, scores, 0.0).abs()
    if metric == "euclidean":
        dd2 = gamma * (s_qq + s_yy + 2.0 * s_qy)
        tol = dd2 / torch.maximum(s, torch.sqrt(dd2))
    else:
        nqy = torch.sqrt(torch.clamp(qq * yy, min=1e-30))
        tol = gamma * (s_qy / nqy + s * (s_qq / torch.clamp(qq, min=1e-30)
                                         + s_yy / torch.clamp(yy, min=1e-30)))
    return torch.where(valid, tol, 0.0)


def topk_mismatches(ids_a, scores_a, ids_b, scores_b, tol) -> int:
    """Result slots whose ids differ and are not explained by a near tie:
    a slot may differ only where the scores at that rank agree within
    ``tol`` and the reference's score there lies within 2*tol of a
    neighbouring rank's (or the slot is the last one)."""
    differ = ids_a != ids_b
    close = (scores_a - scores_b).abs() <= tol
    s = scores_b
    k = s.shape[1]
    prev = torch.cat([torch.full_like(s[:, :1], float("nan")), s[:, :-1]], 1)
    nxt = torch.cat([s[:, 1:], torch.full_like(s[:, :1], float("nan"))], 1)
    tie = ((s - prev).abs() <= 2 * tol) | ((nxt - s).abs() <= 2 * tol)
    last = torch.zeros_like(differ)
    last[:, k - 1] = True
    ok = close & (tie | last)
    return int((differ & ~ok).sum())


def sample_mismatches(mode: str, key, got_ids, want_ids, union,
                      ulps: int = 2) -> int:
    """Rows whose drawn sets (``got_ids`` / ``want_ids``, (B, topk) with -1
    fill, e.g. K1's sample and its plain version's) differ beyond what the
    weighted mode's logarithms explain. ``union`` is the rows' probed union
    (``fused_query.sample_union``: eff, mult, valid) and ``key`` the draw's
    key words. "uniform" ranks by integers, so its sets must be equal; in
    "weighted" a member may be in one set only where its sampling key (as
    the plain version computes it, ``fused_query.sample_key32``) lies within
    ``ulps`` units of the last drawn member's key, where two fp32
    evaluations of log(mult) - log(-log(u)) may order it differently."""
    from repro_torch.kernels.fused_query import noise_bits, sample_key32
    eff, mult, valid = union
    rows = torch.arange(eff.shape[0], device=eff.device)
    k32 = sample_key32(mode, noise_bits(key, rows, eff), mult)
    packed = torch.where(valid, (k32 - (1 << 31)) * (1 << 32) + eff,
                         torch.iinfo(torch.int64).max)
    packed = torch.sort(packed, dim=1).values
    bad = 0
    for r in range(got_ids.shape[0]):
        got = set(got_ids[r][got_ids[r] >= 0].tolist())
        want = set(want_ids[r][want_ids[r] >= 0].tolist())
        if got == want:
            continue
        if mode != "weighted" or len(got) != len(want):
            bad += 1
            continue
        last = int(packed[r, len(want) - 1] >> 32) + (1 << 31)
        keys = dict(zip(eff[r][valid[r]].tolist(),
                        k32[r][valid[r]].tolist()))
        if any(abs(keys.get(e, -(1 << 40)) - last) > ulps
               for e in got ^ want):
            bad += 1
    return bad
