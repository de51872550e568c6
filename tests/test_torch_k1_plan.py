"""K1's launch plan and its dense x CP summation order, on the CPU.

The plan (``fused_query.SHAPES``, ``smem_bytes``, ``window_plan``, the
dense instantiation's ring slots ``ring_slot``) is the Python copy of the
C launch's, which refuses any other: every instantiation's block fits one
H100 SM's shared memory at its target blocks per SM over ragged dims, 1 and
16 modes, dense rows of 65,536 floats, T > 1 and live windows, and the
redesign refuses no shape the previous plan (8 warps, 3 blocks, no ring
for dense rows) took. A launch is one block per query (grid = B), so every
query is covered once by construction.

The dense x CP re-rank (``dense_cp_sweep`` in ``csrc/fused_query.cuh``)
sums in the reference's order, mode 1 first, through the wrapper's column
table (``column_table``); a plain model of that order, lane by lane and
through the warp's butterfly in fp32, is held against the reference's
``inner_dense_cp`` (XLA, no Pallas compilation) within the rounding bound
``parity.cross_length`` carries.
"""

import itertools
import math

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import contractions as ref_contractions
from repro.core.tensor_formats import CPTensor as RefCP
from repro_torch.core import probing
from repro_torch.core.tensor_formats import CPTensor, DenseTensor
from repro_torch.kernels import fused_query as fq
from repro_torch.kernels import parity
from repro_torch.kernels.epilogues import (BLOCK_RESERVED, MAX_SMEM,
                                           SM_SMEM, SMEM_GRANULE)

import torch

# (corpus layout, query layout, mode dims, ranks (query, corpus))
PAIRS = [
    ("dense", "dense", (12, 12, 12), (1, 1)),   # [dense-main]: ring slots
    ("dense", "dense", (10, 173), (1, 1)),      # whole floats: in place
    ("dense", "dense", (4, 4, 4), (1, 1)),
    ("dense", "dense", (2048,), (1, 1)),        # the longest ring slot
    ("dense", "dense", (4, 513), (1, 1)),       # 2,052 floats: in place
    ("dense", "dense", (16, 16, 16, 16), (1, 1)),  # 65,536: all in place
    ("dense", "dense", (2,) * 16, (1, 1)),      # 16 modes
    ("cp", "cp", (12, 12, 12), (4, 4)),
    ("tt", "tt", (16, 16, 16, 16), (4, 4)),
    ("tt", "tt", (8, 8, 8), (16, 16)),
    ("cp", "dense", (12, 12, 12), (1, 4)),      # [mixed dense x cp]
    ("cp", "dense", (6, 5, 7), (1, 32)),
    ("cp", "dense", (40,), (1, 3)),
    ("cp", "dense", (2,) * 16, (1, 5)),
    ("cp", "dense", (16, 16, 16, 16), (1, 4)),  # the query read in place
    ("dense", "cp", (12, 12, 12), (4, 1)),
    ("dense", "tt", (16, 16, 16, 16), (16, 1)),
    ("tt", "dense", (12, 12, 12), (1, 4)),
    ("tt", "cp", (12, 12, 12), (4, 4)),
    ("cp", "tt", (12, 12, 12), (16, 4)),
]
# (tables, cap, probes, topk): exact caps, a live window's, T > 1
LAUNCHES = [(10, 367, 1, 10), (10, 765, 1, 10), (10, 64, 4, 10),
            (4, 3, 8, 7), (10, 2952, 1, 10)]


def _args(layout, q_layout, dims, ranks):
    """window_plan's / smem_bytes' shape arguments for a pair: (n_modes, d,
    rq, rc, keywords)."""
    rq, rc = ranks
    if layout == "dense" and q_layout == "dense":
        return 1, math.prod(dims), 1, 1, dict(dense=True)
    kw = dict(tt=layout == "tt", dense=layout == "dense")
    if q_layout != layout:
        kw.update(q_layout=q_layout, df=math.prod(dims))
    return len(dims), max(dims), rq, rc, kw


def _blocks(smem):
    per = -(-smem // SMEM_GRANULE) * SMEM_GRANULE + BLOCK_RESERVED
    return SM_SMEM // per


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[1]}-{p[0]}")
def test_plan_fits_the_target_blocks(pair):
    """Every instantiation's planned block fits 227 KB at every launch
    shape, and its target blocks per SM at T = 1 and ranks up to 8 (the
    redesigned dense one: 12 warps, 2 blocks, a ring slot a warp where the
    rows allow one; dense x CP: 12 warps, two rows each; an expansion may
    take the room of a block, as before)."""
    layout, q_layout = pair[:2]
    n, d, rq, rc, kw = _args(*pair)
    tr_qr = fq.instance(layout, q_layout, rq, rc)
    threads, target, _ = fq.SHAPES[tr_qr]
    for tables, cap, probes, topk in LAUNCHES:
        exp = probing.expansion_size("e2lsh", 10) if probes > 1 else 0
        kw["ring"] = (tr_qr == (fq.DENSE, fq.DENSE)
                      and fq.ring_plan(tables, cap, d, probes, topk, exp))
        window, _ = fq.window_plan(tables, cap, n, d, rq, rc, probes=probes,
                                   topk=topk, expansion=exp, **kw)
        smem = fq.smem_bytes(tables, n, d, rq, rc, window, probes=probes,
                             topk=topk, expansion=exp, **kw)
        assert smem <= MAX_SMEM and _blocks(smem) >= 1
        # TT rank 8's register tile keeps one block; dense x CP at CP rank
        # 32 stages 12 warps' two pairs of 2,688-byte rows, and keeps one
        if probes == 1 and tr_qr != (8, 8) and rc <= 8:
            assert _blocks(smem) >= target, (pair, tables, cap, smem)
        assert window & (window - 1) == 0
        if kw["ring"]:
            assert fq.ring_slot(d) == d and d % 4 == 0 and d <= fq.RING_ROW
    assert threads % 32 == 0


def test_ring_plan_at_the_cells():
    """[dense-main] / [dense-cp] (1,728 floats, L = 10, exact caps) read
    their rows through the ring beside a 1,024-slot window, [dense-mut]'s
    (T = 4, its expansion's 200 candidates) beside one as large; rows of
    2,048 floats leave that expansion no room, nor do rows past
    ``RING_ROW`` or of whole floats take a slot."""
    exp = probing.expansion_size("e2lsh", 10)
    assert fq.ring_plan(10, 367, 1728) and fq.ring_plan(10, 765, 1728)
    assert fq.window_plan(10, 367, 1, 1728, 1, 1, dense=True,
                          ring=True) == (1024, True)
    assert fq.ring_plan(10, 64, 1728, probes=4, expansion=exp)
    assert fq.window_plan(10, 64, 1, 1728, 1, 1, dense=True, probes=4,
                          expansion=exp, ring=True) == (1024, True)
    assert not fq.ring_plan(10, 64, 2048, probes=4, expansion=exp)
    assert not fq.ring_plan(10, 367, 2052) and not fq.ring_plan(10, 367,
                                                                 1730)
    assert fq.ring_plan(10, 367, 64) and fq.ring_plan(4, 3, 2048)


def test_plan_refuses_nothing_it_took(monkeypatch):
    """The two redesigned instantiations plan every launch the previous
    plans did (dense rows: 8 warps, 3 blocks, no ring; dense queries over
    CP rows: 8 warps, one row a warp), at a window no smaller than a
    quarter of it; the other instantiations' plans are unchanged."""
    new = {}
    for pair, launch in itertools.product(PAIRS, LAUNCHES):
        n, d, rq, rc, kw = _args(*pair)
        tables, cap, probes, topk = launch
        exp = probing.expansion_size("e2lsh", 10) if probes > 1 else 0
        new[pair, launch] = fq.window_plan(tables, cap, n, d, rq, rc,
                                           probes=probes, topk=topk,
                                           expansion=exp, **kw)
    monkeypatch.setitem(fq.SHAPES, (fq.DENSE, fq.DENSE), (256, 3, 2))
    monkeypatch.setitem(fq.SHAPES, (0, fq.DENSE), (256, 2, 1))
    redesigned = (("dense", "dense"), ("cp", "dense"))
    for (pair, launch), (window, _) in new.items():
        n, d, rq, rc, kw = _args(*pair)
        tables, cap, probes, topk = launch
        exp = probing.expansion_size("e2lsh", 10) if probes > 1 else 0
        old, _ = fq.window_plan(tables, cap, n, d, rq, rc, probes=probes,
                                topk=topk, expansion=exp, **kw)
        if pair[:2] in redesigned:
            assert window >= min(old, fq.MIN_WINDOW * 4), (pair, launch)
        else:
            assert window == old, (pair, launch)


@pytest.mark.parametrize("dims", [(12, 12, 12), (6, 5, 7), (13, 3, 2),
                                  (40,), (2,) * 10, (3, 1, 4)])
def test_column_table_holds_each_columns_rows(dims):
    """Entry (n - 1, p) is n * d + i_n(p) for column p of the row read as
    (d_1, P), the last mode fastest (numpy's unravel_index)."""
    d = max(dims) + 1
    table = np.array(fq.column_table(dims, d), dtype=np.int64)
    p = math.prod(dims[1:])
    assert table.size == (len(dims) - 1) * p
    if len(dims) > 1:
        idx = np.unravel_index(np.arange(p), dims[1:])
        want = np.stack([n * d + idx[n - 1] for n in range(1, len(dims))])
        np.testing.assert_array_equal(table.reshape(len(dims) - 1, p), want)


def _fma(a, b, c):
    """fp32 a * b + c rounded once (the product is exact in float64)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def sweep_model(q, a, dims):
    """``dense_cp_sweep``'s order in fp32 for one CP row: q (DF,) the dense
    row, a (N, D, R) the padded CP factors -> qy, unscaled. Per chunk of
    four ranks, lane l's columns p = l, l + 32, ...: t[r] = the FMA chain
    over A_1's rows, the weight the product over modes n > 1 in mode
    order, acc += t[r] w[r] in rank order; then the butterfly."""
    n_modes, d, r_all = a.shape
    d1, p_cols = dims[0], math.prod(dims[1:])
    qm = q.reshape(d1, p_cols)
    table = np.array(fq.column_table(dims, d), dtype=np.int64).reshape(
        n_modes - 1, p_cols)
    flat = a.reshape(n_modes * d, r_all)
    acc = np.zeros(32, np.float32)
    for r0 in range(0, r_all, 4):
        nr = min(4, r_all - r0)
        t = np.zeros((nr, p_cols), np.float32)
        for i in range(d1):
            for r in range(nr):
                t[r] = _fma(np.full(p_cols, a[0, i, r0 + r], np.float32),
                            qm[i], t[r])
        w = np.ones((nr, p_cols), np.float32)
        for m in range(n_modes - 1):
            w = (w * flat[table[m], r0:r0 + nr].T).astype(np.float32)
        for k in range(0, p_cols, 32):
            cols = np.arange(32) + k
            live = cols < p_cols
            cols = np.where(live, cols, 0)
            for r in range(nr):
                acc = np.where(live, _fma(t[r, cols], w[r, cols], acc), acc)
    for o in (16, 8, 4, 2, 1):
        acc = (acc + acc[np.arange(32) ^ o]).astype(np.float32)
    return acc[0]


@pytest.mark.parametrize("dims,rank", [((12, 12, 12), 4), ((13, 3, 2), 1),
                                       ((6, 5, 7), 5), ((40,), 3),
                                       ((2,) * 10, 5), ((4, 4, 4, 4), 32)])
def test_sweep_order_within_the_cross_bound(dims, rank):
    """The kernel's dense x CP order (``sweep_model``) against the
    reference's ``inner_dense_cp`` and against float64, within 2 n u S,
    n = ``parity.cross_length`` and S the same contraction over absolute
    values."""
    rng = np.random.default_rng(22)
    factors = [rng.standard_normal((dn, rank)).astype(np.float32)
               for dn in dims]
    q = rng.standard_normal(dims).astype(np.float32)
    d = max(dims)
    padded = np.zeros((len(dims), d, rank), np.float32)
    for n, f in enumerate(factors):
        padded[n, :f.shape[0]] = f
    ref = float(ref_contractions.inner_dense_cp(
        jnp.asarray(q), RefCP(tuple(jnp.asarray(f) for f in factors))))
    exact = float((q.astype(np.float64) * _dense(factors)).sum())
    s = float((np.abs(q).astype(np.float64)
               * _dense([np.abs(f) for f in factors])).sum())
    x = DenseTensor(torch.from_numpy(q), dims)
    y = CPTensor(tuple(torch.from_numpy(f) for f in factors), 1.0)
    bound = 2 * parity.cross_length(x, y) * parity.U * s
    got = float(sweep_model(q.reshape(-1), padded, dims))
    assert abs(got - ref) <= bound, (got, ref, bound)
    assert abs(got - exact) <= bound / 2, (got, exact)


def _dense(factors):
    """sum_r outer(f_1[:, r], ..., f_N[:, r]) in float64."""
    out = 0.0
    for r in range(factors[0].shape[1]):
        t = factors[0][:, r].astype(np.float64)
        for f in factors[1:]:
            t = np.multiply.outer(t, f[:, r].astype(np.float64))
        out = out + t
    return out
