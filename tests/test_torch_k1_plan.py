"""K1's launch plan and its cross-format summation orders, on the CPU.

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
``parity.cross_length`` carries. So are the orders of CP and dense queries
over TT rows of ranks <= 4 (``cp_tt_half``, ``dense_tt_sweep``: two rows a
warp, a row a half-warp, states in registers) against ``inner_cp_tt`` /
``inner_dense_tt``, and the rows' own chain (``tt_self_half``) against
``inner_tt_tt``, at ragged TT ranks, one to four modes and mode dims that
are not multiples of 4; their plan is pinned at [cp-as-tt]. TT queries of
ranks <= 4 over CP rows (``<0, 4>``) score with the same ``cp_tt_half``,
the roles swapped (the CP row the CP operand), and the rows' own Grams on
a half-warp; held against the reference's ``inner`` on (TT, CP) and
``inner_cp_cp``, their plan pinned at [main]. A TT query over dense rows is
densified prefix by prefix (``densify_tt``): a model of that order equals
the per-entry chain bit for bit. The TT chain of ``<8, 8>``, ``<16, 16>``
and ``<16, 0>``'s yy (``tt_chain``: T_i once a slice, the state in
registers) and ``<16, 0>``'s qy (``cp_tt_rows``) are modelled against the
first design's ``tt_chains`` / ``cp_tt_chain`` bit for bit and against the
reference's ``inner_tt_tt`` / ``inner_cp_tt`` within their bounds; their
plans are pinned at [tt8] and [limits].
"""

import itertools
import math

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import contractions as ref_contractions
from repro.core.tensor_formats import CPTensor as RefCP
from repro_torch.core import probing
from repro_torch.core.tensor_formats import CPTensor, DenseTensor, TTTensor
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
    ("tt", "cp", (16, 16, 16, 16), (4, 4)),     # the longest staged row
    ("tt", "cp", (32, 32, 64), (4, 4)),         # rows read in place
    ("tt", "dense", (32, 32, 64), (1, 4)),
    ("cp", "tt", (12, 12, 12), (16, 4)),
    ("cp", "tt", (12, 12, 12), (4, 4)),        # [mixed tt x cp]: <0, 4>
    ("cp", "tt", (16, 16, 16, 16), (4, 4)),    # the longest staged CP row
    ("cp", "tt", (2, 2, 2), (3, 32)),          # CP rank 32, short rows
    ("cp", "tt", (6, 5, 7), (2, 6)),
    ("cp", "tt", (12, 12, 12), (4, 8)),        # 288 floats: <0, 16>
    ("cp", "tt", (12, 12, 12), (8, 4)),        # TT rank 8: <0, 16>
    ("dense", "tt", (12, 12, 12), (4, 1)),     # [mixed tt x dense]: ring
    ("dense", "cp", (2048,), (4, 1)),          # the longest ring slot
    ("dense", "tt", (4, 513), (16, 1)),        # 2,052 floats: in place
    ("dense", "tt", (10, 173), (2, 1)),        # whole floats: in place
    ("cp", "tt", (12, 12, 12), (16, 4)),       # TT rank 16 over [main]'s rows
    ("cp", "tt", (12, 12, 12), (8, 32)),       # CP rank 32: 1,152 floats
    ("cp", "tt", (32, 32, 64), (8, 4)),        # rows read in place
    ("tt", "dense", (12, 12, 12), (1, 8)),     # [tt8]: ring slots
    ("tt", "dense", (12, 12, 12), (1, 16)),    # 9,216 floats: in place
    ("tt", "dense", (16, 16, 16, 16), (1, 16)),  # the query read in place
    ("tt", "dense", (6, 5, 7), (1, 5)),        # whole floats: in place
    ("tt", "tt", (12, 12, 12), (8, 8)),        # [tt8 x tt8]: ring slots
    ("tt", "tt", (12, 12, 12), (16, 8)),       # [tt16 x tt8]: in place
    ("tt", "tt", (6, 5, 7), (5, 7)),           # ragged: in place
    ("tt", "cp", (12, 12, 12), (4, 8)),        # [mixed cp x tt8]: ring
    ("tt", "cp", (4, 3, 5, 2), (5, 16)),       # rank 16, four modes
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


def _ring(pair, launch, n, d, rq, kw):
    """Whether the launch plan keeps its row slots (``slot_plan``: a dense
    corpus's ring slots for queries of any format, ``<16, kDense>``'s TT
    ring slots, ``<0, 16>``'s staged CP rows), as ``launch_plan`` decides."""
    layout, q_layout = pair[:2]
    tables, cap, probes, topk = launch
    exp = probing.expansion_size("e2lsh", 10) if probes > 1 else 0
    return fq.slot_plan(layout, q_layout, tables, cap, n, d, rq, pair[3][1],
                        probes, topk, exp, kw.get("df", 0))


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
    tr_qr = fq.instance(layout, q_layout, rq, rc, n, d)
    threads, target, _, _ = fq.SHAPES[tr_qr]
    for tables, cap, probes, topk in LAUNCHES:
        exp = probing.expansion_size("e2lsh", 10) if probes > 1 else 0
        kw["ring"] = _ring(pair, (tables, cap, probes, topk), n, d, rq, kw)
        window, _ = fq.window_plan(tables, cap, n, d, rq, rc, probes=probes,
                                   topk=topk, expansion=exp, **kw)
        smem = fq.smem_bytes(tables, n, d, rq, rc, window, probes=probes,
                             topk=topk, expansion=exp, **kw)
        assert smem <= MAX_SMEM and _blocks(smem) >= 1
        # dense x CP at CP rank 32 stages 12 warps' two pairs of 2,688-byte
        # rows, and keeps one
        if probes == 1 and rc <= 8:
            assert _blocks(smem) >= target, (pair, tables, cap, smem)
        assert window & (window - 1) == 0
        if kw["ring"] and layout == "dense":
            row = kw.get("df") or d
            assert fq.ring_slot(row) == row and row % 4 == 0
            assert row <= fq.RING_ROW
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
    """The redesigned instantiations plan every launch the previous plans
    did (dense rows: 8 warps, 3 blocks, no ring; dense queries over CP
    rows: 8 warps, one row a warp; CP or dense queries over TT rows of
    ranks <= 4: 8 warps, one row a warp in two buffers, whatever the
    row's length; CP or TT queries over dense rows: 8 warps, two rows a
    warp, no ring; TT queries over CP rows: ``<0, 16>``, 8 warps, one
    staged row a warp, whatever the query's rank and the row's length;
    dense queries over TT rows of ranks 5-16: ``<16, kDense>``, 8 warps,
    one row a warp read in place, each warp's chain state; CP and TT
    queries over TT rows of ranks 5-16: ``<16, 0>``, ``<16, 16>``, rows
    read in place, and ``<8, 8>``, 1 block a SM, rows staged in two
    buffers, each warp's chain states and their next values), at a window
    of at least the old one or 1,024 slots (512 where a dense corpus's
    rows go through its ring slots); the other instantiations' plans are
    unchanged."""
    new, ring = {}, {}
    for pair, launch in itertools.product(PAIRS, LAUNCHES):
        n, d, rq, rc, kw = _args(*pair)
        tables, cap, probes, topk = launch
        exp = probing.expansion_size("e2lsh", 10) if probes > 1 else 0
        ring[pair, launch] = _ring(pair, launch, n, d, rq, kw)
        new[pair, launch] = fq.window_plan(
            tables, cap, n, d, rq, rc, probes=probes, topk=topk,
            expansion=exp, ring=ring[pair, launch], **kw)
    monkeypatch.setitem(fq.SHAPES, (fq.DENSE, fq.DENSE), (256, 3, 2, 2))
    monkeypatch.setitem(fq.SHAPES, (8, 8), (256, 1, 1, 2))
    monkeypatch.setitem(fq.SHAPES, (0, fq.DENSE), (256, 2, 1, 2))
    for qr in (0, fq.DENSE):
        monkeypatch.setitem(fq.SHAPES, (4, qr), (256, 2, 1, 2))
    for qr in (0, 16):
        monkeypatch.setitem(fq.SHAPES, (fq.DENSE, qr), (256, 2, 2, 2))
    instance = fq.instance

    def old_instance(layout, q_layout, rq, rc, n_modes, d):
        tr, qr = instance(layout, q_layout, rq, rc, n_modes, d)
        if (tr, qr) == (0, 4):
            return 0, 16
        return (4, qr) if layout != q_layout and tr == 16 and rc <= 4 else (
            tr, qr)

    smem_bytes = fq.smem_bytes

    def old_smem(tables, n, d, rq, rc, window, **kw):
        """The previous ``<0, 16>`` and ``<16, kDense>`` (8 warps, one row a
        warp, each warp's chain states; ``<0, 16>`` staged its CP rows in two
        buffers, ``<16, kDense>`` read its TT rows in place)."""
        layout = "tt" if kw.get("tt") else "dense" if kw.get("dense") else "cp"
        inst = old_instance(layout, kw.get("q_layout") or layout, rq, rc, n, d)
        if inst not in ((0, 16), (16, fq.DENSE), (16, 0), (8, 8), (16, 16)):
            return smem_bytes(tables, n, d, rq, rc, window, **kw)
        if inst == (0, 16):
            rows, query = 16 * (-(-n * d * rc // 4) * 4), n * rq * d * rq
            states = 2 * max(rq * rc, rq * rq)
        elif inst == (16, 0):
            rows, query = 0, n * d * rq
            states = 2 * max(rq * rc, rc * rc)
        elif inst in ((8, 8), (16, 16)):
            rows = 16 * (-(-n * rc * d * rc // 4) * 4) if inst == (8, 8) else 0
            query, states = n * rq * d * rq, 2 * max(rq * rc + rc * rc, rq * rq)
        else:
            rows, states = 0, 2 * rc * rc
            query = kw["df"] if kw["df"] <= fq.DENSE_STAGE else 0
        region = -(-max(3 * window, 16 * kw.get("expansion", 0)) // 4) * 4
        topk = kw.get("topk", 10)
        return ((rows + query + 8 * states + region) * 4 + 9 * topk * 8
                + (4 * tables * kw.get("probes", 1) + 1) * 4
                + fq.STATIC_SMEM)

    monkeypatch.setitem(fq.SHAPES, (0, 16), (256, 2, 1, 2))
    monkeypatch.setattr(fq, "smem_bytes", old_smem)
    monkeypatch.setattr(fq, "instance", old_instance)
    redesigned = (("dense", "dense"), ("cp", "dense"), ("tt", "cp"),
                  ("tt", "dense"), ("dense", "cp"), ("dense", "tt"),
                  ("cp", "tt"), ("tt", "tt"))
    for (pair, launch), (window, _) in new.items():
        n, d, rq, rc, kw = _args(*pair)
        tables, cap, probes, topk = launch
        exp = probing.expansion_size("e2lsh", 10) if probes > 1 else 0
        old, _ = fq.window_plan(tables, cap, n, d, rq, rc, probes=probes,
                                topk=topk, expansion=exp, **kw)
        if pair[:2] in redesigned:
            # a dense ring slot a warp takes the room of a larger window
            # (twelve rows of 2,048 floats are 96 KiB)
            dense_ring = ring[pair, launch] and pair[0] == "dense"
            least = fq.MIN_WINDOW * (2 if dense_ring else 4)
            assert window >= min(old, least), (pair, launch, window, old)
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


# --- CP and dense queries over TT rows of ranks <= 4 (``Shape::tt_pair``) --

def _tt_cores(rng, dims, ranks):
    """Random TT cores (r_{n-1}, d_n, r_n), float32."""
    return [rng.standard_normal((ranks[n], d, ranks[n + 1])).astype(
        np.float32) for n, d in enumerate(dims)]


def _stack_tt(cores, dims):
    """One stacked TT row (N, R, D, R), R the largest rank, D the largest
    mode dim, zeros where a core is smaller (``ops.stack_tt``'s layout)."""
    r = max(max(c.shape[0], c.shape[2]) for c in cores)
    out = np.zeros((len(cores), r, max(dims), r), np.float32)
    for n, c in enumerate(cores):
        out[n, :c.shape[0], :c.shape[1], :c.shape[2]] = c
    return out


def _pad4(g):
    """A stacked TT row padded to rank 4 with zeros: the kernel guards its
    loads past the row's rank, which reads as zeros."""
    n, r, d, _ = g.shape
    out = np.zeros((n, 4, d, 4), np.float32)
    out[:, :r, :, :r] = g
    return out


def _butterfly(v, width):
    """A butterfly sum over the lanes of ``v`` (width lanes), in fp32."""
    v = v.astype(np.float32)
    o = width // 2
    while o:
        v = (v + v[np.arange(width) ^ o]).astype(np.float32)
        o //= 2
    return v[0]


def cp_tt_model(a, g):
    """``cp_tt_half``'s order in fp32: a (N, D, RA) a stacked CP row, g (N,
    r, D, r) a stacked TT row, r <= 4 -> <A, G> unscaled. Per chunk of four
    CP ranks, lane (q, x): mode 1 the x lanes take slices i = x, x + 4, ...
    of M[q][0][e]; a later mode M[q][x][e] = sum_i A[i][q] G[x][i][e] (an
    FMA chain), times S[q][x]; the x lanes' butterfly gives S'[q][e], lane
    x keeping e = x; then the q lanes' totals by a butterfly."""
    g = _pad4(g)
    n_modes, d, ra = a.shape
    totals = np.zeros(16, np.float32)
    for q0 in range(0, ra, 4):
        for ql in range(4):
            q = min(q0 + ql, ra - 1)
            s = np.zeros(4, np.float32)        # lane x holds S[q][x]
            for n in range(n_modes):
                p = np.zeros((4, 4), np.float32)   # [lane x][e]
                for x in range(4):
                    if n == 0:
                        for i in range(x, d, 4):
                            p[x] = _fma(np.full(4, a[0, i, q]), g[0, 0, i],
                                        p[x])
                    else:
                        for i in range(d):
                            p[x] = _fma(np.full(4, a[n, i, q]), g[n, x, i],
                                        p[x])
                        p[x] = (p[x] * s[x]).astype(np.float32)
                t = (p + p[[1, 0, 3, 2]]).astype(np.float32)
                full = (t + t[[2, 3, 0, 1]]).astype(np.float32)
                s = np.array([full[x, x] for x in range(4)], np.float32)
            if q0 + ql < ra:
                totals[4 * ql] = np.float32(totals[4 * ql] + s[0])
    return _butterfly(totals, 16)


def tt_self_model(g):
    """``tt_self_half``'s order in fp32 for a stacked TT row g (N, r, D, r),
    r <= 4 -> <G, G> unscaled: mode 1 S[c][e] = sum_i G[0][i][c] G[0][i][e];
    a middle mode tt_chains' step; the last mode S'[0][0], lane (a, b)
    adding G[a][i][0] V[a][0] over the slices i = b, b + 4, ..., then a
    butterfly."""
    g = _pad4(g)
    n_modes, _, d, _ = g.shape
    s = np.zeros((4, 4), np.float32)
    for i in range(d):
        s = _fma(g[0, 0, i][:, None], g[0, 0, i][None, :], s)
    if n_modes == 1:
        return s[0, 0]
    for n in range(1, n_modes):
        gn = g[n]                                  # (a, i, c)
        if n == n_modes - 1:
            acc = np.zeros(16, np.float32)
            for a_ in range(4):
                for b in range(4):
                    for i in range(b, d, 4):
                        v = np.float32(0)
                        for y in range(4):
                            v = _fma(s[a_, y], gn[y, i, 0], v)
                        acc[4 * a_ + b] = _fma(gn[a_, i, 0], v,
                                               acc[4 * a_ + b])
            return _butterfly(acc, 16)
        nxt = np.zeros((4, 4), np.float32)
        for c in range(4):
            for e in range(4):
                acc = np.float32(0)
                for i in range(d):
                    for x in range(4):
                        u = np.float32(0)
                        for y in range(4):
                            u = _fma(s[x, y], gn[y, i, e], u)
                        acc = _fma(gn[x, i, c], u, acc)
                nxt[c, e] = acc
        s = nxt


def dense_tt_model(q, g, dims):
    """``dense_tt_sweep``'s order in fp32 for one TT row: q (DF,) the dense
    row, g (N, r, D, r) a stacked TT row -> qy, unscaled. Half-lane h's
    columns p = h, h + 16, ...: t[c] = the FMA chain over G_1's rank rows,
    the weight G_2[:, i_2, :] ... G_N[:, i_N, 0] right to left (the slices
    from ``column_table``: entry n * D + i_n), acc += t[c] w[c] in rank
    order; then the butterfly over the half."""
    g = _pad4(g)
    n_modes, _, d, _ = g.shape
    d1, p_cols = dims[0], math.prod(dims[1:])
    qm = q.reshape(d1, p_cols)
    table = np.array(fq.column_table(dims, d), dtype=np.int64).reshape(
        n_modes - 1, p_cols)
    acc = np.zeros(16, np.float32)
    for p in range(p_cols):
        t = np.zeros(4, np.float32)
        for i in range(d1):
            t = _fma(g[0, 0, i], np.full(4, qm[i, p]), t)
        w = np.array([1, 0, 0, 0], np.float32)
        if n_modes > 1:
            w = g[n_modes - 1, :, table[n_modes - 2, p]
                  - (n_modes - 1) * d, 0].copy()
            for n in range(n_modes - 2, 0, -1):
                i_n = table[n - 1, p] - n * d
                nv = np.zeros(4, np.float32)
                for a_ in range(4):
                    u = np.float32(0)
                    for c in range(4):
                        u = _fma(g[n, a_, i_n, c], w[c], u)
                    nv[a_] = u
                w = nv
        lane = p % 16
        for c in range(4):
            acc[lane] = _fma(t[c], w[c], acc[lane])
    return _butterfly(acc, 16)


def _ref_tt(cores):
    from repro.core.tensor_formats import TTTensor as RefTT
    return RefTT(tuple(jnp.asarray(c) for c in cores))


def _tt_dense64(cores):
    """The TT tensor's entries in float64."""
    t = cores[0].astype(np.float64)[0]
    for c in cores[1:]:
        t = np.tensordot(t, c.astype(np.float64), axes=(-1, 0))
    return t[..., 0]


# (mode dims, TT ranks r_0 .. r_N): [cp-as-tt]'s, ragged ranks and mode
# dims that are not multiples of 4, one mode and four
TT_SHAPES = [((12, 12, 12), (1, 4, 4, 1)), ((6, 5, 7), (1, 3, 2, 1)),
             ((13, 3), (1, 2, 1)), ((3, 4, 5, 6), (1, 3, 4, 2, 1)),
             ((2, 3, 2, 3), (1, 2, 4, 3, 1)), ((9,), (1, 1))]


@pytest.mark.parametrize("rank", [1, 2, 3, 4, 6])
@pytest.mark.parametrize("shape", TT_SHAPES[:4], ids=str)
def test_cp_tt_order_within_the_cross_bound(shape, rank):
    """The kernel's CP x TT order (``cp_tt_model``) against the reference's
    ``inner_cp_tt`` and against float64, within 2 n u S, n =
    ``parity.cross_length`` and S the same contraction over absolute
    values; CP ranks 1-4 and 6 (two chunks of four)."""
    dims, ranks = shape
    rng = np.random.default_rng(23)
    cores = _tt_cores(rng, dims, ranks)
    factors = [rng.standard_normal((dn, rank)).astype(np.float32)
               for dn in dims]
    a = np.zeros((len(dims), max(dims), rank), np.float32)
    for n, f in enumerate(factors):
        a[n, :f.shape[0]] = f
    ref = float(ref_contractions.inner_cp_tt(
        RefCP(tuple(jnp.asarray(f) for f in factors)), _ref_tt(cores)))
    cp64 = _dense(factors)
    exact = float((cp64 * _tt_dense64(cores)).sum())
    s = float((np.abs(cp64) if rank == 1 else _dense(
        [np.abs(f) for f in factors])).ravel()
        @ _tt_dense64([np.abs(c) for c in cores]).ravel())
    x = CPTensor(tuple(torch.from_numpy(f) for f in factors), 1.0)
    y = TTTensor(tuple(torch.from_numpy(c) for c in cores), 1.0)
    bound = 2 * parity.cross_length(x, y) * parity.U * s
    got = float(cp_tt_model(a, _stack_tt(cores, dims)))
    assert abs(got - ref) <= bound, (got, ref, bound)
    assert abs(got - exact) <= bound / 2, (got, exact)


@pytest.mark.parametrize("shape", TT_SHAPES, ids=str)
def test_dense_tt_order_within_the_cross_bound(shape):
    """The kernel's dense x TT order (``dense_tt_model``: mode 1 first, the
    columns' weights through the column table) against the reference's
    ``inner_dense_tt`` and against float64, within 2 n u S, n =
    ``parity.cross_length``."""
    dims, ranks = shape
    rng = np.random.default_rng(24)
    cores = _tt_cores(rng, dims, ranks)
    q = rng.standard_normal(dims).astype(np.float32)
    ref = float(ref_contractions.inner_dense_tt(jnp.asarray(q),
                                                _ref_tt(cores)))
    exact = float((q.astype(np.float64) * _tt_dense64(cores)).sum())
    s = float((np.abs(q).astype(np.float64)
               * _tt_dense64([np.abs(c) for c in cores])).sum())
    x = DenseTensor(torch.from_numpy(q), dims)
    y = TTTensor(tuple(torch.from_numpy(c) for c in cores), 1.0)
    bound = 2 * parity.cross_length(x, y) * parity.U * s
    got = float(dense_tt_model(q.reshape(-1), _stack_tt(cores, dims), dims))
    assert abs(got - ref) <= bound, (got, ref, bound)
    assert abs(got - exact) <= bound / 2, (got, exact)


@pytest.mark.parametrize("shape", TT_SHAPES, ids=str)
def test_tt_self_order_within_the_bound(shape):
    """The TT rows' own inner product in the pair branches' order
    (``tt_self_model``) against the reference's ``inner_tt_tt`` and against
    float64, within 2 n u S, n = the TT format's ``inner_length``."""
    dims, ranks = shape
    rng = np.random.default_rng(25)
    cores = _tt_cores(rng, dims, ranks)
    ref = float(ref_contractions.inner_tt_tt(_ref_tt(cores), _ref_tt(cores)))
    t64 = _tt_dense64(cores)
    exact = float((t64 * t64).sum())
    y = TTTensor(tuple(torch.from_numpy(c) for c in cores), 1.0)
    bound = 2 * y.inner_length(y.rank) * parity.U * exact
    got = float(tt_self_model(_stack_tt(cores, dims)))
    assert abs(got - ref) <= bound, (got, ref, bound)
    assert abs(got - exact) <= bound / 2, (got, exact)


def test_tt_pair_plan_at_the_cells():
    """CP and dense queries over TT rows of ranks <= 4: 12 warps, two rows a
    warp in one buffer (``SHAPES``' last column), 2 blocks a SM; at [cp-as-tt]
    (2^20 items as TT rank 4 over (12, 12, 12), L = 10, cap 473) a block
    plans 55,296 bytes of rows and a 4,096-slot window beside them and the
    query row (576 CP floats or 1,728 dense ones staged): 106,260 and
    112,596 bytes, two blocks a SM. The other cross pairs keep two buffers,
    and TT ranks 5-16 (TR = 16) stage no rows."""
    for qr in (0, fq.DENSE):
        assert fq.SHAPES[4, qr] == (384, 2, 2, 1)
    for tr_qr, shape in fq.SHAPES.items():
        if tr_qr not in ((4, 0), (4, fq.DENSE)):
            assert shape[3] == 2
    for ql, rq, want in (("cp", 4, 106_260), ("dense", 1, 112_596)):
        kw = dict(tt=True, q_layout=ql, df=1728)
        window = fq.window_plan(10, 473, 3, 12, rq, 4, **kw)
        assert window == (4096, True)
        smem = fq.smem_bytes(10, 3, 12, rq, 4, 4096, **kw)
        assert smem == want and _blocks(smem) == 2, (ql, smem)
        rows = 12 * 2 * 576 * 4
        assert smem - fq.smem_bytes(10, 3, 12, rq, 4, 2048, **kw) == (
            2048 * 12)
        assert smem > rows == 55_296
    # TT ranks 5-16 without a ring slot read their rows in place: no row
    # buffers at all (a staged rank-16 row would take 36,864 bytes), each
    # warp's chain tiles and two slices of 1 KiB
    assert fq.instance("tt", "cp", 4, 16, 3, 12) == (16, 0)
    assert fq.smem_bytes(10, 3, 12, 4, 16, 256, tt=True, q_layout="cp",
                         df=1728) == 37_332


@pytest.mark.parametrize("q_layout", ["cp", "dense"])
def test_tt_pair_takes_rows_up_to_its_stage(q_layout):
    """CP and dense queries over TT rows of ranks <= 4 go to the TT pair
    branch (TR = 4, rows staged) for rows of at most ``TT_PAIR_ROW`` floats
    (N * R * D * R, the stacked rank): 24 such rows are 96 KiB, and a block
    beside the smallest window and a small query row keeps two blocks a
    SM; longer rows, and ranks 5-16, go to TR = 16, which reads them in
    place and so plans any shape the first design (one row a warp, two
    buffers) took."""
    qr = fq.instance("tt", q_layout, 4, 4, 3, 12)[1]
    assert qr == (0 if q_layout == "cp" else fq.DENSE)
    for n, d, rc, tr in ((3, 12, 4, 4), (4, 16, 4, 4), (3, 21, 4, 4),
                         (3, 22, 4, 16), (3, 64, 4, 16), (3, 64, 1, 4),
                         (3, 85, 2, 4), (3, 86, 2, 16), (3, 37, 3, 4),
                         (3, 38, 3, 16), (1, 64, 4, 4), (1, 65, 4, 16),
                         (3, 12, 5, 16)):
        assert fq.instance("tt", q_layout, 4, rc, n, d) == (tr, qr), (n, d,
                                                                     rc)
        assert (tr == 4) == (rc <= 4 and n * rc * d * rc <= fq.TT_PAIR_ROW)
    # the same-format pairs and the other cross pairs take no row rule
    assert fq.instance("tt", "tt", 4, 4, 3, 64) == (4, 4)
    assert fq.instance("cp", q_layout, 1, 4, 3, 64)[0] == 0
    # the longest staged row, CP rank 4 queries: two blocks a SM at L = 10
    window, _ = fq.window_plan(10, 2952, 4, 16, 4, 4, tt=True,
                               q_layout=q_layout, df=16 ** 4)
    smem = fq.smem_bytes(10, 4, 16, 4, 4, window, tt=True,
                         q_layout=q_layout, df=16 ** 4)
    assert _blocks(smem) == 2 and smem > 24 * 1024 * 4


@pytest.mark.parametrize("dims", [(12, 12, 12), (6, 5, 7), (3, 4, 5, 6)])
def test_tt_column_table_decodes_each_columns_slices(dims):
    """The dense x TT sweep reads column p's slice of mode n as entry (n -
    1, p) of ``column_table`` minus n * D: the mode index i_n(p) of the
    row read as (d_1, P), the last mode fastest, for the padded D."""
    d = max(dims)
    p = math.prod(dims[1:])
    table = np.array(fq.column_table(dims, d), np.int64).reshape(
        len(dims) - 1, p)
    idx = np.unravel_index(np.arange(p), dims[1:])
    for n in range(1, len(dims)):
        np.testing.assert_array_equal(table[n - 1] - n * d, idx[n - 1])


# --- TT queries over CP rows (``<0, 4>``) and over dense rows --------------

def test_tt_query_instances():
    """TT queries of ranks 1-4 over CP rows of at most ``CP_PAIR_ROW``
    floats (N * d * R, the stacked CP rank) choose ``<0, 4>``; ranks 5-16,
    and longer rows, ``<0, 16>`` (one staged row a warp, the first
    design); over dense rows every TT rank takes ``<kDense, 16>``, and CP
    queries ``<kDense, 0>``."""
    for rq in range(1, fq.MAX_TT_RANK + 1):
        for n, d, rc in ((3, 12, 4), (4, 16, 4), (3, 2, 32), (1, 64, 4),
                         (3, 12, 8), (4, 16, 5), (1, 65, 4)):
            short = n * d * rc <= fq.CP_PAIR_ROW
            want = (0, 4) if rq <= 4 and short else (0, 16)
            assert fq.instance("cp", "tt", rq, rc, n, d) == want, (rq, n, d)
        assert fq.instance("dense", "tt", rq, 1, 3, 12) == (fq.DENSE, 16)
    assert fq.instance("dense", "cp", 4, 1, 3, 12) == (fq.DENSE, 0)
    assert fq.SHAPES[0, 4] == (384, 2, 2, 2)
    for qr in (0, 16):
        assert fq.SHAPES[fq.DENSE, qr] == fq.SHAPES[fq.DENSE, fq.DENSE]
    assert fq.instance_name(fq.DENSE, 16) == "<kDense, 16>"
    assert fq.instance_name(0, 4) == "<0, 4>"


def test_cp_pair_plan_at_the_cells():
    """``<0, 4>``: 12 warps, two CP rows a warp in two buffers, 2 blocks a
    SM. At [mixed tt x cp] ([main]'s CP rows of 144 floats, TT queries of
    rank 4: 576 floats staged, L = 10, cap 765) a block plans 27,648 bytes
    of rows beside a 4,096-slot window (80,468 bytes); an 8,192-slot one
    would not fit two blocks with one buffer either. The longest staged row
    (256 floats, (16,)*4 at rank 4, with the query's 1,024 floats), CP rank
    32 rows and a live window at T = 4 keep two blocks a SM."""
    kw = dict(q_layout="tt", df=1728)
    assert fq.window_plan(10, 765, 3, 12, 4, 4, **kw) == (4096, True)
    smem = fq.smem_bytes(10, 3, 12, 4, 4, 4096, **kw)
    assert smem == 80_468 and _blocks(smem) == 2
    rows = 12 * 2 * 2 * 144 * 4
    assert rows == 27_648
    assert _blocks(fq.smem_bytes(10, 3, 12, 4, 4, 8192, **kw) - rows // 2) < 2
    exp = probing.expansion_size("e2lsh", 10)
    for n, d, rq, rc, launch in ((4, 16, 4, 4, (10, 2952, 1, 10)),
                                 (3, 2, 3, 32, (10, 765, 1, 10)),
                                 (3, 12, 4, 4, (10, 64, 4, 10))):
        assert fq.instance("cp", "tt", rq, rc, n, d) == (0, 4)
        tables, cap, probes, topk = launch
        e = exp if probes > 1 else 0
        k = dict(q_layout="tt", df=d ** n, probes=probes, topk=topk,
                 expansion=e)
        window, _ = fq.window_plan(tables, cap, n, d, rq, rc, **k)
        assert _blocks(fq.smem_bytes(tables, n, d, rq, rc, window,
                                     **k)) == 2, (n, d, rc)


@pytest.mark.parametrize("q_layout,rq", [("cp", 4), ("tt", 4), ("tt", 16)])
def test_dense_ring_for_every_query_format(q_layout, rq):
    """CP and TT queries over dense rows read them through the ring slots
    where the dense instantiation would: at [dense-main] (1,728 floats, L
    = 10, cap 367) beside a 1,024-slot window and the densified query row,
    two blocks a SM (a TT query's chain state once a block, 2 R^2 floats);
    at rows of 2,048 floats too; not past ``RING_ROW`` or at whole floats.
    """
    query = (q_layout, 3, 12, rq)
    assert fq.ring_plan(10, 367, 1728, query=query)
    kw = dict(dense=True, q_layout=q_layout, df=1728, ring=True)
    window, _ = fq.window_plan(10, 367, 3, 12, rq, 1, **kw)
    assert window == 1024
    smem = fq.smem_bytes(10, 3, 12, rq, 1, window, **kw)
    assert _blocks(smem) == 2
    assert smem - fq.smem_bytes(10, 3, 12, rq, 1, window,
                                **dict(kw, ring=False)) == 12 * 1730 * 4
    assert fq.ring_plan(10, 367, 2048, query=(q_layout, 1, 2048, rq))
    assert not fq.ring_plan(10, 367, 2052, query=(q_layout, 2, 1026, rq))
    assert not fq.ring_plan(10, 367, 1730, query=(q_layout, 2, 865, rq))
    plan = fq._plan("dense", 10, 367, 3, 12, rq, 1, 1, 10, 0, q_layout, 1728,
                    fq.SHAPES[fq.instance("dense", q_layout, rq, 1, 3, 12)])
    assert plan == (1024, True, smem)


def gram_half_model(a):
    """The CP pair branch's yy, <A, A> of a stacked CP row a (N, D, R) on a
    half-warp, in fp32: half-lane h takes the (r, q) terms p = h, h + 16,
    ... (pair_terms: per mode a d-long FMA chain, the modes' product in
    mode order), then the half's butterfly."""
    n_modes, d, r_all = a.shape
    acc = np.zeros(16, np.float32)
    for p in range(r_all * r_all):
        r, q = divmod(p, r_all)
        prod = np.float32(0)
        for n in range(n_modes):
            dot = np.float32(0)
            for i in range(d):
                dot = _fma(a[n, i, r], a[n, i, q], dot)
            prod = dot if n == 0 else np.float32(prod * dot)
        acc[p % 16] = np.float32(acc[p % 16] + prod)
    return _butterfly(acc, 16)


@pytest.mark.parametrize("rank", [1, 2, 3, 4, 6])
@pytest.mark.parametrize("shape", TT_SHAPES[:4], ids=str)
def test_cp_pair_order_within_the_cross_bound(shape, rank):
    """The CP pair branch's qy (``cp_tt_half`` with the roles swapped: the
    staged CP row the CP operand, the TT query's cores the TT one) against
    the reference's ``inner`` on (TT query, CP row), which is
    ``inner_cp_tt(row, query)``, and against float64, within 2 n u S (n =
    ``parity.cross_length``); its yy (the row's Grams on a half-warp)
    against ``inner_cp_cp`` within 2 n u <|A|, |A|> (n the CP format's
    ``inner_length``). TT query ranks 1-4, ragged; CP row ranks 1-4 and 6."""
    dims, ranks = shape
    rng = np.random.default_rng(26)
    cores = _tt_cores(rng, dims, ranks)
    factors = [rng.standard_normal((dn, rank)).astype(np.float32)
               for dn in dims]
    a = np.zeros((len(dims), max(dims), rank), np.float32)
    for n, f in enumerate(factors):
        a[n, :f.shape[0]] = f
    row = RefCP(tuple(jnp.asarray(f) for f in factors))
    ref = float(ref_contractions.inner(_ref_tt(cores), row))
    cp64 = _dense(factors)
    exact = float((cp64 * _tt_dense64(cores)).sum())
    s = float(_dense([np.abs(f) for f in factors]).ravel()
              @ np.abs(_tt_dense64([np.abs(c) for c in cores])).ravel())
    x = TTTensor(tuple(torch.from_numpy(c) for c in cores), 1.0)
    y = CPTensor(tuple(torch.from_numpy(f) for f in factors), 1.0)
    bound = 2 * parity.cross_length(x, y) * parity.U * s
    got = float(cp_tt_model(a, _stack_tt(cores, dims)))
    assert abs(got - ref) <= bound, (got, ref, bound)
    assert abs(got - exact) <= bound / 2, (got, exact)
    yy = float(gram_half_model(a))
    yy_ref = float(ref_contractions.inner_cp_cp(row, row))
    yy64 = float((cp64 * cp64).sum())
    s_yy = float((_dense([np.abs(f) for f in factors]) ** 2).sum())
    b_yy = 2 * y.inner_length(rank) * parity.U * s_yy
    assert abs(yy - yy_ref) <= b_yy and abs(yy - yy64) <= b_yy / 2


def densify_entry_model(g, dims):
    """The first design's densified TT row, in fp32: each entry its own
    chain from e_0 through every mode (``tt_row_step``: nv[c] = the FMA
    chain over a < R of v[a] G[a][i][c]), its component 0."""
    n_modes, r, d, _ = g.shape
    out = np.zeros(math.prod(dims), np.float32)
    for p, ix in enumerate(itertools.product(*map(range, dims))):
        v = np.zeros(r, np.float32)
        v[0] = 1
        for n in range(n_modes):
            nv = np.zeros(r, np.float32)
            for a_ in range(r):
                nv = _fma(np.full(r, v[a_]), g[n, a_, ix[n]], nv)
            v = nv
        out[p] = v[0]
    return out


def densify_prefix_model(g, dims):
    """``densify_tt``'s order in fp32: each prefix (i_1 .. i_{N-1}) steps
    the row vector through the first N - 1 cores once, then each of the
    last mode's entries is the FMA chain over a < R of v[a] G_N[a][j][0]."""
    n_modes, r, d, _ = g.shape
    out = np.zeros(math.prod(dims), np.float32)
    dl = dims[-1]
    for p, ix in enumerate(itertools.product(*map(range, dims[:-1]))):
        v = np.zeros(r, np.float32)
        v[0] = 1
        for n in range(n_modes - 1):
            nv = np.zeros(r, np.float32)
            for a_ in range(r):
                nv = _fma(np.full(r, v[a_]), g[n, a_, ix[n]], nv)
            v = nv
        e = np.zeros(dl, np.float32)
        for a_ in range(r):
            e = _fma(np.full(dl, v[a_]), g[n_modes - 1, a_, :dl, 0], e)
        out[p * dl:(p + 1) * dl] = e
    return out


@pytest.mark.parametrize("shape", TT_SHAPES, ids=str)
def test_densify_prefix_equals_the_entry_chain(shape):
    """A TT query densified prefix by prefix (``densify_tt``) equals the
    first design's per-entry chain bit for bit (the same FMAs in the same
    order for every entry), ragged ranks and mode dims, one mode and four;
    and both lie within the chain's rounding of the float64 entries."""
    dims, ranks = shape
    rng = np.random.default_rng(27)
    cores = _tt_cores(rng, dims, ranks)
    g = _stack_tt(cores, dims)
    prefix = densify_prefix_model(g, dims)
    entry = densify_entry_model(g, dims)
    np.testing.assert_array_equal(prefix.view(np.int32), entry.view(np.int32))
    t64 = _tt_dense64(cores).ravel()
    s = _tt_dense64([np.abs(c) for c in cores]).ravel()
    r = g.shape[1]
    bound = 2 * len(dims) * r * parity.U * s
    assert bool((np.abs(prefix - t64) <= bound).all())


# --- TT ranks 5-16: TT queries over CP rows (``<0, 16>``) and dense queries
# over TT rows (``<16, kDense>``) ---------------------------------------------

# (mode dims, TT ranks): ranks 5, 8, 12 and 16 and a ragged (1, 5, 7, 1), at
# (12, 12, 12) and a ragged shape
WIDE_RANKS = [(1, 5, 5, 1), (1, 8, 8, 1), (1, 12, 12, 1), (1, 16, 16, 1),
              (1, 5, 7, 1)]
WIDE_SHAPES = [(dims, ranks) for dims in ((12, 12, 12), (6, 5, 7))
               for ranks in WIDE_RANKS]


def _rank_bound(r):
    """The rank bound E of the wide branches' lanes: 4, 8 or 16."""
    return 4 if r <= 4 else 8 if r <= 8 else 16


def cp_tt_wide_model(a, g):
    """``cp_tt_wide``'s order in fp32: a (N, D, RA) a stacked CP row, g (N,
    r, D, r) a stacked TT row, r <= 16 (E = 8 or 16) -> <A, G> unscaled.
    Half-lane h = E
    ql + e holds S[q][e] for q = q0 + ql + k 16 / E (k < K: 2, 1 at E =
    16); mode 1 the
    d-long chain of A[i][q] G[0][i][e]; a middle mode m[k][x] the d-long
    chains of A[i][q] G[x][i][e], then S'[q][e] the r-long chain of S[q][x]
    m[k][x]; the last mode S[q][e] times the chain of A[i][q] G[e][i][0];
    the lane's live terms in chunk order, then the half's butterfly."""
    n_modes, d, ra = a.shape
    r = g.shape[1]
    e_bound = 8 if r <= 8 else 16
    qn, kq = 16 // e_bound, 1 if e_bound == 16 else 2
    ql, e = np.divmod(np.arange(16), e_bound)
    ec = np.minimum(e, r - 1)
    totals = np.zeros(16, np.float32)
    for q0 in range(0, ra, kq * qn):
        qk = [q0 + ql + qn * k for k in range(kq)]
        live = [(q < ra) & (e < r) for q in qk]
        qk = [np.minimum(q, ra - 1) for q in qk]
        s = []
        for k in range(kq):
            acc = np.zeros(16, np.float32)
            for i in range(d):
                acc = _fma(a[0, i, qk[k]], g[0, 0, i, ec], acc)
            s.append(np.where(e < r, acc, 0).astype(np.float32))
        for n in range(1, n_modes):
            if n == n_modes - 1:
                for k in range(kq):
                    acc = np.zeros(16, np.float32)
                    for i in range(d):
                        acc = _fma(a[n, i, qk[k]], g[n, ec, i, 0], acc)
                    s[k] = (s[k] * acc).astype(np.float32)
                break
            m = np.zeros((kq, e_bound, 16), np.float32)
            for i in range(d):
                for x in range(e_bound):
                    gv = g[n, x, i, ec] if x < r else np.zeros(16, np.float32)
                    for k in range(kq):
                        m[k, x] = _fma(a[n, i, qk[k]], gv, m[k, x])
            for k in range(kq):
                ns = np.zeros(16, np.float32)
                for x in range(e_bound):
                    ns = _fma(s[k][ql * e_bound + x], m[k, x], ns)
                s[k] = np.where(e < r, ns, 0).astype(np.float32)
        if n_modes == 1:
            s = [np.where(e == 0, v, 0).astype(np.float32) for v in s]
        for k in range(kq):
            totals = np.where(live[k], totals + s[k], totals).astype(
                np.float32)
    return _butterfly(totals, 16)


def dense_tt_row_model(q, g, dims):
    """``dense_tt_row``'s order in fp32 for one TT row: q (DF,) the dense
    row, g (N, r, D, r) a stacked TT row -> (qy, yy) unscaled. Lane l's
    columns p = l, l + 32, ..., two at a time (one at E = 16): each
    column's weight w =
    G_2[:, i_2, :] ... G_N[:, i_N, 0] right to left by r-long FMA chains;
    per slice i of mode 1 the entries y = the chain of G_1[0][i][c] w[c],
    then qy += q[i, p] y and yy += y y; a butterfly over the warp."""
    n_modes, r, d, _ = g.shape
    d1, p_cols = dims[0], math.prod(dims[1:])
    qm = q.reshape(d1, p_cols)
    e_bound = _rank_bound(r)
    gp = np.zeros((n_modes, e_bound, d, e_bound), np.float32)
    gp[:, :r, :, :r] = g
    w = np.zeros((p_cols, e_bound), np.float32)
    w[:, 0] = 1
    if n_modes > 1:
        table = np.array(fq.column_table(dims, d), dtype=np.int64).reshape(
            n_modes - 1, p_cols)
        w = gp[n_modes - 1, :, table[-1] - (n_modes - 1) * d, 0].copy()
        for n in range(n_modes - 2, 0, -1):
            rows = gp[n][:, table[n - 1] - n * d, :]   # (a, p, c)
            nv = np.zeros((p_cols, e_bound), np.float32)
            for a_ in range(r):
                u = np.zeros(p_cols, np.float32)
                for c in range(e_bound):
                    u = _fma(rows[a_, :, c], w[:, c], u)
                nv[:, a_] = u
            w = nv
    lanes = np.arange(32)
    aq = np.zeros(32, np.float32)
    ay = np.zeros(32, np.float32)
    cg = 1 if e_bound == 16 else 2
    for p0 in range(0, p_cols, 32 * cg):
        on = [lanes + p0 + 32 * k < p_cols for k in range(cg)]
        cols = [np.minimum(lanes + p0 + 32 * k, p_cols - 1)
                for k in range(cg)]
        for i in range(d1):
            for k in range(cg):
                y = np.zeros(32, np.float32)
                for c in range(e_bound):
                    y = _fma(np.full(32, gp[0, 0, i, c]), w[cols[k], c], y)
                aq = np.where(on[k], _fma(qm[i, cols[k]], y, aq), aq)
                ay = np.where(on[k], _fma(y, y, ay), ay)
    return _butterfly(aq, 32), _butterfly(ay, 32)


@pytest.mark.parametrize("shape,rank", [
    (shape, rank) for shape in WIDE_SHAPES
    for rank in ((1, 2, 3, 4, 6) if shape[0] == (12, 12, 12) else (1, 6))],
    ids=str)
def test_cp_tt_wide_order_within_the_cross_bound(shape, rank):
    """``<0, 16>``'s qy (``cp_tt_wide_model``: a row a half-warp, each
    lane's CP x TT state entries in registers, passed by shuffles) against
    the reference's ``inner`` on (TT query, CP row), which is
    ``inner_cp_tt(row, query)``, and against float64, within 2 n u S (n =
    ``parity.cross_length``); TT query ranks 5, 8, 12, 16 and ragged, CP
    row ranks 1-4 and 6 at (12, 12, 12), 1 and 6 (two chunks of four) at
    ragged mode dims."""
    dims, ranks = shape
    rng = np.random.default_rng(28)
    cores = _tt_cores(rng, dims, ranks)
    factors = [rng.standard_normal((dn, rank)).astype(np.float32)
               for dn in dims]
    a = np.zeros((len(dims), max(dims), rank), np.float32)
    for n, f in enumerate(factors):
        a[n, :f.shape[0]] = f
    ref = float(ref_contractions.inner(
        _ref_tt(cores), RefCP(tuple(jnp.asarray(f) for f in factors))))
    cp64 = _dense(factors)
    exact = float((cp64 * _tt_dense64(cores)).sum())
    s = float(_dense([np.abs(f) for f in factors]).ravel()
              @ _tt_dense64([np.abs(c) for c in cores]).ravel())
    x = TTTensor(tuple(torch.from_numpy(c) for c in cores), 1.0)
    y = CPTensor(tuple(torch.from_numpy(f) for f in factors), 1.0)
    bound = 2 * parity.cross_length(x, y) * parity.U * s
    got = float(cp_tt_wide_model(a, _stack_tt(cores, dims)))
    assert abs(got - ref) <= bound, (got, ref, bound)
    assert abs(got - exact) <= bound / 2, (got, exact)


@pytest.mark.parametrize("shape", TT_SHAPES[:4], ids=str)
def test_cp_tt_wide_takes_low_ranks(shape):
    """TT queries of ranks <= 4 over CP rows past ``CP_PAIR_ROW`` go to
    ``<0, 16>`` too: its order at rank bound 8 (lanes e >= r idle) holds
    against ``inner_cp_tt`` at CP ranks 3 and 9 (three chunks)."""
    dims, ranks = shape
    rng = np.random.default_rng(29)
    cores = _tt_cores(rng, dims, ranks)
    for rank in (3, 9):
        factors = [rng.standard_normal((dn, rank)).astype(np.float32)
                   for dn in dims]
        a = np.zeros((len(dims), max(dims), rank), np.float32)
        for n, f in enumerate(factors):
            a[n, :f.shape[0]] = f
        ref = float(ref_contractions.inner_cp_tt(
            RefCP(tuple(jnp.asarray(f) for f in factors)), _ref_tt(cores)))
        s = float(_dense([np.abs(f) for f in factors]).ravel()
                  @ _tt_dense64([np.abs(c) for c in cores]).ravel())
        x = CPTensor(tuple(torch.from_numpy(f) for f in factors), 1.0)
        y = TTTensor(tuple(torch.from_numpy(c) for c in cores), 1.0)
        bound = 2 * parity.cross_length(x, y) * parity.U * s
        got = float(cp_tt_wide_model(a, _stack_tt(cores, dims)))
        assert abs(got - ref) <= bound, (rank, got, ref, bound)


@pytest.mark.parametrize("shape", WIDE_SHAPES + [((13, 3), (1, 9, 1)),
                                                 ((3, 4, 5, 6),
                                                  (1, 6, 9, 5, 1)),
                                                 ((9,), (1, 1))], ids=str)
def test_dense_tt_row_order_within_the_bounds(shape):
    """``<16, kDense>``'s qy and yy (``dense_tt_row_model``: mode 1 first,
    a row a warp, each column's weight at rank r, yy the squared entries)
    against the reference's ``inner_dense_tt`` within 2 n u S (n =
    ``parity.cross_length``) and ``inner_tt_tt`` within the re-rank's
    yy bound (2 n u <|Y|, |Y|>, n the pair's ``cross_length``, which
    ``parity.rerank_bound`` carries), and both against float64."""
    dims, ranks = shape
    rng = np.random.default_rng(30)
    cores = _tt_cores(rng, dims, ranks)
    q = rng.standard_normal(dims).astype(np.float32)
    ref_qy = float(ref_contractions.inner_dense_tt(jnp.asarray(q),
                                                   _ref_tt(cores)))
    ref_yy = float(ref_contractions.inner_tt_tt(_ref_tt(cores),
                                                _ref_tt(cores)))
    t64 = _tt_dense64(cores)
    abs64 = _tt_dense64([np.abs(c) for c in cores])
    x = DenseTensor(torch.from_numpy(q), dims)
    y = TTTensor(tuple(torch.from_numpy(c) for c in cores), 1.0)
    n = parity.cross_length(x, y)
    b_qy = 2 * n * parity.U * float((np.abs(q) * abs64).sum())
    b_yy = 2 * n * parity.U * float((abs64 * abs64).sum())
    qy, yy = dense_tt_row_model(q.reshape(-1), _stack_tt(cores, dims), dims)
    assert abs(float(qy) - ref_qy) <= b_qy, (qy, ref_qy, b_qy)
    assert abs(float(qy) - float((q * t64).sum())) <= b_qy / 2
    assert abs(float(yy) - ref_yy) <= b_yy, (yy, ref_yy, b_yy)
    assert abs(float(yy) - float((t64 * t64).sum())) <= b_yy / 2


def test_wide_plans_at_the_cells():
    """``<0, 16>``: 12 warps, two CP rows a warp in two buffers, 2 blocks a
    SM. At [mixed tt8 x cp] ([main]'s 144-float CP rows, TT queries of rank
    8 staged at the ``wide_row`` stride, L = 10, cap 765) a block plans
    27,648 bytes of rows and qq's block-wide chain (r^2 + r d r floats)
    beside a 4,096-slot window: 90,676 bytes; at rank 16 a 2,048-slot
    window (103,828). ``<16, kDense>`` at [tt8] (TT rows of
    rank 8, 2,304 floats, cap 36): 8 warps, a ring slot a warp (73,792
    bytes) beside a 512-slot window, 2 blocks; rank-16 rows (9,216 floats)
    and rows of whole floats are read in place; every one 2 blocks a SM."""
    assert fq.SHAPES[0, 16] == (384, 2, 2, 2)
    assert fq.SHAPES[16, fq.DENSE] == (256, 2, 1, 2)
    kw = dict(q_layout="tt", df=1728)
    for rq, window, want in ((8, 4096, 90_676), (16, 2048, 103_828)):
        assert fq.instance("cp", "tt", rq, 4, 3, 12) == (0, 16)
        assert fq.slot_plan("cp", "tt", 10, 765, 3, 12, rq, 4, df=1728)
        assert fq.window_plan(10, 765, 3, 12, rq, 4, ring=True, **kw) == (
            window, True)
        smem = fq.smem_bytes(10, 3, 12, rq, 4, window, ring=True, **kw)
        assert smem == want and _blocks(smem) == 2, (rq, smem)
        assert smem - fq.smem_bytes(10, 3, 12, rq, 4, window, **kw) == (
            12 * 2 * 2 * 144 * 4)
    kw = dict(tt=True, q_layout="dense", df=1728)
    assert fq.instance("tt", "dense", 1, 8, 3, 12) == (16, fq.DENSE)
    assert fq.tt_ring_slot(3 * 8 * 12 * 8) == 2304
    assert fq.slot_plan("tt", "dense", 10, 36, 3, 12, 1, 8, df=1728)
    assert fq.window_plan(10, 36, 3, 12, 1, 8, ring=True, **kw) == (512,
                                                                    False)
    smem = fq.smem_bytes(10, 3, 12, 1, 8, 512, ring=True, **kw)
    assert _blocks(smem) == 2
    assert smem - fq.smem_bytes(10, 3, 12, 1, 8, 512, **kw) == 8 * 2306 * 4
    # edges: rank-16 TT rows, ragged rows, long CP rows; all two blocks
    for layout, ql, dims, rq, rc, slots in (
            ("tt", "dense", (12, 12, 12), 1, 16, False),
            ("tt", "dense", (6, 5, 7), 1, 5, False),
            ("tt", "dense", (22, 22, 22), 1, 4, True),
            ("cp", "tt", (32, 32, 64), 8, 4, False),
            ("cp", "tt", (12, 12, 12), 16, 8, True),
            ("cp", "tt", (12, 12, 12), 5, 4, True)):
        n, d, df = len(dims), max(dims), math.prod(dims)
        got = fq.slot_plan(layout, ql, 10, 765, n, d, rq, rc, df=df)
        assert got == slots, (layout, dims, rq, rc)
        k = dict(tt=layout == "tt", q_layout=ql, df=df, ring=got)
        window, _ = fq.window_plan(10, 765, n, d, rq, rc, **k)
        assert _blocks(fq.smem_bytes(10, n, d, rq, rc, window, **k)) == 2


# --- TT rows of ranks 5-16: <16, 0>, <8, 8>, <16, 16> ------------------------

def tt_chains_model(a, b, pad):
    """``tt_chains``' order (the first design's) in fp32 for one chain <A, B>
    of stacked TT rows a (N, ra, D, ra), b (N, rb, D, rb) -> S[0][0]: from
    e_00 through every mode, entry (c, e) the FMA chain over the slices i
    and, inside, the ranks x of A[x][i][c] u, u the FMA chain of S[x][y]
    B[y][i][e] over y, every rank padded with zeros to ``pad`` (its
    register tile's bound)."""
    n_modes, ra, d, _ = a.shape
    rb = b.shape[1]
    ap = np.zeros((n_modes, pad, d, pad), np.float32)
    bp = np.zeros((n_modes, pad, d, pad), np.float32)
    ap[:, :ra, :, :ra] = a
    bp[:, :rb, :, :rb] = b
    s = np.zeros((pad, pad), np.float32)
    s[0, 0] = 1
    for n in range(n_modes):
        acc = np.zeros((pad, pad), np.float32)
        for i in range(d):
            for x in range(pad):
                u = np.zeros(pad, np.float32)
                for y in range(pad):
                    u = _fma(s[x, y], bp[n, y, i], u)
                acc = _fma(ap[n, x, i][:, None], u[None, :], acc)
        s = acc
    return s[0, 0]


def tt_chain_model(a, b):
    """``tt_chain``'s order in fp32 -> S[0][0]: mode 1 the FMA chain of
    A[0][i][c] B[0][i][e] over the slices; a middle mode per slice T[x][e]
    the chain of S[x][y] B[y][i][e] over y < rb, then the state the chain
    of A[x][i][c] T[x][e] over x < ra, slice after slice; the last mode
    T_i[x][0] alike and S'[0][0] one chain over the slices and, inside,
    x."""
    n_modes, ra, d, _ = a.shape
    rb = b.shape[1]
    s = np.zeros((ra, rb), np.float32)
    for i in range(d):
        s = _fma(a[0, 0, i][:, None], b[0, 0, i][None, :], s)
    if n_modes == 1:
        return s[0, 0]
    for n in range(1, n_modes):
        if n == n_modes - 1:
            r = np.float32(0)
            for i in range(d):
                t = np.zeros(ra, np.float32)
                for y in range(rb):
                    t = _fma(s[:, y], b[n, y, i, 0], t)
                for x in range(ra):
                    r = _fma(a[n, x, i, 0], t[x], r)
            return r
        acc = np.zeros((ra, rb), np.float32)
        for i in range(d):
            t = np.zeros((ra, rb), np.float32)
            for y in range(rb):
                t = _fma(s[:, y][:, None], b[n, y, i][None, :], t)
            for x in range(ra):
                acc = _fma(a[n, x, i][:, None], t[x][None, :], acc)
        s = acc


def cp_tt_chain_model(a, g, mode1_direct=False):
    """``cp_tt_chain``'s order (the first design's) in fp32, or with
    ``mode1_direct`` ``cp_tt_rows``' (mode 1's u taken as G[0][i][e]):
    a (N, D, RA) a stacked CP row, g (N, RG, D, RG) a stacked TT row ->
    <A, G>: from S = ones(RA, 1), per mode entry (q, e) the FMA chain over
    the slices of A[i][q] u, u the chain of S[q][x] G[x][i][e] over x; then
    S[q][0] added in q order from +0."""
    n_modes, d, ra = a.shape
    rg = g.shape[1]
    s = np.zeros((ra, rg), np.float32)
    s[:, 0] = 1
    for n in range(n_modes):
        acc = np.zeros((ra, rg), np.float32)
        for i in range(d):
            if n == 0 and mode1_direct:
                u = np.broadcast_to(g[0, 0, i], (ra, rg))
            else:
                u = np.zeros((ra, rg), np.float32)
                for x in range(rg):
                    u = _fma(s[:, x][:, None], g[n, x, i][None, :], u)
            acc = _fma(a[n, i][:, None], u, acc)
        s = acc
    v = np.float32(0)
    for q in range(ra):
        v = np.float32(v + s[q, 0])
    return v


def _bits(v):
    return np.float32(v).view(np.int32)


# (mode dims, the query's TT ranks, the row's): [tt8 x tt8], [tt16 x tt8],
# ragged ranks, four modes at rank 16, one mode, a rank-4 row (past
# ``TT_PAIR_ROW`` it goes to <16, QR>)
TT_WIDE_PAIRS = [((12, 12, 12), (1, 8, 8, 1), (1, 8, 8, 1)),
                 ((12, 12, 12), (1, 16, 16, 1), (1, 8, 8, 1)),
                 ((6, 5, 7), (1, 5, 7, 1), (1, 6, 5, 1)),
                 ((4, 3, 5, 2), (1, 16, 16, 5, 1), (1, 9, 16, 12, 1)),
                 ((9,), (1, 1), (1, 1)),
                 ((13, 3), (1, 6, 1), (1, 4, 1))]


@pytest.mark.parametrize("shape", TT_WIDE_PAIRS, ids=str)
def test_tt_chain_order_equals_tt_chains(shape):
    """``tt_chain``'s order (T_i once per slice, mode 1 and the last mode
    cut to the terms they need, no padded ranks) gives ``tt_chains``' value
    bit for bit, for qy (query x row) and yy (row x row) at rank bounds 8
    and 16, and holds against the reference's ``inner_tt_tt`` and float64
    within 2 n u S (n the TT format's ``inner_length``, S the chain over
    absolute values)."""
    dims, qranks, ranks = shape
    rng = np.random.default_rng(31)
    qc, yc = _tt_cores(rng, dims, qranks), _tt_cores(rng, dims, ranks)
    q, y = _stack_tt(qc, dims), _stack_tt(yc, dims)
    pad = fq.tt_tile(max(max(qranks), max(ranks)))
    for xc, xs in ((qc, q), (yc, y)):
        got = tt_chain_model(xs, y)
        assert _bits(got) == _bits(tt_chains_model(xs, y, pad))
        ref = float(ref_contractions.inner_tt_tt(_ref_tt(xc), _ref_tt(yc)))
        exact = float((_tt_dense64(xc) * _tt_dense64(yc)).sum())
        s = float((_tt_dense64([np.abs(c) for c in xc])
                   * _tt_dense64([np.abs(c) for c in yc])).sum())
        x = TTTensor(tuple(torch.from_numpy(c) for c in xc), 1.0)
        bound = 2 * x.inner_length(max(ranks)) * parity.U * s
        assert abs(float(got) - ref) <= bound, (got, ref, bound)
        assert abs(float(got) - exact) <= bound / 2, (got, exact)


@pytest.mark.parametrize("shape,rank", [
    (((12, 12, 12), (1, 8, 8, 1)), 4), (((6, 5, 7), (1, 6, 7, 1)), 3),
    (((4, 3, 5, 2), (1, 9, 16, 12, 1)), 5), (((12, 12, 12), (1, 4, 4, 1)), 9)],
    ids=str)
def test_cp_tt_rows_order_equals_cp_tt_chain(shape, rank):
    """``<16, 0>``'s qy (``cp_tt_rows``: mode 1 from G[0][i][e] itself, the
    state in registers) gives the first design's ``cp_tt_chain`` value bit
    for bit at row ranks 4, ragged, 8 and 16 and CP ranks up to 9 (chunks of
    32 / E lanes), and holds against the reference's ``inner_cp_tt`` and
    float64 within 2 n u S (n = ``parity.cross_length``)."""
    dims, ranks = shape
    rng = np.random.default_rng(32)
    cores = _tt_cores(rng, dims, ranks)
    factors = [rng.standard_normal((dn, rank)).astype(np.float32)
               for dn in dims]
    a = np.zeros((len(dims), max(dims), rank), np.float32)
    for n, f in enumerate(factors):
        a[n, :f.shape[0]] = f
    g = _stack_tt(cores, dims)
    got = cp_tt_chain_model(a, g, mode1_direct=True)
    assert _bits(got) == _bits(cp_tt_chain_model(a, g))
    ref = float(ref_contractions.inner_cp_tt(
        RefCP(tuple(jnp.asarray(f) for f in factors)), _ref_tt(cores)))
    exact = float((_dense(factors) * _tt_dense64(cores)).sum())
    s = float(_dense([np.abs(f) for f in factors]).ravel()
              @ _tt_dense64([np.abs(c) for c in cores]).ravel())
    x = CPTensor(tuple(torch.from_numpy(f) for f in factors), 1.0)
    y = TTTensor(tuple(torch.from_numpy(c) for c in cores), 1.0)
    bound = 2 * parity.cross_length(x, y) * parity.U * s
    assert abs(float(got) - ref) <= bound, (got, ref, bound)
    assert abs(float(got) - exact) <= bound / 2, (got, exact)


def test_tt_wide_plans_at_the_cells():
    """CP and TT queries over TT rows of ranks 5-16 (``<16, 0>``, ``<8,
    8>``, ``<16, 16>``): 8 warps, 2 blocks a SM, a row a warp through a ring
    slot (``TT_RING``, whole float4s of at most ``TT_RING_ROW`` floats)
    where it fits beside the query and the chain tiles, else read in place.
    At [tt8] (rank-8 rows of 2,304 floats, L = 10, cap 36): [mixed cp x
    tt8] 89,620 bytes and [tt8 x tt8] 102,356, each with 73,792 bytes of
    ring slots and a 512-slot window; [tt16 x tt8] (a rank-16 query of
    9,216 floats, two rank-16 tile pairs and two slice buffers a warp)
    reads its rows in place, 93,076 bytes; [limits] (rank 16 over (8, 8,
    8, 8), L = 8, a cap of 1,000) keeps two blocks a SM beside a 2,048-slot
    window."""
    assert set(fq.TT_RING) == {(16, fq.DENSE), (16, 0), (8, 8), (16, 16)}
    for inst in ((16, 0), (8, 8), (16, 16)):
        assert fq.SHAPES[inst] == (256, 2, 1, 2)
    assert [fq.tt_tile(r) for r in (1, 4, 5, 8, 9, 16)] == [8] * 4 + [16] * 2
    for ql, rq, rc, dims, tables, cap, inst, ring, window, want in (
            ("cp", 4, 8, (12, 12, 12), 10, 36, (16, 0), True, 512, 89_620),
            ("tt", 8, 8, (12, 12, 12), 10, 36, (8, 8), True, 512, 102_356),
            ("tt", 16, 8, (12, 12, 12), 10, 36, (16, 16), False, 512,
             93_076),
            ("tt", 16, 16, (8, 8, 8, 8), 8, 1000, (16, 16), False, 2048,
             107_380)):
        n, d = len(dims), max(dims)
        kw = dict(tt=True, q_layout=ql, df=0 if ql == "tt" else 1728)
        assert fq.instance("tt", ql, rq, rc, n, d) == inst
        assert fq.slot_plan("tt", ql, tables, cap, n, d, rq, rc,
                            df=kw["df"]) == ring
        assert fq.window_plan(tables, cap, n, d, rq, rc, ring=ring,
                              **kw)[0] == window
        smem = fq.smem_bytes(tables, n, d, rq, rc, window, ring=ring, **kw)
        assert smem == want and _blocks(smem) >= 2, (ql, rq, smem)
        if ring:
            assert smem - fq.smem_bytes(tables, n, d, rq, rc, window,
                                        **kw) == 8 * 2306 * 4
