"""Port parity: TT formats and contractions against the reference.

The port's ``inner_tt_tt``, ``norm``, ``distance`` and ``cosine_similarity``
of TT pairs against ``repro.core.contractions`` on the same numpy cores
(rtol 1e-5: both sides sum a few hundred fp32 products in different orders,
a rounding error of order 1e-6 relative at these sizes, and the inputs keep
clear of cancellation); ``inner_tt_tt`` against the dense inner product of
``tt_to_dense``; ``tt_to_dense`` against the reference's. The generator
samplers are checked by distribution (the RNGs are never the same), and the
stacked TT layout by its zero padding and its views.
"""

import math

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import numpy as np
import pytest
import torch

import torch_bridge as tb
from repro.core import contractions as jcon
from repro.core import tensor_formats as jtf
from repro.kernels import ops as jops
from repro_torch.core import contractions as tcon
from repro_torch.core import tensor_formats as ttf
from repro_torch.kernels import ops as tops

RTOL = 1e-5


def _cores(rng, dims, rank):
    n = len(dims)
    return [rng.normal(size=(1 if i == 0 else rank, d,
                             1 if i == n - 1 else rank)).astype(np.float32)
            for i, d in enumerate(dims)]


def _pair(seed, dims=(3, 4, 5), rx=2, ry=3):
    rng = np.random.default_rng(seed)
    return _cores(rng, dims, rx), _cores(rng, dims, ry)


@pytest.mark.parametrize("fn", ["inner", "distance", "cosine_similarity",
                                "norm"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tt_contractions_match_reference(fn, seed):
    x, y = _pair(seed)
    jx, jy = tb.jax_tt(x, 0.5), tb.jax_tt(y, 1.5)
    tx, ty = tb.torch_tt(x, 0.5), tb.torch_tt(y, 1.5)
    if fn == "norm":
        ref, got = jcon.norm(jx), tcon.norm(tx)
    else:
        ref, got = getattr(jcon, fn)(jx, jy), getattr(tcon, fn)(tx, ty)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL)


@pytest.mark.parametrize("dims,rx,ry", [((3, 4, 5), 2, 3), ((6, 6), 4, 1),
                                        ((2, 3, 2, 3), 3, 3)])
def test_inner_tt_tt_matches_dense_oracle(dims, rx, ry):
    rng = np.random.default_rng(3)
    x, y = _cores(rng, dims, rx), _cores(rng, dims, ry)
    tx, ty = tb.torch_tt(x, 0.7), tb.torch_tt(y)
    dense = tcon.inner_dense_dense(ttf.tt_to_dense(tx), ttf.tt_to_dense(ty))
    np.testing.assert_allclose(tcon.inner_tt_tt(tx, ty).numpy(),
                               dense.numpy(), rtol=RTOL)
    ref = jtf.tt_to_dense(tb.jax_tt(x, 0.7))
    np.testing.assert_allclose(ttf.tt_to_dense(tx).numpy(), np.asarray(ref),
                               rtol=RTOL, atol=1e-6)


def test_tt_chain_broadcasts_over_leading_axes():
    """One chain serves a batch of pairs and a (queries x items) matrix."""
    corpus, queries = tb.tt_fixture(7, 3, seed=4)
    q, c = tb.torch_tt(queries), tb.torch_tt(corpus)
    mat = tcon.tt_chain([g[:, None] for g in q.cores],
                        [g[None] for g in c.cores])
    assert mat.shape == (3, 7)
    for i in range(3):
        for j in range(7):
            want = tcon.inner_tt_tt(q.index(i), c.index(j))
            np.testing.assert_allclose(mat[i, j].numpy(), want.numpy(),
                                       rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("fmt", ["cp", "tt"])
def test_format_interface(fmt):
    """Each format class answers for its format: ``pair_inners`` over
    broadcast leading axes equals the pairwise ``inner``, ``self_inners``
    the diagonal, ``row_floats`` one item's leaves, ``abs`` and ``stack``
    keep the leaves' values, and ``layout`` names the kernels' layout."""
    rng = np.random.default_rng(5)
    dims = (3, 4, 5)
    if fmt == "tt":
        def batch(n, rank, scale):
            items = [_cores(rng, dims, rank) for _ in range(n)]
            return tb.torch_tt([np.stack(m) for m in zip(*items)], scale)
        q, c = batch(2, 2, 0.5), batch(4, 3, 1.5)
        want_row = sum(t.shape[1] * t.shape[2] * t.shape[3] for t in c.cores)
    else:
        q = tb.torch_cp([rng.normal(size=(2, d, 2)).astype(np.float32)
                         for d in dims], 0.5)
        c = tb.torch_cp([rng.normal(size=(4, d, 3)).astype(np.float32)
                         for d in dims], 1.5)
        want_row = sum(d * 3 for d in dims)
    assert q.layout == c.layout == fmt
    assert c.row_floats == want_row
    mat = q.index((slice(None), None)).pair_inners(c.index((None,)))
    assert mat.shape == (2, 4)
    for i in range(2):
        for j in range(4):
            np.testing.assert_allclose(
                mat[i, j].numpy(), tcon.inner(q.index(i), c.index(j)).numpy(),
                rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(
        c.self_inners().numpy(),
        [float(tcon.inner(c.index(j), c.index(j))) for j in range(4)],
        rtol=RTOL)
    assert all(torch.equal(a, b.abs()) for a, b in zip(c.abs().leaves,
                                                      c.leaves))
    views, stacked = c.stack()
    assert stacked.shape[0] == 4 and stacked.is_contiguous()
    assert all(torch.equal(a, b) for a, b in zip(views.leaves, c.leaves))
    assert c.inner_length(2) == (
        max(dims) + 3 + 9 if fmt == "cp" else 3 * (3 + max(dims) * 3) + 2)


def test_cross_format_pairs_are_queued():
    """The TT x CP pair, once queued, is served: ``inner`` of a TT and a CP
    tensor, either way round, equals the reference's within the rounding
    bound of the chain with an (R^ x r) state."""
    from repro_torch.kernels import parity
    x, _ = _pair(0)
    rng = np.random.default_rng(1)
    f = [rng.normal(size=(d, 2)).astype(np.float32) for d in (3, 4, 5)]
    tt, cp = tb.torch_tt(x, 0.5), tb.torch_cp(f, 2.0)
    want = float(jcon.inner(tb.jax_tt(x, 0.5), tb.jax_cp(f, 2.0)))
    s = float(tcon.inner(tt.abs(), cp.abs()))
    tol = 2 * parity.pair_length(tt, cp) * parity.U * s
    assert abs(float(tcon.inner(tt, cp)) - want) <= tol
    assert abs(float(tcon.inner(cp, tt)) - want) <= tol


def test_tt_rademacher_distribution():
    gen = torch.Generator().manual_seed(0)
    t = ttf.tt_rademacher(gen, (6, 7, 8), rank=5, batch=300)
    assert t.ranks == (1, 5, 5, 1) and t.rank == 5 and t.dims == (6, 7, 8)
    assert [tuple(c.shape) for c in t.cores] == [
        (300, 1, 6, 5), (300, 5, 7, 5), (300, 5, 8, 1)]
    vals = torch.cat([c.reshape(-1) for c in t.cores])
    assert set(torch.unique(vals).tolist()) == {-1.0, 1.0}
    assert abs(float(vals.mean())) < 0.02           # 5e4+ fair signs
    assert t.scale == pytest.approx(1 / math.sqrt(5 ** 2))


def test_tt_gaussian_and_random_data_distributions():
    gen = torch.Generator().manual_seed(1)
    g = ttf.tt_gaussian(gen, (4, 9, 5), rank=3, batch=2000)
    assert float(g.cores[1].std()) == pytest.approx(1.0, rel=0.03)
    assert g.scale == pytest.approx(1 / 3)
    x = ttf.tt_random_data(gen, (4, 9, 5), rank=3, batch=2000)
    assert x.scale == 1.0
    for c, (r, d) in zip(x.cores, ((1, 4), (3, 9), (3, 5))):
        # N(0, 1) / (r d)^(1/4) entries: the sample std within 3%
        assert float(c.std()) == pytest.approx((r * d) ** -0.25, rel=0.03)


def test_tt_tensor_index_and_to():
    corpus, _ = tb.tt_fixture(9, 1, seed=2)
    t = tb.torch_tt(corpus, 2.0)
    sub = t.index(slice(2, 5))
    assert sub.scale == 2.0 and sub.cores[1].shape == (3, 2, 4, 2)
    assert sub.to("cpu").device.type == "cpu"
    assert t.leaves is t.cores


def test_stacked_tt_layout_matches_reference_and_views():
    """``stack_tt``: the boundary ranks and mode dims zero-padded as the
    reference's ``_stack_tt_batch`` pads them (minus its 8-row tile pad),
    and the returned cores are views of the stacked tensor at their true
    ranks."""
    corpus, _ = tb.tt_fixture(11, 1, seed=5)
    views, stacked = tops.stack_tt(tb.torch_tt(corpus))
    assert stacked.shape == (11, 3, 2, 4, 2)
    ref = np.asarray(jops._stack_tt_batch(tb.jax_tt(corpus), 2))[..., :4, :]
    np.testing.assert_array_equal(stacked.numpy(), ref)
    for v, c in zip(views.cores, corpus):
        assert v.shape == c.shape
        assert v.data_ptr() >= stacked.data_ptr()
        np.testing.assert_array_equal(v.numpy(), c)
    assert float(stacked[:, 0, 1:].abs().sum()) == 0.0     # padded rows
    assert float(stacked[:, -1, :, :, 1:].abs().sum()) == 0.0
