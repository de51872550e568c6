"""Port parity: the single-item and storage API and ``core.theory``.

* ``storage_size`` of CP and TT tensors equal the reference's on the same
  arrays; the projections' ``single(k)`` equal the reference's k-th tensor
  bit for bit; ``cp_gaussian``, the port's own sampler, by its moments.
* ``projections.project`` and ``LSHFamily.raw_projections`` against the
  reference's on carried-over families (``torch_bridge.bridge_family``)
  within ``parity.family_raw_bound``; ``hash(x)`` and ``hash_packed(x)``
  against the reference's, boundary-aware (codes may differ only within
  that bound of a bucket edge or of 0), and against the port's own
  ``hash_batch`` row.
* ``theory``'s four functions against the reference's to 1e-6; the
  storage identities of Tables 1-2 (the reference's
  ``TestSpaceComplexity``); the port's empirical collision rates against
  the port's ``theory`` within the reference's bound 5 se + 0.015
  (``TestCollisionProbabilities``), at M = 1,500 codes.

The reference hashes through XLA here (``hash_backend="xla"``): no Pallas
compilation.
"""

import math

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grids
import torch_bridge as tb
from repro.core import make_family as jax_make_family
from repro.core import projections as jproj
from repro.core import tensor_formats as jtf
from repro.core import theory as jtheory
from repro_torch.core import projections as tproj
from repro_torch.core import tensor_formats as ttf
from repro_torch.core import theory
from repro_torch.core.lsh import make_family, naive_storage_size, pack_bits
from repro_torch.kernels import parity

KINDS = ("cp-e2lsh", "cp-srp", "tt-e2lsh", "tt-srp", "e2lsh", "srp")


def _inputs(layout, n=3, seed=3):
    """n items of ``grids.DIMS`` in ``layout`` as (reference batch, port
    batch), the same numpy arrays."""
    if layout == "cp":
        f, _ = tb.cp_fixture(n, 1, seed=seed)
        return tb.jax_cp(f), tb.torch_cp(f)
    if layout == "tt":
        c, _ = tb.tt_fixture(n, 1, seed=seed)
        return tb.jax_tt(c), tb.torch_tt(c)
    a = np.random.default_rng(seed).normal(size=(n,) + tb.DIMS)
    a = a.astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _item(x, i):
    """Item i of a batch (either package's format, or a plain array)."""
    if hasattr(x, "factors"):
        return type(x)(tuple(f[i] for f in x.factors), x.scale)
    if hasattr(x, "cores"):
        return type(x)(tuple(c[i] for c in x.cores), x.scale)
    return x[i]


@pytest.fixture(scope="module", params=KINDS)
def family(request):
    kind = request.param
    k, w = tb.grid_params(kind)
    if kind.endswith("srp"):
        k = 40                       # two packed words a table
    fam = jax_make_family(tb.jax_key(11), kind, tb.DIMS, num_codes=k,
                          num_tables=3, rank=2, bucket_width=w,
                          hash_backend="xla")
    return kind, fam, tb.bridge_family(fam)


@pytest.mark.parametrize("layout", ["cp", "tt"])
def test_storage_size_matches_reference(layout):
    jx, tx = _inputs(layout, n=4)
    assert tx.storage_size() == jx.storage_size()
    one_j, one_t = _item(jx, 0), tx.index(0)
    assert one_t.storage_size() == one_j.storage_size()
    r = tx.rank
    expect = (sum(d * r for d in tx.dims) if layout == "cp"
              else sum(a * d * b for a, d, b in zip(tx.ranks, tx.dims,
                                                     tx.ranks[1:])))
    assert one_t.storage_size() == expect


@pytest.mark.parametrize("kind", ["cp-e2lsh", "tt-srp"])
def test_single_matches_reference(kind):
    fam = jax_make_family(tb.jax_key(5), kind, tb.DIMS, num_codes=4,
                          num_tables=2, rank=3, hash_backend="xla")
    tfam = tb.bridge_family(fam)
    for k in (0, 3, 7):
        ref = fam.projection.single(k)
        got = tfam.projection.single(k)
        assert type(got).__name__ == type(ref).__name__
        assert got.scale == pytest.approx(ref.scale, rel=1e-12)
        for a, b in zip(got.leaves, tb.leaves_of(ref)):
            np.testing.assert_array_equal(a.numpy(), b)
        assert got.storage_size() == ref.storage_size()


def test_cp_gaussian_moments():
    """The port's CP_N(R) sampler: N(0, 1) factor entries (mean and
    variance within five standard errors over 24,000 draws), scale
    1/sqrt(R), shapes as the reference's."""
    gen = torch.Generator().manual_seed(0)
    dims, r = (5, 6, 4), 4
    x = ttf.cp_gaussian(gen, dims, r, batch=400)
    ref = jtf.cp_gaussian(tb.jax_key(0), dims, r)
    assert x.scale == pytest.approx(ref.scale)
    assert x.index(0).dims == ref.dims and x.rank == ref.rank
    v = torch.cat([f.reshape(-1) for f in x.factors]).double()
    n = v.numel()
    assert abs(float(v.mean())) < 5 / math.sqrt(n)
    assert abs(float(v.var()) - 1.0) < 5 * math.sqrt(2 / n)
    one = ttf.cp_gaussian(gen, dims, r)
    assert tuple(f.shape for f in one.factors) == tuple(
        f.shape for f in ref.factors)


@pytest.mark.parametrize("layout", ["cp", "tt", "dense"])
def test_project_and_raw_projections_match_reference(family, layout):
    kind, fam, tfam = family
    jx, tx = _inputs(layout)
    bound = parity.family_raw_bound(tfam, ttf.as_batch(tx)).numpy()
    batch = tproj.project_batch(tfam.projection, ttf.as_batch(tx)).numpy()
    for i in range(2):
        ref = np.asarray(jproj.project(fam.projection, _item(jx, i)))
        got = tproj.project(tfam.projection, _item(tx, i)).numpy()
        raw = tfam.raw_projections(_item(tx, i)).numpy()
        np.testing.assert_array_equal(raw, got)
        assert (np.abs(got - ref) <= bound[i]).all()
        assert (np.abs(got - batch[i]) <= bound[i]).all()


def _near(kind, tfam, values, bound):
    """(L, K) codes another fp32 rounding of ``values`` could flip."""
    l, k = tfam.num_tables, tfam.num_codes
    offs = None if tfam.offsets is None else tfam.offsets.reshape(l, k)
    return parity.boundary_codes(values.reshape(1, l, k),
                                 bound.reshape(1, l, k), kind, offs,
                                 tfam.bucket_width)[0].numpy()


@pytest.mark.parametrize("layout", ["cp", "tt", "dense"])
def test_hash_matches_reference_boundary_aware(family, layout):
    kind, fam, tfam = family
    jx, tx = _inputs(layout)
    tb_x = ttf.as_batch(tx)
    bound = parity.family_raw_bound(tfam, tb_x)
    rows = tfam.hash_batch(tb_x).numpy()
    for i in range(tb_x.leaves[0].shape[0]):
        ref = np.asarray(fam.hash(_item(jx, i)))
        got = tfam.hash(_item(tx, i))
        assert got.shape == (3, tfam.num_codes) and got.dtype == torch.int32
        near = _near(kind, tfam, tfam.raw_projections(_item(tx, i)),
                     bound[i])
        assert ((got.numpy() == ref) | near).all()
        np.testing.assert_array_equal(got.numpy(), rows[i])
        if kind.endswith("srp"):
            packed = tfam.hash_packed(_item(tx, i))
            np.testing.assert_array_equal(packed.numpy(),
                                          pack_bits(got[None])[0].numpy())
            ref_words = np.asarray(fam.hash_packed(_item(jx, i)))
            far = ~near.reshape(3, -1).any(-1)
            np.testing.assert_array_equal(packed.numpy()[far],
                                          ref_words.astype(np.int64)[far])


def test_hash_packed_refuses_e2lsh():
    fam = make_family(torch.Generator().manual_seed(0), "cp-e2lsh", tb.DIMS,
                      device="cpu")
    x = ttf.cp_random_data(torch.Generator().manual_seed(1), tb.DIMS, 2)
    with pytest.raises(ValueError, match="SRP"):
        fam.hash_packed(x)


def test_theory_matches_reference():
    r = np.array([0.05, 0.3, 1.0, 2.5, 4.0, 8.0, 40.0], np.float32)
    for w in (1.0, 4.0, 6.0):
        got = theory.e2lsh_collision_prob(torch.from_numpy(r), w).numpy()
        ref = np.asarray(jtheory.e2lsh_collision_prob(jnp.asarray(r), w))
        np.testing.assert_allclose(got, ref, atol=1e-6)
        assert float(theory.e2lsh_collision_prob(2.0, w)) == pytest.approx(
            float(jtheory.e2lsh_collision_prob(2.0, w)), abs=1e-6)
    c = np.linspace(-1.3, 1.3, 27).astype(np.float32)
    np.testing.assert_allclose(
        theory.srp_collision_prob(torch.from_numpy(c)).numpy(),
        np.asarray(jtheory.srp_collision_prob(jnp.asarray(c))), atol=1e-6)
    for n in (2, 3, 4, 6):
        for d in (4, 16, 64):
            for rank in (1, 3, 8):
                for name in ("cp_rank_condition", "tt_rank_condition"):
                    assert getattr(theory, name)(n, d, rank) == \
                        pytest.approx(getattr(jtheory, name)(n, d, rank),
                                      rel=1e-6, abs=1e-6)


def test_table_1_and_2_storage():
    """The reference's TestSpaceComplexity on the port's families."""
    gen = torch.Generator().manual_seed(0)
    n, d, r, k = 4, 10, 3, 16
    dims = (d,) * n
    cp_e2 = make_family(gen, "cp-e2lsh", dims, num_codes=k, rank=r,
                        device="cpu")
    tt_e2 = make_family(gen, "tt-e2lsh", dims, num_codes=k, rank=r,
                        device="cpu")
    naive = make_family(gen, "e2lsh", dims, num_codes=k, device="cpu")
    assert cp_e2.storage_size() == k * n * d * r
    assert tt_e2.storage_size() == k * (2 * d * r + (n - 2) * d * r * r)
    assert naive.storage_size() == k * d ** n
    assert naive_storage_size(dims, k, 1) == k * d ** n
    assert cp_e2.storage_size() < tt_e2.storage_size() < \
        naive.storage_size()
    for kind in ("cp-srp", "tt-srp", "srp"):
        fam = make_family(gen, kind, dims, num_codes=k, rank=r,
                          device="cpu")
        twin = {"cp-srp": cp_e2, "tt-srp": tt_e2, "srp": naive}[kind]
        assert fam.storage_size() == twin.storage_size()


M = 1500
COLLISION_DIMS = (4, 5, 6)


def _limit(p):
    return 5 * math.sqrt(max(p * (1 - p), 1e-4) / M) + 0.015


@pytest.mark.parametrize("kind", ["cp-e2lsh", "tt-e2lsh", "e2lsh"])
def test_e2lsh_collision_matches_theory(kind):
    """The reference's collision test on the port: M codes of one table,
    dense x and y at distance r, against ``theory.e2lsh_collision_prob``."""
    gen = torch.Generator().manual_seed(7)
    w = 4.0
    x = torch.randn(COLLISION_DIMS, generator=gen)
    noise = torch.randn(COLLISION_DIMS, generator=gen)
    fam = make_family(gen, kind, COLLISION_DIMS, num_codes=M, num_tables=1,
                      rank=2, bucket_width=w, device="cpu")
    cx = fam.hash(x).reshape(-1)
    for r in (1.0, 3.0, 6.0):
        y = x + noise * (r / noise.norm())
        emp = float((cx == fam.hash(y).reshape(-1)).float().mean())
        want = float(theory.e2lsh_collision_prob(r, w))
        assert abs(emp - want) < _limit(want), (kind, r, emp, want)


@pytest.mark.parametrize("kind", ["cp-srp", "tt-srp", "srp"])
def test_srp_collision_matches_theory(kind):
    gen = torch.Generator().manual_seed(9)
    x = torch.randn(COLLISION_DIMS, generator=gen)
    noise = torch.randn(COLLISION_DIMS, generator=gen)
    fam = make_family(gen, kind, COLLISION_DIMS, num_codes=M, num_tables=1,
                      rank=2, device="cpu")
    cx = fam.hash(x).reshape(-1)
    for mix in (0.1, 0.5, 1.5):
        y = x + mix * noise
        cos = float((x * y).sum() / (x.norm() * y.norm()))
        emp = float((cx == fam.hash(y).reshape(-1)).float().mean())
        want = float(theory.srp_collision_prob(cos))
        assert abs(emp - want) < _limit(want), (kind, mix, emp, want)
