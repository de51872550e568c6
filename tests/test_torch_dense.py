"""Port parity: dense inputs and the naive kinds (``e2lsh``, ``srp``) on the
hash side, against the reference.

Inputs are made with numpy from a seed; sampled parameters are carried from
the reference with ``convert.family_from_numpy`` (the naive kinds'
(L*K, prod d) matrix, CP factors, TT cores). Tolerances are the fp32
rounding bounds of ``kernels.parity``: a dot of n products evaluated in two
orders differs by at most 2 n 2^-24 times the same dot over absolute
values (``parity.dense_bound`` for the dense raw values, n = prod d; the
mode-by-mode contractions carry n = prod d * R + N). Codes, keys and packed
words are held bitwise except where the raw value lies within that bound
of a bucket edge (E2LSH) or of 0 (SRP).

* ``inner_dense_cp`` / ``inner_dense_tt`` and ``inner``'s dense pairs;
* ``sample_dense_projection`` by its distribution;
* the materialized CP and TT stacks, and ``project_batch`` for every new
  pair (CP / TT on dense inputs, the dense projection on dense, CP and TT
  inputs) on both sides of ``MATERIALIZE_LIMIT`` (the chain below it);
* ``hash_batch`` / ``hash_keys`` / ``hash_packed_batch`` of carried
  families;
* ``storage_size`` and ``naive_storage_size`` equal to the reference's.
"""

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grids
import torch_bridge as tb
from repro.core import contractions as jcon
from repro.core import lsh as jlsh
from repro.core import projections as jproj
from repro_torch.core import contractions as tcon
from repro_torch.core import lsh as tlsh
from repro_torch.core import projections as tproj
from repro_torch.core.tensor_formats import DenseTensor, as_batch
from repro_torch.kernels import parity

U = 2.0 ** -24
DIMS = tb.DIMS               # (4, 4, 4)
NAIVE = ("e2lsh", "srp")
DENSE_PAIRS = ("e2lsh", "srp", "cp-e2lsh", "tt-srp")


def _dense(n, seed, dims=DIMS):
    return np.random.default_rng(seed).normal(size=(n,) + dims).astype(
        np.float32)


@pytest.mark.parametrize("fmt", ["cp", "tt"])
def test_inner_dense_cp_tt_against_reference(fmt):
    """<dense, CP> / <dense, TT> (and ``inner`` in either order, on a plain
    tensor or a DenseTensor) within 2 (D R + N) u sum |x| |P| of the
    reference's."""
    x = _dense(1, 0, (5, 6, 7))[0]
    corpus, _ = (tb.cp_fixture if fmt == "cp" else tb.tt_fixture)(
        1, 1, seed=3, dims=(5, 6, 7))
    one = [a[0] for a in corpus]
    jy = (jnp.asarray(x), (tb.jax_cp if fmt == "cp" else tb.jax_tt)(one))
    ty = (tb.torch_cp(one) if fmt == "cp" else tb.torch_tt(one))
    ref = float((jcon.inner_dense_cp if fmt == "cp"
                 else jcon.inner_dense_tt)(*jy))
    fn = tcon.inner_dense_cp if fmt == "cp" else tcon.inner_dense_tt
    tx = torch.from_numpy(x)
    got = float(fn(tx, ty))
    s = float(fn(tx.abs(), ty.abs()))
    tol = 2.0 * (x.size * 3 + 3) * U * s
    assert abs(got - ref) <= tol
    for a, b in ((tx, ty), (ty, tx), (DenseTensor(tx, x.shape), ty)):
        assert abs(float(tcon.inner(a, b)) - ref) <= tol
    assert float(tcon.inner(tx, tx)) == pytest.approx(float((x * x).sum()),
                                                      rel=1e-5)


def test_sample_dense_projection_distribution():
    """N(0, 1) entries in a (K, prod d) matrix: mean and variance within
    five standard errors of 0 and 1, scale 1 (1/sqrt(K) normalized)."""
    gen = torch.Generator().manual_seed(0)
    p = tproj.sample_dense_projection(gen, 200, (6, 7, 8))
    assert p.matrix.shape == (200, 336) and p.dims == (6, 7, 8)
    assert p.scale == 1.0 and p.num_hashes == 200
    m = p.matrix.double()
    n = m.numel()
    assert abs(float(m.mean())) < 5 / n ** 0.5
    assert abs(float(m.var()) - 1.0) < 5 * (2 / n) ** 0.5
    q = tproj.sample_dense_projection(gen, 16, (3, 3), normalize=True)
    assert q.scale == pytest.approx(0.25)
    assert p.storage_size() == 200 * 336


def _carried(kind, dims=DIMS, rank=2, num_tables=4):
    fam = grids.grid_family(kind, dims=dims, num_tables=num_tables,
                            rank=rank, hash_backend="xla")
    return fam, tb.bridge_family(fam)


@pytest.mark.parametrize("kind", ["cp-e2lsh", "tt-srp"])
def test_materialized_stack_against_reference(kind):
    """(K, prod d) densified projections, scale applied: within 2 (N + R)
    u times the same stack over |factors| / |cores| of the reference's;
    cached once per projection."""
    fam, tfam = _carried(kind, dims=(3, 4, 5), rank=3)
    mat = (jproj._materialize_cp if kind.startswith("cp")
           else jproj._materialize_tt)
    ref = np.asarray(mat(fam.projection)).reshape(fam.projection.num_hashes,
                                                  -1)
    p = tfam.projection
    got = p.materialized
    assert got is p.materialized                     # cached
    s = p.with_leaves(a.abs() for a in p.leaves).materialized.abs().numpy()
    tol = 2.0 * (3 + 3 * 3) * U * s
    assert (np.abs(got.numpy() - ref) <= tol).all()


def _pair_bound(tfam, x):
    """(B, K) bound of two fp32 evaluations of the dense pairs' raw values:
    2 (D R + N + 2) u sum |x| |P| (densified over absolute leaves)."""
    p = tfam.projection
    ap = p.with_leaves(a.abs() for a in p.leaves)
    if p.layout == "dense":
        m = ap.matrix
    else:
        m = (tproj._materialize_cp if p.layout == "cp"
             else tproj._materialize_tt)(ap)
    n = m.shape[1] * p.rank + len(p.dims) + 2
    return 2.0 * n * U * (x.abs().double() @ m.abs().double().T).float()


@pytest.mark.parametrize("limit", ["materialized", "chain"])
@pytest.mark.parametrize("kind", ["cp-e2lsh", "tt-srp"])
def test_project_batch_on_dense_inputs(monkeypatch, kind, limit):
    """CP / TT projections on dense inputs, materialized and (with the
    limit below the stack's size, in both packages) the mode-by-mode
    chain: (B, K) values within ``_pair_bound`` of the reference's."""
    if limit == "chain":
        monkeypatch.setattr(jproj, "MATERIALIZE_LIMIT", 8)
        monkeypatch.setattr(tproj, "MATERIALIZE_LIMIT", 8)
    fam, tfam = _carried(kind, dims=(3, 4, 5), rank=3)
    assert (tfam.projection.materialized is None) == (limit == "chain")
    x = _dense(37, 5, (3, 4, 5))
    ref = np.asarray(jproj.project_batch(fam.projection, jnp.asarray(x)))
    got = tproj.project_batch(tfam.projection, as_batch(torch.from_numpy(x)))
    tol = _pair_bound(tfam, torch.from_numpy(x.reshape(37, -1)))
    k = fam.num_codes * fam.num_tables
    assert got.shape == (37, k)
    assert (np.abs(got.numpy() - ref) <= tol.numpy()).all()
    assert tproj.chunk_rows(tfam.projection) == (
        tproj.MATMUL_ROWS if limit == "materialized" else
        max(1, min(tproj.MATMUL_ROWS, tproj.CHAIN_FLOATS // (k * 3 * 20))))


@pytest.mark.parametrize("fmt", ["dense", "cp", "tt"])
@pytest.mark.parametrize("kind", NAIVE)
def test_dense_projection_on_any_input(kind, fmt):
    """The naive kinds' matrix on dense, CP and TT batches (densified):
    within ``parity.dense_bound`` (plus the densification's own rounding)
    of the reference's ``project_batch``."""
    fam, tfam = _carried(kind)
    if fmt == "dense":
        x = _dense(29, 6)
        jx, tx, flat = jnp.asarray(x), as_batch(torch.from_numpy(x)), x
    else:
        fixture, jwrap, twrap = ((tb.cp_fixture, tb.jax_cp, tb.torch_cp)
                                 if fmt == "cp" else
                                 (tb.tt_fixture, tb.jax_tt, tb.torch_tt))
        leaves, _ = fixture(29, 1, seed=6)
        jx, tx = jwrap(leaves), twrap(leaves)
        flat = np.asarray(jproj._densify_batch(jx))
    ref = np.asarray(jproj.project_batch(fam.projection, jx))
    got = tproj.project_batch(tfam.projection, tx)
    x = torch.from_numpy(np.abs(flat).reshape(29, -1))
    tol = parity.dense_bound(x, tfam.projection.matrix) * 2 + 8 * U * (
        x.double() @ tfam.projection.matrix.abs().double().T).float()
    assert (np.abs(got.numpy() - ref) <= tol.numpy()).all()


def test_dense_rows_do_not_depend_on_the_batch():
    """Every dense pair runs over fixed 1,024-row chunks: a row's raw values
    are the same bits alone, inside a batch of 3,000 and at any offset (an
    item queried as itself lands in its own buckets)."""
    gen = torch.Generator().manual_seed(4)
    fam = tlsh.make_family(gen, "e2lsh", (6, 6, 6), num_codes=5,
                           num_tables=3, device="cpu")
    x = torch.randn((3000, 6, 6, 6), generator=gen)
    whole = fam.raw_stacked(as_batch(x).stack()[1], 1.0)
    for s, e in ((0, 1), (1500, 1501), (1023, 2047), (2999, 3000)):
        part = fam.raw_stacked(as_batch(x[s:e]).stack()[1], 1.0)
        assert torch.equal(part, whole[s:e])


@pytest.mark.parametrize("kind", DENSE_PAIRS)
def test_codes_keys_and_words_against_reference(kind):
    """hash_batch / hash_keys / hash_packed_batch of a carried family on a
    dense batch, bitwise but where a raw value lies within the rounding
    bound of a bucket edge (E2LSH) or of 0 (SRP)."""
    fam, tfam = _carried(kind)
    x = _dense(61, 8)
    jx, tx = jnp.asarray(x), as_batch(torch.from_numpy(x))
    mults = jlsh.make_mults(3, fam.num_codes)
    raw = tproj.project_batch(tfam.projection, tx)
    bound = _pair_bound(tfam, torch.from_numpy(np.abs(x).reshape(61, -1)))
    l, k = fam.num_tables, fam.num_codes
    offs = tfam.offsets.reshape(l, k) if tfam.offsets is not None else None
    near = parity.boundary_codes(raw.reshape(61, l, k),
                                 bound.reshape(61, l, k), kind, offs,
                                 tfam.bucket_width).numpy()
    codes = tfam.hash_batch(tx).numpy()
    ref_codes = np.asarray(fam.hash_batch(jx))
    assert ((codes == ref_codes) | near).all()
    keys = tfam.hash_keys(tx, mults).numpy()
    ref_keys = np.asarray(fam.hash_keys(jx, jnp.asarray(mults)))
    assert ((keys == ref_keys.astype(np.int64)) | near.any(-1)).all()
    assert near.mean() < 0.05
    if kind.endswith("srp"):
        words = tfam.hash_packed_batch(tx).numpy()
        ref_words = np.asarray(fam.hash_packed_batch(jx)).astype(np.int64)
        assert ((words == ref_words).all(-1) | near.any(-1)).all()
    else:
        with pytest.raises(ValueError, match="SRP"):
            tfam.hash_packed_batch(tx)


def test_naive_kinds_hash_cp_and_tt_inputs():
    """The naive e2lsh over a CP and a TT batch: codes of the densified
    rows, the same as hashing those rows as a dense batch (the densify is
    exact up to its own rounding, so codes agree away from edges); and a
    TT family hashes the CP batch (the TT projection on CP inputs) to the
    reference's codes."""
    fam, tfam = _carried("e2lsh")
    leaves, _ = tb.cp_fixture(40, 1, seed=9)
    cp = tb.torch_cp(leaves)
    ref = np.asarray(fam.hash_batch(tb.jax_cp(leaves)))
    got = tfam.hash_batch(cp).numpy()
    assert (got == ref).mean() > 0.99
    flat = tproj.densify_batch(cp)
    dense = tfam.hash_batch(as_batch(flat.reshape((40,) + DIMS)))
    assert (dense.numpy() == got).mean() > 0.99
    tt_fam, tt_tfam = _carried("tt-srp")             # CP under TT
    assert (tt_tfam.hash_batch(cp).numpy()
            == np.asarray(tt_fam.hash_batch(tb.jax_cp(leaves)))).mean() > 0.99


@pytest.mark.parametrize("kind", ("e2lsh", "srp", "cp-e2lsh", "tt-srp",
                                  "cp-srp", "tt-e2lsh"))
def test_storage_sizes_equal_the_reference(kind):
    fam, tfam = _carried(kind, dims=(3, 4, 5), rank=3)
    assert tfam.storage_size() == fam.storage_size()
    assert tlsh.naive_storage_size((3, 4, 5), 3, 4) == \
        jlsh.naive_storage_size((3, 4, 5), 3, 4)
    assert tlsh.naive_storage_size((12, 12, 12), 10, 10) == 172800
