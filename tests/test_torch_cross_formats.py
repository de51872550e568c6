"""Port parity: inner products and projections across formats.

``contractions.inner`` and the pair dispatch ``contractions.pair_inners``
over all nine (dense, CP, TT) x (dense, CP, TT) pairs against the
reference's ``contractions.inner``; the CP projection on TT inputs and the
TT projection on CP inputs (``projections.project_batch``) against the
reference's ``project_batch``, values within ``parity.cross_raw_bound``,
and one row's bits alone, in a batch of 3,000 and at any offset; and the
twin of ``tests/test_core_lsh.py``'s format invariance: one tensor hashed
as CP, as TT (the exact ``tensor_formats.cp_to_tt``) and dense by the four
tensorized kinds gives the same codes. Inputs are numpy arrays from a seed;
no Pallas kernel is compiled here.
"""

import functools
import itertools
import math

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_bridge as tb
from repro.core import contractions as jcon
from repro.core import make_family
from repro.core import projections as jproj
from repro.core.tensor_formats import CPTensor as JaxCP
from repro.core.tensor_formats import TTTensor as JaxTT
from repro_torch.core import contractions, projections, tensor_formats
from repro_torch.core.tensor_formats import CPTensor, DenseTensor, TTTensor
from repro_torch.kernels import parity

DIMS = (4, 3, 5)
FORMATS = ("dense", "cp", "tt")


def _leaves(rng, layout, batch=None, rank=3, dims=DIMS):
    lead = () if batch is None else (batch,)
    if layout == "dense":
        return rng.normal(size=lead + dims).astype(np.float32)
    if layout == "cp":
        return [(rng.normal(size=lead + (d, rank)) / np.sqrt(d))
                .astype(np.float32) for d in dims]
    n = len(dims)
    return [(rng.normal(size=lead + (1 if i == 0 else rank, d,
                                     1 if i == n - 1 else rank))
             / np.sqrt(d)).astype(np.float32) for i, d in enumerate(dims)]


SCALES = {"dense": 1.0, "cp": 0.75, "tt": 1.25}


def _port(layout, leaves):
    if layout == "dense":
        a = torch.from_numpy(leaves)
        return DenseTensor(a, tuple(a.shape[a.dim() - len(DIMS):]))
    cls = CPTensor if layout == "cp" else TTTensor
    return cls(tuple(torch.from_numpy(a) for a in leaves), SCALES[layout])


def _ref(layout, leaves):
    if layout == "dense":
        return jnp.asarray(leaves)
    cls = JaxCP if layout == "cp" else JaxTT
    return cls(tuple(jnp.asarray(a) for a in leaves), SCALES[layout])


def _bound(x, y):
    """2 n u S: the rounding bound of one <x, y> (``parity.pair_length``)."""
    s = contractions.pair_inners(x.abs(), y.abs()).abs()
    return 2.0 * parity.pair_length(x, y) * parity.U * s


@pytest.mark.parametrize("qf,yf", list(itertools.product(FORMATS, FORMATS)))
def test_inner_every_pair_against_reference(qf, yf):
    """``inner`` and ``pair_inners`` on one pair, and ``pair_inners`` over a
    (queries x items) matrix whose leading axes broadcast, against the
    reference's ``contractions.inner`` on the same numpy arrays."""
    rng = np.random.default_rng(7)
    x, y = _leaves(rng, qf, rank=3), _leaves(rng, yf, rank=2)
    px, py = _port(qf, x), _port(yf, y)
    ref = float(jcon.inner(_ref(qf, x), _ref(yf, y)))
    tol = float(_bound(px, py))
    assert abs(float(contractions.inner(px, py)) - ref) <= tol
    assert abs(float(contractions.pair_inners(px, py)) - ref) <= tol
    xb, yb = _leaves(rng, qf, batch=4), _leaves(rng, yf, batch=6, rank=2)
    qb = _port(qf, xb).index((slice(None), None))
    cb = _port(yf, yb).index((None,))
    mat = contractions.pair_inners(qb, cb)
    assert mat.shape == (4, 6)
    tols = _bound(qb, cb)
    for i, j in itertools.product(range(4), range(6)):
        want = float(jcon.inner(_ref(qf, _row(xb, i)),
                                _ref(yf, _row(yb, j))))
        assert abs(float(mat[i, j]) - want) <= float(tols[i, j])


def _row(leaves, i):
    if isinstance(leaves, np.ndarray):
        return leaves[i]
    return [a[i] for a in leaves]


def test_cross_inners_order_and_distance():
    """CP x TT and TT x CP are one function (the CP operand first), and
    ``distance`` / ``cosine_similarity`` of a CP tensor and its exact TT
    copy are 0 and 1 within the rounding bound."""
    rng = np.random.default_rng(3)
    x = _port("cp", _leaves(rng, "cp", rank=3))
    t = _port("tt", _leaves(rng, "tt", rank=2))
    assert float(contractions.inner(x, t)) == float(contractions.inner(t, x))
    xt = tensor_formats.cp_to_tt(x)
    assert xt.ranks == (1, 3, 3, 1)
    scale = float(contractions.inner(x, x))
    assert float(contractions.distance(x, xt)) <= math.sqrt(
        200 * parity.U * scale)
    assert abs(float(contractions.cosine_similarity(x, xt)) - 1.0) <= 1e-5


@pytest.mark.parametrize("dims", [(5,), (4, 3), (4, 3, 5, 2)])
def test_cp_to_tt_is_a_valid_tt_of_the_same_tensor(dims):
    """``cp_to_tt`` at one, two and four modes, single and batched: the
    cores chain (first and last TT rank 1) and densify to the CP tensor's
    entries within the rounding of their rank sums (2 (N + R) u sum_r
    prod |A|)."""
    rng = np.random.default_rng(23)
    leaves = _leaves(rng, "cp", batch=3, rank=3, dims=dims)
    x = _port("cp", leaves)
    t = tensor_formats.cp_to_tt(x)
    assert len(t.cores) == len(dims) and t.scale == x.scale
    assert t.ranks[0] == t.ranks[-1] == 1
    for core, d in zip(t.cores, dims):
        assert core.shape[0] == 3 and core.shape[2] == d
    want = projections.densify_batch(x)
    size = projections.densify_batch(_port("cp", [np.abs(a) for a in leaves]))
    bound = 2 * (len(dims) + 3) * parity.U * size
    assert ((projections.densify_batch(t) - want).abs() <= bound).all()
    one = tensor_formats.cp_to_tt(x.index(1))
    assert ((tensor_formats.tt_to_dense(one).reshape(-1) - want[1]).abs()
            <= bound[1]).all()


@functools.lru_cache(maxsize=None)
def _family(kind):
    """One family a kind for the module (the reference test's K = 16, L = 2,
    rank 3)."""
    return make_family(jax.random.PRNGKey(3), kind, DIMS, num_codes=16,
                       num_tables=2, rank=3, hash_backend="xla")


@pytest.mark.parametrize("kind,xf", [("cp-e2lsh", "tt"), ("tt-e2lsh", "cp"),
                                     ("cp-srp", "tt"), ("tt-srp", "cp")])
def test_project_batch_cross_against_reference(kind, xf):
    """The CP projection on TT inputs and the TT one on CP inputs: values
    within ``parity.cross_raw_bound`` of the reference's ``project_batch``
    on the same arrays."""
    fam = _family(kind)
    tfam = tb.bridge_family(fam)
    rng = np.random.default_rng(11)
    leaves = _leaves(rng, xf, batch=37, rank=3)
    ref = np.asarray(jproj.project_batch(fam.projection, _ref(xf, leaves)))
    xs = _port(xf, leaves)
    got = projections.project_batch(tfam.projection, xs)
    bound = parity.cross_raw_bound(tfam.projection, xs)
    assert got.shape == ref.shape == (37, fam.num_tables * fam.num_codes)
    assert (np.abs(got.numpy() - ref) <= bound.numpy()).all()
    assert float(bound.max()) < 1e-4 * float(np.abs(ref).max())


@pytest.mark.parametrize("kind,xf", [("cp-e2lsh", "tt"), ("tt-e2lsh", "cp")])
def test_project_cross_row_bits_do_not_depend_on_the_batch(kind, xf):
    """One row's raw values are the same bits alone, in a batch of 3,000
    (three fixed-shape chunks, the last padded) and at any row offset: the
    hash of an item does not depend on what it was hashed with."""
    tfam = tb.bridge_family(_family(kind))
    rng = np.random.default_rng(13)
    xs = _port(xf, _leaves(rng, xf, batch=3000, rank=2))
    p = tfam.projection
    whole = projections.project_batch(p, xs)
    for i in (0, 1, 1023, 1024, 2047, 2999):
        alone = projections.project_batch(p, xs.index(slice(i, i + 1)))
        assert torch.equal(alone[0], whole[i]), i
        window = projections.project_batch(p, xs.index(slice(i - i % 7,
                                                             i + 5)))
        assert torch.equal(window[i % 7], whole[i]), i


@pytest.mark.parametrize("kind", ["cp-e2lsh", "tt-e2lsh", "cp-srp", "tt-srp"])
def test_format_invariance_of_hash_batch(kind):
    """The twin of ``tests/test_core_lsh.py``'s format invariance: one
    family hashes a batch of CP tensors, the same tensors in TT format
    (``cp_to_tt``, exact) and densified to the same codes (> 95%, float
    association), and the TT codes agree with the reference's on the same
    TT cores (> 95%)."""
    dims = DIMS
    fam = _family(kind)
    tfam = tb.bridge_family(fam)
    rng = np.random.default_rng(17)
    leaves = _leaves(rng, "cp", batch=9, rank=3, dims=dims)
    x_cp = CPTensor(tuple(torch.from_numpy(a) for a in leaves), 1.0)
    x_tt = tensor_formats.cp_to_tt(x_cp)
    dense = projections.densify_batch(x_cp).reshape((9,) + dims)
    x_dense = DenseTensor(dense, dims)
    h = {name: tfam.hash_batch(x).numpy() for name, x in
         (("cp", x_cp), ("tt", x_tt), ("dense", x_dense))}
    assert (h["dense"] == h["cp"]).mean() > 0.95, kind
    assert (h["dense"] == h["tt"]).mean() > 0.95, kind
    assert (h["cp"] == h["tt"]).mean() > 0.95, kind
    ref_tt = JaxTT(tuple(jnp.asarray(c.numpy()) for c in x_tt.cores), 1.0)
    ref = np.asarray(fam.hash_batch(ref_tt))
    assert (ref == h["tt"]).mean() > 0.95, kind
