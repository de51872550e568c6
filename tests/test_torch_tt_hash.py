"""Port parity: TT projection and fused TT hashing (K4's plain version and
its epilogues) against the reference.

* Raw values: the port's ``project_batch``, ``tt_inner_plain(raw)`` and
  ``ref.tt_inner_ref`` against the reference's ``project_batch``, its
  Pallas ``tt_inner_pallas`` (interpret mode) and ``ref.tt_inner_ref``,
  within ``repro_torch.kernels.parity.tt_raw_bound``: the fp32 rounding
  bound 2 * (N * max(Rx + d*Rp, Rp + d*Rx) + 2) * 2^-24 * S of two
  evaluation orders of the chain, S the same chain on |cores|.
* Integer stages, bitwise: given the reference kernel's raw TT values, the
  port's ``apply_epilogue`` gives the codes, keys and packed words the
  reference's epilogue and its fused kernel give.
* End to end, boundary-aware: the port's TT codes and keys equal the
  reference's except where a code lies within the raw bound of a bucket
  edge (E2LSH) or of 0 (SRP).
"""

import math

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_bridge as tb
from repro.core import projections as jproj
from repro.kernels import epilogues as jepi
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.tt_inner import tt_inner_pallas
from repro_torch.core import lsh as tlsh
from repro_torch.core import projections as tproj
from repro_torch.kernels import epilogues as tepi
from repro_torch.kernels import parity
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ops import _stack_tt_batch, _stack_tt_proj
from repro_torch.kernels.tt_inner import block_shape, tt_inner_plain

N_ITEMS = 29


@pytest.fixture(scope="module", params=tb.TT_KINDS)
def case(request):
    kind = request.param
    fam = tb.jax_family(kind)
    corpus, _ = tb.tt_fixture(N_ITEMS, 1, seed=3)
    return kind, fam, tb.bridge_family(fam), corpus


def _stacked(tfam, corpus):
    x = _stack_tt_batch(tb.torch_tt(corpus))
    p = _stack_tt_proj(tfam.projection, tfam.num_tables)
    return x, p, tfam.projection.scale


def _offsets(fam):
    """(L, K) E2LSH offsets: the family's, or for an SRP family fixed
    U[0, w) draws, so that every epilogue runs on either kind."""
    if fam.offsets is not None:
        return np.asarray(fam.offsets).reshape(fam.num_tables, fam.num_codes)
    rng = np.random.default_rng(8)
    return rng.uniform(0, fam.bucket_width, (fam.num_tables, fam.num_codes)
                       ).astype(np.float32)


def _ref_kernel(fam, corpus, epilogue, mults=None):
    """The reference's Pallas K4 (interpret mode) on its own stacking; for
    'srp-packed' the hashes are padded to whole words with zero projections
    (sign bit 0), as the reference's ``ops.fused_hash`` pads them."""
    jx = tb.jax_tt(corpus)
    rx = max(max(c.shape[1], c.shape[3]) for c in jx.cores)
    rp = fam.projection.rank
    xf = jops._pad_axis(jops._stack_tt_batch(jx, rx), 0, 8)
    pf = jops._stack_tt_proj(fam.projection, rp, fam.num_tables)
    offs = jnp.asarray(_offsets(fam))
    if epilogue == "srp-packed":
        pf, offs = jops._pad_axis(pf, 2, 32), None
    out = tt_inner_pallas(xf, pf, offs, mults, epilogue=epilogue,
                          w=fam.bucket_width, scale=float(fam.projection.scale), interpret=True)
    return np.asarray(out)[:N_ITEMS], xf, pf


def test_tt_raw_values_match_reference(case):
    kind, fam, tfam, corpus = case
    x, p, scale = _stacked(tfam, corpus)
    bound = parity.tt_raw_bound(x, p, scale).reshape(N_ITEMS, -1).numpy()
    jx = tb.jax_tt(corpus)
    ref_xla = np.asarray(jproj.project_batch(fam.projection, jx))
    ref_pallas, xf, pf = _ref_kernel(fam, corpus, "raw")
    ref_pallas = ref_pallas.reshape(N_ITEMS, -1)
    n, l, k, rp, d, _ = pf.shape
    ref_oracle = float(fam.projection.scale) * np.asarray(jref.tt_inner_ref(
        xf, pf.reshape(n, l * k, rp, d, rp)))[:N_ITEMS]
    got_proj = tproj.project_batch(tfam.projection, tb.torch_tt(corpus))
    got_plain = tt_inner_plain(x, p, epilogue="raw", scale=scale)
    got_oracle = scale * tref.tt_inner_ref(
        x, p.reshape(p.shape[0], -1, *p.shape[3:]))
    for got in (got_proj, got_plain.reshape(N_ITEMS, -1), got_oracle):
        for ref in (ref_xla, ref_pallas, ref_oracle):
            assert (np.abs(got.numpy() - ref) <= bound).all()
    # the bound is not vacuous: the values are far larger than it
    assert np.median(np.abs(ref_xla)) > 10 * np.median(bound)


@pytest.mark.parametrize("epilogue", ["e2lsh", "srp", "e2lsh-keys",
                                      "srp-keys", "srp-packed"])
def test_epilogues_bitwise_on_reference_tt_values(case, epilogue):
    """Given the reference kernel's raw TT values, the port's epilogue
    equals the reference's epilogue and its fused kernel, bit for bit."""
    kind, fam, tfam, corpus = case
    mults = tlsh.make_mults(4, fam.num_codes)
    raw, _, _ = _ref_kernel(fam, corpus, "raw")
    offs = _offsets(fam)
    fused, _, _ = _ref_kernel(fam, corpus, epilogue, jnp.asarray(mults)[None])
    ref_raw = raw
    if epilogue == "srp-packed":  # the reference's epilogue packs whole words
        ref_raw = np.pad(raw, ((0, 0), (0, 0), (0, -raw.shape[-1] % 32)))
    ref = np.asarray(jepi.apply_epilogue(
        jnp.asarray(ref_raw), jnp.asarray(offs), jnp.asarray(mults)[None],
        epilogue=epilogue, w=fam.bucket_width))
    got = tepi.apply_epilogue(
        torch.from_numpy(raw.copy()), torch.from_numpy(offs),
        torch.from_numpy(mults.astype(np.int64)), epilogue=epilogue,
        w=fam.bucket_width).numpy()
    for want in (ref, fused):
        want = want.astype(np.int64) if want.dtype == np.uint32 else want
        np.testing.assert_array_equal(got, want)


def test_tt_codes_keys_end_to_end_boundary_aware(case):
    kind, fam, tfam, corpus = case
    mults = tlsh.make_mults(0, fam.num_codes)
    jx = tb.jax_tt(corpus)
    ref_keys = np.asarray(fam.hash_keys(jx, jnp.asarray(mults)))  # pallas
    ref_codes = np.asarray(fam.hash_batch(jx))
    tx = tb.torch_tt(corpus)
    got_keys = tfam.hash_keys(tx, mults).numpy()
    got_codes = tfam.hash_batch(tx).numpy()
    near = tb.near_codes(tfam, corpus)
    assert ((got_codes == ref_codes) | near).all()
    far_tables = ~near.any(axis=-1)
    assert far_tables.mean() > 0.5
    np.testing.assert_array_equal(got_keys[far_tables],
                                  ref_keys.astype(np.int64)[far_tables])
    np.testing.assert_array_equal(
        got_keys, tlsh._combine_codes(torch.from_numpy(got_codes),
                                      torch.from_numpy(mults.astype(np.int64))))


def test_tt_hash_batch_aux_matches_reference(case):
    kind, fam, tfam, corpus = case
    ref_codes, ref_aux = (np.asarray(a) for a in
                          fam.hash_batch_aux(tb.jax_tt(corpus)))
    codes, aux = tfam.hash_batch_aux(tb.torch_tt(corpus))
    x, p, scale = _stacked(tfam, corpus)
    bound = parity.tt_raw_bound(x, p, scale).numpy()
    near = (np.abs(ref_aux) <= bound if kind.endswith("srp") else
            np.minimum(ref_aux, 1 - ref_aux) * fam.bucket_width <= 2 * bound)
    assert ((codes.numpy() == ref_codes) | near).all()
    scale_aux = 1.0 if kind.endswith("srp") else 1.0 / fam.bucket_width
    ok = np.abs(aux.numpy() - ref_aux) <= 2 * bound * scale_aux + 1e-6
    assert (ok | near).all()


@pytest.mark.parametrize("kind", tb.TT_KINDS)
def test_make_family_tt_kinds(kind):
    """The port's own TT families: TT_Rad(R) cores of the right shapes,
    scale 1/sqrt(R^(N-1)), offsets in [0, w) for E2LSH; asking for the card
    where there is none raises."""
    gen = torch.Generator().manual_seed(0)
    fam = tlsh.make_family(gen, kind, (4, 5, 6), num_codes=3, num_tables=2,
                           rank=3, bucket_width=2.0, device="cpu")
    p = fam.projection
    assert isinstance(p, tproj.TTProjection)
    assert p.ranks == (1, 3, 3, 1) and p.dims == (4, 5, 6)
    assert p.num_hashes == 6
    assert p.scale == pytest.approx(1 / math.sqrt(3 ** 2))
    assert set(torch.unique(torch.cat([c.reshape(-1) for c in p.cores]))
               .tolist()) == {-1.0, 1.0}
    assert fam.stacked_projection.shape == (3, 2, 3, 3, 6, 3)
    if kind.endswith("e2lsh"):
        assert fam.offsets.shape == (6,)
        assert bool(((fam.offsets >= 0) & (fam.offsets < 2.0)).all())
    else:
        assert fam.offsets is None
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fam.hash_batch(tb.torch_cp([np.ones((d, 2), np.float32)[None]
                                    for d in (4, 5, 6)]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tlsh.make_family(gen, kind, (4, 5, 6))


def test_k4_block_shape_fits_its_budget():
    """K4's (items, tables, hashes) per block: at most 512 threads, one per
    (item, hash), whole tables, and one mode's staged cores within its
    shared-memory budget; a table of more than 512 hashes runs in chunks
    of 512 (one item, one table), and a shape that cannot fit one table
    goes to the warp kernel (None)."""
    from repro_torch.kernels.tt_inner import MAX_THREADS, SMEM_BUDGET
    assert block_shape(16, 4, 4, 10, 10, 1 << 20) == (32, 1, 10)
    assert block_shape(4, 2, 2, 4, 3, 29) == (29, 4, 3)
    bb, lb, kb = block_shape(4, 2, 2, 2, 40, 129)
    assert bb * lb * 40 <= MAX_THREADS and kb == 40
    bb, lb, kb = block_shape(32, 8, 8, 4, 6, 4096)       # 8 KiB per core
    assert bb * lb * 6 <= MAX_THREADS and kb == 6
    assert 4 * (8 * 32 * 8 * bb + lb * 6 * 8 * 32 * 8) <= SMEM_BUDGET
    assert block_shape(8, 2, 2, 1, 1024, 4096) == (1, 1, 512)
    assert block_shape(8, 2, 2, 1, 2000, 4096) == (1, 1, 512)
    assert block_shape(256, 8, 8, 2, 16, 4096) is None
