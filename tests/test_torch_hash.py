"""Port parity: projection and fused hashing (K3's plain version and its
epilogues) against the reference.

* Raw values: the port's ``project_batch`` and ``cp_gram_plain(raw)``
  against the reference's ``project_batch``, its Pallas ``cp_gram_pallas``
  (interpret mode) and ``ref.cp_inner_ref``, within
  ``repro_torch.kernels.parity.raw_bound``: the fp32 rounding bound
  2 * (d + N + Rx*Rp) * 2^-24 * S of two summation orders, S the same sum
  over absolute values.
* Integer stages, bitwise: given the reference's raw values, the port's
  ``apply_epilogue`` gives equal codes, keys and packed words in all six
  modes, at w = 6 (the grid's E2LSH width, where a multiply by 1/w would
  floor differently) and at w = 2; ``make_mults`` is bitwise equal.
* End to end, boundary-aware: the port's keys equal the reference's except
  in tables holding a code whose reference residual lies within the raw
  bound of a bucket edge (E2LSH) or of 0 (SRP).
"""

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_bridge as tb
from repro.core import lsh as jlsh
from repro.core import projections as jproj
from repro.kernels import epilogues as jepi
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.cp_gram import cp_gram_pallas
from repro_torch.core import lsh as tlsh
from repro_torch.core import projections as tproj
from repro_torch.kernels import epilogues as tepi
from repro_torch.kernels import parity
from repro_torch.kernels import ref as tref
from repro_torch.kernels.cp_gram import cp_gram_plain
from repro_torch.kernels.ops import _stack_cp_batch, _stack_cp_proj

N_ITEMS = 29


@pytest.fixture(scope="module", params=tb.KINDS)
def case(request):
    kind = request.param
    fam = tb.jax_family(kind)
    corpus, _ = tb.cp_fixture(N_ITEMS, 1, seed=3)
    return kind, fam, tb.bridge_family(fam), corpus


def _stacked(tfam, corpus):
    x = _stack_cp_batch(tb.torch_cp(corpus))
    p = _stack_cp_proj(tfam.projection, tfam.num_tables)
    return x, p, tfam.projection.scale


def test_raw_values_match_reference(case):
    kind, fam, tfam, corpus = case
    x, p, scale = _stacked(tfam, corpus)
    bound = parity.raw_bound(x, p, scale).reshape(N_ITEMS, -1).numpy()
    jx = tb.jax_cp(corpus)
    ref_xla = np.asarray(jproj.project_batch(fam.projection, jx))
    # the reference's Pallas kernel, interpret mode, on its own stacking
    xf = jops._pad_axis(jops._stack_cp_batch(jx), 0, 8)
    pf = jops._stack_cp_proj(fam.projection, fam.num_tables)
    ref_pallas = np.asarray(cp_gram_pallas(
        xf, pf, epilogue="raw", scale=float(fam.projection.scale),
        interpret=True))[:N_ITEMS].reshape(N_ITEMS, -1)
    ref_oracle = float(fam.projection.scale) * np.asarray(jref.cp_inner_ref(
        jops._stack_cp_batch(jx), pf.reshape(pf.shape[0], -1,
                                             *pf.shape[3:])))[:N_ITEMS]
    got_proj = tproj.project_batch(tfam.projection, tb.torch_cp(corpus))
    got_plain = cp_gram_plain(x, p, epilogue="raw", scale=scale)
    got_oracle = scale * tref.cp_inner_ref(
        x, p.reshape(p.shape[0], -1, *p.shape[3:]))
    for got in (got_proj, got_plain.reshape(N_ITEMS, -1), got_oracle):
        for ref in (ref_xla, ref_pallas, ref_oracle):
            assert (np.abs(got.numpy() - ref) <= bound).all()


@pytest.mark.parametrize("w", [6.0, 2.0])
@pytest.mark.parametrize("epilogue", tepi.EPILOGUES)
def test_epilogues_bitwise_on_reference_values(epilogue, w):
    rng = np.random.default_rng(5)
    b, l, k = 13, 3, 32 if epilogue == "srp-packed" else 7
    # values scaled so that many land next to bucket edges
    v = (rng.normal(size=(b, l, k)) * 3 * w).astype(np.float32)
    offs = rng.uniform(0, w, size=(l, k)).astype(np.float32)
    mults = tlsh.make_mults(9, k)
    ref = np.asarray(jepi.apply_epilogue(
        jnp.asarray(v), jnp.asarray(offs), jnp.asarray(mults)[None],
        epilogue=epilogue, w=w))
    got = tepi.apply_epilogue(
        torch.from_numpy(v), torch.from_numpy(offs),
        torch.from_numpy(mults.astype(np.int64)), epilogue=epilogue,
        w=w).numpy()
    if ref.dtype == np.uint32:
        ref = ref.astype(np.int64)
    np.testing.assert_array_equal(got, ref)


def test_combine_and_mults_bitwise():
    for seed, k in ((0, 3), (7, 6), (123, 10)):
        np.testing.assert_array_equal(tlsh.make_mults(seed, k),
                                      jlsh.make_mults(seed, k))
    rng = np.random.default_rng(1)
    codes = rng.integers(-2**31, 2**31, size=(11, 4, 10), dtype=np.int64)
    codes = codes.astype(np.int32)
    mults = tlsh.make_mults(3, 10)
    ref = np.asarray(jref.combine_ref(jnp.asarray(codes), jnp.asarray(mults)))
    got = tref.combine_ref(torch.from_numpy(codes),
                           torch.from_numpy(mults.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))
    np.testing.assert_array_equal(
        tlsh._combine_codes(torch.from_numpy(codes),
                            torch.from_numpy(mults.astype(np.int64))).numpy(),
        ref.astype(np.int64))


def test_codes_keys_end_to_end_boundary_aware(case):
    kind, fam, tfam, corpus = case
    mults = tlsh.make_mults(0, fam.num_codes)
    jx = tb.jax_cp(corpus)
    ref_keys = np.asarray(fam.hash_keys(jx, jnp.asarray(mults)))  # pallas
    ref_codes, aux = (np.asarray(a) for a in fam.hash_batch_aux(jx))
    tx = tb.torch_cp(corpus)
    got_keys = tfam.hash_keys(tx, mults).numpy()
    got_codes = tfam.hash_batch(tx).numpy()
    x, p, scale = _stacked(tfam, corpus)
    bound = parity.raw_bound(x, p, scale).numpy()
    if kind.endswith("srp"):
        near = np.abs(aux) <= bound
    else:       # residual in [0, 1): distance to the nearer edge, in values
        near = np.minimum(aux, 1.0 - aux) * fam.bucket_width <= 2 * bound
    assert ((got_codes == ref_codes) | near).all()
    far_tables = ~near.any(axis=-1)
    np.testing.assert_array_equal(got_keys[far_tables],
                                  ref_keys.astype(np.int64)[far_tables])
    # the keys of a batch equal the combine of its codes, bit for bit
    np.testing.assert_array_equal(
        got_keys, tlsh._combine_codes(torch.from_numpy(got_codes),
                                      torch.from_numpy(mults.astype(np.int64))))


def test_hash_batch_aux_matches_reference(case):
    kind, fam, tfam, corpus = case
    ref_codes, ref_aux = (np.asarray(a) for a in
                          fam.hash_batch_aux(tb.jax_cp(corpus)))
    codes, aux = tfam.hash_batch_aux(tb.torch_cp(corpus))
    x, p, scale = _stacked(tfam, corpus)
    bound = parity.raw_bound(x, p, scale).numpy()
    near = (np.abs(ref_aux) <= bound if kind.endswith("srp") else
            np.minimum(ref_aux, 1 - ref_aux) * fam.bucket_width <= 2 * bound)
    assert ((codes.numpy() == ref_codes) | near).all()
    scale_aux = 1.0 if kind.endswith("srp") else 1.0 / fam.bucket_width
    ok = np.abs(aux.numpy() - ref_aux) <= 2 * bound * scale_aux + 1e-6
    assert (ok | near).all()


SMS = 132   # an H100's SMs: the planner takes the count, it reads no card


@pytest.mark.parametrize("shape,kernel", [
    ((1024, 10, 10, 4, 3, 3, 12), "thread"),   # [main]'s query batch
    ((65536, 10, 10, 4, 3, 3, 12), "thread"),  # [main]'s build launch
    ((5, 10, 10, 4, 3, 3, 12), "thread"),      # a batch of 5
    ((4096, 40, 32, 4, 3, 3, 12), "thread"),
    ((4096, 1, 2000, 2, 2, 3, 8), "thread"),   # collision.py: a table cut
    ((4096, 2, 64, 8, 8, 3, 64), "thread"),    # ranks above 4: <8, 8>
    ((64, 8, 8, 32, 32, 4, 64), "warp"),       # benchmarks/kernels.py R=32
    ((64, 1, 8, 8, 8, 4, 512), "warp"),        # rows no thread block stages
])
def test_k3_block_choice_fits_its_budget(shape, kernel):
    """K3's launch plan: the thread kernel's blocks are whole warps of its
    register tile within ``MAX_THREADS`` threads, the warp kernel's at most
    8 warps; the shared bytes are the source's sum and fit a block (one
    more a SM would not fit where the plan targets two); the grid covers
    every (item, hash); a 1,024-item launch at the serving shape runs at
    least two blocks a SM; ranks above 8 and rows the thread kernel cannot
    stage take the warp kernel, and a table of more hashes than a block
    holds is cut over blocks (its keys combine into zeros)."""
    from repro_torch.kernels import cp_gram as k3
    from repro_torch.kernels import epilogues as epi
    b, l, k, rx, rp, n, d = shape
    p = k3.plan(b, l, k, rx, rp, n, d, SMS)
    assert (p.block_items > 0) == (kernel == "thread")
    if kernel == "thread":
        inst = k3.instantiation(rx, rp)
        ti, th = k3.THREAD_TILES[inst]
        assert p.block_items % (8 * ti) == 0 and p.block_hashes % (4 * th) == 0
        assert p.threads == (p.block_items // (8 * ti)) * (
            p.block_hashes // (4 * th)) * 32 <= k3.MAX_THREADS
        assert p.smem == k3.thread_smem(n, d, inst, p.block_items,
                                        p.block_hashes)
        assert p.blocks == -(-b // p.block_items) * -(-l * k // p.block_hashes)
    else:
        assert p.threads == 32 * p.block_hashes <= 256
        assert p.smem == k3.warp_smem(p.block_hashes)
        assert p.blocks == b * -(-l * k // p.block_hashes)
    assert 1 <= p.target_blocks <= epi.resident(p.smem)
    assert p.smem <= epi.MAX_SMEM
    if b >= 1024 and kernel == "thread":
        assert p.blocks >= 2 * SMS and p.target_blocks == 2
    cut = l * k > p.block_hashes and p.block_hashes % k != 0
    assert epi.needs_zeros(p, l, k, "e2lsh-keys") == cut
    assert not epi.needs_zeros(p, l, k, "raw")
    if k == 2000:
        assert cut