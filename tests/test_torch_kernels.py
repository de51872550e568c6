"""The port's kernel-level path against the reference, on the CPU.

The standalone kernels K6 (``srp_pack``) and K7 (``e2lsh_quant``), their
``ops`` wrappers, ``lsh.pack_bits`` / ``unpack_bits``,
``LSHFamily.hash_packed_batch``, ``ops.cp_inner_products`` /
``tt_inner_products``, and the plain paths of K3 and K4 at the shapes the
port's hash kernels took up in this slice (K = 2000 in one table, TT rank
16). Inputs are made with numpy from a seed and handed to both packages;
the reference runs as its own tests run it (Pallas with interpret=True, the
``kernels/ref.py`` oracles, the XLA hash path). Integer outputs are held
bitwise; raw values to the rounding bounds of ``kernels.parity``, and
``*_inner_products`` to the reference's own rtol/atol of 2e-4.

Only four Pallas shapes are compiled here (ROADMAP.md, R3): K6 at two, K7 at
one power-of-two width, and K7 at w = 6, where the Pallas kernel multiplies
by 1/w and the oracle divides (R4).
"""

import importlib
import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_bridge as tb
from repro.core import lsh as jlsh
from repro.core import (cp_random_data, make_family, project,
                        sample_cp_projection, sample_tt_projection,
                        tt_random_data)
from repro.kernels import ref as jref
from repro.kernels.e2lsh_quant import e2lsh_quant_pallas
from repro.kernels.srp_pack import srp_pack_pallas
from repro_torch import convert
from repro_torch.core import lsh as tlsh
from repro_torch.core.projections import CPProjection, TTProjection
from repro_torch.kernels import ops, parity, ref
from repro_torch.kernels.cp_gram import cp_gram_plain
from repro_torch.kernels.cp_gram import plan as k3_plan
from repro_torch.kernels.e2lsh_quant import e2lsh_quant, e2lsh_quant_plain
from repro_torch.kernels.srp_pack import srp_pack as k6, srp_pack_plain
from repro_torch.kernels.tt_inner import plan as k4_plan
from repro_torch.kernels.tt_inner import tt_inner_plain

# the module (``repro_torch.kernels`` exports its wrapper under the name)
k6_mod = importlib.import_module("repro_torch.kernels.srp_pack")


def _np(a):
    return np.asarray(a)


def _words(a):
    """uint32 words (a reference array) as the port's int64 values."""
    return _np(a).astype(np.uint32).astype(np.int64)


def _signed_values(rng, b, k):
    """N(0, 1) values with exact zeros, negative zeros and a tiny positive
    value sprinkled in (bits 0, 0, 1). Not a subnormal: XLA on the CPU
    flushes those to zero before the compare."""
    v = rng.normal(size=(b, k)).astype(np.float32)
    flat = v.reshape(-1)
    idx = rng.permutation(flat.size)
    flat[idx[0::7]] = 0.0
    flat[idx[1::7]] = -0.0
    flat[idx[2::11]] = np.float32(1e-30)
    return v


@pytest.mark.parametrize("b,k", [(8, 32), (24, 96)])
def test_k6_plain_matches_pallas(b, k):
    v = _signed_values(np.random.default_rng(b * k), b, k)
    got = srp_pack_plain(torch.from_numpy(v))
    want = srp_pack_pallas(jnp.asarray(v), block_b=8, interpret=True)
    assert got.dtype == torch.int64 and got.shape == (b, k // 32)
    np.testing.assert_array_equal(got.numpy(), _words(want))


def test_k7_plain_matches_pallas():
    """A power-of-two width, where multiplying by 1/w is exact."""
    rng = np.random.default_rng(7)
    v = (10.0 * rng.normal(size=(8, 64))).astype(np.float32)
    offs = rng.uniform(0.0, 4.0, size=64).astype(np.float32)
    got = e2lsh_quant_plain(torch.from_numpy(v), torch.from_numpy(offs), 4.0)
    want = e2lsh_quant_pallas(jnp.asarray(v), jnp.asarray(offs), 4.0,
                              block_b=8, interpret=True)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _np(want))


def test_k7_divides_by_w():
    """At w = 6 the port equals the reference's oracle ``e2lsh_quant_ref``
    (and ``lsh.e2lsh_discretize``) bit for bit; the reference's Pallas
    kernel, which multiplies by 1/w, floors otherwise on values one ulp
    below a bucket edge (R4)."""
    rng = np.random.default_rng(6)
    m = rng.integers(-1000, 1000, size=(40, 150)).astype(np.float32)
    offs = rng.uniform(0.0, 6.0, size=150).astype(np.float32)
    edge = np.nextafter((6.0 * m).astype(np.float32), np.float32(-np.inf))
    v = (edge - offs).astype(np.float32)
    got = ops.e2lsh_quantize(torch.from_numpy(v), torch.from_numpy(offs), 6.0)
    want = jref.e2lsh_quant_ref(jnp.asarray(v), jnp.asarray(offs), 6.0)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    np.testing.assert_array_equal(
        got.numpy(), _np(jlsh.e2lsh_discretize(jnp.asarray(v),
                                               jnp.asarray(offs), 6.0)))
    pallas = _np(e2lsh_quant_pallas(jnp.asarray(v), jnp.asarray(offs), 6.0,
                                    block_b=8, interpret=True))
    assert (pallas != got.numpy()).sum() > 100


@pytest.mark.parametrize("b,k", [(1, 1), (3, 31), (5, 33), (7, 40), (8, 70),
                                 (13, 129), (20, 5), (9, 200)])
def test_srp_pack_ragged_matches_reference(b, k):
    v = _signed_values(np.random.default_rng(b * 1000 + k), b, k)
    launches, calls = k6.launches, srp_pack_plain.calls
    got = ops.srp_pack(torch.from_numpy(v))
    assert got.shape == (b, -(-k // 32)) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(),
                                  _words(jref.srp_pack_ref(jnp.asarray(v))))
    # a CPU tensor runs the plain version, never the kernel
    assert srp_pack_plain.calls == calls + 1
    assert k6.launches == launches


def test_srp_pack_zero_bits():
    """sign(0) = 0 (Definition 2: 1 iff v > 0); the tail past K is 0."""
    v = torch.tensor([[0.0, -0.0, -1.0, 1e-30, 2.0] + [0.0] * 30])
    got = ops.srp_pack(v)
    assert got.tolist() == [[(1 << 3) | (1 << 4), 0]]
    assert ops.srp_pack(torch.zeros(8, 32)).eq(0).all()


# K6's launch plan (the C launch recomputes it and refuses another, on the
# card only; these pin the Python copy against the source's constants)
K6_SHAPES = [(1 << 20, 128), (1 << 20, 100), (1 << 16, 2000), (1 << 20, 8),
             (5, 4096), (4000, 4096), (3000, 100), (100003, 32), (1, 1),
             (8, 70)]


def _k6_source_constants():
    src = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
           / "kernels" / "csrc" / "srp_pack.cu").read_text()
    return {name: int(v) for name, v in
            re.findall(r"constexpr int (k\w+) = (\d+);", src)}


@pytest.mark.parametrize("k,aligned,path", [
    (128, True, "vector"), (100, True, "vector"), (4, True, "vector"),
    (4096, True, "vector"), (101, True, "scalar"), (2, True, "scalar"),
    (33, True, "scalar"), (128, False, "scalar"), (100, False, "scalar")])
def test_k6_plan_path(k, aligned, path):
    """float4 units only where K % 4 == 0 and the values are 16-byte
    aligned; K % 4 != 0 or a view with a storage offset reads floats."""
    assert k6_mod.plan(4096, k, 132, aligned).path == path


@pytest.mark.parametrize("sms", [132, 114, 16])
@pytest.mark.parametrize("b,k", K6_SHAPES)
def test_k6_plan_grid(sms, b, k):
    """At most MIN_BLOCKS blocks a SM, as many as the chunks fill, and the
    chunks cover every row (or every piece of a cut row) once."""
    for aligned in (True, False):
        p = k6_mod.plan(b, k, sms, aligned)
        assert p.blocks == min(k6_mod.MIN_BLOCKS * sms,
                               -(-p.chunks // k6_mod.WARPS))
        if p.chunks >= k6_mod.MIN_BLOCKS * sms * k6_mod.WARPS:
            assert p.blocks == 2 * sms
        v = 4 if p.path == "vector" else 1
        units = k // v
        if p.pieces == 1:
            assert p.piece == units
            assert (p.chunks - 1) * p.rows < b <= p.chunks * p.rows
        else:
            assert p.rows == 1 and p.chunks == b * p.pieces
            assert p.piece % (32 // v) == 0      # pieces end on a word
            assert (p.pieces - 1) * p.piece < units <= p.pieces * p.piece


@pytest.mark.parametrize("b,k", K6_SHAPES)
def test_k6_plan_matches_source(b, k):
    """Threads, rows a chunk and a block step, and bytes in flight as the
    source's constants make them."""
    c = _k6_source_constants()
    assert (c["kThreads"], c["kMinBlocks"], c["kChunkBytes"],
            c["kStageWords"], c["kLaneBytes"]) == (
        k6_mod.THREADS, k6_mod.MIN_BLOCKS, k6_mod.CHUNK_BYTES,
        k6_mod.STAGE_WORDS, k6_mod.LANE_BYTES)
    for aligned in (True, False):
        p = k6_mod.plan(b, k, 132, aligned)
        v = 4 if p.path == "vector" else 1
        assert p.threads == c["kThreads"]
        assert p.block_rows == p.rows * c["kThreads"] // 32
        # a chunk of whole rows holds at most kChunkBytes of values (one
        # row at least) and at most kStageWords words
        assert p.rows * (k // v) * 4 * v <= max(c["kChunkBytes"], 4 * k)
        assert p.rows * -(-k // 32) <= c["kStageWords"] or p.pieces > 1
        assert p.in_flight == (c["kMinBlocks"] * c["kThreads"]
                               * c["kLaneBytes"]) >= 24 * 1024
    assert k6_mod.plan(1 << 20, 128, 132, True) == k6_mod.Plan(
        "vector", 512, 264, 16, 1, 32, 65536, 2, 65536)
    assert k6_mod.plan(1 << 20, 100, 132, True).rows == 20


@pytest.mark.parametrize("k", [1, 5, 12, 31, 33, 127, 129, 200])
def test_e2lsh_quantize_ragged_matches_reference(k):
    rng = np.random.default_rng(k * 7)
    v = (5.0 * rng.normal(size=(6, k))).astype(np.float32)
    offs = rng.uniform(0.0, 2.0, size=k).astype(np.float32)
    calls = e2lsh_quant_plain.calls
    got = ops.e2lsh_quantize(torch.from_numpy(v), torch.from_numpy(offs), 2.0)
    assert got.shape == (6, k) and got.dtype == torch.int32
    want = jlsh.e2lsh_discretize(jnp.asarray(v), jnp.asarray(offs), 2.0)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    assert e2lsh_quant_plain.calls == calls + 1


def test_e2lsh_quantize_floor_boundary():
    """Exact multiples of w land in the upper bucket (floor semantics)."""
    v = np.array([[0.0, 2.0, -2.0, 3.999999, -0.000001]] * 3, np.float32)
    offs = np.zeros(5, np.float32)
    got = ops.e2lsh_quantize(torch.from_numpy(v), torch.from_numpy(offs), 2.0)
    assert got[0].tolist() == [0, 1, -1, 1, -1]
    np.testing.assert_array_equal(
        got.numpy(), _np(jref.e2lsh_quant_ref(jnp.asarray(v),
                                              jnp.asarray(offs), 2.0)))


def test_standalone_kernels_refuse_other_devices():
    v = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.srp_pack(v)
    with pytest.raises(ValueError, match="cuda or cpu"):
        e2lsh_quant(v, torch.empty(8, device="meta"), 2.0)
    with pytest.raises(ValueError, match=r"\(K,\) offsets"):
        e2lsh_quant(torch.zeros(4, 8), torch.zeros(7), 2.0)


@pytest.mark.parametrize("k", [1, 32, 70])
def test_pack_unpack_round_trip(k):
    rng = np.random.default_rng(k)
    bits = rng.integers(0, 2, size=(4, 3, k)).astype(np.int32)
    words = tlsh.pack_bits(torch.from_numpy(bits))
    np.testing.assert_array_equal(words.numpy(),
                                  _words(jlsh.pack_bits(jnp.asarray(bits))))
    back = tlsh.unpack_bits(words, k)
    assert back.dtype == torch.int32
    np.testing.assert_array_equal(back.numpy(), bits)
    np.testing.assert_array_equal(
        back.numpy(), _np(jlsh.unpack_bits(jnp.asarray(words.numpy()
                                                       .astype(np.uint32)),
                                           k)))


@pytest.mark.parametrize("kind,k", [("cp-srp", 40), ("tt-srp", 6)])
def test_hash_packed_batch_on_carried_family(kind, k):
    """The port's fused srp-packed path on a carried-over family: bits
    equal the reference's except where the raw value lies within the raw
    rounding bound of 0, and equal ``pack_bits(hash_batch)`` exactly."""
    jfam = make_family(tb.jax_key(11), kind, tb.DIMS, num_codes=k,
                       num_tables=2, rank=2, hash_backend="xla")
    tfam = tb.bridge_family(jfam)
    fixture = tb.cp_fixture if kind.startswith("cp-") else tb.tt_fixture
    corpus, _ = fixture(48, 1, seed=3)
    jx = (tb.jax_cp if kind.startswith("cp-") else tb.jax_tt)(corpus)
    tx = (tb.torch_cp if kind.startswith("cp-") else tb.torch_tt)(corpus)
    got = tfam.hash_packed_batch(tx)
    assert got.shape == (48, 2, -(-k // 32))
    want = _words(jfam.hash_packed_batch(jx))
    near = tb.near_codes(tfam, corpus)
    bits = tlsh.unpack_bits(got, k).numpy()
    want_bits = tlsh.unpack_bits(torch.from_numpy(want), k).numpy()
    assert ((bits == want_bits) | near).all()
    np.testing.assert_array_equal(
        got.numpy(), tlsh.pack_bits(tfam.hash_batch(tx)).numpy())
    e2 = tb.bridge_family(make_family(tb.jax_key(11), kind.replace(
        "srp", "e2lsh"), tb.DIMS, num_codes=3, num_tables=2, rank=2,
        hash_backend="xla"))
    with pytest.raises(ValueError, match="SRP kinds only"):
        e2.hash_packed_batch(tx)


@pytest.mark.parametrize("seed", range(3))
def test_cp_inner_products_match_project(seed):
    """``ops.cp_inner_products`` (K3's batch-of-1 raw values, scales
    applied) against the reference's ``project``, as
    tests/test_kernels.py holds the reference's own wrapper."""
    dims = (10, 10, 10)
    x = cp_random_data(tb.jax_key(seed), dims, 3)
    p = sample_cp_projection(tb.jax_key(100 + seed), 12, dims, 4)
    tx = convert.cp_tensor_from_numpy([_np(f) for f in x.factors], x.scale,
                                      "cpu")
    tp = CPProjection(tuple(torch.tensor(_np(f)) for f in p.factors),
                      float(p.scale))
    got = ops.cp_inner_products(tx, tp)
    assert got.shape == (12,)
    np.testing.assert_allclose(got.numpy(), _np(project(p, x)), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("seed", range(3))
def test_tt_inner_products_match_project(seed):
    dims = (9, 9, 9)
    x = tt_random_data(tb.jax_key(seed), dims, 3)
    p = sample_tt_projection(tb.jax_key(100 + seed), 10, dims, 2)
    tx = convert.tt_tensor_from_numpy([_np(c) for c in x.cores], x.scale,
                                      "cpu")
    tp = TTProjection(tuple(torch.tensor(_np(c)) for c in p.cores),
                      float(p.scale))
    got = ops.tt_inner_products(tx, tp)
    assert got.shape == (10,)
    np.testing.assert_allclose(got.numpy(), _np(project(p, x)), rtol=2e-4,
                               atol=2e-4)


def test_inner_products_refuse_unequal_dims():
    """As the reference's ``_check_equal_dims``: the kernel-level path takes
    equal mode dims."""
    gen = torch.Generator().manual_seed(0)
    from repro_torch.core import projections, tensor_formats
    x = tensor_formats.cp_random_data(gen, (4, 5, 4), 2)
    p = projections.sample_cp_projection(gen, 3, (4, 5, 4), 2)
    with pytest.raises(ValueError, match="equal mode dims"):
        ops.cp_inner_products(x, p)
    x = tensor_formats.tt_random_data(gen, (4, 5, 4), 2)
    p = projections.sample_tt_projection(gen, 3, (4, 5, 4), 2)
    with pytest.raises(ValueError, match="equal mode dims"):
        ops.tt_inner_products(x, p)


def test_k3_plain_at_collision_shape():
    """benchmarks/collision.py's shape, K = 2000 in one table (dims
    (8, 8, 8), rank 2), which K3 tiles over hashes: the plain version
    against the reference's ``cp_inner_ref`` within the raw bound."""
    rng = np.random.default_rng(2000)
    x = rng.normal(size=(6, 3, 8, 2)).astype(np.float32)
    p = rng.normal(size=(3, 1, 2000, 8, 2)).astype(np.float32)
    lp = k3_plan(6, 1, 2000, 2, 2, 3, 8, 132)   # the table cut over blocks
    assert 0 < lp.block_items and lp.block_hashes < 2000
    got = cp_gram_plain(torch.from_numpy(x), torch.from_numpy(p))
    want = _np(jref.cp_inner_ref(jnp.asarray(x),
                                 jnp.asarray(p.reshape(3, 2000, 8, 2))))
    bound = parity.raw_bound(torch.from_numpy(x), torch.from_numpy(p), 1.0)
    err = np.abs(got.numpy() - want.reshape(6, 1, 2000))
    assert (err <= bound.numpy()).all()


@pytest.mark.parametrize("shape", [
    (5, 3, 8, 2, 2, 1, 1024),     # K4 tiled over hashes (K > 512)
    (4, 3, 4, 16, 16, 2, 3),      # TT rank 16: the warp kernel's ranks
])
def test_k4_plain_at_new_shapes(shape):
    """K4's plain version at the shapes the kernel took up, against the
    reference's ``tt_inner_ref`` within ``parity.tt_raw_bound``."""
    b, n, d, rx, rp, l, k = shape
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=(b, n, rx, d, rx)).astype(np.float32)
    p = rng.normal(size=(n, l, k, rp, d, rp)).astype(np.float32)
    lp = k4_plan(b, l, k, rx, rp, d, 132)
    assert (lp.block_items > 0) == (rx <= 8)   # else the warp kernel
    if rx <= 8:
        assert lp.block_hashes < k                 # the table cut over blocks
    got = tt_inner_plain(torch.from_numpy(x), torch.from_numpy(p))
    want = _np(jref.tt_inner_ref(jnp.asarray(x), jnp.asarray(
        p.reshape(n, l * k, rp, d, rp)))).reshape(b, l, k)
    bound = parity.tt_raw_bound(torch.from_numpy(x), torch.from_numpy(p), 1.0)
    assert (np.abs(got.numpy() - want) <= bound.numpy()).all()
    ours = ref.tt_inner_ref(torch.from_numpy(x),
                            torch.from_numpy(p.reshape(n, l * k, rp, d, rp)))
    assert (np.abs(ours.numpy().reshape(b, l, k) - want)
            <= bound.numpy()).all()


@pytest.mark.parametrize("first", [
    "import repro_torch; from repro_torch.kernels import _build",
    "import repro_torch.kernels",
    "import repro_torch.kernels.ref",
    "import repro_torch.kernels.srp_pack",
    "import repro_torch.kernels.e2lsh_quant",
    "from repro_torch.kernels import ops",
])
def test_kernel_modules_import_first(first):
    """The kernels package and its new modules import as a process's first
    import of the port (``chip_smoke.py`` starts with the first case):
    ``kernels/__init__`` exports ``ops``, which the core package imports
    back."""
    src = Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    run = subprocess.run([sys.executable, "-c", first], env=env,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]
