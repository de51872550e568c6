"""Port parity: the multi-probe expansion (``repro_torch.core.probing``)
against the reference's (``repro.core.probing``).

* ``expansion_size`` and the static pair indices equal the reference's.
* Keys bitwise: given the reference's own raw projections (or its own
  ``hash_batch_aux`` residuals), the port's ranked (B, L, T) keys equal
  ``probing.probe_keys``' for the four kinds at T in {2, 8}, including the
  stable tie order of the E2LSH pair sums and the uint32 wrap of the
  deltas.
* The padding regime T - 1 > C (SRP, K = 2: C = 3) repeats the base key.
* The port's ``query_keys(probes=T)`` on its own projection: slot 0 equal to
  ``hash_keys``, and equal to the reference's except in tables holding a
  code within the raw rounding bound of a bucket edge or a near tie of two
  perturbation scores.
"""

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_bridge as tb
from repro.core import make_family as jax_make_family
from repro.core import probing as jprob
from repro.core import projections as jproj
from repro.core.lsh import _combine_codes as jax_combine
from repro.core.lsh import make_mults as jax_make_mults
from repro_torch.core import probing as tprob
from repro_torch.core import segments as tseg
from repro_torch.kernels.fused_query import probe_keys_from_values

B = 7
KINDS = tb.KINDS + tb.TT_KINDS


def _case(kind, seed=31):
    fam = tb.jax_family(kind)
    if kind.startswith("tt-"):
        _, q = tb.tt_fixture(20, B, seed=seed)
        return fam, q, tb.jax_tt(q), tb.torch_tt(q)
    _, q = tb.cp_fixture(20, B, seed=seed)
    return fam, q, tb.jax_cp(q), tb.torch_cp(q)


@pytest.mark.parametrize("kind", ["cp-e2lsh", "cp-srp", "e2lsh", "srp"])
@pytest.mark.parametrize("k", [1, 2, 3, 6, 10])
def test_expansion_size_and_pair_indices(kind, k):
    assert tprob.expansion_size(kind, k) == jprob.expansion_size(kind, k)
    e2 = kind.endswith("e2lsh")
    coord = np.concatenate([np.arange(k)] * (2 if e2 else 1))
    want = jprob._pair_indices(coord)
    got = tprob.pair_indices(e2, k)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w_))
    singles = 2 * k if e2 else k
    assert singles + got[0].size == tprob.expansion_size(kind, k)


@pytest.mark.parametrize("probes", [2, 8])
@pytest.mark.parametrize("kind", KINDS)
def test_keys_bitwise_on_reference_raw_values(kind, probes):
    """From the reference's raw projections: the kernel-side expansion
    (discretize, residuals, combine, rank) gives the reference's keys."""
    fam, _, jq, _ = _case(kind)
    mults = jax_make_mults(0, fam.num_codes)
    ref = np.asarray(jprob.probe_keys(fam, jnp.asarray(mults), jq,
                                      probes=probes)).astype(np.int64)
    values = torch.from_numpy(np.array(jproj.project_batch(fam.projection,
                                                           jq)))
    tfam = tb.bridge_family(fam)
    got = probe_keys_from_values(
        values, tfam.offsets, torch.from_numpy(mults.astype(np.int64)),
        e2=kind.endswith("e2lsh"), w=tfam.bucket_width,
        num_tables=tfam.num_tables, num_codes=tfam.num_codes, probes=probes)
    np.testing.assert_array_equal(got.permute(2, 0, 1).numpy(), ref)
    assert (ref[..., 1:] != ref[..., :1]).any()


@pytest.mark.parametrize("probes", [2, 8])
@pytest.mark.parametrize("kind", KINDS)
def test_expand_keys_bitwise_on_reference_aux(kind, probes):
    """From the reference's own ``hash_batch_aux`` residuals and base keys:
    ``expand_keys`` (stable top-(T-1), uint32 deltas) gives its keys."""
    fam, _, jq, _ = _case(kind, seed=32)
    mults = jax_make_mults(0, fam.num_codes)
    codes, aux = fam.hash_batch_aux(jq)
    base = np.asarray(jax_combine(codes, jnp.asarray(mults))).astype(np.int64)
    ref = np.asarray(jprob.probe_keys(fam, jnp.asarray(mults), jq,
                                      probes=probes)).astype(np.int64)
    got = tprob.expand_keys(torch.from_numpy(base),
                            torch.from_numpy(np.array(aux)),
                            torch.from_numpy(mults.astype(np.int64)),
                            e2=kind.endswith("e2lsh"), probes=probes)
    np.testing.assert_array_equal(got.numpy(), ref)
    scores, deltas = jprob.scores_and_deltas(fam, jnp.asarray(mults), aux)
    tscores, tdeltas = tprob.scores_and_deltas(
        tb.bridge_family(fam), mults, torch.from_numpy(np.array(aux)))
    np.testing.assert_array_equal(tscores.numpy().view(np.uint32),
                                  np.asarray(scores).view(np.uint32))
    np.testing.assert_array_equal(tdeltas.numpy(),
                                  np.asarray(deltas).astype(np.int64))


@pytest.mark.parametrize("kind", ["cp-srp", "tt-srp"])
def test_padding_past_the_expansion(kind):
    """SRP at K = 2 ranks C = 3 candidates; T = 8 pads slots 4..7 with the
    base key, bitwise as the reference."""
    tt = kind.startswith("tt-")
    fam = jax_make_family(tb.jax_key(3), kind, tb.DIMS, num_codes=2,
                          num_tables=3, rank=2, bucket_width=1.0,
                          hash_backend="pallas")
    assert tprob.expansion_size(kind, 2) == 3
    _, q = (tb.tt_fixture if tt else tb.cp_fixture)(20, B, seed=33)
    jq = tb.jax_tt(q) if tt else tb.jax_cp(q)
    mults = jax_make_mults(0, 2)
    ref = np.asarray(jprob.probe_keys(fam, jnp.asarray(mults), jq,
                                      probes=8)).astype(np.int64)
    values = torch.from_numpy(np.array(jproj.project_batch(fam.projection,
                                                           jq)))
    got = probe_keys_from_values(
        values, None, torch.from_numpy(mults.astype(np.int64)), e2=False,
        w=1.0, num_tables=3, num_codes=2, probes=8).permute(2, 0, 1).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got[..., 4:] == got[..., :1]).all()


@pytest.mark.parametrize("kind", KINDS)
def test_query_keys_multiprobe(kind):
    """``segments.query_keys(probes=T)`` on the port's own projection:
    (L, T, B), slot 0 the single-probe keys, and equal to the reference's
    in every table without a boundary code or a near score tie."""
    fam, q, jq, tq = _case(kind, seed=34)
    tfam = tb.bridge_family(fam)
    mults = jax_make_mults(0, fam.num_codes)
    got = tseg.query_keys(tfam, mults, tq, probes=8).numpy()   # (L, T, B)
    assert got.shape == (tfam.num_tables, 8, B)
    np.testing.assert_array_equal(got[:, 0],
                                  tseg.query_keys(tfam, mults, tq).numpy())
    ref = np.asarray(jprob.probe_keys(fam, jnp.asarray(mults), jq,
                                      probes=8)).astype(np.int64)
    same = (got.transpose(2, 0, 1) == ref).all(-1)             # (B, L)
    near = tb.near_tables(tfam, q)
    # a table may differ only near an edge, or where the port's residuals
    # (another fp32 projection) reorder two perturbation scores within
    # their rounding
    _, aux = tfam.hash_batch_aux(tq)
    scores, _ = tprob.scores_and_deltas(tfam, mults, aux)
    srt = torch.sort(scores, dim=-1).values
    tie = ((srt[..., 1:] - srt[..., :-1]) <= 1e-5).any(-1).numpy()
    assert (same | near | tie).all()
    assert same.mean() > 0.5
