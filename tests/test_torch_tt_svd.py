"""Port parity: the TT-SVD, CP-ALS and Khatri-Rao utilities of
``repro_torch.core.tensor_formats`` against the reference's
(``repro.core.tensor_formats``), on the same numpy inputs.

* ``dense_to_tt`` keeps the reference's ranks (``min(max_rank, len(s))``,
  or the ``eps`` count) at the reference tests' shapes and ``max_rank``
  values, and reconstructs its input as closely as the reference's does
  (within 1e-5 of the reference's own error); the truncation error falls
  with ``max_rank``;
* ``khatri_rao`` equals the reference's bit for bit (one fp32 product an
  entry);
* ``cp_als`` fits exact rank-R tensors to a relative error below 1e-3;
* the twin of ``test_format_invariance``: one port family hashes a CP
  tensor, its dense form and the port's ``dense_to_tt(max_rank=20)`` of it
  to the same codes on more than 95% of them (fp32 reassociation is the
  only difference).
"""

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tensor_formats as jtf
from repro_torch.core import (DenseTensor, TTTensor, cp_als, cp_to_dense,
                              cp_random_data, dense_to_tt, khatri_rao,
                              make_family, tt_to_dense)


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# the reference tests' shapes and max_rank values (tests/test_core_formats.py,
# tests/test_core_lsh.py), and a truncating eps
@pytest.mark.parametrize("shape,max_rank,eps", [
    ((4, 5, 6), 30, 0.0), ((4, 5, 6), 20, 0.0), ((5, 6, 7), 1, 0.0),
    ((5, 6, 7), 3, 0.0), ((5, 6, 7), 8, 0.0), ((5, 6, 7), 30, 0.0),
    ((3, 4, 5, 6), 4, 0.0), ((5, 6, 7), 30, 0.3)])
def test_dense_to_tt_ranks_and_error_match_reference(shape, max_rank, eps):
    x = _normal(shape, seed=sum(shape) + max_rank)
    ref = jtf.dense_to_tt(jnp.asarray(x), max_rank=max_rank, eps=eps)
    tt = dense_to_tt(torch.from_numpy(x), max_rank=max_rank, eps=eps)
    assert isinstance(tt, TTTensor)
    assert [tuple(c.shape) for c in tt.cores] == [tuple(c.shape)
                                                  for c in ref.cores]
    err = float(torch.linalg.norm(tt_to_dense(tt) - torch.from_numpy(x)))
    ref_err = float(jnp.linalg.norm(jtf.tt_to_dense(ref) - x))
    assert abs(err - ref_err) <= 1e-5 * max(1.0, ref_err)
    if max(tt.ranks) >= max(shape):       # full rank: exact up to rounding
        assert err < 1e-4


def test_dense_to_tt_truncation_error_falls_with_max_rank():
    x = torch.from_numpy(_normal((5, 6, 7), seed=5))
    errs = [float(torch.linalg.norm(tt_to_dense(dense_to_tt(x, r)) - x))
            for r in (1, 2, 3, 5, 7)]
    assert all(a > b for a, b in zip(errs, errs[1:])), errs
    assert errs[-1] < 1e-3


def test_dense_to_tt_rank_20_of_a_large_tensor():
    """Ranks above K1's and K4's limit come out as TT-SVD gives them (the
    card refuses them by name; tests/test_torch_cuda.py)."""
    x = torch.from_numpy(_normal((8, 8, 8, 8), seed=9))
    tt = dense_to_tt(x, max_rank=20)
    assert tt.ranks == (1, 8, 20, 8, 1)


def test_khatri_rao_equals_reference_bitwise():
    mats = [_normal((d, 3), seed=d) for d in (4, 5, 2)]
    ref = np.asarray(jtf.khatri_rao([jnp.asarray(m) for m in mats]))
    got = khatri_rao([torch.from_numpy(m) for m in mats]).numpy()
    assert got.shape == (40, 3)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[:, 0], np.kron(np.kron(
        mats[0][:, 0], mats[1][:, 0]), mats[2][:, 0]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cp_als_fits_exact_rank_r_tensors(seed):
    rank = 3
    factors = [_normal((d, rank), seed=10 * seed + i)
               for i, d in enumerate((4, 5, 6))]
    x = torch.from_numpy(np.einsum("ir,jr,kr->ijk", *factors))
    fit = cp_als(x, rank, iters=200,
                 generator=torch.Generator().manual_seed(seed))
    assert fit.rank == rank and fit.dims == (4, 5, 6)
    rel = float(torch.linalg.norm(cp_to_dense(fit) - x) / torch.linalg.norm(x))
    assert rel < 1e-3, rel


@pytest.mark.parametrize("kind", ["cp-e2lsh", "tt-e2lsh", "cp-srp", "tt-srp"])
def test_format_invariance(kind):
    """Same tensors in three formats, one family -> the same codes."""
    dims = (4, 5, 6)
    gen = torch.Generator().manual_seed(3)
    x_cp = cp_random_data(gen, dims, 3, batch=6)
    dense = torch.stack([cp_to_dense(x_cp.index(i)) for i in range(6)])
    tts = [dense_to_tt(d, max_rank=20) for d in dense]
    x_tt = TTTensor(tuple(torch.stack([t.cores[m] for t in tts])
                          for m in range(len(dims))), 1.0)
    fam = make_family(torch.Generator().manual_seed(4), kind, dims,
                      num_codes=16, num_tables=2, rank=3, device="cpu")
    h_dense = fam.hash_batch(DenseTensor(dense, dims)).numpy()
    h_cp = fam.hash_batch(x_cp).numpy()
    h_tt = fam.hash_batch(x_tt).numpy()
    assert (h_dense == h_cp).mean() > 0.95, kind
    assert (h_dense == h_tt).mean() > 0.95, kind
