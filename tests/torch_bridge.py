"""Shared fixtures of the port's parity suites (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages as numpy
arrays: the reference (``repro``, JAX) and the port (``repro_torch``,
PyTorch on the CPU). The RNGs never cross; sampled parameters are carried
from the reference into the port with ``repro_torch.convert``.

Not a test module: pytest puts this directory on sys.path, so the suites
``import torch_bridge`` as they ``import grids``.
"""

import jax
import jax.numpy as jnp
import numpy as np

import grids
from repro.core import CPTensor as JaxCP
from repro_torch import convert

DIMS = grids.DIMS          # (4, 4, 4)
RHAT = 3                   # data rank of the CP corpora
NUM_TABLES = 4
KINDS = ("cp-e2lsh", "cp-srp")


def grid_params(kind):
    """(K, w) of ``grids.grid_family`` for a kind."""
    k, w = (3, 6.0) if "e2lsh" in kind else (6, 0.0)
    return k, max(w, 1.0)


def cp_fixture(n, n_queries, seed=0, clusters=6, spread=0.35, noise=0.05,
               dims=DIMS, rank=RHAT):
    """Clustered CP corpus + queries perturbed off its first rows:
    per-mode factor lists of numpy float32 (n, d, R) / (n_queries, d, R)."""
    rng = np.random.default_rng(seed)
    centers = [rng.normal(size=(clusters, d, rank)) / np.sqrt(d)
               for d in dims]
    corpus = [(c[np.arange(n) % clusters]
               + spread * rng.normal(size=(n, d, rank)) / np.sqrt(d))
              .astype(np.float32) for c, d in zip(centers, dims)]
    queries = [(f[:n_queries] + noise * rng.normal(size=f[:n_queries].shape))
               .astype(np.float32) for f in corpus]
    return corpus, queries


def jax_cp(factors, scale=1.0):
    return JaxCP(tuple(jnp.asarray(f) for f in factors), scale)


def torch_cp(factors, scale=1.0):
    return convert.cp_tensor_from_numpy(factors, scale, "cpu")


def jax_family(kind, seed=42, backend="pallas"):
    k, w = grid_params(kind)
    return grids.grid_family(kind, num_tables=NUM_TABLES, seed=seed,
                             hash_backend=backend)


def bridge_family(fam):
    """Reference LSHFamily -> port LSHFamily on the CPU."""
    p = fam.projection
    return convert.family_from_numpy(
        fam.kind, [np.asarray(f) for f in p.factors], p.scale,
        None if fam.offsets is None else np.asarray(fam.offsets),
        fam.num_codes, fam.num_tables, fam.bucket_width, "cpu")


def jax_key(seed):
    return jax.random.PRNGKey(seed)


def near_tables(tfam, factors):
    """(n, L) bool: the tables in which some code of these items lies
    within the raw rounding bound of a bucket edge (E2LSH) or of 0 (SRP),
    where two fp32 evaluations may disagree (``parity.raw_bound``)."""
    from repro_torch.kernels import parity
    from repro_torch.kernels.cp_gram import cp_gram_plain
    from repro_torch.kernels.ops import _stack_cp_batch, _stack_cp_proj
    x = _stack_cp_batch(torch_cp(factors))
    p = _stack_cp_proj(tfam.projection, tfam.num_tables)
    scale = tfam.projection.scale
    v = cp_gram_plain(x, p, epilogue="raw", scale=scale)
    offs = (tfam.offsets.reshape(tfam.num_tables, tfam.num_codes)
            if tfam.offsets is not None else None)
    return parity.boundary_codes(v, parity.raw_bound(x, p, scale), tfam.kind,
                                 offs, tfam.bucket_width).any(-1).numpy()
