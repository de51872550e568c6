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
from repro.core import TTTensor as JaxTT
from repro_torch import convert

DIMS = grids.DIMS          # (4, 4, 4)
RHAT = 3                   # data rank of the CP corpora
TT_RHAT = 2                # data TT rank of the TT corpora
NUM_TABLES = 4
KINDS = ("cp-e2lsh", "cp-srp")
TT_KINDS = ("tt-e2lsh", "tt-srp")


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


def tt_fixture(n, n_queries, seed=0, clusters=6, spread=0.35, noise=0.05,
               dims=DIMS, rank=TT_RHAT):
    """Clustered TT corpus + queries perturbed off its first rows: per-mode
    core lists of numpy float32 (n, r, d, r') / (n_queries, r, d, r'),
    boundary ranks 1, entries N(0, 1) / (r d)^(1/4) as ``tt_random_data``
    makes them."""
    rng = np.random.default_rng(seed)
    shapes = [(1 if i == 0 else rank, d, 1 if i == len(dims) - 1 else rank)
              for i, d in enumerate(dims)]
    centers = [rng.normal(size=(clusters,) + s) / (s[0] * s[1]) ** 0.25
               for s in shapes]
    corpus = [(c[np.arange(n) % clusters]
               + spread * rng.normal(size=(n,) + s) / (s[0] * s[1]) ** 0.25)
              .astype(np.float32) for c, s in zip(centers, shapes)]
    queries = [(g[:n_queries] + noise * rng.normal(size=g[:n_queries].shape))
               .astype(np.float32) for g in corpus]
    return corpus, queries


def jax_tt(cores, scale=1.0):
    return JaxTT(tuple(jnp.asarray(c) for c in cores), scale)


def torch_tt(cores, scale=1.0):
    return convert.tt_tensor_from_numpy(cores, scale, "cpu")


def jax_cp(factors, scale=1.0):
    return JaxCP(tuple(jnp.asarray(f) for f in factors), scale)


def torch_cp(factors, scale=1.0):
    return convert.cp_tensor_from_numpy(factors, scale, "cpu")


def jax_family(kind, seed=42, backend="pallas"):
    k, w = grid_params(kind)
    return grids.grid_family(kind, num_tables=NUM_TABLES, seed=seed,
                             hash_backend=backend)


def bridge_family(fam):
    """Reference LSHFamily (any of the six kinds) -> port LSHFamily on the
    CPU: CP factors, TT cores, or the naive kinds' (L*K, prod d) matrix."""
    p = fam.projection
    if fam.kind.startswith("cp-"):
        leaves = p.factors
    elif fam.kind.startswith("tt-"):
        leaves = p.cores
    else:
        leaves = (p.matrix,)
    return convert.family_from_numpy(
        fam.kind, [np.asarray(f) for f in leaves], p.scale,
        None if fam.offsets is None else np.asarray(fam.offsets),
        fam.num_codes, fam.num_tables, fam.bucket_width, "cpu",
        dims=p.dims)


def jax_key(seed):
    return jax.random.PRNGKey(seed)


def near_codes(tfam, leaves):
    """(n, L, K) bool: the codes of these items (CP factors or TT cores)
    that lie within the raw rounding bound of a bucket edge (E2LSH) or of 0
    (SRP), where two fp32 evaluations may disagree (``parity.raw_bound`` /
    ``parity.tt_raw_bound``)."""
    from repro_torch.kernels import parity
    from repro_torch.kernels.cp_gram import cp_gram_plain
    from repro_torch.kernels.tt_inner import tt_inner_plain
    tt = tfam.kind.startswith("tt-")
    xs = torch_tt(leaves) if tt else torch_cp(leaves)
    x = tfam.stack(xs)
    p = tfam.stacked_projection
    scale = tfam.projection.scale
    plain, bound = ((tt_inner_plain, parity.tt_raw_bound) if tt
                    else (cp_gram_plain, parity.raw_bound))
    v = plain(x, p, epilogue="raw", scale=scale)
    offs = (tfam.offsets.reshape(tfam.num_tables, tfam.num_codes)
            if tfam.offsets is not None else None)
    return parity.boundary_codes(v, bound(x, p, scale), tfam.kind, offs,
                                 tfam.bucket_width).numpy()


def near_tables(tfam, leaves):
    """(n, L) bool: the tables holding a ``near_codes`` code."""
    return near_codes(tfam, leaves).any(-1)


def leaves_of(x):
    """A reference CP or TT tensor's factors or cores as numpy arrays; a
    dense array as one numpy array."""
    if hasattr(x, "factors"):
        return [np.asarray(a) for a in x.factors]
    if hasattr(x, "cores"):
        return [np.asarray(a) for a in x.cores]
    return np.asarray(x)


def carry_store(store, device="cpu"):
    """A reference ``SegmentStore`` (single-device or sharded) -> the
    port's, through ``convert.store_from_numpy`` (each segment's arrays as
    numpy, with ``counts`` for sharded segments, plus the reference's
    ``host_state()``)."""
    segs = []
    for seg in [store.base] + list(store.deltas):
        arrays = dict(corpus_factors=leaves_of(seg.corpus),
                      sorted_keys=np.asarray(seg.sorted_keys),
                      perm=np.asarray(seg.perm), keys=np.asarray(seg.keys),
                      cap=seg.cap,
                      corpus_scale=getattr(seg.corpus, "scale", 1.0))
        if hasattr(seg, "counts"):
            arrays["counts"] = seg.counts
        segs.append(arrays)
    return convert.store_from_numpy(segs, store.host_state(), device)
