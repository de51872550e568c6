"""The port's CP-sketch gradient compression
(``repro_torch.training.compression``) against the reference's.

* with the reference's own ``_factors`` carried over (``roundtrip``'s
  ``factors=``), one roundtrip of a stablelm-smoke-shaped gradient tree
  with a nonzero error state matches: each compressed leaf's sketch s
  within SKETCH_TOL of its largest |s|, the projected gradient and the new
  error within PROJ_TOL of the leaf's largest |value|, raw leaves and
  their zeroed errors exactly, ``comm_ratio`` exactly;
* the port's own factors are +-1 and equiprobable (a binomial test over
  every entry drawn), the same for the same (seed, step, leaf), and
  different across steps and across leaves;
* the projection meets its sketch: <P_k, G^> = s_k within the ridge's
  relative residual;
* the reference's ``test_error_feedback_accumulates`` and
  ``test_sketch_roundtrip_reduces_comm_and_trains``, on the port.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import compression as RC
from repro_torch.configs import get_config
from repro_torch.data.synthetic import DataConfig, batch_at
from repro_torch.models import params as P
from repro_torch.training import compression as C
from repro_torch.training import optimizer as opt_lib
from repro_torch.training import train_loop as TL

# float32 both sides; a sketch sums d1 * d2 * R signed terms in another
# order, and the solve differs (LAPACK against XLA's LU). Measured: s 2.9e-6,
# the projected gradient 2.5e-6, the error 6.5e-8
SKETCH_TOL = 1e-5
PROJ_TOL = 2e-5
STEP = 3
CFG = dict(num_projections=16, rank=2, min_size=4096, seed=99)


def _grads_tree(seed):
    cfg = get_config("stablelm-3b", "smoke")
    rng = np.random.default_rng(seed)
    return {p: rng.standard_normal(s.shape).astype(np.float32)
            for p, s in P.tree_leaves(P.param_specs(cfg))}


def _nest(flat):
    out = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


@functools.lru_cache(maxsize=None)
def reference():
    cfg = RC.CompressionConfig(**CFG)
    grads = _nest(_grads_tree(1))
    err = jax.tree.map(lambda g: 0.1 * g, _nest(_grads_tree(2)))
    seed, _ = RC.init_compressor(cfg, grads)
    step = jnp.asarray(STEP, jnp.uint32)
    ghat, st, m = jax.jit(lambda g, e: RC.roundtrip(
        cfg, seed, RC.CompressorState(error=e), g, step=step))(
        jax.tree.map(jnp.asarray, grads), jax.tree.map(jnp.asarray, err))
    leaves = jax.tree.leaves(grads)
    factors, sketches = {}, {}
    for i, g in enumerate(leaves):
        ms = RC._matricize_shape(g.shape)
        if ms is None or g.size < cfg.min_size:
            continue
        fa, fb = RC._factors(cfg, seed, step, i, *ms)
        factors[i] = (np.array(fa), np.array(fb))
        e = jax.tree.leaves(err)[i]
        sketches[i] = np.asarray(RC._sketch(
            jnp.asarray(g + e).reshape(ms), fa, fb, cfg.rank))
    return {"grads": grads, "err": err, "factors": factors,
            "sketches": sketches,
            "ghat": dict(P.tree_leaves(jax.tree.map(np.asarray, ghat))),
            "error": dict(P.tree_leaves(jax.tree.map(np.asarray, st.error))),
            "comm_ratio": np.asarray(m["comm_ratio"])}


@functools.lru_cache(maxsize=None)
def port():
    ref = reference()
    cfg = C.CompressionConfig(**CFG)
    to_t = lambda t: P.tree_map(torch.from_numpy, t)  # noqa: E731
    state = C.CompressorState(error=to_t(ref["err"]))
    used = []

    def factors(i, d1, d2):
        used.append(i)
        fa, fb = ref["factors"][i]
        assert fa.shape[1] == d1 and fb.shape[1] == d2
        return torch.from_numpy(fa), torch.from_numpy(fb)
    ghat, st, m = C.roundtrip(cfg, cfg.seed, state, to_t(ref["grads"]),
                              step=STEP, factors=factors)
    return {"ghat": dict(P.tree_leaves(ghat)),
            "error": dict(P.tree_leaves(st.error)),
            "comm_ratio": m["comm_ratio"], "used": used}


def _rel(a, b):
    b = np.asarray(b, np.float64)
    return float(np.abs(np.asarray(a, np.float64) - b).max()
                 / max(np.abs(b).max(), 1e-30))


def test_roundtrip_with_reference_factors_matches():
    ref, got = reference(), port()
    assert sorted(got["used"]) == sorted(ref["factors"])
    assert len(got["used"]) >= 4
    for path, want in ref["ghat"].items():
        assert _rel(got["ghat"][path].numpy(), want) <= PROJ_TOL, path
        assert _rel(got["error"][path].numpy(), ref["error"][path]) \
            <= PROJ_TOL, path


def test_raw_leaves_pass_exactly():
    ref, got = reference(), port()
    cfg = C.CompressionConfig(**CFG)
    for path, g in P.tree_leaves(ref["grads"]):
        if C._matricize_shape(g.shape) is None or g.size < cfg.min_size:
            assert np.array_equal(got["ghat"][path].numpy(), g)
            assert not got["error"][path].any()


def test_comm_ratio_is_the_reference_s():
    assert float(port()["comm_ratio"]) == float(reference()["comm_ratio"])
    assert port()["comm_ratio"].dtype == torch.float32


def test_sketch_matches_reference():
    ref = reference()
    cfg = C.CompressionConfig(**CFG)
    leaves = P.tree_leaves(ref["grads"])
    errs = P.tree_leaves(ref["err"])
    for i, (fa, fb) in ref["factors"].items():
        g = leaves[i][1] + errs[i][1]
        s = C._sketch(torch.from_numpy(g).reshape(fa.shape[1], -1),
                      torch.from_numpy(fa), torch.from_numpy(fb), cfg.rank)
        assert _rel(s.numpy(), ref["sketches"][i]) <= SKETCH_TOL


def test_port_factors_are_equiprobable_signs():
    cfg = C.CompressionConfig(num_projections=32, rank=2)
    fa, fb = C._factors(cfg, 5, 7, 3, 40, 300, device="cpu")
    assert fa.shape == (32, 40, 2) and fb.shape == (32, 300, 2)
    vals = torch.cat([fa.reshape(-1), fb.reshape(-1)])
    assert set(torch.unique(vals).tolist()) == {-1.0, 1.0}
    n = vals.numel()
    plus = int((vals > 0).sum())
    # binomial(n, 1/2): |plus - n/2| within 5 standard deviations
    assert abs(plus - n / 2) <= 5 * math.sqrt(n) / 2


def test_port_factors_depend_on_the_triple_alone():
    cfg = C.CompressionConfig(num_projections=8, rank=2)
    a = C._factors(cfg, 5, 7, 3, 10, 20, device="cpu")
    b = C._factors(cfg, 5, 7, 3, 10, 20, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    for other in ((5, 8, 3), (5, 7, 4), (6, 7, 3)):
        c = C._factors(cfg, *other, 10, 20, device="cpu")
        assert not torch.equal(a[1], c[1]), other


def test_projection_meets_its_sketch():
    """<P_k, G^> = s_k up to the ridge: (M + lam I) alpha = s gives
    M alpha = s - lam alpha, lam = ridge * trace(M) / K."""
    cfg = C.CompressionConfig(num_projections=16, rank=2)
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (24, 200)).astype(np.float32))
    fa, fb = C._factors(cfg, 1, 0, 0, 24, 200, device="cpu")
    s = C._sketch(g, fa, fb, cfg.rank)
    ghat = C._project(s, fa, fb, cfg.rank, cfg.ridge)
    back = C._sketch(ghat, fa, fb, cfg.rank)
    resid = float((back - s).norm() / s.norm())
    assert resid <= 2 * cfg.ridge + 1e-5, resid


def test_error_feedback_accumulates():
    cfg = C.CompressionConfig(num_projections=8, rank=2, min_size=1)
    params = {"w": torch.zeros((64, 64))}
    sk, st = C.init_compressor(cfg, params)
    g = {"w": torch.ones((64, 64))}
    ghat, st2, _ = C.roundtrip(cfg, sk, st, g)
    np.testing.assert_allclose(st2.error["w"].numpy(),
                               (g["w"] - ghat["w"]).numpy(), atol=1e-5)


def test_sketch_roundtrip_reduces_comm_and_trains():
    cfg = get_config("stablelm-3b", "smoke")
    tc = TL.TrainConfig(
        adamw=opt_lib.AdamWConfig(peak_lr=1e-3, warmup_steps=5,
                                  decay_steps=100),
        compression=C.CompressionConfig(num_projections=256, rank=2,
                                        min_size=4096))
    state, sketch = TL.init_state(cfg, tc, torch.Generator().manual_seed(0),
                                  device="cpu")
    step = TL.make_train_step(cfg, tc, sketch=sketch)
    dc = DataConfig(batch_size=4, seq_len=64, seed=0)
    losses = []
    for i in range(30):
        state, metrics = step(state, batch_at(dc, cfg, i, device="cpu"))
        losses.append(float(metrics["loss"]))
    assert float(metrics["comm_ratio"]) < 0.05  # >20x comm reduction
    assert losses[-1] < losses[0] - 0.25, losses[::6]
