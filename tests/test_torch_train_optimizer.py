"""The port's AdamW (``repro_torch.training.optimizer``) against the
reference's (``repro.training.optimizer``) on the same numpy inputs.

* ``schedule`` over steps 0-200 within two float32 units of the peak lr
  of the reference's, jitted or op by op. The port computes the
  reference's expression op by op in float32; the two libraries' float32
  cos differ by one unit at some arguments (both faithful, neither
  correctly rounded), which the schedule's ``1 + cos`` carries as up to
  3 units of a small lr (at most one unit of the peak lr, measured against
  the reference op by op), and XLA's fused jitted schedule differs from
  its own op-by-op values by up to 6 units (1.5 units of the peak lr,
  measured with no warmup), so no float32 evaluation matches both to the
  bit;
* ``update`` given the reference's own gradients, carried over: new
  params, both moments, ``grad_norm`` and ``lr`` within the ulps stated
  below (float32 and bfloat16 parameters, weight decay on every leaf);
* the row-chunked in-place update is bit-equal to a whole-leaf one;
* the reference's ``test_schedule_shape`` and ``test_clipping``, ported.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.training import optimizer as ref_opt
from repro_torch.training import optimizer as opt_lib

# in units of the peak lr's float32 spacing (see above)
SCHEDULE_ULPS = 2
# Differences in units of the float32 spacing at the leaf's largest
# magnitude (bfloat16 parameters: bfloat16 units at each value). The
# global norm sums in another order (measured 3 units of itself), so the
# clip scale and with it every clipped gradient differ by a few units;
# XLA contracts the jitted update's products and sums into FMAs, the port
# rounds each operation (measured without clipping: 1 unit). Measured with
# clipping: params 0.5 (bfloat16 bit-equal), mu 3, nu 9 (the square doubles
# the scale's error).
PARAM_ULPS = {"float32": 2, "bfloat16": 1}
MOMENT_ULPS = {"clipped": 16, "unclipped": 2}
NORM_ULPS = 4


def ulps(a, b) -> float:
    """max |a - b| in units of the float32 spacing at |b|."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    spacing = np.spacing(np.abs(b).astype(np.float32)).astype(np.float64)
    spacing = np.maximum(spacing, np.spacing(np.float32(1e-30)))
    return float(np.max(np.abs(a - b) / spacing))


def leaf_ulps(a, b) -> float:
    """max |a - b| in units of the float32 spacing at max |b|."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b))
                 / np.spacing(np.float32(max(np.abs(b).max(), 1e-30))))


def lr_ulps(a, b, peak: float) -> float:
    """max |a - b| in units of the float32 spacing at ``peak``."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float(np.max(d) / np.spacing(np.float32(peak)))


def bf16_ulps(a, b) -> float:
    """max |a - b| in bfloat16 units at |b| (both exact bfloat16 values)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    exp = np.floor(np.log2(np.maximum(np.abs(b), 2.0 ** -126)))
    return float(np.max(np.abs(a - b) / 2.0 ** (exp - 7)))


CFG = dict(peak_lr=1e-3, warmup_steps=10, decay_steps=100,
           min_lr_ratio=0.1)


@pytest.mark.parametrize("warmup,decay", [(10, 100), (20, 30), (0, 200)])
def test_schedule_matches_reference(warmup, decay):
    c_ref = ref_opt.AdamWConfig(peak_lr=3e-4, warmup_steps=warmup,
                                decay_steps=decay)
    c = opt_lib.AdamWConfig(peak_lr=3e-4, warmup_steps=warmup,
                            decay_steps=decay)
    steps = np.arange(201, dtype=np.int32)
    jitted = jax.jit(lambda s: ref_opt.schedule(c_ref, s))
    got = opt_lib.schedule(c, torch.from_numpy(steps)).numpy()
    assert got.dtype == np.float32
    for run in (jitted, lambda s: ref_opt.schedule(c_ref, s)):
        want = np.array([np.asarray(run(jnp.asarray(s, jnp.int32)))
                         for s in steps], np.float32)
        assert lr_ulps(got, want, c.peak_lr) <= SCHEDULE_ULPS


def test_schedule_shape():
    c = opt_lib.AdamWConfig(peak_lr=1.0, warmup_steps=10, decay_steps=100,
                            min_lr_ratio=0.1)
    lrs = [float(opt_lib.schedule(c, torch.tensor(s)))
           for s in [0, 5, 10, 55, 100, 200]]
    assert lrs[0] == 0.0 and abs(lrs[2] - 1.0) < 1e-6
    assert lrs[1] == pytest.approx(0.5)
    assert lrs[4] == pytest.approx(0.1, abs=1e-6)
    assert lrs[5] == pytest.approx(0.1, abs=1e-6)


def test_clipping():
    c = opt_lib.AdamWConfig(clip_norm=1.0, weight_decay=0.0)
    params = {"w": torch.ones(4)}
    grads = {"w": torch.full((4,), 100.0)}
    st = opt_lib.init(params)
    _, _, m = opt_lib.update(c, grads, st, params)
    assert float(m["grad_norm"]) == pytest.approx(200.0)


def _tree(rng, dtype):
    """A params-like tree: a stacked (L, ...) leaf, a matrix, norms."""
    shapes = {"blocks": {"wq": (3, 16, 24), "ln": (3, 16)},
              "embed": {"tokens": (40, 16)}, "final_norm": (16,)}

    def walk(t, scale):
        if isinstance(t, dict):
            return {k: walk(v, scale) for k, v in t.items()}
        return (scale * rng.standard_normal(t)).astype(np.float32).astype(
            dtype)
    return walk(shapes, 0.02), walk(shapes, 1.0)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flat(tree[k], f"{prefix}{k}/")
        return out
    return [(prefix[:-1], tree)]


def _to_torch(tree, dtype):
    if isinstance(tree, dict):
        return {k: _to_torch(v, dtype) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree, np.float32)).to(dtype)


def _run_both(dtype_name, steps, clip_norm=1.0, grad_scale=1.0):
    rng = np.random.default_rng(5)
    np_dtype = ml_dtypes.bfloat16 if dtype_name == "bfloat16" else np.float32
    params_np, _ = _tree(rng, np_dtype)
    c_ref = ref_opt.AdamWConfig(clip_norm=clip_norm, **CFG)
    c = opt_lib.AdamWConfig(clip_norm=clip_norm, **CFG)
    r_params = jax.tree.map(jnp.asarray, params_np)
    r_state = ref_opt.init(r_params)
    upd = jax.jit(lambda g, s, p: ref_opt.update(c_ref, g, s, p))
    t_params = _to_torch(params_np, getattr(torch, dtype_name))
    t_state = opt_lib.init(t_params)
    out = []
    for _ in range(steps):
        _, grads_np = _tree(rng, np_dtype)
        grads_np = jax.tree.map(lambda g: (g.astype(np.float32) * grad_scale)
                                .astype(np_dtype), grads_np)
        r_params, r_state, r_m = upd(jax.tree.map(jnp.asarray, grads_np),
                                     r_state, r_params)
        t_params, t_state, t_m = opt_lib.update(
            c, _to_torch(grads_np, getattr(torch, dtype_name)), t_state,
            t_params)
        # the port updates in place: keep this step's values
        snap = jax.tree.map(lambda t: t.clone(), (t_params, t_state, t_m))
        out.append((jax.tree.map(np.asarray, (r_params, r_state, r_m)),
                    snap))
    return out


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip_norm", [1.0, 1e6])
def test_update_matches_reference(dtype_name, clip_norm):
    for (rp, rs, rm), (tp, ts, tm) in _run_both(dtype_name, 3, clip_norm):
        assert lr_ulps(float(tm["lr"]), rm["lr"], CFG["peak_lr"]) \
            <= SCHEDULE_ULPS
        assert ulps(float(tm["grad_norm"]), rm["grad_norm"]) <= NORM_ULPS
        assert int(ts.step) == int(rs.step)
        for (path, want), (_, got) in zip(_flat(rp), _flat(tp)):
            got = got.float().numpy()
            want = np.asarray(want, np.float32)
            err = (bf16_ulps(got, want) if dtype_name == "bfloat16"
                   else leaf_ulps(got, want))
            assert err <= PARAM_ULPS[dtype_name], (path, err)
        for moment in ("mu", "nu"):
            for (path, want), (_, got) in zip(
                    _flat(getattr(rs, moment)),
                    _flat(getattr(ts, moment))):
                assert got.dtype == torch.float32
                bound = MOMENT_ULPS["clipped" if clip_norm == 1.0
                                    else "unclipped"]
                assert leaf_ulps(got.numpy(), want) <= bound, (moment, path)


def test_weight_decay_reaches_a_leaf_with_zero_gradient():
    """A leaf whose gradient is zero (phi3-lsh's ``lsh_proj``) is scaled
    by 1 - lr * wd, rounded to its dtype, as the reference does."""
    c = opt_lib.AdamWConfig(**CFG)
    p = torch.randn(8, 4, generator=torch.Generator().manual_seed(1)).to(
        torch.bfloat16)
    params = {"lsh_proj": {"f1": p.clone()}, "w": torch.ones(3)}
    grads = {"lsh_proj": {"f1": torch.zeros_like(p)}, "w": torch.ones(3)}
    st = opt_lib.init(params)
    params, st, m = opt_lib.update(c, grads, st, params)
    lr = m["lr"]
    want = (p.float() - lr * (c.weight_decay * p.float())).to(torch.bfloat16)
    assert torch.equal(params["lsh_proj"]["f1"], want)
    assert float(lr) > 0


def test_chunked_update_is_bit_equal_to_whole_leaf(monkeypatch):
    """Given the same global norm (its chunks fixed), an update a few rows
    at a time gives the bits of a whole-leaf one."""
    rng = np.random.default_rng(9)
    p0, _ = _tree(rng, np.float32)
    _, g = _tree(rng, np.float32)
    c = opt_lib.AdamWConfig(**CFG)
    results = []
    for chunk in (1 << 25, 7):
        monkeypatch.setattr(opt_lib, "UPDATE_CHUNK", chunk)
        params = _to_torch(p0, torch.float32)
        st = opt_lib.init(params)
        for _ in range(2):
            params, st, m = opt_lib.update(c, _to_torch(g, torch.float32),
                                           st, params)
        results.append((params, st, float(m["grad_norm"])))
    (pa, sa, na), (pb, sb, nb) = results
    for (_, a), (_, b) in zip(_flat(pa) + _flat(sa.mu) + _flat(sa.nu),
                              _flat(pb) + _flat(sb.mu) + _flat(sb.nu)):
        assert torch.equal(a, b)
    assert na == nb


def test_bf16_moments_stay_bf16():
    c = opt_lib.AdamWConfig(moment_dtype="bfloat16", **CFG)
    params = {"w": torch.ones(5, 3)}
    st = opt_lib.init(params, "bfloat16")
    params, st, _ = opt_lib.update(c, {"w": torch.full((5, 3), 0.5)}, st,
                                   params)
    assert st.mu["w"].dtype == torch.bfloat16
    assert st.nu["w"].dtype == torch.bfloat16
    assert params["w"].dtype == torch.float32
    with pytest.raises(TypeError, match="moment_dtype"):
        opt_lib.update(opt_lib.AdamWConfig(**CFG), {"w": torch.ones(5, 3)},
                       st, params)
