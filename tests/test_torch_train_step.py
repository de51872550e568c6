"""The port's train step (``repro_torch.training.train_loop``) against the
reference's ``make_train_step`` on the same carried state and batches.

stablelm-3b's smoke config (float32), the reference's seeded ``init_state``
carried across (``convert.train_state_from_numpy``), the reference's
``batch_at`` batches as numpy, ``grad_accum`` 1 and 2, 3 steps each side
(the reference jitted, as its launcher runs it). Held each step:

* the metric keys are the reference's, ``loss`` / ``ce`` within LOSS_TOL
  relative, ``lr`` within 2 units of the peak lr, ``grad_norm`` within
  NORM_TOL relative;
* parameters: AdamW's first steps move each element by about lr * g / |g|,
  so an element whose gradient has opposite signs on the two sides (a
  near-zero gradient; both gradients agree within 2e-5 of the leaf's
  largest |g|) may differ by up to 2 * lr a step (none flipped in these
  runs); elsewhere within PARAM_TOL of lr (measured 1.3e-2: a same-sign
  gradient near zero still moves m / sqrt(v) by its relative difference);
  both moments within MOMENT_TOL of the leaf's largest |value| (measured
  2.0e-6).

And the state round-trips through ``train_state_to_numpy``, and
``abstract_state`` / ``state_axes`` / ``dryrun_train_config`` follow the
reference's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.data.synthetic import DataConfig as RefDataConfig
from repro.data.synthetic import batch_at as ref_batch_at
from repro.models import transformer as RT
from repro.training import optimizer as ref_opt
from repro.training import train_loop as ref_tl
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import params as P
from repro_torch.training import optimizer as opt_lib
from repro_torch.training import train_loop as TL

ARCH = "stablelm-3b"
STEPS = 3
LOSS_TOL = 1e-5
NORM_TOL = 1e-5
PARAM_TOL = 2e-2
MOMENT_TOL = 1e-5
ADAMW = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=20)


def _flat(tree):
    return dict(P.tree_leaves(tree))


@functools.lru_cache(maxsize=None)
def reference(accum: int):
    cfg = ref_config(ARCH, "smoke")
    tc = ref_tl.TrainConfig(adamw=ref_opt.AdamWConfig(**ADAMW),
                            grad_accum=accum)
    state, sketch = ref_tl.init_state(cfg, tc, jax.random.PRNGKey(2))
    step = jax.jit(ref_tl.make_train_step(cfg, tc, sketch=sketch))
    grad = jax.jit(jax.grad(lambda p, b: RT.loss_fn(cfg, p, b)[0]))
    dc = RefDataConfig(batch_size=4, seq_len=32, seed=5)
    init = jax.tree.map(np.asarray, state)
    batches, metrics, states, grads = [], [], [], []
    for i in range(STEPS):
        b = ref_batch_at(dc, cfg, i)
        grads.append(jax.tree.map(np.asarray, grad(state.params, b)))
        state, m = step(state, b)
        batches.append({k: np.array(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
        states.append(jax.tree.map(np.asarray, state))
    return {"init": init, "batches": batches, "metrics": metrics,
            "states": states, "grads": grads}


@functools.lru_cache(maxsize=None)
def port(accum: int):
    ref = reference(accum)
    cfg = get_config(ARCH, "smoke")
    tc = TL.TrainConfig(adamw=opt_lib.AdamWConfig(**ADAMW), grad_accum=accum)
    state = convert.train_state_from_numpy(cfg, tc, ref["init"],
                                           device="cpu")
    step = TL.make_train_step(cfg, tc)
    metrics, states, grads = [], [], []
    for b in ref["batches"]:
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        grads.append(_flat(TL.grads_of(cfg, state.params, tb)[2]))
        state, m = step(state, tb)
        metrics.append({k: float(v) for k, v in m.items()})
        states.append(convert.train_state_to_numpy(state))
    return {"metrics": metrics, "states": states, "grads": grads}


@pytest.mark.parametrize("accum", [1, 2])
def test_metrics_match_reference(accum):
    ref, got = reference(accum), port(accum)
    for rm, pm in zip(ref["metrics"], got["metrics"]):
        assert set(pm) == set(rm)
        for k in ("loss", "ce"):
            assert abs(pm[k] - rm[k]) <= LOSS_TOL * abs(rm[k]), k
        assert abs(pm["lr"] - rm["lr"]) <= 2 * np.spacing(
            np.float32(ADAMW["peak_lr"]))
        assert abs(pm["grad_norm"] - rm["grad_norm"]) <= \
            NORM_TOL * rm["grad_norm"]


@pytest.mark.parametrize("accum", [1, 2])
def test_params_and_moments_match_reference(accum):
    ref, got = reference(accum), port(accum)
    lr = ADAMW["peak_lr"]
    flipped = {}
    for i, (rs, ps) in enumerate(zip(ref["states"], got["states"])):
        rg, pg = _flat(ref["grads"][i]), got["grads"][i]
        for path, g in rg.items():
            f = np.sign(g) != np.sign(pg[path].numpy())
            flipped[path] = flipped.get(path, False) | f
        assert int(ps["opt"]["step"]) == int(rs.opt.step) == i + 1
        for path, want in _flat(rs.params).items():
            have = _flat(ps["params"])[path]
            d = np.abs(have.astype(np.float64) - want)
            flip = np.broadcast_to(flipped[path], d.shape)
            assert float(d[flip].max(initial=0.0)) <= 2 * lr * (i + 1), path
            assert float(d[~flip].max(initial=0.0)) <= PARAM_TOL * lr, path
        for moment in ("mu", "nu"):
            for path, want in _flat(getattr(rs.opt, moment)).items():
                have = _flat(ps["opt"][moment])[path]
                scale = max(float(np.abs(want).max()), 1e-30)
                d = np.abs(have.astype(np.float64) - want) / scale
                flip = np.broadcast_to(flipped[path], d.shape)
                assert float(d[~flip].max(initial=0.0)) <= MOMENT_TOL, \
                    (moment, path)


def test_train_state_roundtrips_through_numpy():
    cfg = get_config(ARCH, "smoke")
    tc = TL.TrainConfig()
    init = reference(1)["init"]
    state = convert.train_state_from_numpy(cfg, tc, init, device="cpu")
    back = convert.train_state_to_numpy(state)
    for path, want in _flat(init.params).items():
        assert np.array_equal(_flat(back["params"])[path], want)
    for moment in ("mu", "nu"):
        for path, want in _flat(getattr(init.opt, moment)).items():
            assert np.array_equal(_flat(back["opt"][moment])[path], want)
    assert int(back["opt"]["step"]) == int(init.opt.step)
    assert back["compressor"] is None
    bad = dict(init.params)
    bad.pop("final_norm")
    with pytest.raises(ValueError, match="missing"):
        convert.train_state_from_numpy(
            cfg, tc, {"params": bad, "opt": init.opt, "compressor": None},
            device="cpu")


def test_abstract_state_of_a_bf16_config():
    cfg = get_config(ARCH, "full")
    small = TL.abstract_state(cfg, TL.TrainConfig())
    assert small.params["blocks"]["wq"].dtype == torch.bfloat16
    assert small.opt.mu["blocks"]["wq"].dtype == torch.float32
    assert small.opt.step.dtype == torch.int32
    assert small.params["blocks"]["wq"].device.type == "meta"


def test_abstract_state_and_axes_follow_the_reference():
    for arch, variant in (("stablelm-3b", "smoke"), ("phi3-mini-3.8b", "long"),
                          ("mixtral-8x22b", "smoke")):
        cfg = get_config(arch, variant)
        rcfg = ref_config(arch, variant)
        tc = TL.TrainConfig()
        got = TL.abstract_state(cfg, tc)
        want = ref_tl.abstract_state(rcfg, ref_tl.TrainConfig())
        for (path, a), (_, b) in zip(P.tree_leaves(got.params),
                                     P.tree_leaves(jax.tree.map(
                                         lambda x: x, want.params,
                                         is_leaf=lambda x: hasattr(
                                             x, "shape")))):
            assert tuple(a.shape) == tuple(b.shape), path
        axes = TL.state_axes(cfg)
        rax = ref_tl.state_axes(rcfg)
        assert axes.params == rax.params
        assert axes.opt.mu == rax.opt.mu and axes.opt.step == rax.opt.step


@pytest.mark.parametrize("arch", ["stablelm-3b", "mistral-large-123b",
                                  "llama4-maverick-400b-a17b"])
def test_dryrun_train_config_follows_the_reference(arch):
    got = TL.dryrun_train_config(get_config(arch))
    want = ref_tl.dryrun_train_config(ref_config(arch))
    assert got.grad_accum == want.grad_accum
    assert got.adamw.moment_dtype == want.adamw.moment_dtype
