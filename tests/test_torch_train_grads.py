"""The port's backward through the LM substrate against the reference's
``jax.value_and_grad(loss_fn)`` on the same numpy inputs.

Each arch's smoke config (float32) runs once a module on each side: the
reference's seeded parameters carried across
(``convert.model_params_from_numpy``), a seeded numpy batch with
next-token labels (the last masked). Held:

* the loss within 1e-5 relative of the reference's;
* every gradient leaf within GRAD_TOL of the leaf's largest |g| (both
  float32: reduction order only; measured below 4e-6);
* the three remat policies ("nothing", "dots", "none") bit-equal on the
  CPU (recompute runs the same operations on the same inputs);
* ``lsh_proj``'s gradient exactly zero (its codes are signs);
* for every arch, the reference's ``test_forward_and_train_step`` on the
  port: ce in (1, 20), gradients finite and nonzero in total;
* a trainable ``LM`` module's ``loss`` backward gives the same gradients;
* caveat R11: at mamba2's own 256-token SSD chunk the reference's gradient
  is NaN (its ``where(mask, exp(ldiff), 0)`` overflows above the
  diagonal and the backward multiplies the inf by 0); the port's, which
  takes exp of -inf there, is finite and its loss the reference's.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lm_bridge
from repro.configs import get_config as ref_config
from repro.models import params as ref_params
from repro.models import transformer as RT
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import params as P
from repro_torch.models import transformer as T
from repro_torch.training import train_loop as TL

ARCHS = ("stablelm-3b", "phi3-mini-3.8b", "mixtral-8x22b", "mamba2-130m",
         "zamba2-7b", "whisper-tiny", "llama4-maverick-400b-a17b")
B, S = 2, 32
LOSS_TOL = 1e-5
GRAD_TOL = 2e-5


def _batch(cfg, seed):
    batch = lm_bridge.make_batch(cfg, B, S, seed)
    labels = np.roll(batch["tokens"], -1, axis=1)
    labels[:, -1] = -1
    batch["labels"] = labels
    return batch


@functools.lru_cache(maxsize=None)
def reference(arch: str):
    cfg = ref_config(arch, "smoke")
    params = ref_params.init_params(cfg, jax.random.PRNGKey(7))
    batch = _batch(cfg, 11)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: RT.loss_fn(cfg, p, b), has_aux=True))(params, jb)
    return {"params": jax.tree.map(np.asarray, params), "batch": batch,
            "loss": float(loss),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": dict(P.tree_leaves(jax.tree.map(np.asarray, grads)))}


@functools.lru_cache(maxsize=None)
def port(arch: str, policy: str = "nothing"):
    ref = reference(arch)
    cfg = dataclasses.replace(get_config(arch, "smoke"), remat_policy=policy)
    params = convert.model_params_from_numpy(cfg, ref["params"],
                                             device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    loss, metrics, grads = TL.grads_of(cfg, params, batch)
    return {"loss": float(loss),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": dict(P.tree_leaves(grads))}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_reference(arch):
    ref, got = reference(arch), port(arch)
    assert abs(got["loss"] - ref["loss"]) <= LOSS_TOL * abs(ref["loss"])
    for k in ("ce", "aux", "tokens"):
        assert abs(got["metrics"][k] - ref["metrics"][k]) <= \
            LOSS_TOL * max(abs(ref["metrics"][k]), 1.0), k


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_reference(arch):
    ref, got = reference(arch)["grads"], port(arch)["grads"]
    assert set(got) == set(ref)
    for path, want in ref.items():
        g = got[path].numpy()
        assert g.shape == want.shape and g.dtype == np.float32
        scale = float(np.abs(want).max())
        err = float(np.abs(g.astype(np.float64) - want).max())
        assert err <= GRAD_TOL * max(scale, 1e-30), (path, err, scale)


@pytest.mark.parametrize("policy", ["dots", "none"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_policies_give_equal_gradients(arch, policy):
    base, other = port(arch, "nothing"), port(arch, policy)
    assert other["loss"] == base["loss"]
    for path, g in base["grads"].items():
        assert torch.equal(other["grads"][path], g), path


def test_lsh_proj_gradient_is_exactly_zero():
    grads = port("phi3-mini-3.8b")["grads"]
    for leaf in ("lsh_proj/f1", "lsh_proj/f2"):
        assert bool((grads[leaf] == 0).all())
        assert bool((reference("phi3-mini-3.8b")["grads"][leaf] == 0).all())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_and_train_step_on_port(arch):
    """The reference's ``test_forward_and_train_step``, on the port alone
    with its own seeded parameters."""
    cfg = get_config(arch, "smoke")
    gen = torch.Generator().manual_seed(0)
    params = P.init_params(cfg, gen, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 1).items()}
    loss, metrics, grads = TL.grads_of(cfg, params, batch)
    assert np.isfinite(float(loss))
    assert 1.0 < float(metrics["ce"]) < 20.0
    flat = [g for _, g in P.tree_leaves(grads)]
    assert all(bool(torch.isfinite(g).all()) for g in flat)
    assert sum(float(g.abs().sum()) for g in flat) > 0.0


def test_trainable_lm_module_backward():
    arch = "stablelm-3b"
    ref = reference(arch)
    cfg = get_config(arch, "smoke")
    params = convert.model_params_from_numpy(cfg, ref["params"],
                                             device="cpu")
    lm = T.LM(cfg, params, trainable=True)
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    loss, _ = lm.loss(batch)
    loss.backward()
    want = port(arch)["grads"]
    for path, leaf in P.tree_leaves(lm.tree()):
        assert torch.equal(leaf.grad, want[path]), path
    frozen = T.LM(cfg, params)
    assert not any(p.requires_grad for p in frozen.parameters())


def test_r11_ssd_gradient_is_finite_where_the_reference_nans():
    cfg_r = dataclasses.replace(ref_config("mamba2-130m", "smoke"),
                                ssm_chunk=256)
    cfg = dataclasses.replace(get_config("mamba2-130m", "smoke"),
                              ssm_chunk=256)
    params = ref_params.init_params(cfg_r, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (2, 256)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    batch = {"tokens": tokens, "labels": labels}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.value_and_grad(
        lambda p: RT.loss_fn(cfg_r, p, jb)[0])(params)
    assert not all(bool(jnp.isfinite(g).all())
                   for g in jax.tree.leaves(grads))
    tp = convert.model_params_from_numpy(
        cfg, jax.tree.map(np.asarray, params), device="cpu")
    tl, _, tg = TL.grads_of(cfg, tp, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
    assert abs(float(tl) - float(loss)) <= LOSS_TOL * abs(float(loss))
    assert all(bool(torch.isfinite(g).all()) for _, g in P.tree_leaves(tg))
