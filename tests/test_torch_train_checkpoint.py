"""Checkpoints, the fault-tolerant loop, the launcher and generation after
training, on the port and against the reference.

* a float32 smoke ``TrainState`` (with and without the compressor's
  error) saved by both packages gives byte-identical directories (every
  ``.npy`` file and ``manifest.json``), and each package restores the
  other's bit for bit;
* a bfloat16 state: the port writes the reference's bytes, round-trips
  its own directory and reads the reference's; the reference cannot
  restore it (caveat R10, pinned: ``jnp.asarray`` of the void array raises
  ``TypeError``);
* the reference's round-trip, async, corruption and partial-save tests;
* a crash at step 12 and a restart from step 10 end bit-identical to an
  uninterrupted run; the watchdog; the data's skip-ahead;
* ``launch.train.main`` on the CPU returns the history, and raises without
  ``--device cpu`` where there is no card;
* ``greedy_generate`` on trained parameters follows the learned bigram.
"""

import dataclasses
import filecmp
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import params as ref_params
from repro.training import checkpoint as ref_ckpt
from repro.training import compression as ref_comp
from repro.training import optimizer as ref_opt
from repro.training import train_loop as ref_tl
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.data.synthetic import DataConfig, batch_at, bigram_next
from repro_torch.launch import train as launch_train
from repro_torch.models import params as P
from repro_torch.serving.engine import greedy_generate
from repro_torch.training import checkpoint as ckpt_lib
from repro_torch.training import compression as comp_lib
from repro_torch.training import optimizer as opt_lib
from repro_torch.training import train_loop as TL
from repro_torch.training.fault_tolerance import (FailureInjector,
                                                  InjectedFailure,
                                                  StepWatchdog, run_training)

ARCH = "stablelm-3b"
CFG = get_config(ARCH, "smoke")


def _ref_state(compress: bool, dtype: str = "float32"):
    cfg = dataclasses.replace(ref_config(ARCH, "smoke"), dtype=dtype)
    params = ref_params.init_params(cfg, jax.random.PRNGKey(4))
    opt = ref_opt.init(params)
    # nonzero moments and step, as after training
    opt = ref_opt.OptState(
        step=jnp.asarray(7, jnp.int32),
        mu=jax.tree.map(lambda p: 0.5 * p.astype(jnp.float32), params),
        nu=jax.tree.map(lambda p: jnp.square(p.astype(jnp.float32)), params))
    comp = None
    if compress:
        _, comp = ref_comp.init_compressor(ref_comp.CompressionConfig(),
                                           params)
        comp = ref_comp.CompressorState(error=jax.tree.map(
            lambda p: 0.25 * p.astype(jnp.float32), params))
    return ref_tl.TrainState(params=params, opt=opt, compressor=comp)


def _port_state(ref_state, dtype: str = "float32"):
    cfg = dataclasses.replace(CFG, dtype=dtype)
    return convert.train_state_from_numpy(
        cfg, TL.TrainConfig(), jax.tree.map(np.asarray, ref_state),
        device="cpu")


def _same_dirs(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    _, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors, mismatch


def _equal_states(a, b):
    fa, fb = ckpt_lib._flatten(a), ckpt_lib._flatten(b)
    assert list(fa) == list(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        assert torch.equal(fa[k], fb[k]), k


@pytest.mark.parametrize("compress", [False, True])
def test_float32_directories_are_byte_identical(tmp_path, compress):
    rs = _ref_state(compress)
    ps = _port_state(rs)
    ref_ckpt.save(str(tmp_path / "ref"), 7, rs, meta={"arch": ARCH})
    ckpt_lib.save(str(tmp_path / "port"), 7, ps, meta={"arch": ARCH})
    _same_dirs(tmp_path / "ref" / "step_00000007",
               tmp_path / "port" / "step_00000007")
    with open(tmp_path / "port" / "step_00000007" / "manifest.json") as f:
        keys = list(json.load(f)["leaves"])
    assert ".params/blocks/wq" in keys and ".opt/.step" in keys
    assert (".compressor/.error/final_norm" in keys) == compress


@pytest.mark.parametrize("compress", [False, True])
def test_each_package_restores_the_other(tmp_path, compress):
    rs = _ref_state(compress)
    ps = _port_state(rs)
    ref_ckpt.save(str(tmp_path / "ref"), 3, rs)
    ckpt_lib.save(str(tmp_path / "port"), 3, ps)
    got, _ = ckpt_lib.restore(str(tmp_path / "ref"), 3, ps)
    _equal_states(got, ps)
    back, _ = ref_ckpt.restore(str(tmp_path / "port"), 3, rs)
    for (ka, a), (kb, b) in zip(ref_ckpt._flatten(back).items(),
                                ref_ckpt._flatten(rs).items()):
        assert ka == kb and a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_bf16_port_writes_the_reference_bytes_and_resumes(tmp_path):
    rs = _ref_state(False, "bfloat16")
    ps = _port_state(rs, "bfloat16")
    assert ps.params["blocks"]["wq"].dtype == torch.bfloat16
    ref_ckpt.save(str(tmp_path / "ref"), 2, rs)
    ckpt_lib.save(str(tmp_path / "port"), 2, ps)
    _same_dirs(tmp_path / "ref" / "step_00000002",
               tmp_path / "port" / "step_00000002")
    for d in ("ref", "port"):
        got, _ = ckpt_lib.restore(str(tmp_path / d), 2, ps)
        _equal_states(got, ps)


def test_r10_reference_cannot_restore_a_bf16_leaf(tmp_path):
    """R10: the reference saves a bfloat16 leaf as '<V2' bytes (manifest
    dtype "bfloat16") and its restore hands the void array to
    ``jnp.asarray``, which raises. The port reads it by the manifest."""
    rs = _ref_state(False, "bfloat16")
    ref_ckpt.save(str(tmp_path), 1, rs)
    with open(tmp_path / "step_00000001" / "manifest.json") as f:
        info = json.load(f)["leaves"][".params/blocks/wq"]
    assert info["dtype"] == "bfloat16"
    leaf = np.load(tmp_path / "step_00000001" / info["file"])
    assert leaf.dtype.kind == "V" and leaf.dtype.itemsize == 2
    with pytest.raises(TypeError, match="V2"):
        ref_ckpt.restore(str(tmp_path), 1, rs)
    got, _ = ckpt_lib.restore(str(tmp_path), 1, _port_state(rs, "bfloat16"))
    want = np.asarray(rs.params["blocks"]["wq"])
    assert np.array_equal(
        got.params["blocks"]["wq"].view(torch.int16).numpy(),
        want.view(np.int16))
    assert want.dtype == ml_dtypes.bfloat16


def _setup(tc=None, seed=0):
    tc = tc or TL.TrainConfig(adamw=opt_lib.AdamWConfig(
        peak_lr=1e-3, warmup_steps=5, decay_steps=100))
    state, sketch = TL.init_state(CFG, tc,
                                  torch.Generator().manual_seed(seed),
                                  device="cpu")
    step = TL.make_train_step(CFG, tc, sketch=sketch)
    dc = DataConfig(batch_size=4, seq_len=64, seed=seed)
    return state, step, dc


def test_roundtrip(tmp_path):
    state, step, dc = _setup()
    state, _ = step(state, batch_at(dc, CFG, 0, device="cpu"))
    ckpt_lib.save(str(tmp_path), 7, state, meta={"arch": CFG.name})
    restored, meta = ckpt_lib.restore(str(tmp_path), 7, state)
    _equal_states(restored, state)
    assert meta["arch"] == CFG.name
    assert ckpt_lib.latest_step(str(tmp_path)) == 7


def test_restore_into_abstract_state(tmp_path):
    state, _, _ = _setup()
    ckpt_lib.save(str(tmp_path), 1, state)
    like = TL.abstract_state(CFG, TL.TrainConfig())
    restored, _ = ckpt_lib.restore(str(tmp_path), 1, like, device="cpu")
    _equal_states(restored, state)


def test_async_save(tmp_path):
    state, _, _ = _setup()
    t = ckpt_lib.save(str(tmp_path), 3, state, async_=True)
    # the leaves were copied before the thread started
    state.params["final_norm"].add_(1.0)
    t.join()
    restored, _ = ckpt_lib.restore(str(tmp_path), 3, state)
    assert torch.equal(restored.params["final_norm"] + 1.0,
                       state.params["final_norm"])


def test_corruption_detected(tmp_path):
    state, _, _ = _setup()
    ckpt_lib.save(str(tmp_path), 1, state)
    leaf = os.path.join(str(tmp_path), "step_00000001", "leaf_00000.npy")
    arr = np.load(leaf)
    arr.reshape(-1)[0] += 1.0
    np.save(leaf, arr)
    with pytest.raises(IOError, match="corruption"):
        ckpt_lib.restore(str(tmp_path), 1, state)


def test_missing_leaf_detected(tmp_path):
    state, _, _ = _setup()
    ckpt_lib.save(str(tmp_path), 1, TL.TrainState(
        params={k: v for k, v in state.params.items() if k != "final_norm"},
        opt=state.opt))
    with pytest.raises(IOError, match="missing"):
        ckpt_lib.restore(str(tmp_path), 1, state)


def test_partial_save_is_invisible(tmp_path):
    """A .tmp dir (crash mid-save) must not count as a checkpoint."""
    state, _, _ = _setup()
    ckpt_lib.save(str(tmp_path), 5, state)
    os.makedirs(os.path.join(str(tmp_path), "step_00000009.tmp"))
    assert ckpt_lib.latest_step(str(tmp_path)) == 5


def test_restart_is_bit_identical(tmp_path):
    """Crash at step 12, restart, final state == uninterrupted run."""
    def run(ckpt_dir, injector):
        state0, step, dc = _setup(seed=3)
        return run_training(
            train_step=step, init_state_fn=lambda: state0,
            batch_fn=lambda s: batch_at(dc, CFG, s, device="cpu"),
            num_steps=20, ckpt_dir=ckpt_dir, ckpt_every=5,
            injector=injector, log_every=0, log_fn=lambda m: None)

    d1 = str(tmp_path / "a")
    with pytest.raises(InjectedFailure):
        run(d1, FailureInjector(fail_at_step=12))
    assert ckpt_lib.latest_step(d1) == 10
    logs = []
    state0, step, dc = _setup(seed=3)
    state_a, hist = run_training(
        train_step=step, init_state_fn=lambda: state0,
        batch_fn=lambda s: batch_at(dc, CFG, s, device="cpu"),
        num_steps=20, ckpt_dir=d1, ckpt_every=5, log_every=0,
        log_fn=logs.append)
    assert logs == ["[ft] resumed from checkpoint step 10"]
    assert len(hist) == 10
    state_b, _ = run(str(tmp_path / "b"), FailureInjector())
    _equal_states(state_a, state_b)


def test_watchdog_flags_stragglers():
    wd = StepWatchdog(threshold_x=2.0)
    seen = []
    wd.on_straggler = lambda step, dt, med: seen.append(step)
    for i in range(10):
        wd.observe(i, 0.1)
    wd.observe(10, 0.5)
    assert wd.straggler_steps == [10] and seen == [10]


def test_data_skip_ahead_determinism():
    dc = DataConfig(batch_size=2, seq_len=16, seed=9)
    b1 = batch_at(dc, CFG, 1234, device="cpu")
    b2 = batch_at(dc, CFG, 1234, device="cpu")
    assert torch.equal(b1["tokens"], b2["tokens"])
    b3 = batch_at(dc, CFG, 1235, device="cpu")
    assert not torch.equal(b1["tokens"], b3["tokens"])


def test_launcher_trains_on_the_cpu(tmp_path):
    out = tmp_path / "metrics.json"
    hist = launch_train.main(["--smoke", "--steps", "3", "--device", "cpu",
                              "--metrics-out", str(out)])
    assert len(hist) == 3
    assert set(hist[0]) == {"ce", "aux", "tokens", "grad_norm", "lr", "loss"}
    assert json.loads(out.read_text()) == hist


def test_launcher_resumes_after_an_injected_failure(tmp_path):
    args = ["--smoke", "--steps", "6", "--device", "cpu", "--batch", "2",
            "--seq", "16", "--ckpt-every", "2", "--compress"]
    with pytest.raises(InjectedFailure):
        launch_train.main(args + ["--ckpt-dir", str(tmp_path / "a"),
                                  "--fail-at", "3"])
    a, hist = launch_train.train(args + ["--ckpt-dir", str(tmp_path / "a")])
    assert len(hist) == 4 and "comm_ratio" in hist[0]
    b, _ = launch_train.train(args + ["--ckpt-dir", str(tmp_path / "b")])
    _equal_states(a, b)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
def test_launcher_defaults_to_the_card():
    with pytest.raises(RuntimeError, match="cuda"):
        launch_train.main(["--smoke", "--steps", "1"])


def test_greedy_generate_shapes():
    params = P.init_params(CFG, torch.Generator().manual_seed(0),
                           device="cpu")
    tokens = torch.randint(0, CFG.vocab_size, (2, 12),
                           generator=torch.Generator().manual_seed(1))
    out = greedy_generate(CFG, params, {"tokens": tokens}, steps=5,
                          max_len=32)
    assert out.shape == (2, 5)
    assert bool((out >= 0).all()) and bool((out < CFG.vocab_size).all())


def test_generation_follows_learned_bigram():
    """After training on the affine-bigram stream, greedy generation on
    the trained ``TrainState.params`` follows the rule far above chance."""
    tc = TL.TrainConfig(adamw=opt_lib.AdamWConfig(
        peak_lr=2e-3, warmup_steps=5, decay_steps=200))
    state, step, dc = _setup(tc=tc)
    for i in range(60):
        state, _ = step(state, batch_at(dc, CFG, i, device="cpu"))
    batch = batch_at(dc, CFG, 999, device="cpu")
    prompt = batch["tokens"][:, :48]
    out = greedy_generate(CFG, state.params, {"tokens": prompt}, steps=8,
                          max_len=64)
    prev = torch.cat([prompt[:, -1:], out[:, :-1]], dim=1)
    want = bigram_next(dc, CFG, prev)
    acc = float((out == want).float().mean())
    assert acc > 0.5, acc  # chance is 1/256
