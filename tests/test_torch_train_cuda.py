"""The port's training path on the card against its own CPU run, on the
smoke configs (float32).

Marked ``cuda``: they need an NVIDIA card and skip elsewhere, deciding
inside a fixture. Training runs PyTorch operations only (the reference's
training reaches no Pallas kernel), so these hold the card's results
against the port's CPU results on the same parameters and batch (TF32 off,
so both are float32 products in another summation order). Run them on the
card with

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_train_cuda.py

* every arch's loss within 1e-5 relative, every gradient leaf within
  GRAD_TOL of the leaf's largest |g|;
* the remat policies' gradients bit-equal on the card;
* one train step (AdamW, and with compression on factors carried from the
  CPU's draw) within PARAM_TOL of lr a parameter, a near-zero gradient of
  opposite sign allowed 2 * lr;
* ``launch.train.main`` on the card by default, and its checkpoints
  resume bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data import synthetic
from repro_torch.models import params as P
from repro_torch.training import compression as C
from repro_torch.training import optimizer as O
from repro_torch.training import train_loop as TL

pytestmark = pytest.mark.cuda

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 2e-2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: this suite holds the card's training "
                    "path against the CPU's")
    return torch.device("cuda")


def _setup(arch, seed=0):
    cfg = get_config(arch, "smoke")
    params = P.init_params(cfg, torch.Generator().manual_seed(seed),
                           device="cpu")
    dc = synthetic.DataConfig(batch_size=2, seq_len=32, seed=seed + 1)
    batch = synthetic.batch_at(dc, cfg, 0, device="cpu")
    return cfg, params, batch


def _to(tree, dev):
    """Copies on ``dev`` (the train step updates its state in place)."""
    return P.tree_map(lambda t: t.to(dev, copy=True), tree)


def _rel(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_gradients_match_cpu(card, arch):
    cfg, params, batch = _setup(arch)
    loss_c, _, g_c = TL.grads_of(cfg, params, batch)
    loss_g, _, g_g = TL.grads_of(cfg, _to(params, card), _to(batch, card))
    assert abs(float(loss_g) - float(loss_c)) <= LOSS_TOL * abs(float(loss_c))
    for (path, a), (_, b) in zip(P.tree_leaves(g_g), P.tree_leaves(g_c)):
        assert a.device.type == "cuda"
        assert bool(torch.isfinite(a).all()), path
        assert _rel(a, b) <= GRAD_TOL, path


@pytest.mark.parametrize("arch", ["stablelm-3b", "phi3-mini-3.8b",
                                  "mamba2-130m", "zamba2-7b"])
def test_remat_policies_bit_equal_on_card(card, arch):
    cfg, params, batch = _setup(arch)
    params, batch = _to(params, card), _to(batch, card)
    out = {}
    for policy in ("nothing", "dots", "none"):
        c = dataclasses.replace(cfg, remat_policy=policy)
        out[policy] = dict(P.tree_leaves(TL.grads_of(c, params, batch)[2]))
    for policy in ("dots", "none"):
        for path, g in out["nothing"].items():
            assert torch.equal(out[policy][path], g), (policy, path)


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("arch", ["stablelm-3b", "mamba2-130m"])
def test_train_step_matches_cpu(card, arch, compress):
    cfg, params, batch = _setup(arch, seed=2)
    comp = C.CompressionConfig(num_projections=16, min_size=1024) \
        if compress else None
    tc = TL.TrainConfig(adamw=O.AdamWConfig(peak_lr=1e-3, warmup_steps=1,
                                            decay_steps=10),
                        compression=comp)
    lr = tc.adamw.peak_lr

    def state_on(dev):
        p = _to(params, dev)
        cs = C.init_compressor(comp, p)[1] if compress else None
        return TL.TrainState(params=p, opt=O.init(p), compressor=cs)
    drawn = {}
    orig = C._factors

    def factors(cfg_, seed, step, i, d1, d2, device="cuda"):
        # the CPU's draw, carried to the card (generators differ by device)
        if i not in drawn:
            drawn[i] = orig(cfg_, seed, step, i, d1, d2, "cpu")
        return tuple(f.to(device) for f in drawn[i])
    C._factors = factors
    try:
        sc, mc = TL.make_train_step(cfg, tc, sketch=1234)(state_on("cpu"),
                                                          batch)
        sg, mg = TL.make_train_step(cfg, tc, sketch=1234)(
            state_on(card), _to(batch, card))
    finally:
        C._factors = orig
    assert set(mg) == set(mc)
    assert abs(float(mg["loss"]) - float(mc["loss"])) <= \
        LOSS_TOL * abs(float(mc["loss"]))
    g_cpu = dict(P.tree_leaves(TL.grads_of(cfg, params, batch)[2]))
    for (path, a), (_, b) in zip(P.tree_leaves(sg.params),
                                 P.tree_leaves(sc.params)):
        d = (a.cpu().double() - b.double()).abs().numpy()
        g = g_cpu[path].abs().numpy()
        near = g <= GRAD_TOL * g.max()
        assert float(d[~near].max(initial=0.0)) <= PARAM_TOL * lr, path
        assert float(d.max()) <= 2 * lr, path


def test_launcher_trains_and_resumes_on_card(card, tmp_path):
    from repro_torch.launch import train as launch
    from repro_torch.training.fault_tolerance import InjectedFailure
    args = ["--smoke", "--steps", "6", "--batch", "2", "--seq", "32",
            "--ckpt-every", "2"]
    with pytest.raises(InjectedFailure):
        launch.main(args + ["--ckpt-dir", str(tmp_path / "a"),
                            "--fail-at", "3"])
    a, hist = launch.train(args + ["--ckpt-dir", str(tmp_path / "a")])
    b, _ = launch.train(args + ["--ckpt-dir", str(tmp_path / "b")])
    assert len(hist) == 4
    assert a.params["final_norm"].device.type == "cuda"
    for (path, x), (_, y) in zip(P.tree_leaves(a.params),
                                 P.tree_leaves(b.params)):
        assert torch.equal(x, y), path
    for (path, x), (_, y) in zip(P.tree_leaves(a.opt.nu),
                                 P.tree_leaves(b.opt.nu)):
        assert torch.equal(x, y), path
    assert np.isfinite(hist[-1]["loss"])
