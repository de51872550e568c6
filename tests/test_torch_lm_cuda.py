"""The port's LM serving path on the card, on the smoke configs.

Marked ``cuda``: they need an NVIDIA card and skip elsewhere, deciding
inside a fixture. The LM path runs PyTorch operations only (no hand
kernel: the reference's LM reaches no Pallas kernel), so these hold the
card's results against the port's own CPU results and against its own
forward pass. Run them on the card with

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_lm_cuda.py

* decode against forward on the card for every smoke arch: prefill 29
  tokens, 3 teacher-forced decode steps, each within the reference's TOL
  (0.12 of the largest |logit| for the MoE archs, else 0.05) of the
  forward logits (phi3's LSH decode approximates attention: finite only);
* the card's forward logits within 1e-4 of the largest |logit| of the CPU's
  on the same float32 parameters (TF32 off);
* greedy tokens on the card equal the CPU's before the first near tie;
* an LSH decode past the cache's end raises on the card too (R8).
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data import synthetic
from repro_torch.models import params as P
from repro_torch.models import transformer as T
from repro_torch.serving import engine

pytestmark = pytest.mark.cuda

S, N_DECODE = 32, 3
TOL = {"mixtral-8x22b": 0.12, "llama4-maverick-400b-a17b": 0.12}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: this suite holds the card's LM path "
                    "against the CPU's")
    return torch.Generator(device="cuda").manual_seed(0)


def _setup(arch, gen):
    cfg = get_config(arch, "smoke")
    params = P.init_params(cfg, gen, device="cuda")
    dc = synthetic.DataConfig(batch_size=2, seq_len=S, seed=3)
    batch = synthetic.batch_at(dc, cfg, 0, device="cuda")
    return cfg, params, batch


def _prefix(batch, n):
    out = dict(batch)
    out["tokens"] = batch["tokens"][:, :n]
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_matches_forward_on_card(gen, arch):
    cfg, params, batch = _setup(arch, gen)
    with torch.inference_mode():
        logits = T.forward(cfg, params, batch)[0].float()
        s0 = S - N_DECODE
        last, cache = engine.make_prefill_step(cfg, S)(
            params, _prefix(batch, s0))
        outs = [last.float()]
        serve = engine.make_serve_step(cfg)
        for cur in range(s0, S):
            step, cache = serve(params, cache,
                                batch["tokens"][:, cur:cur + 1], cur)
            outs.append(step.float())
    assert all(bool(torch.isfinite(o).all()) for o in outs)
    if cfg.lsh_attention:
        return
    scale = max(float(logits.abs().max()), 1.0)
    errs = [float((o - logits[:, s0 - 1 + i]).abs().max())
            for i, o in enumerate(outs)]
    assert max(errs) < TOL.get(arch, 0.05) * scale, errs


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_card_forward_matches_cpu(gen, arch):
    cfg, params, batch = _setup(arch, gen)
    cpu = P.tree_map(lambda a: a.cpu(), params)
    with torch.inference_mode():
        got = T.forward(cfg, params, batch)[0].cpu()
        want = T.forward(cfg, cpu, {k: v.cpu() for k, v in batch.items()})[0]
    scale = max(float(want.abs().max()), 1.0)
    assert float((got - want).abs().max()) < 1e-4 * scale


@pytest.mark.parametrize("arch", ["stablelm-3b", "whisper-tiny",
                                  "llama4-maverick-400b-a17b", "zamba2-7b"])
def test_greedy_on_card_matches_cpu(gen, arch):
    cfg, params, batch = _setup(arch, gen)
    cpu = P.tree_map(lambda a: a.cpu(), params)
    pre = _prefix(batch, S - 4)
    got = engine.greedy_generate(cfg, params, pre, steps=4, max_len=S).cpu()
    want = engine.greedy_generate(cfg, cpu, {k: v.cpu() for k, v in
                                             pre.items()}, steps=4, max_len=S)
    assert got.dtype == torch.int32 and got.shape == (2, 4)
    # the first token comes from the prefill's logits: no earlier tie
    with torch.inference_mode():
        last, _ = T.prefill(cfg, cpu, {k: v.cpu() for k, v in pre.items()},
                            max_len=S)
    top = torch.topk(engine.mask_pad(cfg, last), 2).values
    decided = (top[:, 0] - top[:, 1]) > 1e-4 * float(last.abs().max())
    assert torch.equal(got[decided, 0], want[decided, 0])
    assert (got < cfg.vocab_size).all()


def test_lsh_decode_past_the_cache_raises_on_card(gen):
    cfg, params, batch = _setup("phi3-mini-3.8b", gen)
    pre = _prefix(batch, 8)
    last, cache = engine.make_prefill_step(cfg, 8)(params, pre)
    with pytest.raises(ValueError, match="R8"):
        engine.make_serve_step(cfg)(params, cache, pre["tokens"][:, :1], 8)
    assert np.isfinite(last.float().cpu().numpy()).all()
