"""The port's LM serving path against the reference on the MoE and SSM
smoke archs (mixtral: top-2 of 4 experts and a sliding window; llama4:
alternating dense / MoE layers with a shared expert; mamba2: SSD; zamba2:
SSD groups with a weight-shared attention block): forward logits within
PARITY of the largest |logit|, the prefill's last logits and every cache
leaf, three decode steps and their cache (against the reference's decode
with R9 repaired, see ``lm_bridge``), the port's own decode against its
forward at the reference's TOL and against the reference's forward (at
PARITY; the MoE archs at TOL), and greedy tokens equal to a reference
greedy loop except after a near tie. The dense archs are in
test_torch_lm_archs.py.
"""

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import numpy as np
import pytest

import lm_bridge as lb

ARCHS = ("mixtral-8x22b", "llama4-maverick-400b-a17b", "mamba2-130m",
         "zamba2-7b")


def leaves_close(got, ref) -> None:
    assert [p for p, _ in got] == [p for p, _ in ref]
    for (path, a), (_, b) in zip(got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(a, b, err_msg=path)
        else:
            s = max(float(np.abs(b).max()), 1.0)
            assert lb.rel_err(a, b, s) < lb.PARITY, path


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    ref, got = lb.reference(arch), lb.port(arch)
    assert got["forward"].shape == ref["forward"].shape
    assert np.isfinite(got["forward"]).all()
    assert lb.rel_err(got["forward"], ref["forward"],
                      ref["scale"]) < lb.PARITY


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_cache_match_reference(arch):
    ref, got = lb.reference(arch), lb.port(arch)
    assert lb.rel_err(got["prefill"], ref["prefill"],
                      ref["scale"]) < lb.PARITY
    leaves_close(got["cache"], ref["cache"])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch):
    ref, got = lb.reference(arch), lb.port(arch)
    for step, (a, b) in enumerate(zip(got["decode"], ref["decode"])):
        assert lb.rel_err(a, b, ref["scale"]) < lb.PARITY, step
    leaves_close(got["decode_cache"], ref["decode_cache"])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_own_forward(arch):
    """The reference's decode-vs-forward property on the port alone."""
    got = lb.port(arch)
    s0 = lb.S - lb.N_DECODE
    errs = [np.abs(got["prefill"] - got["forward"][:, s0 - 1]).max()]
    errs += [np.abs(a - got["forward"][:, s0 + i]).max()
             for i, a in enumerate(got["decode"])]
    scale = max(float(np.abs(got["forward"]).max()), 1.0)
    assert max(errs) < lb.tol(arch) * scale, errs


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference_forward(arch):
    """With R9 repaired a decode step is the forward pass at its
    position: the port's prefill and decode logits against the
    reference's forward at PARITY (the MoE archs at TOL: the forward's
    batch routes near capacity, a decode step's never does)."""
    ref, got = lb.reference(arch), lb.port(arch)
    cfg = lb.get_config(arch, "smoke")
    s0 = lb.S - lb.N_DECODE
    limit = lb.tol(arch) if cfg.n_experts else lb.PARITY
    outs = [got["prefill"]] + got["decode"]
    for i, a in enumerate(outs):
        assert lb.rel_err(a, ref["forward"][:, s0 - 1 + i],
                          ref["scale"]) < limit, i


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_matches_reference(arch):
    ref, got = lb.reference(arch), lb.port(arch)
    assert got["greedy"].shape == (lb.B, lb.GREEDY_STEPS)
    assert got["greedy"].dtype == np.int32
    vocab = lb.get_config(arch, "smoke").vocab_size
    assert (got["greedy"] >= 0).all() and (got["greedy"] < vocab).all()
    assert lb.greedy_agree(ref, got["greedy"], ref["scale"]), (
        got["greedy"], ref["greedy"], ref["greedy_gaps"])
