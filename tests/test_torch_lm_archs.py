"""The port's LM serving path against the reference on the smoke archs
(dense, GQA, vision prefix, encoder-decoder, and phi3's CP-SRP LSH
attention): forward logits within PARITY of the largest |logit|, the
prefill's last logits and every cache leaf, three decode steps and their
cache (against the reference's decode with R9 repaired, see
``lm_bridge``), the port's own decode against its forward at the
reference's TOL and against the reference's forward at PARITY, and greedy
tokens equal to a reference greedy loop except after a near tie. phi3's LSH codes are held boundary-aware (``lm_bridge.SRPMargins``):
where every code is decided the outputs are held at PARITY. The MoE and
SSM archs are in test_torch_lm_archs_moe_ssm.py.
"""

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import numpy as np
import pytest

import lm_bridge as lb

ARCHS = ("stablelm-3b", "gemma-7b", "phi3-mini-3.8b", "mistral-large-123b",
         "pixtral-12b", "whisper-tiny")


def held(arch):
    """Outputs are compared at PARITY unless an LSH code is undecided."""
    return lb.codes_decided(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    ref, got = lb.reference(arch), lb.port(arch)
    assert got["forward"].shape == ref["forward"].shape
    assert np.isfinite(got["forward"]).all()
    if held(arch):
        assert lb.rel_err(got["forward"], ref["forward"],
                          ref["scale"]) < lb.PARITY


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_cache_match_reference(arch):
    ref, got = lb.reference(arch), lb.port(arch)
    assert [p for p, _ in got["cache"]] == [p for p, _ in ref["cache"]]
    for (path, a), (_, b) in zip(got["cache"], ref["cache"]):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if a.dtype.kind in "iu" and path != "layers/codes":
            np.testing.assert_array_equal(a, b, err_msg=path)
    if not held(arch):
        # an undecided code may differ, nothing else may
        codes = dict(got["cache"])["layers/codes"]
        assert (codes != dict(ref["cache"])["layers/codes"]).sum() <= \
            got["srp_near"]
        return
    assert lb.rel_err(got["prefill"], ref["prefill"],
                      ref["scale"]) < lb.PARITY
    for (path, a), (_, b) in zip(got["cache"], ref["cache"]):
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(a, b, err_msg=path)
        else:
            s = max(float(np.abs(b).max()), 1.0)
            assert lb.rel_err(a, b, s) < lb.PARITY, path


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch):
    ref, got = lb.reference(arch), lb.port(arch)
    for step, (a, b) in enumerate(zip(got["decode"], ref["decode"])):
        assert np.isfinite(a).all()
        if held(arch):
            assert lb.rel_err(a, b, ref["scale"]) < lb.PARITY, step
    if held(arch):
        for (path, a), (_, b) in zip(got["decode_cache"],
                                     ref["decode_cache"]):
            if a.dtype.kind in "iu":
                np.testing.assert_array_equal(a, b, err_msg=path)
            else:
                s = max(float(np.abs(b).max()), 1.0)
                assert lb.rel_err(a, b, s) < lb.PARITY, path


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_own_forward(arch):
    """The reference's decode-vs-forward property on the port alone
    (phi3's LSH decode approximates attention: finite only, as there)."""
    got = lb.port(arch)
    if arch == "phi3-mini-3.8b":
        assert all(np.isfinite(a).all() for a in got["decode"])
        return
    s0 = lb.S - lb.N_DECODE
    errs = [np.abs(got["prefill"] - got["forward"][:, s0 - 1]).max()]
    errs += [np.abs(a - got["forward"][:, s0 + i]).max()
             for i, a in enumerate(got["decode"])]
    scale = max(float(np.abs(got["forward"]).max()), 1.0)
    assert max(errs) < lb.tol(arch) * scale, errs


@pytest.mark.parametrize("arch", [a for a in ARCHS
                                  if a != "phi3-mini-3.8b"])
def test_decode_matches_reference_forward(arch):
    """With R9 repaired a decode step is the forward pass at its
    position: the port's prefill and decode logits against the
    reference's forward at PARITY (phi3's LSH decode selects candidates
    where its forward buckets: not an identity, so not held here)."""
    ref, got = lb.reference(arch), lb.port(arch)
    s0 = lb.S - lb.N_DECODE
    outs = [got["prefill"]] + got["decode"]
    for i, a in enumerate(outs):
        assert lb.rel_err(a, ref["forward"][:, s0 - 1 + i],
                          ref["scale"]) < lb.PARITY, i


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_matches_reference(arch):
    ref, got = lb.reference(arch), lb.port(arch)
    assert got["greedy"].shape == (lb.B, lb.GREEDY_STEPS)
    assert got["greedy"].dtype == np.int32
    vocab = lb.get_config(arch, "smoke").vocab_size
    assert (got["greedy"] >= 0).all() and (got["greedy"] < vocab).all()
    if held(arch):
        assert lb.greedy_agree(ref, got["greedy"], ref["scale"]), (
            got["greedy"], ref["greedy"], ref["greedy_gaps"])


def test_lsh_codes_decided_on_this_fixture():
    """Every SRP value of phi3's run lies off the boundary, so the phi3
    cases above hold the LSH outputs at PARITY, not only their codes."""
    got = lb.port("phi3-mini-3.8b")
    assert got["srp_values"] > 0
    assert got["srp_near"] == 0, got["srp_near"]
