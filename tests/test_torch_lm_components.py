"""The port's LM components against the reference's on the same numpy
inputs (both float32 on the CPU): layers, chunked and decode attention,
CP-SRP bucket codes (boundary-aware), LSH prefill and decode, the decode
candidates' tie rule (R7), the LSH cache's end (R8) and a decode step's
own token (R9), MoE routing and
dispatch, SSD and the causal conv, configs field by field, parameter specs
and counts for the ten full configs, the init laws, the synthetic data,
the parameter converter, the sharding rules, the ``LM`` module and the
engine's entry points.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.distributed import sharding as ref_sharding
from repro.models import attention as RA
from repro.models import layers as RL
from repro.models import lsh_attention as RLSH
from repro.models import moe as RM
from repro.models import params as RP
from repro.models import ssm as RS
from repro.models import transformer as RT
from repro_torch import configs, convert
from repro_torch.data import synthetic
from repro_torch.distributed import sharding
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import lsh_attention as LSH
from repro_torch.models import moe as M
from repro_torch.models import params as P
from repro_torch.models import ssm as SS
from repro_torch.models import transformer as T
from repro_torch.serving import engine

RTOL = 2e-5
U = 2.0 ** -24


def rng(seed):
    return np.random.default_rng(seed)


def normal(r, shape, scale=1.0):
    return (scale * r.standard_normal(shape)).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= rtol * scale, (err, scale)


def smoke(arch):
    return configs.get_config(arch, "smoke"), ref_configs.get_config(
        arch, "smoke")


def ref_tree(arch, seed=0):
    jcfg = ref_configs.get_config(arch, "smoke")
    return jax.tree.map(np.asarray,
                        RP.init_params(jcfg, jax.random.PRNGKey(seed)))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["stablelm-3b", "gemma-7b", "whisper-tiny",
                                  "phi3-mini-3.8b"])
def test_layers_match_reference(arch):
    cfg, jcfg = smoke(arch)
    r = rng(1)
    tree = ref_tree(arch)
    lp = {k: v[0] for k, v in tree["blocks"].items()}
    x = normal(r, (2, 7, cfg.d_model))
    scale = normal(r, (cfg.d_model,)) + 1.0
    close(L.rmsnorm(t(x), t(scale)), RL.rmsnorm(x, scale))
    close(L.layernorm(t(x), t(scale)), RL.layernorm(x, scale))
    close(L.norm(cfg, t(x), t(scale)), RL.norm(jcfg, x, scale))
    pos = np.tile(np.arange(7, dtype=np.int32) * 37, (2, 1))
    xh = normal(r, (2, 7, 3, 16))
    close(L.rope(t(xh), t(pos), 10_000.0), RL.rope(xh, pos, 10_000.0))
    g, u = normal(r, (2, 7, 5)), normal(r, (2, 7, 5))
    close(L.activation(cfg, t(g), t(u)), RL.activation(jcfg, g, u))
    close(L.mlp(cfg, {k: t(v) for k, v in lp.items()}, t(x)),
          RL.mlp(jcfg, lp, x))
    tokens = r.integers(0, cfg.vocab_size, (2, 7)).astype(np.int32)
    tp = convert.model_params_from_numpy(cfg, tree, device="cpu")
    close(L.embed_tokens(cfg, tp, t(tokens)),
          RL.embed_tokens(jcfg, tree, tokens))
    close(L.lm_logits(cfg, tp, t(x)), RL.lm_logits(jcfg, tree, x))


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_activations(act):
    cfg = dataclasses.replace(configs.get_config("stablelm-3b", "smoke"),
                              act=act)
    jcfg = dataclasses.replace(ref_configs.get_config("stablelm-3b", "smoke"),
                               act=act)
    r = rng(2)
    g, u = normal(r, (4, 9), 3.0), normal(r, (4, 9))
    close(L.activation(cfg, t(g), t(u)), RL.activation(jcfg, g, u))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal,window,kv_chunk", [
    (True, 0, 8), (True, 0, 16), (False, 0, 8), (True, 5, 8),
    (True, 12, 32),
])
def test_chunked_attention_matches_reference(causal, window, kv_chunk):
    r = rng(3)
    b, s, h, kvh, hd = 2, 29, 4, 2, 8
    q, k, v = (normal(r, (b, s, h, hd)), normal(r, (b, s, kvh, hd)),
               normal(r, (b, s, kvh, hd)))
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    got = A.chunked_attention(t(q), t(k), t(v), t(pos), t(pos),
                              causal=causal, window=window, kv_chunk=kv_chunk)
    want = RA.chunked_attention(q, k, v, pos, pos, causal=causal,
                                window=window, kv_chunk=kv_chunk)
    close(got, want)


@pytest.mark.parametrize("window", [0, 6])
def test_decode_attention_matches_reference(window):
    r = rng(4)
    b, w, h, kvh, hd = 2, 16, 4, 2, 8
    q = normal(r, (b, 1, h, hd))
    ck, cv = normal(r, (b, w, kvh, hd)), normal(r, (b, w, kvh, hd))
    cache_pos = np.full((w,), -1, np.int32)
    cache_pos[:11] = np.arange(11) + 5     # a ring with empty slots
    for cur in (9, 15):
        got = A.decode_attention(t(q), t(ck), t(cv), t(cache_pos), cur,
                                 window=window)
        want = RA.decode_attention(q, ck, cv, cache_pos, jnp.int32(cur),
                                   window=window)
        close(got, want)


def test_write_cache_is_a_ring_written_in_place():
    ck = torch.zeros((1, 4, 1, 2))
    cache = A.KVCache(ck, torch.zeros_like(ck))
    k = torch.ones((1, 1, 1, 2))
    out = A.write_cache(cache, k, 2 * k, 6)
    assert out.k is ck
    assert ck[0, 2].sum() == 2 and out.v[0, 2].sum() == 4
    assert ck.sum() == 2


# ---------------------------------------------------------------------------
# CP-SRP LSH attention
# ---------------------------------------------------------------------------


def srp_near(x, f1, f2, units=64.0):
    """Where the float32 value may take either sign: within ``units`` of
    U times its terms' absolute sum of 0 (float64)."""
    exact = LSH.srp_values(t(x).double(), t(f1), t(f2))
    mag = LSH.srp_values(t(np.abs(x)).double(), t(np.abs(f1)),
                         t(np.abs(f2)))
    return (exact.abs() <= units * U * mag).numpy()


@pytest.mark.parametrize("shape,k,m1,m2,r_", [
    ((6, 11), 5, 4, 8, 3), ((3, 40, 2), 8, 8, 12, 2), ((2, 9, 4), 4, 4, 4, 2),
])
def test_srp_bucket_codes_match_reference(shape, k, m1, m2, r_):
    r = rng(5)
    x = normal(r, shape + (m1 * m2,))
    f1, f2 = normal(r, (k, m1, r_)), normal(r, (k, m2, r_))
    got = LSH.srp_bucket_codes(t(x), t(f1), t(f2)).numpy()
    want = np.asarray(RLSH.srp_bucket_codes(x, f1, f2))
    assert got.dtype == np.int32 and got.shape == want.shape
    differ = got != want
    # a differing code has a bit whose value lies within the bound of 0
    near = srp_near(x, f1, f2).any(axis=-1)
    assert not (differ & ~near).any()
    assert differ.sum() <= near.sum()
    bits = ((got[..., None] >> np.arange(k)) & 1).astype(bool)
    vals = LSH.srp_values(t(x).double(), t(f1), t(f2)).numpy()
    assert ((bits == (vals > 0)) | srp_near(x, f1, f2)).all()


def _lsh_inputs(seed, b=1, s=64, kvh=4, g=1):
    cfg, jcfg = smoke("phi3-mini-3.8b")
    r = rng(seed)
    hd = cfg.hd
    k = normal(r, (b, s, kvh, hd))
    v = normal(r, (b, s, kvh, hd))
    qk = np.repeat(np.roll(k, 8, axis=1), g, axis=2)
    q = (qk * 4.0 + 0.1 * normal(r, qk.shape)).astype(np.float32)
    m1, m2 = P._factor_head_dim(hd)
    proj = {"f1": normal(r, (cfg.lsh_num_hashes, m1, cfg.lsh_rank)),
            "f2": normal(r, (cfg.lsh_num_hashes, m2, cfg.lsh_rank))}
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    return cfg, jcfg, q, k, v, proj, pos


def _decided(q, k, proj):
    return not (srp_near(q, proj["f1"], proj["f2"]).any()
                or srp_near(k, proj["f1"], proj["f2"]).any())


@pytest.mark.parametrize("s,g", [(64, 1), (61, 2), (13, 1)])
def test_lsh_prefill_matches_reference(s, g):
    cfg, jcfg, q, k, v, proj, pos = _lsh_inputs(6, b=2, s=s, kvh=4 // g, g=g)
    assert _decided(q, k, proj)
    got = LSH.lsh_attention_prefill(
        cfg, {n: t(a) for n, a in proj.items()}, t(q), t(k), t(v), t(pos))
    want = RLSH.lsh_attention_prefill(jcfg, proj, q, k, v, pos)
    close(got, want)


def test_bucket_order_is_lexsort():
    r = rng(7)
    codes = r.integers(0, 4, (2, 3, 50)).astype(np.int32)
    pos = np.tile(r.permutation(50).astype(np.int32), (2, 3, 1))
    codes[..., -5:] = LSH.PAD_CODE
    pos[..., -5:] = LSH.PAD_POS
    got = LSH._bucket_order(t(codes), t(pos)).numpy()
    want = np.asarray(jnp.lexsort((pos, codes), axis=-1))
    np.testing.assert_array_equal(got, want)


def _lsh_cache(cfg, r, b, w, kvh, filled):
    hd = cfg.hd
    ck, cv = normal(r, (b, w, kvh, hd)), normal(r, (b, w, kvh, hd))
    codes = r.integers(0, 1 << cfg.lsh_num_hashes, (b, w, kvh)).astype(
        np.int32)
    cache_pos = np.full((w,), -1, np.int32)
    cache_pos[:filled] = np.arange(filled)
    return ck, cv, codes, cache_pos


@pytest.mark.parametrize("cur", [20, 47])
def test_lsh_decode_matches_reference(cur):
    cfg, jcfg = smoke("phi3-mini-3.8b")
    r = rng(8)
    b, w, kvh = 2, 48, cfg.n_kv_heads
    ck, cv, codes, cache_pos = _lsh_cache(cfg, r, b, w, kvh, cur)
    q = normal(r, (b, 1, cfg.n_heads, cfg.hd))
    m1, m2 = P._factor_head_dim(cfg.hd)
    proj = {"f1": normal(r, (cfg.lsh_num_hashes, m1, cfg.lsh_rank)),
            "f2": normal(r, (cfg.lsh_num_hashes, m2, cfg.lsh_rank))}
    assert not srp_near(q, proj["f1"], proj["f2"]).any()
    got = LSH.lsh_attention_decode(
        cfg, {n: t(a) for n, a in proj.items()}, t(q),
        LSH.LSHKVCache(t(ck), t(cv), t(codes)), t(cache_pos), cur)
    want = RLSH.lsh_attention_decode(
        jcfg, proj, q, RLSH.LSHKVCache(ck, cv, codes), cache_pos,
        jnp.int32(cur))
    close(got, want)


def test_r7_candidate_ties_pick_the_reference_indices():
    """R7: the selection score recent * 4e9 + match * 2e9 + position is
    float32, whose spacing near 6e9 is 512, so hundreds of recent,
    matching slots share a score; ``jax.lax.top_k`` then keeps the lower
    (older) indices, and so must the port."""
    cfg, jcfg = smoke("phi3-mini-3.8b")
    cfg = dataclasses.replace(cfg, lsh_recent=1024, lsh_candidates=5)
    jcfg = dataclasses.replace(jcfg, lsh_recent=1024, lsh_candidates=5)
    r = rng(9)
    b, w, kvh = 1, 640, cfg.n_kv_heads
    ck, cv, codes, cache_pos = _lsh_cache(cfg, r, b, w, kvh, 600)
    q = normal(r, (b, 1, cfg.n_heads, cfg.hd))
    m1, m2 = P._factor_head_dim(cfg.hd)
    proj = {"f1": normal(r, (cfg.lsh_num_hashes, m1, cfg.lsh_rank)),
            "f2": normal(r, (cfg.lsh_num_hashes, m2, cfg.lsh_rank))}
    qc = np.asarray(RLSH.srp_bucket_codes(q, proj["f1"], proj["f2"]))[:, 0]
    codes[:] = qc[:, None, :]               # every slot matches its head
    cur = 599
    sel = np.float32(4e9) + np.float32(2e9) + cache_pos[:600].astype(
        np.float32)
    assert len(np.unique(sel)) <= 3         # 600 slots, a few scores
    scores = np.broadcast_to(
        np.where(cache_pos >= 0, np.pad(sel, (0, w - 600)), -1.0)
        .astype(np.float32), (b, cfg.n_heads, w))
    got_idx = L.top_k(t(np.ascontiguousarray(scores)), 5)[1].numpy()
    want_idx = np.asarray(jax.lax.top_k(scores, 5)[1])
    np.testing.assert_array_equal(got_idx, want_idx)
    got = LSH.lsh_attention_decode(
        cfg, {n: t(a) for n, a in proj.items()}, t(q),
        LSH.LSHKVCache(t(ck), t(cv), t(codes)), t(cache_pos), cur)
    want = RLSH.lsh_attention_decode(
        jcfg, proj, q, RLSH.LSHKVCache(ck, cv, codes), cache_pos,
        jnp.int32(cur))
    close(got, want)


def test_r8_lsh_decode_past_the_cache_raises():
    """R8: the reference's dynamic_update_slice clamps a write past the
    LSH cache onto its last slot; the port refuses the decode."""
    cfg = configs.get_config("phi3-mini-3.8b", "smoke")
    tree = convert.model_params_from_numpy(cfg, ref_tree("phi3-mini-3.8b"),
                                           device="cpu")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, 8))}
    with torch.inference_mode():
        _, cache = T.prefill(cfg, tree, batch, max_len=8)
        with pytest.raises(ValueError, match="R8"):
            T.decode_step(cfg, tree, batch["tokens"][:, :1], cache, 8)
    with pytest.raises(ValueError, match="max_len"):
        engine.greedy_generate(cfg, tree, batch, steps=2, max_len=8)


def test_r9_decode_sees_its_own_token():
    """R9: the reference's decode attends over its cache before it writes
    the token's K/V, so the token's own key is left out and the step
    drifts from the forward pass; the port writes first, so its decode is
    the forward pass at that position."""
    cfg, jcfg = smoke("stablelm-3b")
    tree = ref_tree("stablelm-3b")
    s = 48
    tokens = rng(16).integers(0, cfg.vocab_size, (2, s)).astype(np.int32)
    want = np.asarray(RT.forward(jcfg, tree, {"tokens": tokens})[0])[:, -1]
    _, jc = RT.prefill(jcfg, tree, {"tokens": tokens[:, :-1]}, max_len=s)
    ref_step, _ = RT.decode_step(jcfg, tree, tokens[:, -1:], jc,
                                 jnp.int32(s - 1))
    tp = convert.model_params_from_numpy(cfg, tree, device="cpu")
    with torch.inference_mode():
        _, c = T.prefill(cfg, tp, {"tokens": t(tokens[:, :-1])}, max_len=s)
        got, c = T.decode_step(cfg, tp, t(tokens[:, -1:]), c, s - 1)
    assert int(c.pos[s - 1]) == s - 1
    scale = max(float(np.abs(want).max()), 1.0)
    port_err = float(np.abs(got.numpy() - want).max()) / scale
    ref_err = float(np.abs(np.asarray(ref_step) - want).max()) / scale
    assert port_err < 1e-5
    assert ref_err > 100 * port_err and ref_err > 1e-4


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def _moe(arch, cf, seed, s=16):
    cfg, jcfg = smoke(arch)
    cfg = dataclasses.replace(cfg, capacity_factor=cf)
    jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
    tree = ref_tree(arch, seed)
    lp = {k: v[0] for k, v in tree["blocks"].items()}
    x = normal(rng(seed), (2, s, cfg.d_model))
    return cfg, jcfg, lp, {k: t(v) for k, v in lp.items()}, x


@pytest.mark.parametrize("arch,cf", [("mixtral-8x22b", 8.0),
                                     ("mixtral-8x22b", 1.0),
                                     ("llama4-maverick-400b-a17b", 1.5)])
def test_moe_block_matches_reference(arch, cf):
    cfg, jcfg, lp, tlp, x = _moe(arch, cf, 10, s=32)
    h = np.asarray(RL.norm(jcfg, x, lp["mlp_ln"])).reshape(-1, cfg.d_model)
    logits = h @ lp["router"]
    srt = np.sort(logits, axis=-1)[:, ::-1]
    gap = srt[:, cfg.top_k - 1] - srt[:, cfg.top_k]
    assert (gap > 1e-4 * np.abs(logits).max()).all()   # choices decided
    routing = M.route(cfg, tlp, L.norm(cfg, t(x), tlp["mlp_ln"]).reshape(
        -1, cfg.d_model))
    want_idx = np.asarray(jax.lax.top_k(jnp.asarray(logits), cfg.top_k)[1])
    np.testing.assert_array_equal(routing.top_idx.numpy(), want_idx)
    got, aux = M.moe_block(cfg, tlp, t(x))
    want, waux = RM.moe_block(jcfg, lp, x)
    close(got, want)
    close(aux, waux)


def test_moe_dispatch_equals_dense_reference():
    """Ample capacity (no drops): the slot dispatch equals every expert
    on every token, as the reference's own test holds it."""
    cfg, jcfg, lp, tlp, x = _moe("mixtral-8x22b", 8.0, 11)
    got, aux = M.moe_block(cfg, tlp, t(x))
    close(got, M.moe_block_dense_reference(cfg, tlp, t(x)), 5e-4)
    close(M.moe_block_dense_reference(cfg, tlp, t(x)),
          RM.moe_block_dense_reference(jcfg, lp, x))
    assert float(aux) > 0.0


def test_moe_capacity_drops_in_arrival_order():
    cfg, _, _, tlp, x = _moe("mixtral-8x22b", 1.0, 12, s=32)
    ht = L.norm(cfg, t(x), tlp["mlp_ln"]).reshape(-1, cfg.d_model)
    r = M.route(cfg, tlp, ht)
    assert r.capacity == max(math.ceil(64 * 2 / 4 * 1.0), 4)
    flat = r.top_idx.reshape(-1).numpy()
    for e in range(cfg.n_experts):
        kept = r.keep.numpy()[flat == e]
        n_keep = min(int((flat == e).sum()), r.capacity)
        assert kept[:n_keep].all() and not kept[n_keep:].any()
    assert not r.keep.all()                 # this batch drops some


def test_top_k_ties_keep_the_lower_index():
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.5, 3.0]])
    vals, idx = L.top_k(logits, 2)
    np.testing.assert_array_equal(
        idx.numpy(), np.asarray(jax.lax.top_k(logits.numpy(), 2)[1]))
    np.testing.assert_array_equal(
        vals.numpy(), np.asarray(jax.lax.top_k(logits.numpy(), 2)[0]))


# ---------------------------------------------------------------------------
# SSD
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [4, 8, 16, 64])
def test_ssd_chunked_matches_reference_and_recurrence(chunk):
    r = rng(13)
    b, s, h, p, n = 2, 33, 3, 4, 5
    x = normal(r, (b, s, h, p))
    dt = np.log1p(np.exp(normal(r, (b, s, h)))).astype(np.float32)
    a = (-np.exp(normal(r, (h,)))).astype(np.float32)
    bm, cm = normal(r, (b, s, h, n)), normal(r, (b, s, h, n))
    init = normal(r, (b, h, p, n))
    y, final = SS.ssd_chunked(t(x), t(dt), t(a), t(bm), t(cm), chunk,
                              init_state=t(init))
    wy, wfinal = RS.ssd_chunked(x, dt, a, bm, cm, chunk, init_state=init)
    close(y, wy, 1e-4)
    close(final, wfinal, 1e-4)
    state = t(init)
    ys = []
    for i in range(s):
        y_i, state = SS.ssd_decode_step(state, t(x[:, i]), t(dt[:, i]),
                                        t(a), t(bm[:, i]), t(cm[:, i]))
        ys.append(y_i)
    close(y, torch.stack(ys, dim=1).numpy(), 2e-4)
    close(final, state.numpy(), 2e-4)


def test_causal_conv_and_split_match_reference():
    cfg, jcfg = smoke("mamba2-130m")
    r = rng(14)
    x = normal(r, (2, 11, cfg.conv_channels))
    w = normal(r, (cfg.conv_width, cfg.conv_channels))
    close(SS.causal_conv(t(x), t(w)), RS.causal_conv(x, w))
    for got, want in zip(SS._split_xbc(cfg, t(x)), RS._split_xbc(jcfg, x)):
        close(got, want)
    bm = normal(r, (2, 11, cfg.ssm_groups, cfg.ssm_state))
    close(SS._rep_groups(cfg, t(bm)), RS._rep_groups(jcfg, bm))


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-7b"])
def test_ssm_block_prefill_and_decode_match_reference(arch):
    cfg, jcfg = smoke(arch)
    tree = ref_tree(arch, 15)
    lp = {k: v[0] for k, v in tree["blocks"].items()}
    tlp = {k: t(v) for k, v in lp.items()}
    x = normal(rng(15), (2, 13, cfg.d_model))
    y, cache = SS.ssm_block(cfg, tlp, t(x[:, :12]))
    wy, wcache = RS.ssm_block(jcfg, lp, x[:, :12])
    close(y, wy, 1e-4)
    close(cache.state, wcache.state, 1e-4)
    close(cache.conv, wcache.conv)
    y1, c1 = SS.ssm_block(cfg, tlp, t(x[:, 12:]), cache=cache)
    wy1, wc1 = RS.ssm_block(jcfg, lp, x[:, 12:], cache=wcache)
    close(y1, wy1, 1e-4)
    close(c1.state, wc1.state, 1e-4)


# ---------------------------------------------------------------------------
# configs, specs, counts, init
# ---------------------------------------------------------------------------


def _variants(mod):
    return [getattr(mod, n) for n in ("CONFIG", "SMOKE", "LONG_CONTEXT")
            if hasattr(mod, n)]


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_configs_equal_reference_field_by_field(arch):
    for variant in ("full", "smoke", "long"):
        got = configs.get_config(arch, variant)
        want = ref_configs.get_config(arch, variant)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        for prop in ("padded_vocab", "hd", "d_inner", "ssm_heads",
                     "conv_channels", "is_ssm_block",
                     "active_params_per_token_experts"):
            assert getattr(got, prop) == getattr(want, prop), prop
        assert got.validate() is got
    assert configs.supports_long_context(arch) == \
        ref_configs.supports_long_context(arch)
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert configs.LONG_CONTEXT_ARCHS == ref_configs.LONG_CONTEXT_ARCHS


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_specs_and_counts_equal_reference(arch):
    cfg = configs.get_config(arch, "full")
    jcfg = ref_configs.get_config(arch, "full")
    got = P.tree_leaves(P.param_specs(cfg))
    want = jax.tree_util.tree_flatten_with_path(
        RP.param_specs(jcfg), is_leaf=lambda s: isinstance(s, RP.ParamSpec))[0]
    want = [("/".join(k.key for k in path), s) for path, s in want]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert (a.shape, a.axes, a.init, a.scale) == \
            (b.shape, b.axes, b.init, b.scale), path
    assert P.count_params(cfg) == RP.count_params(jcfg)
    assert P.count_active_params(cfg) == RP.count_active_params(jcfg)
    assert P.param_axes(cfg) == RP.param_axes(jcfg)
    meta = P.tree_leaves(P.abstract_params(cfg))
    assert all(a.device.type == "meta" and a.dtype == torch.bfloat16
               for _, a in meta)
    assert [tuple(a.shape) for _, a in meta] == [s.shape for _, s in got]


def test_init_params_laws(monkeypatch):
    monkeypatch.setattr(P, "DRAW_CHUNK", 1000)    # slices, as on the card
    cfg = dataclasses.replace(configs.get_config("zamba2-7b", "smoke"),
                              d_model=128)
    gen = torch.Generator().manual_seed(3)
    tree = P.init_params(cfg, gen, device="cpu")
    specs = dict(P.tree_leaves(P.param_specs(cfg)))
    for path, a in P.tree_leaves(tree):
        spec = specs[path]
        assert tuple(a.shape) == spec.shape and a.dtype == torch.float32
        if spec.init == "ones":
            assert (a == 1).all()
        elif spec.init == "ssm_a":
            assert (a >= 0).all() and (a < math.log(16.0)).all()
        elif spec.init == "ssm_dt":
            dt = torch.nn.functional.softplus(a)
            assert (dt >= 1e-3 * 0.999).all() and (dt <= 1e-1 * 1.001).all()
        elif a.numel() >= 4096:
            std = float(a.std())
            assert abs(std / spec.scale - 1.0) < 0.05, path
            assert abs(float(a.mean())) < 4 * spec.scale / math.sqrt(
                a.numel()), path
    again = P.init_params(cfg, torch.Generator().manual_seed(3),
                          device="cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(P.tree_leaves(tree), P.tree_leaves(again)))
    bf = P.init_params(dataclasses.replace(cfg, dtype="bfloat16"),
                       torch.Generator().manual_seed(3), device="cpu")
    assert all(a.dtype == torch.bfloat16 for _, a in P.tree_leaves(bf))


# ---------------------------------------------------------------------------
# data, converter, sharding, module, engine
# ---------------------------------------------------------------------------


def test_batch_at_is_a_pure_function_of_seed_and_step():
    cfg = configs.get_config("pixtral-12b", "smoke")
    dc = synthetic.DataConfig(batch_size=4, seq_len=64, seed=5,
                              noise_prob=0.1)
    a = synthetic.batch_at(dc, cfg, 7, device="cpu")
    b = synthetic.batch_at(dc, cfg, 7, device="cpu")
    c = synthetic.batch_at(dc, cfg, 8, device="cpu")
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["tokens"], c["tokens"])
    tok = a["tokens"]
    assert tok.dtype == torch.int32 and tuple(tok.shape) == (4, 64)
    assert a["vision_embeds"].shape == (4, cfg.vision_tokens, cfg.d_model)
    assert (a["labels"][:, :cfg.vision_tokens] == -1).all()
    np.testing.assert_array_equal(a["labels"][:, cfg.vision_tokens:-1],
                                  tok[:, cfg.vision_tokens + 1:])
    assert (a["labels"][:, -1] == -1).all()


def test_batch_at_bigram_rule_and_noise_rate():
    cfg = configs.get_config("whisper-tiny", "smoke")
    dc = synthetic.DataConfig(batch_size=64, seq_len=256, seed=1)
    batch = synthetic.batch_at(dc, cfg, 0, device="cpu")
    tok = batch["tokens"].long()
    follows = synthetic.bigram_next(dc, cfg, tok[:, :-1]) == tok[:, 1:]
    # a pair breaks where either token is noise: ~2 * noise_prob
    rate = 1.0 - float(follows.float().mean())
    assert abs(rate - 2 * dc.noise_prob) < 0.01, rate
    assert (tok >= 0).all() and (tok < cfg.vocab_size).all()
    assert batch["frames"].shape == (64, cfg.encoder_seq, cfg.d_model)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_model_params_round_trip(arch):
    cfg = configs.get_config(arch, "smoke")
    tree = ref_tree(arch)
    got = convert.model_params_from_numpy(cfg, tree, device="cpu")
    want = jax.tree_util.tree_flatten_with_path(tree)[0]
    leaves = P.tree_leaves(got)
    assert [p for p, _ in leaves] == ["/".join(k.key for k in path)
                                      for path, _ in want]
    for (path, a), (_, b) in zip(leaves, want):
        assert a.dtype == P.torch_dtype(cfg) and a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), b, err_msg=path)
    bf = dataclasses.replace(cfg, dtype="bfloat16")
    bft = convert.model_params_from_numpy(
        bf, jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                         tree), device="cpu")
    assert all(a.dtype == torch.bfloat16 for _, a in P.tree_leaves(bft))
    tree = dict(tree)
    tree.pop("final_norm")
    with pytest.raises(ValueError, match="final_norm"):
        convert.model_params_from_numpy(cfg, tree, device="cpu")


def test_resolve_spec_matches_reference_rules():
    mesh = sharding.Mesh(np.array([torch.device("cpu")] * 8).reshape(2, 4),
                         ("data", "model"))
    cases = [(("batch", "seq", "heads", None), (4, 7, 8, 16)),
             (("batch", "seq", "heads", None), (4, 7, 6, 16)),
             (("expert", "capacity", "moe_d"), (8, 10, 64)),
             (("fsdp_embed", "mlp"), (64, 96)),
             (("heads", "kv_heads"), (8, 8))]
    for names, shape in cases:
        with sharding.axis_rules(mesh) as ctx:
            got = sharding.resolve_spec(names, shape)
            fallbacks = list(ctx.fallbacks)
        with ref_sharding.axis_rules(mesh) as rctx:
            want = ref_sharding.resolve_spec(names, shape)
            assert fallbacks == rctx.fallbacks
        assert got == tuple(want), (names, shape)
    assert sharding.resolve_spec(("batch",), (4,)) == ()
    x = torch.zeros(4, 6)
    with sharding.axis_rules(mesh) as ctx:
        assert sharding.shard(x, "batch", "heads") is x
        assert ctx.fallbacks == [("heads", 6, ("model",))]


def test_lm_module_holds_the_tree():
    cfg = configs.get_config("mixtral-8x22b", "smoke")
    tree = convert.model_params_from_numpy(cfg, ref_tree("mixtral-8x22b"),
                                           device="cpu")
    lm = T.LM(cfg, tree)
    back = lm.tree()
    assert [p for p, _ in P.tree_leaves(back)] == \
        [p for p, _ in P.tree_leaves(tree)]
    assert all(a is not None and not a.requires_grad
               for _, a in P.tree_leaves(back))
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 9),
                                     generator=torch.Generator()
                                     .manual_seed(0))}
    with torch.inference_mode():
        assert torch.equal(lm(batch), T.forward(cfg, tree, batch)[0])
    steps = engine.greedy_generate(cfg, lm, batch, steps=3, max_len=12)
    assert torch.equal(steps, engine.greedy_generate(cfg, tree, batch,
                                                     steps=3, max_len=12))


def test_engine_sampling_draws_from_the_generator():
    cfg = configs.get_config("stablelm-3b", "smoke")
    tree = convert.model_params_from_numpy(cfg, ref_tree("stablelm-3b"),
                                           device="cpu")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (3, 6),
                                     generator=torch.Generator()
                                     .manual_seed(1))}

    def draw(seed):
        return engine.greedy_generate(
            cfg, tree, batch, steps=5, max_len=12, temperature=1.0,
            generator=torch.Generator().manual_seed(seed))
    a, b = draw(4), draw(4)
    assert torch.equal(a, b)
    assert (a < cfg.vocab_size).all()
    greedy = engine.greedy_generate(cfg, tree, batch, steps=5, max_len=12)
    assert torch.equal(a[:, 0], greedy[:, 0])   # the first is argmax
    logits = torch.zeros((2, cfg.padded_vocab))
    logits[:, cfg.vocab_size:] = 10.0
    assert (engine.mask_pad(dataclasses.replace(cfg, vocab_size=200),
                            logits)[:, 200:] == float("-inf")).all()


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    cfg = configs.get_config("stablelm-3b", "smoke")
    with pytest.raises(RuntimeError, match="cuda"):
        P.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="cuda"):
        T.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        synthetic.batch_at(synthetic.DataConfig(), cfg, 0)
    with pytest.raises(RuntimeError, match="cuda"):
        convert.model_params_from_numpy(cfg, ref_tree("stablelm-3b"))
