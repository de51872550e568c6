"""Shared runs of the LM parity suites (tests/test_torch_lm_*.py).

Each smoke arch runs once a module through the reference (``repro``, JAX
on the CPU, jitted) and through the port (``repro_torch`` on the CPU) on
the same inputs: the reference's seeded parameters carried across by
``convert.model_params_from_numpy``, a batch made with numpy from a seed.
A run holds the forward logits, the prefill's last logits and cache, three
teacher-forced decode steps and a greedy loop on each side; the suites
compare them.

The reference's decode attends over its cache before it writes the
token's own K/V there, so a decode step leaves the token's own key out
(caveat R9); the port writes first. The reference's decode runs here with
R9 repaired by ``reference_r9_repaired``: its own attention sub-blocks,
reassembled to write before they attend (no file of the reference
changes), which is what the port's decode is held against.

Not a test module: pytest puts this directory on sys.path, so the suites
``import lm_bridge``.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_config
from repro.models import attention as RA
from repro.models import layers as RL
from repro.models import lsh_attention as RLSH
from repro.models import params as ref_params
from repro.models import transformer as RT
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import lsh_attention
from repro_torch.models import transformer as T
from repro_torch.serving import engine

B, S, N_DECODE, GREEDY_STEPS = 2, 32, 3, 4
# the port against the reference, both float32: reduction order only
PARITY = 1e-4
# decode against forward (the reference's tests/test_models_smoke.py TOL):
# MoE capacity drops depend on the batch's token count, so prefill and
# decode route differently near capacity
TOL = {"mixtral-8x22b": 0.12, "llama4-maverick-400b-a17b": 0.12}
# an SRP value whose magnitude is within this many float32 units of its
# terms' absolute sum may take either sign on the two sides: the q / k
# vectors themselves agree to a few units (the logits to ~2e-7)
SRP_NEAR_UNITS = 64.0
U = 2.0 ** -24


def tol(arch: str) -> float:
    return TOL.get(arch, 0.05)


def make_batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.vision_tokens:
        batch["vision_embeds"] = rng.standard_normal(
            (b, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.encoder_decoder:
        batch["frames"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def prefix(batch, n):
    out = dict(batch)
    out["tokens"] = batch["tokens"][:, :n]
    return out


def cache_leaves(cache, prefix_=""):
    """(path, numpy array) of a cache's tensors (port or reference), None
    fields skipped, NamedTuple fields by name."""
    if cache is None:
        return []
    if isinstance(cache, tuple):
        names = getattr(cache, "_fields", None) or [
            str(i) for i in range(len(cache))]
        out = []
        for name, v in zip(names, cache):
            out += cache_leaves(v, f"{prefix_}{name}/")
        return out
    if isinstance(cache, torch.Tensor):
        return [(prefix_[:-1], cache.detach().cpu().numpy())]
    return [(prefix_[:-1], np.asarray(cache))]


def masked_argmax(cfg, logits):
    logits = np.array(logits, dtype=np.float32)
    logits[..., cfg.vocab_size:] = -np.inf
    return logits.argmax(-1)


def top2_gap(cfg, logits):
    part = np.sort(np.asarray(logits)[..., :cfg.vocab_size], axis=-1)
    return part[..., -1] - part[..., -2]


class SRPMargins:
    """Wraps ``lsh_attention.srp_values`` to count values within
    ``SRP_NEAR_UNITS`` float32 units of their terms' absolute sum of 0,
    evaluated in float64 on the same inputs. A zero vector (a padded
    token) gives 0 on both sides, whatever the order: not counted."""

    def __init__(self):
        self.near = 0
        self.values = 0
        self._orig = lsh_attention.srp_values

    def __call__(self, x, f1, f2):
        out = self._orig(x, f1, f2)
        exact = self._orig(x.double(), f1, f2)
        # |sign(f)| = sign(|f|): the terms' absolute sum
        mag = self._orig(x.double().abs(), f1.abs(), f2.abs())
        near = (exact.abs() <= SRP_NEAR_UNITS * U * mag) & (mag > 0)
        self.near += int(near.sum())
        self.values += exact.numel()
        return out


@contextlib.contextmanager
def reference_r9_repaired():
    """The reference's decode with R9 repaired: while active, the
    reference's transformer calls attention sub-blocks that write the
    token's K/V (and LSH code) into the cache and mark its position
    before they attend, built from the reference's own functions."""
    orig_attn, orig_lsh = RT.attention_block, RT.lsh_attention_block

    def out_proj(out, lp, name):
        b, s = out.shape[0], out.shape[1]
        return jnp.einsum("bsq,qd->bsd", out.reshape(b, s, -1), lp[name])

    def attention_block(cfg, lp, x, positions, *, causal=True, window=0,
                        cache=None, cache_pos=None, cur_pos=None, pre=""):
        if cache is None:
            return orig_attn(cfg, lp, x, positions, causal=causal,
                             window=window, pre=pre)
        h = RL.norm(cfg, x, lp[pre + "ln"])
        q, k, v = RA.qkv_proj(cfg, lp, h, positions, pre=pre)
        cache = RA.write_cache(cache, k, v, cur_pos)
        pos = cache_pos.at[cur_pos % cache_pos.shape[0]].set(cur_pos)
        out = RA.decode_attention(q, cache.k, cache.v, pos, cur_pos,
                                  window=window)
        return out_proj(out, lp, pre + "wo"), cache

    def lsh_attention_block(cfg, lp, proj, x, positions, *, cache=None,
                            cache_pos=None, cur_pos=None):
        if cache is None:
            return orig_lsh(cfg, lp, proj, x, positions)
        h = RL.norm(cfg, x, lp["ln"])
        q, k, v = RA.qkv_proj(cfg, lp, h, positions)
        codes = RLSH.srp_bucket_codes(k, proj["f1"], proj["f2"])
        put = jax.lax.dynamic_update_slice_in_dim
        cache = RLSH.LSHKVCache(k=put(cache.k, k, cur_pos, axis=1),
                                v=put(cache.v, v, cur_pos, axis=1),
                                codes=put(cache.codes, codes, cur_pos,
                                          axis=1))
        pos = cache_pos.at[cur_pos].set(cur_pos)
        out = RLSH.lsh_attention_decode(cfg, proj, q, cache, pos, cur_pos)
        return out_proj(out, lp, "wo"), cache

    RT.attention_block, RT.lsh_attention_block = (attention_block,
                                                  lsh_attention_block)
    try:
        yield
    finally:
        RT.attention_block, RT.lsh_attention_block = orig_attn, orig_lsh


@functools.lru_cache(maxsize=None)
def reference(arch: str, seed: int = 0) -> dict:
    """The reference's run of a smoke arch (numpy results)."""
    cfg = ref_config(arch, "smoke")
    params = ref_params.init_params(cfg, jax.random.PRNGKey(seed))
    batch = make_batch(cfg, B, S, seed)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    fwd = jax.jit(lambda p, bt: RT.forward(cfg, p, bt)[0])
    pre = jax.jit(lambda p, bt: RT.prefill(cfg, p, bt, max_len=S))
    out = {"params": jax.tree.map(np.asarray, params), "batch": batch,
           "forward": np.asarray(fwd(params, jb))}
    s0 = S - N_DECODE
    last, cache0 = pre(params, prefix(jb, s0))
    out["prefill"] = np.asarray(last)
    out["cache"] = cache_leaves(cache0)
    with reference_r9_repaired():
        dec = jax.jit(lambda p, t, c, i: RT.decode_step(cfg, p, t, c, i))
        cache, steps = cache0, []
        for cur in range(s0, S):
            logits, cache = dec(params, jb["tokens"][:, cur:cur + 1], cache,
                                jnp.asarray(cur, jnp.int32))
            steps.append(np.asarray(logits))
        out["decode"] = steps
        out["decode_cache"] = cache_leaves(cache)
        # greedy loop from the same prefill (the engine's rule: masked
        # argmax)
        tok = masked_argmax(cfg, out["prefill"])[:, None].astype(np.int32)
        toks, gaps, cache = [tok], [top2_gap(cfg, out["prefill"])], cache0
        for cur in range(s0, s0 + GREEDY_STEPS - 1):
            logits, cache = dec(params, jnp.asarray(tok), cache,
                                jnp.asarray(cur, jnp.int32))
            logits = np.asarray(logits)
            tok = masked_argmax(cfg, logits)[:, None].astype(np.int32)
            toks.append(tok)
            gaps.append(top2_gap(cfg, logits))
    out["greedy"] = np.concatenate(toks, axis=1)
    out["greedy_gaps"] = np.stack(gaps, axis=1)
    out["scale"] = max(float(np.abs(out["forward"]).max()), 1.0)
    return out


@functools.lru_cache(maxsize=None)
def port(arch: str, seed: int = 0) -> dict:
    """The port's run on the reference's parameters and batch (numpy
    results), with the SRP margins of every hash it computed."""
    ref = reference(arch, seed)
    cfg = get_config(arch, "smoke")
    params = convert.model_params_from_numpy(cfg, ref["params"],
                                             device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    margins = SRPMargins()
    lsh_attention.srp_values = margins
    try:
        with torch.inference_mode():
            out = {"forward": T.forward(cfg, params, tb)[0].numpy()}
            s0 = S - N_DECODE
            last, cache = T.prefill(cfg, params, prefix(tb, s0), max_len=S)
            out["prefill"] = last.numpy()
            out["cache"] = [(p, a.copy()) for p, a in cache_leaves(cache)]
            steps = []
            for cur in range(s0, S):
                logits, cache = T.decode_step(
                    cfg, params, tb["tokens"][:, cur:cur + 1], cache, cur)
                steps.append(logits.numpy())
            out["decode"] = steps
            out["decode_cache"] = cache_leaves(cache)
        out["greedy"] = engine.greedy_generate(
            cfg, params, prefix(tb, s0), steps=GREEDY_STEPS,
            max_len=S).numpy()
    finally:
        lsh_attention.srp_values = margins._orig
    out["srp_near"], out["srp_values"] = margins.near, margins.values
    return out


def rel_err(a, b, scale) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max()) / scale


def greedy_agree(ref: dict, got: np.ndarray, scale: float) -> bool:
    """Tokens equal step by step in each row up to the first step whose
    reference top-2 gap is within the parity tolerance (a near tie may
    go either way, and every later token depends on it)."""
    want, gaps = ref["greedy"], ref["greedy_gaps"]
    for row in range(want.shape[0]):
        for j in range(want.shape[1]):
            if gaps[row, j] <= PARITY * scale:
                break
            if want[row, j] != got[row, j]:
                return False
    return True



def codes_decided(arch: str) -> bool:
    """Whether every SRP value the port computed for ``arch`` lies off the
    boundary (then both sides' codes agree and the LSH outputs are held at
    the parity tolerance). Always true for an arch without LSH."""
    return port(arch)["srp_near"] == 0
