#!/usr/bin/env python3
"""Drive the PyTorch port's serving paths and its kernel-level path on one
NVIDIA H100.

    python3 chip_smoke.py [--log2-corpus 20] [--batches 256] [--batch 1024]

Phases (any failure exits non-zero):

  1. device: the card's name, count and power limit;
  2. build: the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc,
     sm_90a), with ptxas' register and shared-memory lines;
  3. for each cell, the CP one ([main]: n = 2^20 CP tensors ((12, 12, 12),
     rank 4), cp-e2lsh K=10 L=10 rank 3 w=2) and the TT one ([tt-main]:
     n = 2^20 TT tensors ((16, 16, 16, 16), TT rank 4), tt-e2lsh K=10 L=10
     rank 4 w=48):
       - ``build_service`` over the corpus, then 256 batches of 1024
         planted-neighbour queries, with every kernel counter zeroed just
         before and read just after: build time, query batch latency (mean,
         median, p99 on the host clock), recall@1 (planted), recall@10
         against brute force, peak memory, and self-queries that must
         return themselves;
       - the hash kernel (K3 ``cp_gram`` / K4 ``tt_inner``) against its
         plain version over the whole corpus and at a small ragged shape,
         for raw / e2lsh-keys / srp-keys / srp-packed, and its raw values
         and key differences against a float64 evaluation;
       - K1 (``fused_query``, the format's re-rank) against its plain
         version on the same raw values and segment arrays, its scores
         against a float64 evaluation, and an SRP / cosine index (CP 4099
         items, TT 2^16) through both kernels;
       - the kernels' times (CUDA events) beside their bounds and the plain
         versions' times: the hash kernel per 65,536-item build launch and
         per 1024-item query batch, K1 per query batch with its registers,
         blocks per SM, shared bytes per block, shared window and the
         queries that used the global scratch; and a torch.profiler window
         over 64 query batches: device time by kernel and the device's busy
         share;
  4. on the CP cell's corpus and queries, the mutable, multi-probe path:
       - [mp]: L = 2 tables, probes T = 8, the exact cap (K1's dense
         multi-probe branch): recall@1, recall@10, candidates and batch
         latency beside [main]'s L = 10, T = 1, and K1 against its plain
         version;
       - [mut]: bucket_cap 64, L = 10, T = 4 (K1's live-window branch over
         a base and eight deltas): deletes, then the capped index against
         a fresh capped build; eight inserts of 1024 items; more deletes;
         256 query batches over the 9 segments with 1/8 of each batch
         planted on inserted items; K1 against its plain version; no
         deleted item returned; ``compact()`` and the compacted index
         against a fresh build bit for bit; an insert past max_deltas
         that auto-compacts;
     and on the TT cell's format at 2^16 ([tt-mut]): T = 4, bucket_cap, two
     deltas and a delete, K1-TT against its plain version;
  5. the sharded path on the same card (K1s, ``fused_query_sharded``: K1's
     kernel over every (shard, segment) pair):
       - [shard]: [main]'s corpus, family and queries over 4 shards (exact
         cap, T = 1), timed like [main]; every batch's ids, scores and
         candidate counts must equal [main]'s bit for bit; K1s against its
         plain version, its time and a profile;
       - [shard-mut]: [mut]'s script over 4 shards (routed slabs, 36
         (shard, segment) pairs), occupancy within one item of even after
         the routed inserts, no deleted item returned, recall@1, shard-local
         ``compact()``, then ``rebalance()`` equal to a fresh sharded build
         bit for bit; an exact-cap mutated sharded index answers as a fresh
         single-device one (ids and candidate counts);
       - [tt-shard]: a tt-srp / cosine index at 2^16 over 3 shards (the last
         padded): answers equal the single-device index's, K1s-TT against
         its plain version;
  6. [ann-k8]: examples/ann_search.py's own K = 8 (L = 10, exact cap about
     2950) over the CP cell's corpus and queries: L*cap past K1's shared
     window, so the launches carry the global scratch, which the queries
     whose window overflows the shared hash set use (counted); recall@1, K1
     against its plain version on 4 batches, its time;
  7. [kernels], the card twin of benchmarks/kernels.py: K3 at B=64 N=4 d=64
     R=32 L=8 K=8 and K4 at B=32 N=4 d=32 R=16 L=4 K=8 (raw values against
     the plain version and float64, fused keys bitwise against the tails
     composed on the kernel's raw values), the standalone K6 (``srp_pack``)
     and K7 (``e2lsh_quant``) bitwise against their plain versions at
     benchmark and ragged shapes (K6 also at K = 4 to 4096, past its grid
     and on views with a storage offset), ``hash_packed_batch`` against
     ``pack_bits(hash_batch)``, ``cp_inner_products`` /
     ``tt_inner_products``; K6 and K7 timed over 2^20 rows (K6 also at
     (2^20, 100) and (2^16, 2000), each with its plan: path, grid,
     registers, blocks per SM, which must reach the plan's target, and
     bytes in flight per SM), beside the read yardstick, one ``torch.amax``
     over K6's (2^20, 128) values;
  8. [limits]: K3 at benchmarks/collision.py's K = 2000 in one table and K4
     at K = 1024 (both tiled over hashes), and a TT rank-16 index (2^14
     items of dims (8, 8, 8, 8)) through K4's warp kernel and K1-TT, each
     against its plain version and timed.

Every path's kernel counters are zeroed just before it runs and read just
after: each kernel and each K1 / K1s branch it needs must have launched,
and no plain version may have run; K1's and K1s's queries that used the
global scratch are counted too ("fused_query:scratch"). The last two lines
are one JSON object of kernel records and the device record. Needs a CUDA
card; imports nothing of JAX or of the ``repro`` package.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12             # fp32 outside the tensor cores
NOISE = 0.02
TOPK = 10
# recall@1 of the planted neighbours measured 0.9894 (CP) and 0.9969 (TT)
# over 262,144 queries with these seeds on an H100; a drop below this limit
# is a fault of the path, not noise
RECALL1_MIN = 0.95
# the rigorous rounding bounds of ``kernels.parity`` are worst cases, loose
# where a sum's signed terms cancel (the TT chain: its bound's median is a
# third of the median raw value at the TT cell). Two tighter checks make a
# kernel that is off by far less than that fail:
#  * against a float64 evaluation of the same inputs, the kernel's error
#    may be at most ACCURACY_FACTOR times the plain fp32 version's (its
#    RMS, and its maximum), floored at one unit in the last place of the
#    median reference value: the kernel is as accurate as an independent
#    fp32 evaluation;
#  * at most KEY_DIFFER_MAX of the key cells may differ from the plain
#    version's at all. A key differs only where one of its K codes lies
#    within the two evaluations' difference of a bucket edge (E2LSH) or of
#    0 (SRP), about 2*K*err/w of them: ~1e-6 at fp32's noise floor (33 of
#    20,971,520 on the TT cell), ~1e-3 for a kernel a relative 1e-4 off.
ACCURACY_FACTOR = 4.0
KEY_DIFFER_MAX = 1e-5
QUERY_HASH_BATCHES = 4     # query batches K3 / K4 are held against plain on
U = 2.0 ** -24

CELLS = {
    # the examples/ann_search.py scenario at n = 2^20, K = 10
    "cp": dict(tag="main", kind="cp-e2lsh", dims=(12, 12, 12), rhat=4,
               codes=10, tables=10, rank=3, width=2.0, seed=0,
               srp=dict(dims=(4, 4, 4), rhat=3, n=4099, codes=12, tables=4,
                        rank=2, every=17)),
    # the same scenario in TT format at the widths of
    # benchmarks/table1_e2lsh.py (d = 16, N = 4, R = R^ = 4); w about the
    # corpus' median norm. The corpus stays at 2^20 (--log2-corpus cuts the
    # CP cell only).
    "tt": dict(tag="tt-main", kind="tt-e2lsh", dims=(16, 16, 16, 16),
               rhat=4, codes=10, tables=10, rank=4, width=48.0, seed=2,
               srp=dict(dims=(16, 16, 16, 16), rhat=4, n=1 << 16, codes=12,
                        tables=8, rank=4, every=67)),
}
TT_LOG2_CORPUS = 20


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fns, reps: int) -> float:
    """Mean CUDA-event time of one call, cycling through ``fns`` (distinct
    inputs, so a call finds its data in HBM and not in the 50 MB L2)."""
    import torch
    for f in fns:
        f()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_device():
    import torch
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(f"[device] {name} x{count}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    return name, count, smi.stdout.strip().splitlines()[0]


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.lib()
    print(f"[build] kernels built and loaded in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {_build.BUILD_INFO.get('seconds', 0.0):.2f} s)")
    for line in _build.BUILD_INFO.get("log", "").splitlines():
        if re.search(r"Compiling entry|registers|spill|==", line):
            print("[build]   " + line.strip())


def hash_fns(layout: str) -> dict:
    """The hash kernel of a format's layout (K3 'cp', K4 'tt'), its plain
    version, rounding bound, float64-capable oracle, and the samplers and
    stackers of its small ragged case."""
    from repro_torch.core import projections, tensor_formats
    from repro_torch.kernels import ops, parity, ref
    from repro_torch.kernels.cp_gram import cp_gram_plain
    from repro_torch.kernels.tt_inner import tt_inner_plain
    kernel = ops.HASH_KERNELS[layout][0]
    if layout == "cp":
        return dict(name="K3", kernel=kernel, plain=cp_gram_plain,
                    bound=parity.raw_bound, ref=ref.cp_inner_ref,
                    data=tensor_formats.cp_random_data,
                    proj=projections.sample_cp_projection,
                    stack_x=ops._stack_cp_batch, stack_p=ops._stack_cp_proj,
                    small_ranks=(2, 3))
    return dict(name="K4", kernel=kernel, plain=tt_inner_plain,
                bound=parity.tt_raw_bound, ref=ref.tt_inner_ref,
                data=tensor_formats.tt_random_data,
                proj=projections.sample_tt_projection,
                stack_x=ops._stack_tt_batch, stack_p=ops._stack_tt_proj,
                small_ranks=(3, 2))


def hash_plan(layout: str, x, p, label: str) -> dict:
    """K3's / K4's launch plan for these stacked operands (``plan`` from the
    launch's shape and the card's SM count) and what the card makes of it;
    prints registers, blocks per SM and grid, and fails below the plan's
    target blocks per SM."""
    from repro_torch.kernels import cp_gram as k3
    from repro_torch.kernels import tt_inner as k4
    from repro_torch.kernels.epilogues import sm_count
    sms = sm_count(x.device)
    if layout == "cp":
        b, n, d, rx = x.shape
        _, l, k, _, rp = p.shape
        lp = k3.plan(b, l, k, rx, rp, n, d, sms)
        occ = k3.occupancy(lp, n, d, rx, rp)
    else:
        b, n, rx, d, _ = x.shape
        _, l, k, rp, _, _ = p.shape
        lp = k4.plan(b, l, k, rx, rp, d, sms)
        occ = k4.occupancy(lp, d, rx, rp)
    name = hash_fns(layout)["name"]
    kind = ("the warp kernel, one item x "
            f"{lp.block_hashes} hashes a block" if lp.block_items == 0 else
            f"the thread kernel, {lp.block_items} items x {lp.block_hashes} "
            "hashes a block")
    print(f"[plan] {name} {label}: {kind}, {lp.threads} threads, {lp.smem} "
          f"shared bytes, grid {lp.blocks} blocks on {sms} SMs; "
          f"{occ['registers']} registers a thread, {occ['local_bytes']} "
          f"local bytes, {occ['blocks_per_sm']} blocks per SM (target "
          f"{lp.target_blocks})")
    if occ["blocks_per_sm"] < lp.target_blocks:
        fail(f"{name} {label}: {occ['blocks_per_sm']} blocks per SM, below "
             f"the plan's {lp.target_blocks}")
    return dict(occ, blocks=lp.blocks, threads=lp.threads)


def library_raw(layout: str, x, p):
    """One ``torch.einsum`` over the same stacked operands computing K3's /
    K4's unscaled raw values (B, L, K) in fp32 (TF32 off): the yardstick
    of ``library_ms``, which the port never calls. Operands alternate input
    and projection mode by mode, so a left-to-right contraction follows the
    chain (TT) or the per-mode Grams (CP)."""
    import torch
    n = x.shape[1]
    letters = iter("abcdefghijmnopqrstuvwxyABCDEFGHIJMNOPSTUVWXY")
    ops, subs = [], []
    if layout == "cp":
        for m in range(n):
            i = next(letters)
            ops += [x[:, m], p[m]]
            subs += [f"z{i}R", f"lk{i}Q"]
    else:
        a = [next(letters) for _ in range(n + 1)]
        b = [next(letters) for _ in range(n + 1)]
        for m in range(n):
            i = next(letters)
            ops += [x[:, m], p[m]]
            subs += [f"z{a[m]}{i}{a[m + 1]}", f"lk{b[m]}{i}{b[m + 1]}"]
    return torch.einsum(",".join(subs) + "->zlk", *ops)


class Accuracy:
    """Errors of the kernel and of the plain version against float64
    values, gathered over chunks."""

    def __init__(self):
        self.max_k = self.max_p = self.ss_k = self.ss_p = 0.0
        self.n, self.ref_abs = 0, []

    def add(self, got_k, got_p, exact) -> None:
        e_k = (got_k.double() - exact).abs()
        e_p = (got_p.double() - exact).abs()
        self.max_k = max(self.max_k, float(e_k.max()))
        self.max_p = max(self.max_p, float(e_p.max()))
        self.ss_k += float((e_k * e_k).sum())
        self.ss_p += float((e_p * e_p).sum())
        self.n += exact.numel()
        self.ref_abs.append(float(exact.abs().median()))

    def check(self, label: str) -> str:
        import statistics
        floor = U * statistics.median(self.ref_abs)
        rms_k, rms_p = (math.sqrt(s / max(self.n, 1))
                        for s in (self.ss_k, self.ss_p))
        for what, k, p in (("RMS", rms_k, rms_p), ("max", self.max_k,
                                                    self.max_p)):
            if k > ACCURACY_FACTOR * max(p, floor):
                fail(f"{label}: the kernel's {what} error against float64 "
                     f"{k:.3g} exceeds {ACCURACY_FACTOR} x the plain fp32 "
                     f"version's {p:.3g}")
        return (f"against float64 over {self.n} values: kernel RMS "
                f"{rms_k:.3g} / max {self.max_k:.3g}, plain RMS {rms_p:.3g} "
                f"/ max {self.max_p:.3g}")


def exact_raw(f: dict, x, p, scale: float):
    """(B, L, K) raw values in float64 from the same stacked inputs."""
    n, l, k = p.shape[:3]
    v = f["ref"](x.double(), p.double().reshape(n, l * k, *p.shape[3:]))
    return (scale * v).reshape(x.shape[0], l, k)


def hash_compare(layout, x, p, offs, mults, scale, w, label, acc=None):
    """K3 / K4 vs plain on one input set -> (max abs raw error, boundary
    codes, key cells that differ at all, key cells compared); ``acc``
    gathers both raw errors against float64."""
    import torch
    from repro_torch.kernels import parity
    f = hash_fns(layout)
    kernel, plain, name = f["kernel"], f["plain"], f["name"]
    raw_k = kernel(x, p, epilogue="raw", scale=scale)
    raw_p = plain(x, p, epilogue="raw", scale=scale)
    bound = f["bound"](x, p, scale)
    err = (raw_k - raw_p).abs()
    if not bool((err <= bound).all()):
        fail(f"{name} raw {label}: {int((err > bound).sum())} values outside "
             f"the rounding bound (max err {float(err.max()):.3g})")
    if acc is not None:
        acc.add(raw_k, raw_p, exact_raw(f, x, p, scale))
    n_boundary = n_differ = n_keys = 0
    for kind, epi in ((f"{layout}-e2lsh", "e2lsh-keys"),
                      (f"{layout}-srp", "srp-keys")):
        keys_k = kernel(x, p, offs, mults, epilogue=epi, w=w, scale=scale)
        keys_p = plain(x, p, offs, mults, epilogue=epi, w=w, scale=scale)
        near = parity.boundary_codes(raw_p, bound, kind, offs, w)
        bad, n_near = parity.key_mismatches(keys_k, keys_p, near)
        if bad:
            fail(f"{name} {epi} {label}: {bad} keys differ away from bucket "
                 "edges")
        n_boundary += int(near.sum())
        n_differ += int((keys_k != keys_p).sum())
        n_keys += keys_k.numel()
    if p.shape[2] % 32 == 0 or label == "small":
        words_k = kernel(x, p, epilogue="srp-packed", scale=scale)
        words_p = plain(x, p, epilogue="srp-packed", scale=scale)
        near = parity.boundary_codes(raw_p, bound, f"{layout}-srp").any(-1)
        if not bool(((words_k == words_p).all(-1) | near).all()):
            fail(f"{name} srp-packed {label}: words differ away from 0")
    torch.cuda.synchronize()
    return float(err.max()), n_boundary, n_differ, n_keys


def phase_hash(svc, cell) -> float:
    """K3 / K4 against its plain version over the cell's whole corpus (the
    segment's stacked corpus, 16,384 items at a time to bound the plain and
    float64 chains' memory) and at a small ragged shape."""
    import torch
    idx = svc.index
    fam, corpus = idx.family, idx.effective_corpus()
    layout = corpus.layout
    f = hash_fns(layout)
    stacked = idx.store.base.stacked
    p = fam.stacked_projection
    offs = fam.offsets.reshape(cell["tables"], cell["codes"])
    scale = corpus.scale * fam.projection.scale
    n = stacked.shape[0]
    x0 = stacked[:16384]
    bound0 = f["bound"](x0, p, scale)
    raw0 = f["plain"](x0, p, epilogue="raw", scale=scale)
    print(f"[{f['name']}] on the first {x0.shape[0]} items: the rounding "
          f"bound's median {float(bound0.median()):.4g} against a median "
          f"|raw value| of {float(raw0.abs().median()):.4g}")
    acc = Accuracy()
    max_err, n_boundary, n_differ, n_keys = 0.0, 0, 0, 0
    for s in range(0, n, 16384):
        e, nb, nd, nk = hash_compare(layout, stacked[s:s + 16384], p, offs,
                                     idx._mults_t, scale, cell["width"],
                                     "serving", acc)
        max_err, n_boundary = max(max_err, e), n_boundary + nb
        n_differ, n_keys = n_differ + nd, n_keys + nk
    accuracy = acc.check(f"{f['name']} raw")
    if n_differ > KEY_DIFFER_MAX * n_keys:
        fail(f"{f['name']}: {n_differ} of {n_keys} key cells differ from the "
             f"plain version's, more than {KEY_DIFFER_MAX} of them")
    # a small ragged shape: odd batch, unequal mode dims and ranks, K not a
    # power of 2
    gen = torch.Generator(device="cuda").manual_seed(7)
    rx, rp = f["small_ranks"]
    xs = f["data"](gen, (5, 7, 3), rx, batch=37)
    ps = f["proj"](gen, 3 * 5, (5, 7, 3), rp)
    offs_s = torch.rand(15, generator=gen, device="cuda").reshape(3, 5) * 6.0
    mults_s = torch.randint(0, 1 << 32, (5,), generator=gen, device="cuda",
                            dtype=torch.int64) | 1
    e, nb, _, _ = hash_compare(layout, f["stack_x"](xs), f["stack_p"](ps, 3),
                               offs_s, mults_s, ps.scale, 6.0, "small")
    print(f"[{f['name']}] raw within the rounding bound at ({n} x L*K="
          f"{cell['tables'] * cell['codes']}) and (37 x 15); max |kernel - "
          f"plain| = {max(max_err, e):.3g}; {accuracy}; {n_boundary + nb} "
          f"boundary codes, keys equal outside their tables; over the corpus "
          f"{n_differ} of {n_keys} e2lsh/srp key cells differ at all")
    return max(max_err, e)


def make_queries(corpus, qid, gen):
    """Corpus members ``qid`` (CP or TT) with NOISE Gaussian noise on every
    factor or core entry."""
    import torch
    q = corpus.index(qid)
    return type(q)(tuple(f + NOISE * torch.randn(f.shape, generator=gen,
                                                 device=f.device)
                         for f in q.leaves), 1.0)


COUNTED = ("cp_gram", "tt_inner", "fused_query", "fused_query_sharded",
           "srp_pack", "e2lsh_quant")


def counters():
    """{name: the wrapper or plain function whose count it is}."""
    from repro_torch.kernels import fused_query as fq
    from repro_torch.kernels.cp_gram import cp_gram, cp_gram_plain
    from repro_torch.kernels.e2lsh_quant import e2lsh_quant, e2lsh_quant_plain
    from repro_torch.kernels.srp_pack import srp_pack, srp_pack_plain
    from repro_torch.kernels.tt_inner import tt_inner, tt_inner_plain
    return {"cp_gram": cp_gram, "cp_gram_plain": cp_gram_plain,
            "tt_inner": tt_inner, "tt_inner_plain": tt_inner_plain,
            "fused_query": fq.fused_query,
            "fused_query_plain": fq.fused_query_plain,
            "fused_query_sharded": fq.fused_query_sharded,
            "fused_query_sharded_plain": fq.fused_query_sharded_plain,
            "srp_pack": srp_pack, "srp_pack_plain": srp_pack_plain,
            "e2lsh_quant": e2lsh_quant,
            "e2lsh_quant_plain": e2lsh_quant_plain}


BRANCHES = ("multiprobe", "live_window", "segments", "scratch")
K1_WRAPPERS = ("fused_query", "fused_query_sharded")


def read_counts() -> dict:
    """Launches and plain calls, K1's and K1s's launches by branch
    (``fused_query:multiprobe``, ``fused_query_sharded:live_window``,
    ...) and their queries that used the global scratch
    (``fused_query:scratch``)."""
    fns = counters()
    counts = {name: getattr(fn, "launches" if name in COUNTED else "calls")
              for name, fn in fns.items()}
    counts.update({f"{k}:{b}": fns[k].branches[b]
                   for k in K1_WRAPPERS for b in BRANCHES})
    return counts


def zero_counts() -> None:
    fns = counters()
    for name, fn in fns.items():
        setattr(fn, "launches" if name in COUNTED else "calls", 0)
    for k in K1_WRAPPERS:
        fns[k].branches.clear()


def check_counts(counts, tag, need) -> None:
    """Fail unless every counter in ``need`` moved and no plain version
    ran."""
    missing = [k for k in need if counts[k] == 0]
    if missing:
        fail(f"the {tag} path never launched {missing}: {counts}")
    if any(counts[f"{k}_plain"] for k in COUNTED):
        fail(f"the {tag} path called a plain version: {counts}")


def serve(svc, queries):
    """A warm-up batch, then every batch through ``query_arrays`` ->
    (results, host-clock latencies in ms)."""
    svc.query_arrays(queries[0], topk=TOPK)
    svc.stats.reset()
    results, lat_ms = [], []
    for q in queries:
        t0 = time.perf_counter()
        results.append(svc.query_arrays(q, topk=TOPK))
        lat_ms.append((time.perf_counter() - t0) * 1e3)
    return results, lat_ms


def latency_line(tag, svc, lat_ms, what="") -> dict:
    import numpy as np
    st = svc.stats
    lat = np.sort(np.asarray(lat_ms))
    out = dict(mean=st.total_ms / st.batches, median=float(np.median(lat)),
               p99=float(lat[int(math.ceil(0.99 * len(lat))) - 1]),
               qps=st.qps, cand=st.mean_candidates)
    print(f"[{tag}] {st.batches} batches of {st.queries // st.batches}"
          f"{what} in {st.total_ms / 1e3:.3f} s: {out['mean']:.3f} ms/batch "
          f"mean, median {out['median']:.3f} ms, p99 {out['p99']:.3f} ms, "
          f"max {lat[-1]:.3f} ms; {st.qps:.0f} QPS, mean candidates "
          f"{st.mean_candidates:.1f}")
    return out


def check_results(results, targets, n) -> tuple[int, int]:
    """Shapes, id ranges, finite ascending scores -> (recall@1 hits, rows
    with a target); ``targets`` per batch the planted target's current
    effective id, -1 where it was deleted."""
    import numpy as np
    hits1 = rows = 0
    for (ids, scores, nc), tgt in zip(results, targets):
        if ids.shape != (len(tgt), TOPK) or nc.shape != (len(tgt),):
            fail(f"result shapes {ids.shape} {nc.shape}")
        valid = ids >= 0
        if ((ids >= n) | (ids < -1)).any() or not (
                (valid.sum(1) == (nc.clip(max=TOPK)))).all():
            fail("ids out of range or valid count != min(n_cand, topk)")
        if not np.isfinite(scores[valid]).all():
            fail("non-finite score on a valid id")
        if (valid[:, 1:] & (scores[:, 1:] < scores[:, :-1])).any():
            fail("scores not ascending")
        alive = tgt >= 0
        hits1 += int((ids[alive, 0] == tgt[alive]).sum())
        rows += int(alive.sum())
    return hits1, rows


def recall10(svc, query, ids, corpus) -> float:
    """recall@10 of 256 queries' ids against brute force over ``corpus``."""
    from repro_torch.core.index import brute_force_batch
    q256 = query.index(slice(0, 256))
    truth, _ = brute_force_batch(svc.index.metric, q256, corpus, TOPK)
    return sum(len(set(t) & set(r[r >= 0].tolist()))
               for t, r in zip(truth.tolist(), ids[:256])) / (256 * TOPK)


def phase_main(cell, corpus, qids, queries):
    """``build_service`` over the cell's corpus and its query batches, with
    every counter zeroed just before and read just after."""
    import torch
    from repro_torch.serving.lsh_service import build_service

    tag, hash_kernel = cell["tag"], cell["hash_kernel"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    svc = build_service(torch.Generator(device="cuda").manual_seed(1),
                        cell["kind"], cell["dims"], corpus,
                        num_codes=cell["codes"], num_tables=cell["tables"],
                        rank=cell["rank"], bucket_width=cell["width"],
                        device="cuda")
    build_launches = read_counts()[hash_kernel]
    results, lat_ms = serve(svc, queries)
    summary = latency_line(tag, svc, lat_ms)
    # self-queries: an item queried as itself is in its own bucket of every
    # table, so it must come back first at a distance at the f32 noise floor
    self_q = corpus.index(qids[0][:256])
    self_ids, self_scores, _ = svc.query_arrays(self_q, topk=TOPK)
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    st = svc.stats
    n = corpus.leaves[0].shape[0]
    print(f"[{tag}] build_service over n={n} {type(corpus).__name__} "
          f"{cell['dims']} rank {cell['rhat']}, {cell['kind']} "
          f"K={cell['codes']} L={cell['tables']} rank {cell['rank']} "
          f"w={cell['width']}: {st.build_s:.3f} s (hash {st.hash_s:.3f} s, "
          f"sort {st.sort_s:.3f} s), cap {svc.index.cap} -> window L*cap = "
          f"{cell['tables'] * svc.index.cap}")
    print(f"[{tag}] launches on the main path: {counts} (build: "
          f"{hash_kernel} {build_launches})")
    check_counts(counts, tag, (hash_kernel, "fused_query"))
    print(f"[{tag}] queries that used K1's global scratch: "
          f"{counts['fused_query:scratch']} of "
          f"{(len(queries) + 1) * len(qids[0]) + 256}")
    if tag == "tt-main" and counts["fused_query:scratch"] == 0:
        fail("tt-main: no query took K1's global scratch, so the main path "
             "no longer holds it against the plain version")
    hits1, n_q = check_results(results, [q.cpu().numpy() for q in qids], n)
    recall1 = hits1 / n_q
    self_ok = (self_ids[:, 0] == qids[0][:256].cpu().numpy()).mean()
    r10 = recall10(svc, queries[0], results[0][0],
                   svc.index.effective_corpus())
    summary.update(recall1=recall1, recall10=r10,
                   build_launches=build_launches)
    print(f"[{tag}] recall@1 (planted) {recall1:.4f} over {n_q} queries; "
          f"recall@10 vs brute force {r10:.4f} over 256; self-queries "
          f"first {self_ok:.4f} (max self distance "
          f"{float(self_scores[:, 0].max()):.3g}); peak device memory "
          f"{peak / 2**30:.2f} GiB")
    norms = svc.index.effective_corpus().self_inners().clamp(min=0).sqrt()
    print(f"[{tag}] corpus norms: min {float(norms.min()):.4g}, median "
          f"{float(norms.median()):.4g}, max {float(norms.max()):.4g}")
    if self_ok < 1.0:
        fail("a self-query did not return itself first")
    if recall1 < RECALL1_MIN:
        fail(f"recall@1 {recall1} below {RECALL1_MIN}")
    return svc, counts, summary, results


def exact_scores(metric, queries, corpus, ids):
    """(B, topk) re-rank scores of ``ids`` in float64 (0 where -1)."""
    import torch
    valid = ids >= 0
    q = type(queries)(tuple(t.double() for t in queries.leaves),
                      queries.scale).index((slice(None), None))
    sub = corpus.index(torch.where(valid, ids, 0).long())
    y = type(sub)(tuple(t.double() for t in sub.leaves), sub.scale)
    qq, yy, qy = q.self_inners(), y.self_inners(), q.pair_inners(y)
    if metric == "euclidean":
        s = torch.sqrt(torch.clamp(qq + yy - 2.0 * qy, min=0.0))
    else:
        s = qy / (torch.sqrt(qq) * torch.sqrt(yy))
    return torch.where(valid, s, 0.0)


def k1_entry(view):
    """K1 over a store view's segments, or K1s over its (shard, segment)
    pairs for a sharded store, and its plain version: two functions of
    (values, offsets, mults, stacked queries, **kw), and the name."""
    from repro_torch.kernels import fused_query as fq
    if view.sharded:
        segs = (view.seg_arrays(0), view.delta_arrays)
        kw = dict(cap=view.base.cap, delta_caps=view.delta_caps)
        kernel, plain, name = (fq.fused_query_sharded,
                               fq.fused_query_sharded_plain, "K1s")
    else:
        segs, kw = (view.all_arrays,), dict(caps=view.all_caps)
        kernel, plain, name = fq.fused_query, fq.fused_query_plain, "K1"
    return (lambda *a, **k: kernel(*a, *segs, table=view.k1_table, **kw, **k),
            lambda *a, **k: plain(*a, *segs, **kw, **k), name)


def k1_compare(svc, queries, label, probes=1, corpus=None,
               need_scratch=False):
    """K1 (K1s on a sharded store) vs plain on the same raw values and the
    arrays of every segment of the service's store, and both against
    float64 scores (``corpus``: the effective corpus, when the caller has
    it already); with ``need_scratch``, fail unless some of the compared
    queries took K1's global scratch."""
    import torch
    from repro_torch.kernels import fused_query as fq
    from repro_torch.kernels import parity
    idx = svc.index
    fam = idx.family
    view = idx.store.view
    if corpus is None:
        corpus = idx.effective_corpus()
    qs = queries.stack()
    values = fam.raw_stacked(qs[1], queries.scale)
    offs, mults = fam.offsets, idx._mults_t
    kw = dict(kind=fam.kind, w=fam.bucket_width, num_tables=fam.num_tables,
              num_codes=fam.num_codes, metric=idx.metric, topk=TOPK,
              probes=probes)
    kernel, plain, name = k1_entry(view)
    branches = (fq.fused_query_sharded if view.sharded
                else fq.fused_query).branches
    took = branches["scratch"]
    ik, sk, nk = kernel(values, offs, mults, qs, **kw)
    ip, sp, np_ = plain(values, offs, mults, qs, **kw)
    torch.cuda.synchronize()
    took = branches["scratch"] - took
    name += "-TT" if corpus.layout == "tt" else ""
    if need_scratch and took == 0:
        fail(f"{name} {label}: no compared query took the global scratch, "
             "so it is not held against the plain version")
    if not torch.equal(nk, np_):
        fail(f"{name} {label}: candidate counts differ in "
             f"{int((nk != np_).sum())} rows")
    tol = parity.rerank_bound(idx.metric, queries, corpus, ip, sp)
    valid = ip >= 0
    same = valid & (ik == ip)
    err = torch.where(same, (sk - sp).abs(), 0.0)
    if bool((err > tol).any()):
        fail(f"{name} {label}: scores outside the rounding bound "
             f"(max err {float(err.max()):.3g})")
    bad = parity.topk_mismatches(ik, sk, ip, sp, tol)
    if bad:
        fail(f"{name} {label}: {bad} result ids differ without a near tie")
    acc = Accuracy()
    acc.add(sk[same], sp[same],
            exact_scores(idx.metric, queries, corpus, ip)[same])
    accuracy = acc.check(f"{name} {label} scores")
    n_tie = int((ik != ip).sum())
    print(f"[{name}] {label}: n_cand equal ({int(nk.sum())} candidates over "
          f"{len(view.k1_segments[0])} segment(s), T={probes}), scores within "
          f"the rounding bound (its median {float(tol[valid].median()):.3g}, max "
          f"{float(tol.max()):.3g}, against a median |score| of "
          f"{float(sp[valid].abs().median()):.3g}; max |kernel - plain| "
          f"{float(err.max()):.3g}; {accuracy}), ids equal except {n_tie} "
          f"near-tie slots; {took} queries took the global scratch")
    return float(err.max()), (values, offs, mults, qs, view, kw)


def phase_srp(cell) -> None:
    """An SRP / cosine index of the cell's format: its build keys (K3 / K4
    on the card) against the plain version's, and K1 against its plain
    version."""
    import torch
    from repro_torch.kernels import parity
    from repro_torch.serving.lsh_service import build_service
    c = cell["srp"]
    layout = cell["kind"][:2]
    f = hash_fns(layout)
    gen = torch.Generator(device="cuda").manual_seed(13)
    corpus = f["data"](gen, c["dims"], c["rhat"], batch=c["n"])
    svc = build_service(gen, f"{layout}-srp", c["dims"], corpus,
                        metric="cosine", num_codes=c["codes"],
                        num_tables=c["tables"], rank=c["rank"],
                        device="cuda")
    idx = svc.index
    base, fam = idx.store.base, idx.family
    p = fam.stacked_projection
    scale = corpus.scale * fam.projection.scale
    bad = n_near = 0
    for s in range(0, c["n"], 16384):
        x = base.stacked[s:s + 16384]
        raw = f["plain"](x, p, scale=scale)
        near = parity.boundary_codes(raw, f["bound"](x, p, scale),
                                     f"{layout}-srp")
        keys = f["plain"](x, p, None, idx._mults_t, epilogue="srp-keys",
                          scale=scale)
        b, nn = parity.key_mismatches(base.keys[s:s + 16384], keys, near)
        bad, n_near = bad + b, n_near + nn
    if bad:
        fail(f"{layout}-srp index: {bad} build keys differ from the plain "
             "version's away from 0")
    print(f"[{layout}-srp] n={c['n']}, K={c['codes']} L={c['tables']}, cap "
          f"{idx.cap}: build keys equal to the plain version's outside "
          f"{n_near} boundary tables")
    q = make_queries(corpus, torch.arange(0, c["n"], c["every"],
                                          device="cuda"), gen)
    k1_compare(svc, q, f"{layout}-srp / cosine index, "
                       f"B={q.leaves[0].shape[0]}")


def tt_chain_flops(xranks, pranks, dims) -> int:
    """fp32 operations of one TT chain <X, T> at true ranks: per mode, with
    cores X (a, d, c) and T (b, d, e), S T_i (a*b*e FMA) then X_i^T (S T_i)
    (c*a*e FMA) for each of the d slices."""
    return sum(2 * d * (a * b * e + c * a * e)
               for d, a, c, b, e in zip(dims, xranks, xranks[1:], pranks,
                                        pranks[1:]))


def inner_flops(x, y) -> int:
    """fp32 operations of one in-format <X, Y> at true ranks: CP, per (r, q)
    term the N d-long dots and the N-fold product; TT, the chain."""
    if x.layout == "cp":
        return x.rank * y.rank * (2 * sum(x.dims) + len(x.dims))
    return tt_chain_flops(x.ranks, y.ranks, x.dims)


def k1_work(k1_args, q_row, c_row, cand_flops, query_flops):
    """(bytes, operations, window slots, candidates) that K1 (K1s) must move
    and do for this batch's data: the inputs and outputs once; with T > 1
    the expansion's pair table once and, per (query, table), its singles,
    pair sums and T - 1 argmin rounds over the C candidates; per segment
    (per (shard, segment) pair, K1s's table rows) and per
    (query, table, probe) the steps of its binary searches over uint32
    keys (side='left' over the m keys, then over the cap keys after the
    start for a dense window or over the table for a live one), the two
    live_rank reads of a live window, and per window slot perm and live
    (dense) or live_pos and perm (live); one corpus row (at its true
    ranks) and effective id per candidate."""
    from repro_torch.core import probing
    from repro_torch.kernels import epilogues as epi
    from repro_torch.kernels.fused_query import probe_keys_from_values
    values, offs, mults, _, view, kw = k1_args
    b = values.shape[0]
    l, k, t = kw["num_tables"], kw["num_codes"], kw["probes"]
    e2 = kw["kind"].endswith("e2lsh")
    keys = probe_keys_from_values(values, offs, mults, e2=e2, w=kw["w"],
                                  num_tables=l, num_codes=k, probes=t)
    nbytes = (values.numel() * 4 + l * k * 4 + k * 4 + b * q_row
              + b * TOPK * 8 + b * 4)
    flops = b * query_flops
    if t > 1:
        c = probing.expansion_size(kw["kind"], k)
        singles = 2 * k if e2 else k
        nbytes += (c - singles) * 8
        flops += b * l * ((3 * k if e2 else 0) + (c - singles)
                          + (t - 1) * c)
    slots = n_cand = 0
    for seg, cap in zip(*view.k1_segments):
        m = seg.sorted_keys.shape[1]
        ids, hit = epi.probe_windows(seg.sorted_keys, seg.perm, keys, cap,
                                     seg.live, seg.win)
        _, valid = epi.dedup_windows(ids, hit, m)
        s, nc = int(hit.sum()), int(valid.sum())
        depth = math.ceil(math.log2(m + 1))
        if seg.win is None:
            steps = depth + math.ceil(math.log2(cap + 1))
            nbytes += b * l * t * steps * 4 + s * 5
        else:
            nbytes += b * l * t * (2 * depth * 4 + 8) + s * 8
        nbytes += nc * (c_row + 4)
        flops += nc * cand_flops
        slots, n_cand = slots + s, n_cand + nc
    return nbytes, flops, slots, n_cand


def phase_times(svc, cell, queries, k1_args):
    """The hash kernel per 65,536-item e2lsh-keys launch, its raw launch per
    query batch (held against its plain version on the first
    ``QUERY_HASH_BATCHES`` batches -> the max error; beside one fp32
    ``torch.einsum`` over the same operands -> its time) and K1 per query
    batch, on the card (CUDA events), beside their bounds and plain
    versions; each hash launch's plan and occupancy (``hash_plan``)."""
    idx = svc.index
    fam, corpus = idx.family, idx.effective_corpus()
    f = hash_fns(corpus.layout)
    stacked = idx.store.base.stacked
    chunk = 65536
    xs = [stacked[s:s + chunk] for s in range(0, stacked.shape[0], chunk)]
    p = fam.stacked_projection
    l, k = cell["tables"], cell["codes"]
    offs = fam.offsets.reshape(l, k)
    mults = idx._mults_t
    scale = corpus.scale * fam.projection.scale
    kw = dict(epilogue="e2lsh-keys", w=cell["width"], scale=scale)
    h_ms = cuda_ms([lambda x=x: f["kernel"](x, p, offs, mults, **kw)
                    for x in xs], 3 * len(xs))
    h_plain = cuda_ms([lambda x=x: f["plain"](x, p, offs, mults, **kw)
                       for x in xs[:2]], 2)
    t = l * k
    proj = fam.projection.input_format(fam.projection.leaves, 1.0)
    b_x = xs[0].shape[0]
    # each item's and each projection's row at its true ranks, read once;
    # uint32 multipliers and keys count 4 bytes each
    h_bytes = (b_x * corpus.row_floats * 4 + t * proj.row_floats * 4
               + t * 4 + k * 4 + b_x * l * 4)
    pair = inner_flops(corpus, proj)
    h_flops = b_x * t * pair
    h_bound, h_by = bound_ms(h_bytes, h_flops)
    hash_plan(corpus.layout, xs[0], p, f"build launch, {b_x} items")
    print(f"[time] {f['name']} e2lsh-keys, {b_x} items x {t} hashes: "
          f"{h_ms:.4f} ms (plain {h_plain:.4f} ms); bound {h_bound:.4f} ms "
          f"by {h_by} ({h_bytes / 1e6:.1f} MB, {h_flops / 1e9:.2f} GFLOP, "
          f"{pair} FLOP per (item, hash))")

    # the query side: one raw launch per batch of stacked queries
    qss = [q.stack()[1] for q in queries]
    q0 = queries[0]
    raw = dict(epilogue="raw", scale=q0.scale * fam.projection.scale)
    q_ms = cuda_ms([lambda x=x: f["kernel"](x, p, **raw) for x in qss],
                   3 * len(qss))
    q_plain = cuda_ms([lambda: f["plain"](qss[0], p, **raw)], 2)
    b_q = qss[0].shape[0]
    q_bytes = (b_q * q0.row_floats * 4 + t * proj.row_floats * 4
               + b_q * t * 4)
    q_flops = b_q * t * inner_flops(q0, proj)
    q_bound, q_by = bound_ms(q_bytes, q_flops)
    hash_plan(corpus.layout, qss[0], p, f"query launch, {b_q} items")
    q_lib = cuda_ms([lambda x=x: library_raw(corpus.layout, x, p)
                     for x in qss[:4]], 12)
    lib_err = float((raw["scale"] * library_raw(corpus.layout, qss[0], p)
                     - f["kernel"](qss[0], p, **raw)).abs().max())
    print(f"[time] {f['name']} raw, {b_q} query items x {t} hashes (one per "
          f"batch): {q_ms:.4f} ms (plain {q_plain:.4f} ms; one fp32 "
          f"torch.einsum over the same operands {q_lib:.4f} ms, max "
          f"|einsum - kernel| {lib_err:.3g}); bound {q_bound:.4f} ms by "
          f"{q_by} ({q_bytes / 1e6:.2f} MB, {q_flops / 1e9:.3f} GFLOP)")
    # that launch against its plain version on the first batches' stacked
    # queries: within the rounding bound, and no further from float64
    q_err, acc = 0.0, Accuracy()
    for q, x in zip(queries[:QUERY_HASH_BATCHES], qss):
        s = q.scale * fam.projection.scale
        raw_k = f["kernel"](x, p, epilogue="raw", scale=s)
        raw_p = f["plain"](x, p, epilogue="raw", scale=s)
        bound = f["bound"](x, p, s)
        err = (raw_k - raw_p).abs()
        if not bool((err <= bound).all()):
            fail(f"{f['name']} raw, query batch: {int((err > bound).sum())} "
                 f"values outside the rounding bound (max err "
                 f"{float(err.max()):.3g})")
        acc.add(raw_k, raw_p, exact_raw(f, x, p, s))
        q_err = max(q_err, float(err.max()))
    accuracy = acc.check(f"{f['name']} raw, query batches")
    print(f"[{f['name']}] raw on {min(len(qss), QUERY_HASH_BATCHES)} query "
          f"batches of {b_q}: within the rounding bound (max |kernel - "
          f"plain| {q_err:.3g}); {accuracy}")

    k1_t = k1_times(svc, queries, k1_args,
                    "K1-TT" if corpus.layout == "tt" else "K1")
    return ((h_ms, h_plain, h_bound, h_by), k1_t,
            (q_ms, q_plain, q_bound, q_by), q_err, q_lib)


def k1_times(svc, queries, k1_args, name, corpus=None):
    """K1 (K1s) per query batch on the card (CUDA events, cycling the
    batches) beside its bound and its plain version's time on one batch."""
    from repro_torch.core import probing
    from repro_torch.kernels import fused_query as fq
    idx = svc.index
    fam = idx.family
    if corpus is None:
        corpus = idx.effective_corpus()
    values, offs, mults, qs, view, kw = k1_args
    kernel, plain, _ = k1_entry(view)
    segs = view.k1_segments[0]
    qss = [q.stack() for q in queries]
    vals = [fam.raw_stacked(q[1], q[0].scale) for q in qss]
    before = read_counts()
    k1_ms = cuda_ms([lambda v=v, q=q: kernel(v, offs, mults, q, **kw)
                     for v, q in zip(vals, qss)], 3 * len(queries))
    after = read_counts()
    # cuda_ms launched every batch 4 times (a warm-up pass, then 3)
    scratch = sum(after[f"{k}:scratch"] - before[f"{k}:scratch"]
                  for k in K1_WRAPPERS) / (4 * len(queries))
    rq = qs[1].shape[-1]
    window, may_scratch, smem = fq.launch_plan(
        view.k1_table, rq, num_tables=kw["num_tables"],
        probes=kw["probes"], topk=kw["topk"],
        expansion=(probing.expansion_size(kw["kind"], kw["num_codes"])
                   if kw["probes"] > 1 else 0))
    occ = fq.occupancy(view.k1_table, rq, smem)
    k1_plain = cuda_ms([lambda: plain(values, offs, mults, qs, **kw)], 2)
    q0 = qs[0]
    k1_bytes, k1_flops, slots, n_cand = k1_work(
        k1_args, q0.row_floats * 4, corpus.row_floats * 4,
        inner_flops(q0, corpus) + inner_flops(corpus, corpus),
        inner_flops(q0, q0))
    k1_bound, k1_by = bound_ms(k1_bytes, k1_flops)
    print(f"[time] {name}, B={values.shape[0]}, T={kw['probes']}, "
          f"{len(segs)} segment(s), {slots} window slots, {n_cand} "
          f"candidates: {k1_ms:.4f} ms (plain {k1_plain:.4f} ms); bound "
          f"{k1_bound:.5f} ms by {k1_by} ({k1_bytes / 1e6:.2f} MB, "
          f"{k1_flops / 1e9:.3f} GFLOP); {occ['registers']} registers a "
          f"thread, {occ['blocks_per_sm']} blocks per SM (target "
          f"{occ['target_blocks']}), {occ['local_bytes']} local bytes, "
          f"{smem} shared bytes per block, a {window}-slot shared window"
          f"{' with the global scratch' if may_scratch else ''}: "
          f"{scratch:.1f} queries per batch used the scratch")
    if occ["blocks_per_sm"] < occ["target_blocks"]:
        fail(f"{name}: {occ['blocks_per_sm']} blocks per SM, below the "
             f"target {occ['target_blocks']} K1's window was sized for")
    return k1_ms, k1_plain, k1_bound, k1_by


def phase_profile(svc, queries, tag):
    """Where a query batch's time goes: torch.profiler over the main path's
    batches, device time by kernel and the device's busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    queries = queries[:64]
    svc.query_arrays(queries[0], topk=TOPK)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for q in queries:
            svc.query_arrays(q, topk=TOPK)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")
                   and e.self_device_time_total > 0), reverse=True)
    busy_ms = sum(r[0] for r in rows)
    print(f"[{tag}] {len(queries)} query batches under the profiler: wall "
          f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"({busy_ms / wall_ms:.1%}); idle {1 - busy_ms / wall_ms:.1%}")
    for ms, count, key in rows[:8]:
        print(f"[{tag}]   {ms:9.3f} ms x{count:<4d} {key[:80]}")


# [mp]: the reference's multi-probe headline pair (L = 2, T = 8) on the CP
# cell; [mut]: the reference's mutation / SLO benchmarks' cap (64), T = 4
MP = dict(tables=2, probes=8)
MUT = dict(cap=64, probes=4, max_deltas=8, inserts=8, insert_batch=1024,
           deletes=16384, deletes_later=1024, planted_inserted=8)
TT_MUT = dict(log2_corpus=16, cap=64, probes=4, inserts=2, deletes=2048)


def cat_tensors(parts):
    """Batched CP or TT tensors of one scale -> one batch."""
    import torch
    return type(parts[0])(tuple(torch.cat(ls) for ls in
                                zip(*(p.leaves for p in parts))),
                          parts[0].scale)


def same_answers(a, b, label) -> None:
    """Two services' (ids, scores, n_cand) bit for bit."""
    import numpy as np
    for x, y, what in zip(a, b, ("ids", "scores", "n_cand")):
        if not np.array_equal(np.asarray(x).view(np.int32),
                              np.asarray(y).view(np.int32)):
            fail(f"{label}: {what} differ in "
                 f"{int((np.asarray(x) != np.asarray(y)).sum())} cells")


def phase_mp(cell, corpus, qids, queries, main):
    """[mp]: build_service with L = 2 tables and probes T = 8 over the CP
    cell's corpus and queries (K1's dense multi-probe branch), counters
    zeroed just before and read just after; then K1 against its plain
    version and its time."""
    import torch
    from repro_torch.serving.lsh_service import build_service
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    svc = build_service(torch.Generator(device="cuda").manual_seed(1),
                        cell["kind"], cell["dims"], corpus,
                        num_codes=cell["codes"], num_tables=MP["tables"],
                        rank=cell["rank"], bucket_width=cell["width"],
                        probes=MP["probes"], device="cuda")
    results, lat_ms = serve(svc, queries)
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    n = corpus.leaves[0].shape[0]
    cap = svc.index.cap
    print(f"[mp] build_service, {cell['kind']} K={cell['codes']} "
          f"L={MP['tables']} T={MP['probes']}, exact cap {cap} -> window "
          f"L*T*cap = {MP['tables'] * MP['probes'] * cap}; build "
          f"{svc.stats.build_s:.3f} s")
    summary = latency_line("mp", svc, lat_ms)
    print(f"[mp] launches on the main path: {counts}")
    check_counts(counts, "mp", ("cp_gram", "fused_query",
                                "fused_query:multiprobe"))
    hits1, n_q = check_results(results, [q.cpu().numpy() for q in qids], n)
    corpus_eff = svc.index.effective_corpus()
    r10 = recall10(svc, queries[0], results[0][0], corpus_eff)
    print(f"[mp] L={MP['tables']} T={MP['probes']}: recall@1 (planted) "
          f"{hits1 / n_q:.4f}, recall@10 {r10:.4f}, {summary['cand']:.1f} "
          f"candidates, {summary['mean']:.3f} ms/batch; [main] L="
          f"{cell['tables']} T=1: recall@1 {main['recall1']:.4f}, recall@10 "
          f"{main['recall10']:.4f}, {main['cand']:.1f} candidates, "
          f"{main['mean']:.3f} ms/batch; peak device memory "
          f"{peak / 2**30:.2f} GiB")
    k1_err, k1_args = k1_compare(svc, queries[0],
                                 f"mp, T={MP['probes']}, B={len(qids[0])}",
                                 probes=MP["probes"], corpus=corpus_eff)
    k1_t = k1_times(svc, queries, k1_args, f"K1 T={MP['probes']}",
                    corpus_eff)
    return record("fused_query[T>1]", *K1_SOURCE, counts,
                  "fused_query:multiprobe", k1_err, k1_t)


def mut_queries(corpus, inserted, qids, gen):
    """[mut]'s batches: 7/8 planted on the [main] targets (base items),
    1/8 on inserted items -> (query batches, per batch the targets'
    sequence ids)."""
    import numpy as np
    import torch
    n = corpus.leaves[0].shape[0]
    n_ins = inserted.leaves[0].shape[0]
    queries, targets = [], []
    for q in qids:
        b = len(q)
        k = b // MUT["planted_inserted"]
        ins = torch.randint(0, n_ins, (k,), generator=gen, device="cuda")
        src = cat_tensors([corpus.index(q[:b - k]), inserted.index(ins)])
        queries.append(make_queries(src, torch.arange(b, device="cuda"),
                                    gen))
        targets.append(np.concatenate([q[:b - k].cpu().numpy(),
                                       n + ins.cpu().numpy()]))
    return queries, targets


def mut_script(tag, svc, batches, n, rng, after_deletes=None,
               after_inserts=None):
    """[mut]'s mutations on a 2^20-item service: 16,384 base deletes, the
    insert batches (one delta or slab each), then 1,024 deletes across the
    base and the deltas (a quarter of them on inserted items) -> (the live
    items' sequence ids in effective-id order, the deleted ones, a timing
    note). ``after_deletes`` / ``after_inserts`` run the caller's gates
    between the steps."""
    import numpy as np
    import torch
    live_seq = np.arange(n)         # the script's own map: eff id -> seq id
    n_ins = sum(b.leaves[0].shape[0] for b in batches)
    # deletes on the base (the live-window tables rebuilt once)
    n_del = min(MUT["deletes"], n // 16)
    del1 = np.sort(rng.choice(n, n_del, replace=False))
    t0 = time.perf_counter()
    svc.delete(del1)
    torch.cuda.synchronize()
    del1_ms = (time.perf_counter() - t0) * 1e3
    deleted = [live_seq[del1]]
    live_seq = np.delete(live_seq, del1)
    if after_deletes is not None:
        after_deletes()
    ins_ms, parts = [], []
    for batch in batches:
        t0 = time.perf_counter()
        svc.insert(batch)
        ins_ms.append((time.perf_counter() - t0) * 1e3)
        parts.append(svc.index.insert_s)
    live_seq = np.concatenate([live_seq, n + np.arange(n_ins)])
    if len(svc.index.store.deltas) != len(batches):
        fail(f"{tag}: {len(svc.index.store.deltas)} deltas after "
             f"{len(batches)} inserts")
    if after_inserts is not None:
        after_inserts()
    # deletes spanning the base and the deltas, planted targets included
    n_live = len(live_seq)
    later = MUT["deletes_later"]
    del2 = np.sort(np.concatenate([
        rng.choice(n_live - n_ins, later - later // 4, replace=False),
        n_live - n_ins + rng.choice(n_ins, later // 4, replace=False)]))
    t0 = time.perf_counter()
    svc.delete(del2)
    torch.cuda.synchronize()
    del2_ms = (time.perf_counter() - t0) * 1e3
    deleted.append(live_seq[del2])
    live_seq = np.delete(live_seq, del2)
    parts = np.mean(np.asarray(parts), axis=0) * 1e3
    note = (f"delete {n_del} base ids {del1_ms:.3f} ms; {len(batches)} "
            f"inserts of {batches[0].leaves[0].shape[0]}: "
            f"{np.mean(ins_ms):.3f} ms per batch mean (hash {parts[0]:.3f}, "
            f"sort {parts[1]:.3f}, lookups {parts[2]:.3f} ms); delete "
            f"{later} ids over base and deltas {del2_ms:.3f} ms")
    return live_seq, np.concatenate(deleted), note


def check_mut_results(tag, svc, results, targets, live_seq, deleted, n,
                      check_store=True):
    """No deleted item among the returned ids, and (``check_store``, before
    a compaction renumbers the sequence) the script's bookkeeping of
    effective ids agrees with the store's -> (recall@1 hits, rows whose
    target survives, the targets' effective ids per batch)."""
    import numpy as np
    store = svc.index.store
    if check_store and not np.array_equal(np.flatnonzero(store._live_seq),
                                          live_seq):
        fail(f"{tag}: the store's effective ids disagree with the script's "
             "own bookkeeping")
    eff_of_seq = np.full(n, -1)
    eff_of_seq[live_seq] = np.arange(len(live_seq))
    tgts = [eff_of_seq[t] for t in targets]
    hits1, rows = check_results(results, tgts, len(live_seq))
    for ids, _, _ in results:
        if np.isin(live_seq[ids[ids >= 0]], deleted).any():
            fail(f"{tag}: a deleted item was returned")
    return hits1, rows, tgts


def phase_mut(cell, corpus, qids, args):
    """[mut]: the capped, mutable, multi-probe path at full width (K1's
    live-window branch over a base and eight deltas), counters zeroed just
    before and read just after each of its two runs (mutations + queries;
    compaction + queries + auto-compaction), with its gates."""
    import numpy as np
    import torch
    from repro_torch.kernels import parity
    from repro_torch.serving.lsh_service import build_service
    n = corpus.leaves[0].shape[0]
    b = len(qids[0])
    gen = torch.Generator(device="cuda").manual_seed(5)
    rng = np.random.default_rng(17)
    data = hash_fns("cp")["data"]
    batches = [data(gen, cell["dims"], cell["rhat"],
                    batch=MUT["insert_batch"]) for _ in range(MUT["inserts"])]
    inserted = cat_tensors(batches)
    n_ins = inserted.leaves[0].shape[0]
    queries, targets = mut_queries(corpus, inserted, qids, gen)
    kw = dict(num_codes=cell["codes"], num_tables=cell["tables"],
              rank=cell["rank"], bucket_width=cell["width"],
              bucket_cap=MUT["cap"], probes=MUT["probes"], device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    svc = build_service(torch.Generator(device="cuda").manual_seed(1),
                        cell["kind"], cell["dims"], corpus,
                        max_deltas=MUT["max_deltas"], **kw)
    fam = svc.index.family

    def fresh_after_deletes():
        # after deletes only, the capped index answers as a fresh capped
        # build
        fresh = build_service(None, cell["kind"], cell["dims"],
                              svc.index.effective_corpus(), family=fam, **kw)
        for q in queries[:8]:
            same_answers(svc.query_arrays(q, topk=TOPK),
                         fresh.query_arrays(q, topk=TOPK),
                         "mut: capped index after deletes vs a fresh capped "
                         "build")

    live_seq, deleted, note = mut_script("mut", svc, batches, n, rng,
                                         after_deletes=fresh_after_deletes)
    results, lat_ms = serve(svc, queries)
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    n_segs = len(svc.index.store.view.segments)
    print(f"[mut] build_service, bucket_cap {MUT['cap']}, L={cell['tables']}"
          f" T={MUT['probes']}, max_deltas {MUT['max_deltas']}: build "
          f"{svc.stats.build_s:.3f} s; {note}; {n_segs} segments, "
          f"{svc.index.size} live")
    summary = latency_line("mut", svc, lat_ms, f" over {n_segs} segments")
    print(f"[mut] launches on the main path: {counts}")
    check_counts(counts, "mut", ("cp_gram", "fused_query",
                                 "fused_query:multiprobe",
                                 "fused_query:live_window",
                                 "fused_query:segments"))
    hits1, rows, tgts = check_mut_results("mut", svc, results, targets,
                                          live_seq, deleted, n + n_ins)
    # the returned ids name the script's own items: scores against them
    own = cat_tensors([corpus, inserted]).index(
        torch.from_numpy(live_seq).cuda())
    ids0 = torch.from_numpy(results[0][0]).cuda()
    sc0 = torch.from_numpy(results[0][1]).cuda()
    tol = parity.rerank_bound(svc.index.metric, queries[0], own, ids0, sc0)
    exact = exact_scores(svc.index.metric, queries[0], own, ids0)
    if bool(((sc0.double() - exact).abs() > tol)[ids0 >= 0].any()):
        fail("mut: returned scores are not the returned items' distances")
    del own
    recall1 = hits1 / rows
    print(f"[mut] recall@1 (planted, surviving targets) {recall1:.4f} over "
          f"{rows} queries ({sum(len(t) for t in tgts) - rows} targets "
          f"deleted); no deleted item among {sum(int((r[0] >= 0).sum()) for r in results)}"
          f" returned ids; scores are the script's own items' distances; "
          f"peak device memory {peak / 2**30:.2f} GiB")
    if recall1 < RECALL1_MIN:
        fail(f"mut: recall@1 {recall1} below {RECALL1_MIN}")
    corpus_eff = svc.index.effective_corpus()
    k1_err, k1_args = k1_compare(svc, queries[0],
                                 f"mut, {n_segs} segments, cap {MUT['cap']},"
                                 f" T={MUT['probes']}, B={b}",
                                 probes=MUT["probes"], corpus=corpus_eff)
    k1_t = k1_times(svc, queries, k1_args,
                    f"K1 live window, {n_segs} segments", corpus_eff)
    del corpus_eff, k1_args

    # the second run: compaction, queries, an insert that auto-compacts
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    svc.compact()
    compact_s = time.perf_counter() - t0
    results, lat_ms = serve(svc, queries)
    after = latency_line("mut", svc, lat_ms, " after compact()")
    fresh = build_service(None, cell["kind"], cell["dims"],
                          svc.index.effective_corpus(), family=fam, **kw)
    for q in queries[:8]:
        same_answers(svc.query_arrays(q, topk=TOPK),
                     fresh.query_arrays(q, topk=TOPK),
                     "mut: compacted index vs a fresh build")
    del fresh
    for _ in range(MUT["max_deltas"]):
        svc.insert(data(gen, cell["dims"], cell["rhat"], batch=b))
    if len(svc.index.store.deltas) != MUT["max_deltas"]:
        fail("mut: the index compacted before max_deltas")
    svc.insert(data(gen, cell["dims"], cell["rhat"], batch=b))
    torch.cuda.synchronize()
    counts2 = read_counts()
    if svc.stats.auto_compactions != 1 or svc.index.store.deltas:
        fail(f"mut: an insert past max_deltas did not auto-compact "
             f"({svc.stats.auto_compactions} auto-compactions, "
             f"{len(svc.index.store.deltas)} deltas)")
    check_counts(counts2, "mut (compaction)", ("cp_gram", "fused_query",
                                               "fused_query:multiprobe",
                                               "fused_query:live_window"))
    hits1c, rows_c = check_results(results, tgts, len(live_seq))
    print(f"[mut] compact() {compact_s:.3f} s (prepare {svc.stats.compact_ms:.3f}"
          f" ms); the compacted index equals a fresh build bit for bit")
    corpus_eff = svc.index.effective_corpus()
    _, k1_args = k1_compare(svc, queries[0], f"mut after compact(), cap "
                            f"{MUT['cap']}, T={MUT['probes']}, B={b}",
                            probes=MUT["probes"], corpus=corpus_eff)
    k1_times(svc, queries, k1_args, "K1 live window, compacted", corpus_eff)
    del corpus_eff, k1_args
    print(f"[mut] after compact(): recall@1 {hits1c / rows_c:.4f}; an insert"
          f" on {MUT['max_deltas']} deltas auto-compacted in "
          f"{svc.stats.auto_compact_ms:.3f} ms (insert_ms excludes it: "
          f"{svc.stats.insert_ms / svc.stats.insert_batches:.3f} ms per "
          f"insert); launches: {counts2}")
    del summary, after
    return record("fused_query[live window, segments]", *K1_SOURCE, counts,
                  "fused_query:segments", k1_err, k1_t)


def phase_tt_mut(cell) -> None:
    """[tt-mut]: K1-TT's new branches at the [tt-srp] scale (2^16 TT
    items): bucket_cap, T = 4, two deltas and a delete, counters checked,
    K1-TT against its plain version."""
    import numpy as np
    import torch
    from repro_torch.serving.lsh_service import build_service
    n = 1 << TT_MUT["log2_corpus"]
    gen = torch.Generator(device="cuda").manual_seed(23)
    data = hash_fns("tt")["data"]
    corpus = data(gen, cell["dims"], cell["rhat"], batch=n)
    zero_counts()
    svc = build_service(torch.Generator(device="cuda").manual_seed(1),
                        cell["kind"], cell["dims"], corpus,
                        num_codes=cell["codes"], num_tables=cell["tables"],
                        rank=cell["rank"], bucket_width=cell["width"],
                        bucket_cap=TT_MUT["cap"], probes=TT_MUT["probes"],
                        device="cuda")
    for _ in range(TT_MUT["inserts"]):
        svc.insert(data(gen, cell["dims"], cell["rhat"], batch=1024))
    rng = np.random.default_rng(29)
    svc.delete(rng.choice(svc.index.size, TT_MUT["deletes"], replace=False))
    q = make_queries(corpus, torch.randint(0, n, (1024,), generator=gen,
                                           device="cuda"), gen)
    ids, _, n_cand = svc.query_arrays(q, topk=TOPK)
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"[tt-mut] n={n} TT items + {TT_MUT['inserts']} deltas of 1024, "
          f"{TT_MUT['deletes']} deleted, bucket_cap {TT_MUT['cap']}, "
          f"T={TT_MUT['probes']}: {float(n_cand.mean()):.1f} candidates per "
          f"query, {(ids[:, 0] >= 0).mean():.4f} rows answered; launches "
          f"{counts}")
    check_counts(counts, "tt-mut", ("tt_inner", "fused_query",
                                    "fused_query:multiprobe",
                                    "fused_query:live_window",
                                    "fused_query:segments"))
    k1_compare(svc, q, f"tt-mut, 3 segments, cap {TT_MUT['cap']}, "
                       f"T={TT_MUT['probes']}", probes=TT_MUT["probes"])


# [shard] / [shard-mut]: the CP cell and [mut]'s script over S = 4 shards on
# the one card; [tt-shard]: the TT cell's tt-srp index at 2^16 over S = 3
# (2^16 = 3 * 21,846 - 2: the last shard padded)
SHARD = dict(shards=4, tt_shards=3)


def phase_shard(cell, corpus, qids, queries, main_results):
    """[shard]: [main]'s corpus, family and queries through
    ``build_service(..., shards=4)`` (exact cap, T = 1), counters zeroed
    just before and read just after; every batch's ids, scores and
    candidate counts must equal [main]'s bit for bit (shard-count
    invariance); then K1s against its plain version, its time and a
    profile."""
    import torch
    from repro_torch.serving.lsh_service import build_service
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    svc = build_service(torch.Generator(device="cuda").manual_seed(1),
                        cell["kind"], cell["dims"], corpus,
                        num_codes=cell["codes"], num_tables=cell["tables"],
                        rank=cell["rank"], bucket_width=cell["width"],
                        shards=SHARD["shards"], device="cuda")
    results, lat_ms = serve(svc, queries)
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    idx = svc.index
    n = corpus.leaves[0].shape[0]
    print(f"[shard] build_service, shards={SHARD['shards']} of "
          f"{idx.shard_size} items, exact per-shard cap {idx.cap} -> window "
          f"L*cap = {cell['tables'] * idx.cap}; build {svc.stats.build_s:.3f}"
          f" s (hash {svc.stats.hash_s:.3f}, sort {svc.stats.sort_s:.3f}); "
          f"occupancy {svc.stats.shard_occupancy}; peak device memory "
          f"{peak / 2**30:.2f} GiB")
    summary = latency_line("shard", svc, lat_ms)
    print(f"[shard] launches on the main path: {counts}")
    check_counts(counts, "shard", (cell["hash_kernel"], "fused_query_sharded",
                                   "fused_query_sharded:segments"))
    if counts["fused_query"]:
        fail("shard: the single-device K1 wrapper ran on the sharded path")
    for i, (got, want) in enumerate(zip(results, main_results)):
        same_answers(got, want, f"shard: batch {i} against [main]")
    hits1, n_q = check_results(results, [q.cpu().numpy() for q in qids], n)
    print(f"[shard] all {len(results)} batches equal [main]'s bit for bit "
          f"(ids, scores, candidate counts); recall@1 {hits1 / n_q:.4f}")
    k1_err, k1_args = k1_compare(svc, queries[0],
                                 f"shard, S={SHARD['shards']}, "
                                 f"B={len(qids[0])}")
    k1_t = k1_times(svc, queries, k1_args, f"K1s S={SHARD['shards']}")
    phase_profile(svc, queries, "shard-profile")
    del summary
    return record("fused_query_sharded", *K1S_SOURCE, counts,
                  "fused_query_sharded", k1_err, k1_t)


def phase_shard_mut(cell, corpus, qids, args):
    """[shard-mut]: [mut]'s script (bucket_cap 64, T = 4, max_deltas 8) over
    S = 4 shards: routed slabs, K1s's live-window branch over 4 x 9
    (shard, segment) pairs, shard-local ``compact()`` and ``rebalance()``,
    with counters zeroed just before and read just after each run; gates:
    occupancy within one item of even after the routed inserts, no deleted
    id returned, recall@1, the rebalanced index equal to a fresh sharded
    build bit for bit, and an exact-cap mutated sharded index equal to a
    fresh single-device one (ids and candidate counts)."""
    import numpy as np
    import torch
    from repro_torch.serving.lsh_service import build_service
    n = corpus.leaves[0].shape[0]
    b = len(qids[0])
    s = SHARD["shards"]
    gen = torch.Generator(device="cuda").manual_seed(5)
    data = hash_fns("cp")["data"]
    batches = [data(gen, cell["dims"], cell["rhat"],
                    batch=MUT["insert_batch"]) for _ in range(MUT["inserts"])]
    inserted = cat_tensors(batches)
    n_ins = inserted.leaves[0].shape[0]
    queries, targets = mut_queries(corpus, inserted, qids, gen)
    base_kw = dict(num_codes=cell["codes"], num_tables=cell["tables"],
                   rank=cell["rank"], bucket_width=cell["width"],
                   max_deltas=MUT["max_deltas"], device="cuda")
    kw = dict(base_kw, bucket_cap=MUT["cap"], probes=MUT["probes"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    svc = build_service(torch.Generator(device="cuda").manual_seed(1),
                        cell["kind"], cell["dims"], corpus, shards=s, **kw)
    fam = svc.index.family
    occ = {}

    def uneven():
        occ["deleted"] = svc.stats.shard_occupancy

    def even():
        o = occ["inserted"] = svc.stats.shard_occupancy
        if max(o) - min(o) > 1:
            fail(f"shard-mut: occupancy {o} not within one item of even "
                 "after the routed inserts")

    live_seq, deleted, note = mut_script(
        "shard-mut", svc, batches, n, np.random.default_rng(17),
        after_deletes=uneven, after_inserts=even)
    results, lat_ms = serve(svc, queries)
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    view = svc.index.store.view
    pairs = len(view.k1_segments[0])
    slabs = [d.shard_size for d in view.segments[1:]]
    print(f"[shard-mut] build_service, shards={s}, bucket_cap {MUT['cap']}, "
          f"L={cell['tables']} T={MUT['probes']}: build "
          f"{svc.stats.build_s:.3f} s; {note}; slab widths {slabs}; "
          f"occupancy after the base deletes {occ['deleted']}, after "
          f"the routed inserts {occ['inserted']}, now "
          f"{svc.stats.shard_occupancy} (skew "
          f"{svc.stats.occupancy_skew:.6f}); {pairs} (shard, segment) pairs")
    summary = latency_line("shard-mut", svc, lat_ms,
                           f" over {pairs} (shard, segment) pairs")
    print(f"[shard-mut] launches on the main path: {counts}")
    check_counts(counts, "shard-mut", (
        "cp_gram", "fused_query_sharded", "fused_query_sharded:multiprobe",
        "fused_query_sharded:live_window", "fused_query_sharded:segments"))
    hits1, rows, tgts = check_mut_results("shard-mut", svc, results, targets,
                                          live_seq, deleted, n + n_ins)
    recall1 = hits1 / rows
    print(f"[shard-mut] recall@1 (planted, surviving targets) {recall1:.4f} "
          f"over {rows} queries; no deleted item returned; peak device "
          f"memory {peak / 2**30:.2f} GiB")
    if recall1 < RECALL1_MIN:
        fail(f"shard-mut: recall@1 {recall1} below {RECALL1_MIN}")
    corpus_eff = svc.index.effective_corpus()
    k1_err, k1_args = k1_compare(svc, queries[0],
                                 f"shard-mut, {pairs} pairs, cap "
                                 f"{MUT['cap']}, T={MUT['probes']}, B={b}",
                                 probes=MUT["probes"], corpus=corpus_eff)
    k1_t = k1_times(svc, queries, k1_args,
                    f"K1s live window, {pairs} pairs", corpus_eff)
    del corpus_eff, k1_args

    # the second run: shard-local compaction, queries, rebalance
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    svc.compact()
    compact_s = time.perf_counter() - t0
    counts_after = svc.index.store.base.counts
    results, lat_ms = serve(svc, queries)
    latency_line("shard-mut", svc, lat_ms, " after compact()")
    hits1c, rows_c, _ = check_mut_results("shard-mut (compacted)", svc,
                                          results, targets, live_seq,
                                          deleted, n + n_ins,
                                          check_store=False)
    t0 = time.perf_counter()
    svc.rebalance()
    rebalance_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts2 = read_counts()
    check_counts(counts2, "shard-mut (compaction)", (
        "fused_query_sharded", "fused_query_sharded:live_window"))
    fresh = build_service(None, cell["kind"], cell["dims"],
                          svc.index.effective_corpus(), family=fam, shards=s,
                          **kw)
    for q in queries[:8]:
        same_answers(svc.query_arrays(q, topk=TOPK),
                     fresh.query_arrays(q, topk=TOPK),
                     "shard-mut: rebalanced index vs a fresh sharded build")
    del fresh
    print(f"[shard-mut] compact() {compact_s:.3f} s (shard-local: per-shard "
          f"counts {counts_after}), recall@1 {hits1c / rows_c:.4f}; "
          f"rebalance() {rebalance_s:.3f} s (prepare "
          f"{svc.stats.rebalance_ms:.3f} ms) -> counts "
          f"{svc.index.store.base.counts}, {svc.stats.rebalances} rebalance; "
          f"the rebalanced index equals a fresh sharded build bit for bit; "
          f"launches: {counts2}")
    del svc

    # exact cap: a mutated sharded index answers as a fresh single-device
    # index over its effective corpus
    ex = build_service(torch.Generator(device="cuda").manual_seed(1),
                       cell["kind"], cell["dims"], corpus, shards=s,
                       **base_kw)
    mut_script("shard-mut (exact cap)", ex, batches, n,
               np.random.default_rng(17))
    single = build_service(None, cell["kind"], cell["dims"],
                           ex.index.effective_corpus(), family=fam,
                           **base_kw)
    for q in queries[:8]:
        got = ex.query_arrays(q, topk=TOPK)
        want = single.query_arrays(q, topk=TOPK)
        for x, y, what in ((got[0], want[0], "ids"),
                           (got[2], want[2], "n_cand")):
            if not np.array_equal(x, y):
                fail(f"shard-mut: the exact-cap mutated sharded index's "
                     f"{what} differ from a fresh single-device index's in "
                     f"{int((x != y).sum())} cells")
    print(f"[shard-mut] exact cap (per-shard {ex.index.cap}): the mutated "
          f"sharded index ({len(ex.index.store.deltas)} slabs) answers as a "
          "fresh single-device index over its effective corpus (ids and "
          "candidate counts bit for bit, 8 batches)")
    del summary
    return record("fused_query_sharded[live window, slabs]", *K1S_SOURCE,
                  counts, "fused_query_sharded:segments", k1_err, k1_t)


def phase_tt_shard(cell) -> None:
    """[tt-shard]: the TT cell's tt-srp / cosine index at 2^16 over S = 3
    shards (the last padded), untimed: counters checked, answers equal the
    single-device index's bit for bit, K1s-TT against its plain version."""
    import torch
    from repro_torch.serving.lsh_service import build_service
    c = cell["srp"]
    gen = torch.Generator(device="cuda").manual_seed(31)
    corpus = hash_fns("tt")["data"](gen, c["dims"], c["rhat"], batch=c["n"])
    kw = dict(metric="cosine", num_codes=c["codes"], num_tables=c["tables"],
              rank=c["rank"], device="cuda")
    zero_counts()
    svc = build_service(gen, "tt-srp", c["dims"], corpus,
                        shards=SHARD["tt_shards"], **kw)
    q = make_queries(corpus, torch.arange(0, c["n"], c["every"],
                                          device="cuda"), gen)
    got = svc.query_arrays(q, topk=TOPK)
    torch.cuda.synchronize()
    counts = read_counts()
    base = svc.index.store.base
    print(f"[tt-shard] n={c['n']} TT items over {SHARD['tt_shards']} shards "
          f"(counts {base.counts}, n_s {base.shard_size}), tt-srp K="
          f"{c['codes']} L={c['tables']}, per-shard cap {base.cap}: "
          f"{float(got[2].mean()):.1f} candidates per query; launches "
          f"{counts}")
    check_counts(counts, "tt-shard", ("tt_inner", "fused_query_sharded"))
    single = build_service(None, "tt-srp", c["dims"], corpus,
                           family=svc.index.family, **kw)
    same_answers(got, single.query_arrays(q, topk=TOPK),
                 "tt-shard: sharded vs single-device answers")
    del single
    print("[tt-shard] answers equal the single-device index's bit for bit")
    k1_compare(svc, q, f"tt-shard, S={SHARD['tt_shards']}, "
                       f"B={q.leaves[0].shape[0]}")


# [kernels]: the card twin of benchmarks/kernels.py (its K3 and K4 shapes,
# K6 at (256, 256) and the ragged shapes of tests/test_kernels.py, K7 at two
# widths), and the standalone kernels at serving scale: K6 over (2^20, 128)
# values and K7 over (2^20, 100), the L*K of [main]. K6 also at K in {4,
# 100, 2000, 4096} (4096: rows cut into pieces), at a B no chunk's rows
# divide, past the grid (the grid-stride loop wraps), on views with a
# storage offset of 1-3 floats (the scalar path; ``k6_views``: B, K,
# offset), and timed at ``k6_timed`` too
KERNELS = dict(
    k3=dict(b=64, n=4, d=64, r=32, l=8, k=8, w=4.0),
    k4=dict(b=32, n=4, d=32, r=16, l=4, k=8),
    k6=[(256, 256), (1, 1), (3, 31), (5, 33), (7, 40), (8, 70), (13, 64),
        (20, 5), (9, 96), (1000, 4), (3000, 100), (257, 2000), (33, 4096),
        (70001, 100), (1 << 17, 128)],
    k6_views=[(256, 128, 1), (129, 100, 2), (17, 2000, 3), (100003, 32, 2)],
    k6_timed=[(1 << 20, 100), (1 << 16, 2000)],
    k7=[(256, 100, 4.0), (33, 129, 6.0), (7, 1, 6.0)],
    serve_rows=1 << 20, k6_cols=128, k7_cols=100)


def bench_hash(layout, x, p, offs, mults, w, raw_k, keys_k, label):
    """benchmarks/kernels.py's checks on the card: the raw values against
    the plain version (rounding bound) and float64 (the accuracy-factor
    rule), and the fused keys bitwise against the tails composed on the
    kernel's own raw values -> max |kernel - plain|."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.e2lsh_quant import e2lsh_quant_plain
    f = hash_fns(layout)
    b, l, k = raw_k.shape
    raw_p = f["plain"](x, p, epilogue="raw")
    bound = f["bound"](x, p, 1.0)
    err = (raw_k - raw_p).abs()
    if not bool((err <= bound).all()):
        fail(f"{f['name']} {label}: {int((err > bound).sum())} raw values "
             "outside the rounding bound")
    acc = Accuracy()
    acc.add(raw_k, raw_p, exact_raw(f, x, p, 1.0))
    accuracy = acc.check(f"{f['name']} {label} raw")
    if offs is not None:
        codes = e2lsh_quant_plain(raw_k.reshape(b, l * k), offs.reshape(-1),
                                  w).reshape(b, l, k)
        epi = "e2lsh-keys"
    else:
        codes, epi = (raw_k > 0).to(torch.int32), "srp-keys"
    want = ref.combine_ref(codes, mults)
    if not torch.equal(keys_k, want):
        fail(f"{f['name']} {label}: {int((keys_k != want).sum())} {epi} "
             "differ from the tails composed on the kernel's raw values")
    print(f"[kernels] {f['name']} {label}: raw within the rounding bound, "
          f"max |kernel - plain| {float(err.max()):.3g} (relative to max "
          f"|raw| {float(err.max() / raw_p.abs().max()):.3g}); {accuracy}; "
          f"{epi} equal to the composed tails on all {keys_k.numel()} cells")
    return float(err.max())


def phase_kernels() -> list:
    """[kernels]: the kernel-level path (the standalone API and the hash
    kernels at benchmarks/kernels.py's shapes), counters zeroed just before
    and read just after; then every output against its plain version, and
    the times of K6, K7 and the two hash shapes -> their kernel records."""
    import torch
    from repro_torch.core import projections, tensor_formats
    from repro_torch.core.lsh import make_family, make_mults, pack_bits
    from repro_torch.kernels import ops
    from repro_torch.kernels.cp_gram import cp_gram
    from repro_torch.kernels.e2lsh_quant import e2lsh_quant_plain
    from repro_torch.kernels.srp_pack import srp_pack_plain
    from repro_torch.kernels.tt_inner import tt_inner
    gen = torch.Generator(device="cuda").manual_seed(23)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    c3, c4 = KERNELS["k3"], KERNELS["k4"]
    x3 = randn(c3["b"], c3["n"], c3["d"], c3["r"])
    p3 = randn(c3["n"], c3["l"], c3["k"], c3["d"], c3["r"])
    offs3 = torch.rand((c3["l"], c3["k"]), generator=gen,
                       device="cuda") * c3["w"]
    mults3 = ops.mults_tensor(make_mults(0, c3["k"]), "cuda")
    x4 = randn(c4["b"], c4["n"], c4["r"], c4["d"], c4["r"])
    p4 = randn(c4["n"], c4["l"], c4["k"], c4["r"], c4["d"], c4["r"])
    mults4 = ops.mults_tensor(make_mults(0, c4["k"]), "cuda")
    k6_in = [randn(b, k) for b, k in KERNELS["k6"]]
    k6_in += [randn(b * k + off)[off:].view(b, k)
              for b, k, off in KERNELS["k6_views"]]
    for v in k6_in:
        v[:, ::5] = 0.0
        v[:, 1::7] = -0.0
        v[:, 2::11] = float("nan")
        v[:, 3::13] = float("inf")
        v[:, 4::17] = -float("inf")
    k7_in = []
    for b, k, w in KERNELS["k7"]:
        offs = torch.rand(k, generator=gen, device="cuda") * w
        m = torch.randint(-1000, 1000, (b, k), generator=gen, device="cuda")
        edge = torch.nextafter(m.float() * w, torch.tensor(
            -float("inf"), device="cuda")) - offs
        k7_in += [(10.0 * randn(b, k), offs, w), (edge, offs, w)]
    fam = make_family(gen, "cp-srp", (8, 8, 8), num_codes=40, num_tables=3,
                      rank=2, device="cuda")
    xs = tensor_formats.cp_random_data(gen, (8, 8, 8), 3, batch=1000)
    x1 = tensor_formats.cp_random_data(gen, (10, 10, 10), 3)
    pc1 = projections.sample_cp_projection(gen, 12, (10, 10, 10), 4)
    t1 = tensor_formats.tt_random_data(gen, (9, 9, 9), 3)
    pt1 = projections.sample_tt_projection(gen, 10, (9, 9, 9), 2)
    torch.cuda.synchronize()

    zero_counts()
    raw3 = cp_gram(x3, p3, epilogue="raw")
    keys3 = cp_gram(x3, p3, offs3, mults3, epilogue="e2lsh-keys", w=c3["w"])
    raw4 = tt_inner(x4, p4, epilogue="raw")
    keys4 = tt_inner(x4, p4, None, mults4, epilogue="srp-keys")
    words = [ops.srp_pack(v) for v in k6_in]
    codes = [ops.e2lsh_quantize(v, o, w) for v, o, w in k7_in]
    packed, hashed = fam.hash_packed_batch(xs), fam.hash_batch(xs)
    ip_cp, ip_tt = ops.cp_inner_products(x1, pc1), ops.tt_inner_products(
        t1, pt1)
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"[kernels] launches on the kernel-level path: {counts}")
    check_counts(counts, "kernels", ("cp_gram", "tt_inner", "srp_pack",
                                     "e2lsh_quant"))

    err3 = bench_hash("cp", x3, p3, offs3, mults3, c3["w"], raw3, keys3,
                      "B=64 N=4 d=64 R=32 L=8 K=8")
    err4 = bench_hash("tt", x4, p4, None, mults4, 0.0, raw4, keys4,
                      "B=32 N=4 d=32 R=16 L=4 K=8")
    for v, got in zip(k6_in, words):
        if not torch.equal(got, srp_pack_plain(v)):
            fail(f"K6 {tuple(v.shape)} at storage offset "
                 f"{v.storage_offset()}: words differ from the plain "
                 "version's")
    for (v, o, w), got in zip(k7_in, codes):
        if not torch.equal(got, e2lsh_quant_plain(v, o, w)):
            fail(f"K7 {tuple(v.shape)} w={w}: codes differ from the plain "
                 "version's")
    if not torch.equal(packed, pack_bits(hashed)):
        fail("hash_packed_batch differs from pack_bits(hash_batch)")
    for name, got, p, x in (("cp_inner_products", ip_cp, pc1, x1),
                            ("tt_inner_products", ip_tt, pt1, t1)):
        want = projections.project_batch(p, x.index((None,)))[0]
        if not torch.allclose(got, want, rtol=2e-4, atol=2e-4):
            fail(f"{name} differs from the plain projection")
    print(f"[kernels] K6 at {KERNELS['k6']} and on views (B, K, offset) "
          f"{KERNELS['k6_views']} (zeros, -0.0, NaN, +-inf), and K7 at "
          f"{[(b, k, w) for b, k, w in KERNELS['k7']]} (random values and "
          "values one ulp below a bucket edge) equal their plain versions "
          "bit for bit; hash_packed_batch (cp-srp K=40, 2 words) equals "
          "pack_bits(hash_batch); cp/tt_inner_products within 2e-4 of the "
          "plain projection")
    print("[kernels] benchmarks/kernels.py's fused-hash block sweep tunes the "
          "TPU grid's (block_b, block_t) tiles; the CUDA kernels plan their "
          "blocks from the shape and the card's SM count (cp_gram.plan, "
          "tt_inner.plan), so the sweep has no counterpart here")
    hash_plan("cp", x3, p3, "B=64 N=4 d=64 R=32 L=8 K=8")
    hash_plan("tt", x4, p4, "B=32 N=4 d=32 R=16 L=4 K=8")

    # times: the two standalone kernels at serving scale, the hash kernels
    # at the benchmark's shapes
    rows = KERNELS["serve_rows"]
    v6 = [randn(rows, KERNELS["k6_cols"]) for _ in range(2)]
    k7c = KERNELS["k7_cols"]
    v7 = [randn(rows, k7c) for _ in range(2)]
    o7 = torch.rand(k7c, generator=gen, device="cuda") * 2.0
    t6 = k6_time(v6, True)
    read = cuda_ms([lambda v=v: torch.amax(v) for v in v6], 20)
    read_bound = bound_ms(v6[0].numel() * 4, 0)[0]
    print(f"[time] read yardstick: torch.amax over {tuple(v6[0].shape)} fp32 "
          f"(one read stream, no K6 function): {read:.4f} ms; its byte bound "
          f"(the values read once) {read_bound:.4f} ms, "
          f"{100 * read_bound / read:.1f}%")
    t7 = (cuda_ms([lambda v=v: ops.e2lsh_quantize(v, o7, 2.0) for v in v7],
                  20),
          cuda_ms([lambda: e2lsh_quant_plain(v7[0], o7, 2.0)], 3),
          *bound_ms(rows * k7c * 8 + k7c * 4, rows * k7c * 3))
    del v6, v7
    for b, k in KERNELS["k6_timed"]:
        v = [randn(b, k) for _ in range(2)]
        k6_time(v, False)
        del v
    n3 = c3["b"] * c3["l"] * c3["k"]
    t3 = (cuda_ms([lambda: cp_gram(x3, p3, offs3, mults3,
                                   epilogue="e2lsh-keys", w=c3["w"])], 20),
          cuda_ms([lambda: hash_fns("cp")["plain"](
              x3, p3, offs3, mults3, epilogue="e2lsh-keys", w=c3["w"])], 3),
          *bound_ms(4 * (x3.numel() + p3.numel() + c3["l"] * c3["k"]
                         + c3["k"] + c3["b"] * c3["l"]),
                    n3 * c3["r"] ** 2 * (2 * c3["n"] * c3["d"] + c3["n"])))
    n4 = c4["b"] * c4["l"] * c4["k"]
    ranks = (1,) + (c4["r"],) * (c4["n"] - 1) + (1,)
    t4 = (cuda_ms([lambda: tt_inner(x4, p4, None, mults4,
                                    epilogue="srp-keys")], 20),
          cuda_ms([lambda: hash_fns("tt")["plain"](
              x4, p4, None, mults4, epilogue="srp-keys")], 3),
          *bound_ms(4 * (x4.numel() + p4.numel() + c4["k"]
                         + c4["b"] * c4["l"]),
                    n4 * tt_chain_flops(ranks, ranks, (c4["d"],) * c4["n"])))
    for name, t, what in (
            ("K7", t7, f"({rows}, {k7c}) values"),
            ("K3 e2lsh-keys", t3, "B=64 N=4 d=64 R=32 L=8 K=8 (warp kernel)"),
            ("K4 srp-keys", t4, "B=32 N=4 d=32 R=16 L=4 K=8 (warp kernel)")):
        print(f"[time] {name}, {what}: {t[0]:.4f} ms (plain {t[1]:.4f} ms); "
              f"bound {t[2]:.4f} ms by {t[3]}")
    return [record("srp_pack", *K6_SOURCE, counts, "srp_pack", 0.0, t6),
            record("e2lsh_quant", *K7_SOURCE, counts, "e2lsh_quant", 0.0, t7),
            record("cp_gram[R=32]", *HASH_RECORDS["cp"][1:], counts,
                   "cp_gram", err3, t3),
            record("tt_inner[R=16]", *HASH_RECORDS["tt"][1:], counts,
                   "tt_inner", err4, t4)]


def k6_plan(v, label: str) -> None:
    """K6's launch plan for these values (``srp_pack.plan`` from the shape,
    the card's SM count and the alignment) and what the card makes of it;
    prints grid, threads, registers, blocks per SM, path and bytes in flight
    per SM, and fails below the plan's target blocks per SM."""
    from repro_torch.kernels.epilogues import sm_count
    from repro_torch.kernels.srp_pack import occupancy, plan
    sms = sm_count(v.device)
    p = plan(*v.shape, sms, v.data_ptr() % 16 == 0)
    occ = occupancy(p)
    pieces = (f"rows cut into {p.pieces} pieces of {p.piece} units"
              if p.pieces > 1 else f"{p.rows} rows a warp chunk, "
              f"{p.block_rows} a block step")
    print(f"[plan] K6 {label}: the {p.path} path, {p.threads} threads, grid "
          f"{p.blocks} blocks on {sms} SMs, {pieces}, {p.chunks} chunks; "
          f"{occ['registers']} registers a thread, {occ['local_bytes']} local "
          f"bytes, {occ['blocks_per_sm']} blocks per SM (target "
          f"{p.target_blocks}); {p.in_flight} bytes of loads in flight per "
          "SM at the target")
    if occ["blocks_per_sm"] < p.target_blocks:
        fail(f"K6 {label}: {occ['blocks_per_sm']} blocks per SM, below the "
             f"plan's {p.target_blocks}")


def k6_time(vs, plain: bool) -> tuple:
    """K6 over the (B, K) values ``vs`` (CUDA events, cycling them) beside
    its byte bound, and its plain version's time if ``plain``; prints its
    plan and a [time] line -> (ms, plain ms or None, bound ms, bound by)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.srp_pack import srp_pack_plain
    b, k = vs[0].shape
    k6_plan(vs[0], f"({b}, {k})")
    ms = cuda_ms([lambda v=v: ops.srp_pack(v) for v in vs], 20)
    plain_ms = cuda_ms([lambda: srp_pack_plain(vs[0])], 3) if plain else None
    bound, by = bound_ms(b * k * 4 + b * -(-k // 32) * 8, b * k)
    print(f"[time] K6, ({b}, {k}) values: {ms:.4f} ms"
          + (f" (plain {plain_ms:.4f} ms)" if plain else "")
          + f"; bound {bound:.4f} ms by {by}, {100 * bound / ms:.1f}%")
    return ms, plain_ms, bound, by


# [ann-k8]: examples/ann_search.py's own K = 8 over [main]'s corpus and
# queries; its exact cap (about 2950) makes L*cap = 29,500 slots, past K1's
# shared window: the launches carry the global scratch
ANN_K8 = dict(codes=8, k1_batches=4)


def phase_ann_k8(cell, corpus, qids, queries):
    """[ann-k8]: build_service at the example's K = 8 (L = 10, exact cap)
    over the CP cell's corpus and queries, counters zeroed just before and
    read just after; the queries that used K1's global scratch; recall@1;
    K1 against its plain version on the first batches; its time."""
    import torch
    from repro_torch.kernels.fused_query import window_plan
    from repro_torch.serving.lsh_service import build_service
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    svc = build_service(torch.Generator(device="cuda").manual_seed(1),
                        cell["kind"], cell["dims"], corpus,
                        num_codes=ANN_K8["codes"], num_tables=cell["tables"],
                        rank=cell["rank"], bucket_width=cell["width"],
                        device="cuda")
    results, lat_ms = serve(svc, queries)
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    idx = svc.index
    n = corpus.leaves[0].shape[0]
    stacked = idx.store.base.stacked
    plan = window_plan(cell["tables"], idx.cap, stacked.shape[1],
                       stacked.shape[2], stacked.shape[3], stacked.shape[3])
    print(f"[ann-k8] build_service, {cell['kind']} K={ANN_K8['codes']} "
          f"L={cell['tables']}: exact cap {idx.cap} -> L*cap = "
          f"{cell['tables'] * idx.cap} slots, a {plan[0]}-slot shared window"
          f"{' and the global scratch' if plan[1] else ''}; build "
          f"{svc.stats.build_s:.3f} s; peak device memory "
          f"{peak / 2**30:.2f} GiB")
    latency_line("ann-k8", svc, lat_ms)
    print(f"[ann-k8] launches on the main path: {counts}; queries that used "
          f"the global scratch: {counts['fused_query:scratch']} of "
          f"{(len(queries) + 1) * len(qids[0])}")
    check_counts(counts, "ann-k8", ("cp_gram", "fused_query"))
    if counts["fused_query:scratch"] == 0:
        fail("ann-k8: no query took K1's global scratch, so the main path "
             "no longer holds it against the plain version")
    hits1, n_q = check_results(results, [q.cpu().numpy() for q in qids], n)
    print(f"[ann-k8] recall@1 (planted) {hits1 / n_q:.4f} over {n_q} queries")
    if hits1 / n_q < RECALL1_MIN:
        fail(f"ann-k8: recall@1 {hits1 / n_q} below {RECALL1_MIN}")
    errs = []
    for i in range(ANN_K8["k1_batches"]):
        e, k1_args = k1_compare(svc, queries[i], f"ann-k8 batch {i}, "
                                                 f"B={len(qids[i])}",
                                need_scratch=True)
        errs.append(e)
    k1_t = k1_times(svc, queries, k1_args, "K1 ann-k8")
    return record("fused_query[ann-k8]", *K1_SOURCE, counts, "fused_query",
                  max(errs), k1_t)


# [limits]: the shapes F2 lifted. K3 at benchmarks/collision.py's (dims
# (8, 8, 8), rank 2, K = 2000 in one table), K4 at K = 1024, and a TT index
# at TT rank 16 through K4 (its warp kernel) and K1-TT (TR = 16)
LIMITS = dict(dims=(8, 8, 8), rank=2, items=4096, k3=2000, k4=1024, w=4.0,
              tt=dict(dims=(8, 8, 8, 8), rhat=16, n=1 << 14, codes=12,
                      tables=8, rank=4, every=64))


def phase_limits() -> list:
    """[limits]: K3 at K = 2000, K4 at K = 1024 and a TT rank-16 index,
    counters zeroed just before and read just after; each against its
    plain version (``hash_compare``, ``k1_compare``) and timed -> their
    kernel records."""
    import torch
    from repro_torch.core import projections, tensor_formats
    from repro_torch.kernels import ops
    from repro_torch.kernels.cp_gram import cp_gram
    from repro_torch.kernels.tt_inner import tt_inner
    from repro_torch.serving.lsh_service import build_service
    gen = torch.Generator(device="cuda").manual_seed(29)
    dims, c = LIMITS["dims"], LIMITS["tt"]
    xs3 = tensor_formats.cp_random_data(gen, dims, LIMITS["rank"],
                                        batch=LIMITS["items"])
    pr3 = projections.sample_cp_projection(gen, LIMITS["k3"], dims,
                                           LIMITS["rank"])
    x3, p3 = ops._stack_cp_batch(xs3), ops._stack_cp_proj(pr3, 1)
    xs4 = tensor_formats.tt_random_data(gen, dims, LIMITS["rank"],
                                        batch=LIMITS["items"])
    pr4 = projections.sample_tt_projection(gen, LIMITS["k4"], dims,
                                           LIMITS["rank"])
    x4, p4 = ops._stack_tt_batch(xs4), ops._stack_tt_proj(pr4, 1)
    s3, s4 = xs3.scale * pr3.scale, xs4.scale * pr4.scale
    corpus = tensor_formats.tt_random_data(gen, c["dims"], c["rhat"],
                                           batch=c["n"])
    w = LIMITS["w"]
    offs = {k: torch.rand((1, k), generator=gen, device="cuda") * w
            for k in (LIMITS["k3"], LIMITS["k4"])}
    mults = {k: torch.randint(0, 1 << 32, (k,), generator=gen, device="cuda",
                              dtype=torch.int64) | 1
             for k in (LIMITS["k3"], LIMITS["k4"])}
    torch.cuda.synchronize()

    zero_counts()
    cp_gram(x3, p3, offs[LIMITS["k3"]], mults[LIMITS["k3"]],
            epilogue="e2lsh-keys", w=w, scale=s3)
    tt_inner(x4, p4, offs[LIMITS["k4"]], mults[LIMITS["k4"]],
             epilogue="e2lsh-keys", w=w, scale=s4)
    svc = build_service(gen, "tt-srp", c["dims"], corpus, metric="cosine",
                        num_codes=c["codes"], num_tables=c["tables"],
                        rank=c["rank"], device="cuda")
    q = make_queries(corpus, torch.arange(0, c["n"], c["every"],
                                          device="cuda"), gen)
    ids, _, n_cand = svc.query_arrays(q, topk=TOPK)
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"[limits] launches: {counts}")
    check_counts(counts, "limits", ("cp_gram", "tt_inner", "fused_query"))
    errs = {}
    for layout, x, p, sc, k in (("cp", x3, p3, s3, LIMITS["k3"]),
                                ("tt", x4, p4, s4, LIMITS["k4"])):
        acc = Accuracy()
        e, nb, nd, nk = hash_compare(layout, x, p, offs[k], mults[k], sc, w,
                                     f"K={k}", acc)
        errs[layout] = e
        print(f"[limits] {hash_fns(layout)['name']} at {LIMITS['items']} "
              f"items of dims {dims}, rank {LIMITS['rank']}, K={k} in one "
              f"table: raw within the rounding bound (max |kernel - plain| "
              f"{e:.3g}); {acc.check(f'{layout} K={k}')}; {nb} boundary "
              f"codes, {nd} of {nk} key cells differ")
    hash_plan("cp", x3, p3, f"K={LIMITS['k3']}, {LIMITS['items']} items")
    hash_plan("tt", x4, p4, f"K={LIMITS['k4']}, {LIMITS['items']} items")
    idx = svc.index
    base = idx.store.base
    fam = idx.family
    hash_plan("tt", base.stacked, fam.stacked_projection,
              f"TT rank {c['rhat']} index, {c['n']} items")
    offs_t = torch.rand((c["tables"], c["codes"]), generator=gen,
                        device="cuda") * 8.0
    acc = Accuracy()
    e, nb, nd, nk = hash_compare("tt", base.stacked, fam.stacked_projection,
                                 offs_t, idx._mults_t,
                                 corpus.scale * fam.projection.scale, 8.0,
                                 "TT rank 16", acc)
    errs["tt16"] = e
    print(f"[limits] K4 over the TT rank-16 index's {c['n']} items (dims "
          f"{c['dims']}, family rank {c['rank']}, K={c['codes']} "
          f"L={c['tables']}): raw within the rounding bound (max |kernel - "
          f"plain| {e:.3g}); {acc.check('K4 TT rank 16')}; {nd} of {nk} key "
          f"cells differ; {float(n_cand.mean()):.1f} candidates per query, "
          f"self-found {float((ids[:, 0] >= 0).mean()):.4f}")
    k1_err, k1_args = k1_compare(svc, q, f"TT rank {c['rhat']}, "
                                         f"B={q.leaves[0].shape[0]}")
    k1_t = k1_times(svc, [q], k1_args, f"K1-TT rank {c['rhat']}")

    def hash_time(layout, x, p, sc, k):
        f = hash_fns(layout)
        kw = dict(epilogue="e2lsh-keys", w=w, scale=sc)
        args = (x, p, offs[k], mults[k])
        items = x.shape[0]
        xr = LIMITS["rank"]
        if layout == "cp":
            pair = xr * xr * (2 * sum(dims) + len(dims))
            row = len(dims) * dims[0] * xr
        else:
            ranks = (1,) + (xr,) * (len(dims) - 1) + (1,)
            pair = tt_chain_flops(ranks, ranks, dims)
            row = sum(a * d * b for a, d, b in zip(ranks, dims, ranks[1:]))
        return (cuda_ms([lambda: f["kernel"](*args, **kw)], 10),
                cuda_ms([lambda: f["plain"](*args, **kw)], 2),
                *bound_ms(4 * (items * row + k * row + 2 * k + items),
                          items * k * pair))

    t3 = hash_time("cp", x3, p3, s3, LIMITS["k3"])
    t4 = hash_time("tt", x4, p4, s4, LIMITS["k4"])
    for name, t in (("K3 e2lsh-keys, K=2000 (tiled)", t3),
                    ("K4 e2lsh-keys, K=1024 (tiled)", t4)):
        print(f"[time] {name}, {LIMITS['items']} items: {t[0]:.4f} ms "
              f"(plain {t[1]:.4f} ms); bound {t[2]:.4f} ms by {t[3]}")
    return [record("cp_gram[K=2000]", *HASH_RECORDS["cp"][1:], counts,
                   "cp_gram", errs["cp"], t3),
            record("tt_inner[K=1024]", *HASH_RECORDS["tt"][1:], counts,
                   "tt_inner", errs["tt"], t4),
            record("fused_query[tt, R=16]", *K1_SOURCE, counts,
                   "fused_query", k1_err, k1_t)]


def record(name, source, replaces, counts, key, err, times):
    """One entry of the kernels line (``key`` a counter of read_counts;
    the plain calls are its kernel's)."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[key],
            "plain_calls": counts[f"{key.split(':')[0]}_plain"],
            "max_abs_err": err,
            "ms": times[0], "plain_ms": times[1], "bound_ms": times[2],
            "bound_by": times[3], "library_ms": None}


HASH_RECORDS = {
    "cp": ("cp_gram", "src/repro_torch/kernels/csrc/cp_gram.cu",
           "src/repro/kernels/cp_gram.py:100"),
    "tt": ("tt_inner", "src/repro_torch/kernels/csrc/tt_inner.cu",
           "src/repro/kernels/tt_inner.py:110"),
}
K1_SOURCE = ("src/repro_torch/kernels/csrc/fused_query.cu",
             "src/repro/kernels/fused_query.py:235")
K1S_SOURCE = ("src/repro_torch/kernels/csrc/fused_query.cu",
              "src/repro/kernels/fused_query.py:250")
K6_SOURCE = ("src/repro_torch/kernels/csrc/srp_pack.cu",
             "src/repro/kernels/srp_pack.py:42")
K7_SOURCE = ("src/repro_torch/kernels/csrc/e2lsh_quant.cu",
             "src/repro/kernels/e2lsh_quant.py:30")


def run_cell(layout: str, log2_corpus: int, args) -> list:
    """One cell's path and its kernels -> their kernel records."""
    import torch
    cell = dict(CELLS[layout], hash_kernel=HASH_RECORDS[layout][0])
    n = 1 << log2_corpus
    gen = torch.Generator(device="cuda").manual_seed(cell["seed"])
    corpus = hash_fns(layout)["data"](gen, cell["dims"], cell["rhat"],
                                      batch=n)
    perm = torch.randperm(n, generator=gen, device="cuda")
    qids = [perm[i * args.batch:(i + 1) * args.batch]
            for i in range(args.batches)]
    queries = [make_queries(corpus, q, gen) for q in qids]
    svc, counts, main, main_results = phase_main(cell, corpus, qids, queries)
    if layout == "tt":
        del corpus                  # the index holds the stacked corpus
    h_err = phase_hash(svc, cell)
    k1_err, k1_args = k1_compare(svc, queries[0],
                                 f"{layout.upper()} index, B={args.batch}",
                                 need_scratch=layout == "tt")
    phase_srp(cell)
    h_t, k1_t, hq_t, hq_err, hq_lib = phase_times(svc, cell, queries,
                                                  k1_args)
    phase_profile(svc, queries, "tt-profile" if layout == "tt" else "profile")
    key, source, replaces = HASH_RECORDS[layout]
    builds = main["build_launches"]
    records = [dict(record(key + "[build]", source, replaces, counts, key,
                           h_err, h_t), launches=builds),
               dict(record(key + "[query]", source, replaces, counts, key,
                           hq_err, hq_t), launches=counts[key] - builds,
                    library_ms=hq_lib),
               record("fused_query" + ("[tt]" if layout == "tt" else ""),
                      *K1_SOURCE, counts, "fused_query", k1_err, k1_t)]
    del svc, k1_args
    torch.cuda.empty_cache()
    if layout == "tt":
        phase_tt_mut(cell)
        phase_tt_shard(cell)
        return records
    records.append(phase_shard(cell, corpus, qids, queries, main_results))
    del main_results
    torch.cuda.empty_cache()
    records.append(phase_mp(cell, corpus, qids, queries, main))
    torch.cuda.empty_cache()
    records.append(phase_mut(cell, corpus, qids, args))
    torch.cuda.empty_cache()
    records.append(phase_shard_mut(cell, corpus, qids, args))
    torch.cuda.empty_cache()
    records.append(phase_ann_k8(cell, corpus, qids, queries))
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log2-corpus", type=int, default=20,
                    help="CP corpus size (the TT cell stays at 2^20)")
    ap.add_argument("--batches", type=int, default=256)
    ap.add_argument("--batch", type=int, default=1024)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (sets the float32 matmul flags)

    t_start = time.perf_counter()
    name, count, smi = phase_device()
    phase_build()
    kernels = run_cell("cp", args.log2_corpus, args)
    torch.cuda.empty_cache()
    kernels += run_cell("tt", TT_LOG2_CORPUS, args)
    torch.cuda.empty_cache()
    kernels += phase_kernels()
    torch.cuda.empty_cache()
    kernels += phase_limits()
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
