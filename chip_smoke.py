#!/usr/bin/env python3
"""Drive the PyTorch port's CP serving path on one NVIDIA H100.

    python3 chip_smoke.py [--log2-corpus 20] [--batches 256] [--batch 1024]

Phases (any failure exits non-zero):

  1. device: the card's name, count and power limit;
  2. build: the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc,
     sm_90a), with ptxas' register and shared-memory lines;
  3. K3 (``cp_gram``) against its plain version on the card, at the serving
     shape and at a small ragged shape, for raw / e2lsh-keys / srp-keys /
     srp-packed;
  4. the main path: ``build_service`` over n = 2^20 CP tensors
     ((12, 12, 12), rank 4, cp-e2lsh K=10 L=10 rank 3 w=2), then 256
     batches of 1024 planted-neighbour queries, with every kernel counter
     zeroed just before and read just after: build time, query batch
     latency (mean, median, p99 on the host clock), recall@1 (planted),
     recall@10 against brute force, peak memory, and self-queries that must
     return themselves;
  5. K1 (``fused_query``) against its plain version on the same raw values
     and segment arrays: the serving index at B = 1024 and a small cp-srp /
     cosine index;
  6. the kernels' times (CUDA events) beside their bounds and the plain
     versions' times;
  7. a torch.profiler window over 64 query batches: device time by kernel
     and the device's busy share.

The last two lines are one JSON object of kernel records and the device
record. Needs a CUDA card; imports nothing of JAX or of the ``repro``
package.
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
DIMS = (12, 12, 12)
RHAT = 4
KIND, NUM_CODES, NUM_TABLES, RANK, WIDTH = "cp-e2lsh", 10, 10, 3, 2.0
NOISE = 0.02
TOPK = 10
# recall@1 of the planted neighbours measured 0.9924 over 4096 queries with
# these seeds on an H100; a drop below this limit over the 262,144 queries of
# the default run is a fault of the path, not noise
RECALL1_MIN = 0.95


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


def k3_compare(x, p, offs, mults, scale, w, label):
    """K3 vs plain on one input set -> (max abs raw error, boundary codes)."""
    import torch
    from repro_torch.kernels import parity
    from repro_torch.kernels.cp_gram import cp_gram, cp_gram_plain
    raw_k = cp_gram(x, p, epilogue="raw", scale=scale)
    raw_p = cp_gram_plain(x, p, epilogue="raw", scale=scale)
    bound = parity.raw_bound(x, p, scale)
    err = (raw_k - raw_p).abs()
    if not bool((err <= bound).all()):
        fail(f"K3 raw {label}: {int((err > bound).sum())} values outside the "
             f"rounding bound (max err {float(err.max()):.3g})")
    n_boundary = 0
    for kind, epi in (("cp-e2lsh", "e2lsh-keys"), ("cp-srp", "srp-keys")):
        keys_k = cp_gram(x, p, offs, mults, epilogue=epi, w=w, scale=scale)
        keys_p = cp_gram_plain(x, p, offs, mults, epilogue=epi, w=w,
                               scale=scale)
        near = parity.boundary_codes(raw_p, bound, kind, offs, w)
        bad, n_near = parity.key_mismatches(keys_k, keys_p, near)
        if bad:
            fail(f"K3 {epi} {label}: {bad} keys differ away from bucket edges")
        n_boundary += int(near.sum())
    if p.shape[2] % 32 == 0 or label == "small":
        words_k = cp_gram(x, p, epilogue="srp-packed", scale=scale)
        words_p = cp_gram_plain(x, p, epilogue="srp-packed", scale=scale)
        near = parity.boundary_codes(raw_p, bound, "cp-srp").any(-1)
        if not bool(((words_k == words_p).all(-1) | near).all()):
            fail(f"K3 srp-packed {label}: words differ away from 0")
    torch.cuda.synchronize()
    return float(err.max()), n_boundary


def phase_k3(fam, corpus, mults):
    import torch
    from repro_torch.core.tensor_formats import cp_random_data
    from repro_torch.core.projections import sample_cp_projection
    from repro_torch.kernels.ops import _stack_cp_batch, _stack_cp_proj
    p = fam.stacked_projection
    offs = fam.offsets.reshape(NUM_TABLES, NUM_CODES)
    scale = corpus.scale * fam.projection.scale
    n = corpus.factors[0].shape[0]
    max_err, n_boundary = 0.0, 0
    for s in range(0, n, 65536):
        x = _stack_cp_batch(corpus.index(slice(s, s + 65536)))
        e, nb = k3_compare(x, p, offs, mults, scale, WIDTH, "serving")
        max_err, n_boundary = max(max_err, e), n_boundary + nb
    # a small ragged shape: odd batch, unequal mode dims, K not a power of 2
    gen = torch.Generator(device="cuda").manual_seed(7)
    xs = cp_random_data(gen, (5, 7, 3), 2, batch=37)
    ps = sample_cp_projection(gen, 3 * 5, (5, 7, 3), 3)
    offs_s = torch.rand(15, generator=gen, device="cuda").reshape(3, 5) * 6.0
    mults_s = torch.randint(0, 1 << 32, (5,), generator=gen, device="cuda",
                            dtype=torch.int64) | 1
    e, nb = k3_compare(_stack_cp_batch(xs), _stack_cp_proj(ps, 3),
                       offs_s, mults_s, ps.scale, 6.0, "small")
    print(f"[K3] raw within the rounding bound at ({n} x L*K={NUM_TABLES * NUM_CODES}) "
          f"and (37 x 15); max |kernel - plain| = {max(max_err, e):.3g}; "
          f"{n_boundary + nb} boundary codes, keys equal outside their "
          "tables")
    return max_err


def make_queries(corpus, qid, gen):
    import torch
    from repro_torch.core.tensor_formats import CPTensor
    q = corpus.index(qid)
    return CPTensor(tuple(f + NOISE * torch.randn(f.shape, generator=gen,
                                                  device=f.device)
                          for f in q.factors), 1.0)


def phase_main(corpus, qids, queries):
    import numpy as np
    import torch
    from repro_torch.core.index import brute_force_batch
    from repro_torch.kernels.cp_gram import cp_gram, cp_gram_plain
    from repro_torch.kernels.fused_query import fused_query, fused_query_plain
    from repro_torch.serving.lsh_service import build_service

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = (cp_gram, cp_gram_plain, fused_query, fused_query_plain)
    for fn in counters:
        setattr(fn, "launches" if hasattr(fn, "launches") else "calls", 0)
    svc = build_service(torch.Generator(device="cuda").manual_seed(1), KIND,
                        DIMS, corpus, num_codes=NUM_CODES,
                        num_tables=NUM_TABLES, rank=RANK, bucket_width=WIDTH,
                        device="cuda")
    build_launches = cp_gram.launches
    svc.query_arrays(queries[0], topk=TOPK)           # warm-up
    svc.stats.reset()
    results, lat_ms = [], []
    for q in queries:
        t0 = time.perf_counter()
        results.append(svc.query_arrays(q, topk=TOPK))
        lat_ms.append((time.perf_counter() - t0) * 1e3)
    # self-queries: an item queried as itself is in its own bucket of every
    # table, so it must come back first at a distance at the f32 noise floor
    self_q = corpus.index(qids[0][:256])
    self_ids, self_scores, _ = svc.query_arrays(self_q, topk=TOPK)
    torch.cuda.synchronize()
    counts = {"cp_gram": cp_gram.launches, "cp_gram_plain": cp_gram_plain.calls,
              "fused_query": fused_query.launches,
              "fused_query_plain": fused_query_plain.calls}
    peak = torch.cuda.max_memory_allocated()
    st = svc.stats
    print(f"[main] build_service over n={corpus.factors[0].shape[0]} CP "
          f"tensors {DIMS} rank {RHAT}: {st.build_s:.3f} s (hash {st.hash_s:.3f} s, "
          f"sort {st.sort_s:.3f} s), cap {svc.index.cap} -> window L*cap = "
          f"{NUM_TABLES * svc.index.cap}")
    lat = np.sort(np.asarray(lat_ms))
    print(f"[main] {st.batches} batches of {queries[0].factors[0].shape[0]} "
          f"in {st.total_ms / 1e3:.3f} s: {st.total_ms / st.batches:.3f} "
          f"ms/batch mean, median {np.median(lat):.3f} ms, p99 "
          f"{lat[int(math.ceil(0.99 * len(lat))) - 1]:.3f} ms, max "
          f"{lat[-1]:.3f} ms; {st.qps:.0f} QPS, mean candidates "
          f"{st.mean_candidates:.1f}")
    print(f"[main] launches on the main path: {counts} (build: cp_gram "
          f"{build_launches})")
    if counts["cp_gram"] == 0 or counts["fused_query"] == 0:
        fail(f"a kernel of the main path never launched: {counts}")
    if counts["cp_gram_plain"] or counts["fused_query_plain"]:
        fail(f"the main path called a plain version: {counts}")

    n = corpus.factors[0].shape[0]
    hits1 = 0
    for (ids, scores, nc), qid in zip(results, qids):
        qid = qid.cpu().numpy()
        if ids.shape != (len(qid), TOPK) or nc.shape != (len(qid),):
            fail(f"result shapes {ids.shape} {nc.shape}")
        valid = ids >= 0
        if ((ids >= n) | (ids < -1)).any() or not (
                (valid.sum(1) == (nc.clip(max=TOPK)))).all():
            fail("ids out of range or valid count != min(n_cand, topk)")
        if not np.isfinite(scores[valid]).all():
            fail("non-finite score on a valid id")
        if (valid[:, 1:] & (scores[:, 1:] < scores[:, :-1])).any():
            fail("scores not ascending")
        hits1 += int((ids[:, 0] == qid).sum())
    n_q = sum(len(q) for q in qids)
    recall1 = hits1 / n_q
    self_ok = (self_ids[:, 0] == qids[0][:256].cpu().numpy()).mean()
    q256 = queries[0].index(slice(0, 256))
    truth, _ = brute_force_batch("euclidean", q256, svc.index.effective_corpus(),
                                 TOPK)
    ids0 = results[0][0][:256]
    recall10 = sum(len(set(t) & set(r[r >= 0].tolist()))
                   for t, r in zip(truth.tolist(), ids0)) / (256 * TOPK)
    print(f"[main] recall@1 (planted) {recall1:.4f} over {n_q} queries; "
          f"recall@10 vs brute force {recall10:.4f} over 256; self-queries "
          f"first {self_ok:.4f} (max self distance "
          f"{float(self_scores[:, 0].max()):.3g}); peak device memory "
          f"{peak / 2**30:.2f} GiB")
    if self_ok < 1.0:
        fail("a self-query did not return itself first")
    if recall1 < RECALL1_MIN:
        fail(f"recall@1 {recall1} below {RECALL1_MIN}")
    return svc, counts, results


def k1_compare(svc, queries, label):
    """K1 vs plain on the same raw values and segment arrays."""
    import torch
    from repro_torch.kernels import parity
    from repro_torch.kernels.fused_query import fused_query, fused_query_plain
    from repro_torch.kernels.ops import stack_cp
    idx = svc.index
    fam = idx.family
    seg = idx.store.seg_arrays(0)
    qs = stack_cp(queries)
    values = fam.raw_stacked(qs[1], queries.scale)
    offs, mults = fam.offsets, idx._mults_t
    kw = dict(kind=fam.kind, w=fam.bucket_width, num_tables=fam.num_tables,
              num_codes=fam.num_codes, metric=idx.metric, topk=TOPK,
              cap=idx.cap)
    ik, sk, nk = fused_query(values, offs, mults, qs, seg, **kw)
    ip, sp, np_ = fused_query_plain(values, offs, mults, qs, seg, **kw)
    torch.cuda.synchronize()
    if not torch.equal(nk, np_):
        fail(f"K1 {label}: candidate counts differ in "
             f"{int((nk != np_).sum())} rows")
    tol = parity.rerank_bound(idx.metric, queries, seg.corpus, ip, sp)
    valid = ip >= 0
    err = torch.where(valid & (ik == ip), (sk - sp).abs(), 0.0)
    if bool((err > tol).any()):
        fail(f"K1 {label}: scores outside the rounding bound "
             f"(max err {float(err.max()):.3g})")
    bad = parity.topk_mismatches(ik, sk, ip, sp, tol)
    if bad:
        fail(f"K1 {label}: {bad} result ids differ without a near tie")
    n_tie = int((ik != ip).sum())
    print(f"[K1] {label}: n_cand equal, scores within the rounding bound "
          f"(max |kernel - plain| {float(err.max()):.3g}), ids equal except "
          f"{n_tie} near-tie slots")
    return float(err.max()), (values, offs, mults, qs, seg, kw)


def phase_k1(svc, queries):
    import torch
    from repro_torch.core.tensor_formats import cp_random_data
    from repro_torch.serving.lsh_service import build_service
    err, args = k1_compare(svc, queries[0], "serving index, B=1024")
    gen = torch.Generator(device="cuda").manual_seed(11)
    small = cp_random_data(gen, (4, 4, 4), 3, batch=4099)
    svc_s = build_service(gen, "cp-srp", (4, 4, 4), small, num_codes=12,
                          num_tables=4, rank=2, device="cuda")
    q = make_queries(small, torch.arange(0, 4099, 17, device="cuda"), gen)
    k1_compare(svc_s, q, "small cp-srp / cosine index, B=242")
    return err, args


def phase_times(svc, corpus, queries, k1_args):
    import torch
    from repro_torch.kernels import epilogues as epi
    from repro_torch.kernels.cp_gram import cp_gram, cp_gram_plain
    from repro_torch.kernels.fused_query import fused_query, fused_query_plain
    from repro_torch.kernels.ops import _stack_cp_batch, stack_cp
    fam = svc.index.family
    n = corpus.factors[0].shape[0]
    chunk = 65536
    xs = [_stack_cp_batch(corpus.index(slice(s, s + chunk)))
          for s in range(0, n, chunk)]
    p = fam.stacked_projection
    offs = fam.offsets.reshape(NUM_TABLES, NUM_CODES)
    mults = svc.index._mults_t
    scale = corpus.scale * fam.projection.scale
    kw = dict(epilogue="e2lsh-keys", w=WIDTH, scale=scale)
    k3_ms = cuda_ms([lambda x=x: cp_gram(x, p, offs, mults, **kw) for x in xs],
                    3 * len(xs))
    k3_plain = cuda_ms([lambda x=x: cp_gram_plain(x, p, offs, mults, **kw)
                        for x in xs[:4]], 4)
    _, nmod, d, rx = xs[0].shape
    rp = p.shape[-1]
    t = NUM_TABLES * NUM_CODES
    # uint32 multipliers and keys count 4 bytes each
    k3_bytes = (chunk * nmod * d * rx * 4 + p.numel() * 4 + t * 4
                + NUM_CODES * 4 + chunk * NUM_TABLES * 4)
    k3_flops = chunk * t * rx * rp * (2 * nmod * d + nmod)
    k3_bound, k3_by = bound_ms(k3_bytes, k3_flops)
    print(f"[time] K3 e2lsh-keys, {chunk} items x {t} hashes: {k3_ms:.4f} ms "
          f"(plain {k3_plain:.4f} ms); bound {k3_bound:.4f} ms by {k3_by} "
          f"({k3_bytes / 1e6:.1f} MB, {k3_flops / 1e9:.2f} GFLOP)")

    values, offs1, mults1, qs1, seg, kw1 = k1_args
    qss = [stack_cp(q) for q in queries]
    vals = [fam.raw_stacked(q[1], q[0].scale) for q in qss]
    k1_ms = cuda_ms([lambda v=v, q=q: fused_query(v, offs1, mults1, q, seg,
                                                   **kw1)
                     for v, q in zip(vals, qss)], 5 * len(queries))
    k1_plain = cuda_ms([lambda: fused_query_plain(values, offs1, mults1,
                                                  qs1, seg, **kw1)], 2)
    # the bytes and operations this batch's data need
    from repro_torch.kernels.fused_query import _discretize_keys
    b = values.shape[0]
    keys = _discretize_keys(values, offs1, mults1, e2=True, w=WIDTH,
                            num_tables=NUM_TABLES, num_codes=NUM_CODES)
    ids, hit = epi.probe_windows(seg.sorted_keys, seg.perm, keys, kw1["cap"],
                                 seg.live)
    _, valid = epi.dedup_windows(ids, hit, n)
    slots, n_cand = int(hit.sum()), int(valid.sum())
    _, nmod, d, rc = seg.stacked.shape
    rq = queries[0].rank
    # per (query, table): a search over the m uint32 keys of the table, and
    # one over the cap keys after the bucket's start
    cap = kw1["cap"]
    search = b * NUM_TABLES * (math.ceil(math.log2(n + 1))
                               + math.ceil(math.log2(cap + 1))) * 4
    k1_bytes = (values.numel() * 4 + t * 4 + NUM_CODES * 4
                + b * nmod * d * rq * 4 + search + slots * 5
                + n_cand * (nmod * d * rc * 4 + 4) + b * TOPK * 8 + b * 4)
    k1_flops = (n_cand * (rq * rc + rc * rc) * (2 * nmod * d + nmod)
                + b * rq * rq * (2 * nmod * d + nmod))
    k1_bound, k1_by = bound_ms(k1_bytes, k1_flops)
    print(f"[time] K1, B={b}, {slots} window slots, {n_cand} candidates: "
          f"{k1_ms:.4f} ms (plain {k1_plain:.4f} ms); bound {k1_bound:.5f} ms "
          f"by {k1_by} ({k1_bytes / 1e6:.2f} MB, {k1_flops / 1e9:.3f} GFLOP)")
    return (k3_ms, k3_plain, k3_bound, k3_by), (k1_ms, k1_plain, k1_bound,
                                                k1_by)


def phase_profile(svc, queries):
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
    print(f"[profile] {len(queries)} query batches under the profiler: wall "
          f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"({busy_ms / wall_ms:.1%}); idle {1 - busy_ms / wall_ms:.1%}")
    for ms, count, key in rows[:8]:
        print(f"[profile]   {ms:9.3f} ms x{count:<4d} {key[:80]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log2-corpus", type=int, default=20)
    ap.add_argument("--batches", type=int, default=256)
    ap.add_argument("--batch", type=int, default=1024)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (sets the float32 matmul flags)
    from repro_torch.core.tensor_formats import cp_random_data

    t_start = time.perf_counter()
    name, count, smi = phase_device()
    phase_build()

    n = 1 << args.log2_corpus
    gen = torch.Generator(device="cuda").manual_seed(0)
    corpus = cp_random_data(gen, DIMS, RHAT, batch=n)
    perm = torch.randperm(n, generator=gen, device="cuda")
    qids = [perm[i * args.batch:(i + 1) * args.batch]
            for i in range(args.batches)]
    queries = [make_queries(corpus, q, gen) for q in qids]

    svc, counts, _ = phase_main(corpus, qids, queries)
    k3_err = phase_k3(svc.index.family, corpus,
                      svc.index._mults_t)
    k1_err, k1_args = phase_k1(svc, queries)
    k3_t, k1_t = phase_times(svc, svc.index.effective_corpus(), queries,
                             k1_args)
    phase_profile(svc, queries)
    kernels = [
        {"name": "cp_gram", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/cp_gram.cu",
         "replaces": "src/repro/kernels/cp_gram.py:100",
         "launches": counts["cp_gram"], "plain_calls": counts["cp_gram_plain"],
         "max_abs_err": k3_err, "ms": k3_t[0], "plain_ms": k3_t[1],
         "bound_ms": k3_t[2], "bound_by": k3_t[3], "library_ms": None},
        {"name": "fused_query", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fused_query.cu",
         "replaces": "src/repro/kernels/fused_query.py:235",
         "launches": counts["fused_query"],
         "plain_calls": counts["fused_query_plain"],
         "max_abs_err": k1_err, "ms": k1_t[0], "plain_ms": k1_t[1],
         "bound_ms": k1_t[2], "bound_by": k1_t[3], "library_ms": None},
    ]
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
