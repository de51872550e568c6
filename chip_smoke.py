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
       - [mesh] (after [shard-mut]): [shard]'s service laid over an
         explicit 4-slot mesh on cuda:0 (``distributed.sharding
         .axis_rules``; each shard's blocks in their own memory, one K1s
         launch a slot and the S-way merge): every batch equal to
         [shard]'s bit for bit, K1s launched 4 times a batch and K3 once,
         recall@1; the batch mean / median / p99 beside [shard]'s, the
         device bytes a slot, each slot's K1s against its plain version
         and its time, the merge's time; [shard-mut]'s script on the mesh
         equal to [shard-mut]'s before and after ``compact()`` and after
         ``rebalance()``; a snapshot of the mutated mesh store recovered
         onto a new 4-slot mesh, bit for bit; 512 single queries through a
         ``ServingScheduler``, each equal to a direct row; then
         ``resolve_mesh(torch.cuda.device_count())`` over the machine's
         real cards (one slot on a one-card machine), equal to [shard];
       - [tt-shard]: a tt-srp / cosine index at 2^16 over 3 shards (the last
         padded): answers equal the single-device index's, K1s-TT against
         its plain version;
  6. the dense path ([main]'s 2^20 CP corpus and its 256 query batches
     densified: 1,728 floats an item), K1's and K1s's dense re-rank
     (``fused_query_kernel<kDense>``):
       - [dense-main]: the naive e2lsh (a Gaussian (100, 1728) matrix,
         K = L = 10, w = 2.0, exact cap) and [dense-cp]: cp-e2lsh rank 3
         on the dense rows (its 100 projections materialized once), each
         timed and checked like [main] (recall@1, self-queries, recall@10,
         build, latency, peak memory, projection storage), K1-dense
         against its plain version and its byte bound, the dense hash per
         query batch, and a profile of [dense-main];
       - untimed: srp / cosine over the dense corpus at 2^16; the naive
         e2lsh over [main]'s CP corpus at 2^16 (densified to hash, K1
         re-ranks in CP); [dense-mut]: [mut]'s script at 2^16 (bucket_cap
         64, T = 4, inserts, deletes, ``compact()`` equal to a fresh
         build) and [dense-shard-mut] the same over 4 shards (K1s-dense,
         timed, ``rebalance()`` equal to a fresh sharded build);
         [dense-big]: 4,096 items of (16, 16, 16, 16) (65,536-float rows
         read in place), e2lsh and cp-e2lsh at rank 4 past
         ``MATERIALIZE_LIMIT`` (the hash's per-mode chain);
  7. [ann-k8]: examples/ann_search.py's own K = 8 (L = 10, exact cap about
     2950) over the CP cell's corpus and queries: L*cap past K1's shared
     window, so the launches carry the global scratch, which the queries
     whose window overflows the shared hash set use (counted); recall@1, K1
     against its plain version on 4 batches, its time;
  8. [kernels], the card twin of benchmarks/kernels.py: K3 at B=64 N=4 d=64
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
  9. [limits]: K3 at benchmarks/collision.py's K = 2000 in one table and K4
     at K = 1024 (both tiled over hashes), and a TT rank-16 index (2^14
     items of dims (8, 8, 8, 8)) through K4's warp kernel and K1-TT, each
     against its plain version and timed.
  10. [mixed] (run within 3, 5 and 6, on their services), queries of
     another format than the corpus's (K1's and K1s's six cross-format
     branches, ``fused_query_kernel<TR, QR>``): [main]'s
     first 32 query batches converted exactly (densified; TT by diagonal
     cores) over [main]'s service (dense x CP, TT x CP, and [mixed tt8 x
     cp]: the TT queries zero-padded to rank 8, recall@1 equal to TT x
     CP's), [dense-main]'s (CP x dense, TT x dense) and [cp-as-tt]
     ([main]'s 2^20 items converted to TT, tt-e2lsh rank 4 through K4: CP
     x TT, dense x TT), [tt8] ([main]'s first 2^16 items as TT padded to
     rank 8, indexed alike: CP x TT and dense x TT over TT ranks 5-16, then
     the same-format TT x TT at ranks 5-16, [tt8 x tt8] (the CP queries as
     TT padded to rank 8, ``<8, 8>``) and [tt16 x tt8] (padded to 16,
     ``<16, 16>``), 32 batches each), and
     dense x CP over [shard]'s 4 shards, every batch bit-equal to the
     single card. Each pair: its branch and the K1 instantiation it means
     to run (``fused_query:k1:<0, 4>``, ...) launched and no plain version,
     recall@1 (planted) and recall@10 against brute force
     (``recall_at_k``), batch latency, K1 against its plain version and
     float64, its time beside its bound and the plain version's.
  11. [sample] (run within 3, 5 and 6's TT cell), the sampling query modes
     (``query_arrays(mode="uniform" | "weighted", seed=...)``: K1's and
     K1s's sampling instantiations, ``fused_query_kernel<TR, QR, true>``
     in ``fused_query_sample.cu``): [main]'s first 64 batches in each mode
     (batch i at seed 7 + i), timed like [main]; every batch's candidate
     counts equal to the top-k path's on the same batch, its draws
     distinct; K1 against its plain version on the first batch (counts
     equal; drawn sets equal, in "weighted" but within 2 ulps of a
     perturbed logit; every draw a member of its query's probed union;
     scores within the rounding bound) and the served answer equal to the
     kernel's; a seed replayed bit for bit, another seed redrawing; a
     chi-square of one query with at least 20 members replicated over
     8,192 rows at topk 1 in each mode; then four batches each of [sample
     dense x cp] (``<0, kDense>``), [shard sample] (K1s over [shard]'s 4
     shards, every draw equal to [main]'s at the same seed bit for bit) and
     [tt sample] (``<4, 4>`` on [tt-main]), each with its sampling
     instantiation launched and no plain version, its time (CUDA events)
     beside the top-k path's bound, registers, spills, blocks per SM,
     shared window and scratch queries.

  12. [host] (run at the end of 3), the host-dict index:
     ``build_service(device=False)`` (``HostLSHIndex``) at [main]'s
     configuration over [main]'s first 2^18 items, 64 batches of 1024
     planted queries through K1 (recall@1); for 256 queries at T = 1 and
     T = 4 the dicts' ``candidates(x)`` against a device index's
     ``candidates_batch`` over the same items and K1's n_candidates,
     ``query(x)`` against ``query_batch`` and ``brute_force`` against
     ``brute_force_batch``; the dict fill beside the device build; K1
     against its plain version and timed.
  13. [tables], the paper's Tables 1 and 2 (benchmarks/table1_e2lsh.py,
     table2_srp.py): N in {2, 3, 4}, d = 16, K = 16, ranks 4, for the
     naive kind, CP and TT on CP inputs and CP and TT on TT inputs:
     projection storage against its closed form, ``hash(x)``'s time a call
     (host clock) and ``hash_batch``'s device time an item over 1,024
     items, ``hash(x)`` equal to its batch row, codes against the plain
     version (boundary-aware); K3 and K4 timed at N = 4.
  14. [collision], benchmarks/collision.py: the empirical collision rate of
     M = 2000 codes at five distances (E2LSH) or mixes (SRP) against
     ``theory``, all six kinds on dense pairs, the CP kinds on CP pairs (K3)
     and the TT kinds on the pairs' TT forms (K4), failing past the
     reference's 5 se + 0.015; each row's largest deviation and time a call.
  15. [sched] (run at the end of 3), the serving scheduler
     (``serving.scheduler.ServingScheduler``, ``max_batch`` 64,
     ``deadline_ms`` 2.0): [main]'s service ("main") and [shard]'s S = 4
     service over the first 2^18 items ("shard", a ``max_items`` quota of
     2^18 + 2^14) behind one scheduler, its query lane on a stream of the
     highest priority and its ingest lane on another; single planted
     queries (one in eight to "shard") arrive open-loop (Poisson) at 20% of
     the closed-loop capacity measured through the scheduler, in
     alternating quiet and compacting blocks (512-item inserts, their
     deletes, ``compact()`` on "main", ``rebalance()`` on "shard"); per
     tenant and phase p50 / p99 / p99.9 / max latency and goodput, the
     compacting / quiet p99 ratio beside the reference's 1.5, the mean
     coalesced batch, swaps, K1 / K1s / K3 launches by lane and the
     interpreter's full collections; quiet answers bit-equal to the direct
     batch's rows, sampling requests replayed by seed and never coalesced,
     the quota's refusal counted, 4,096 queries racing a compaction of a
     mutated store each bit-equal to the pre- or the post-swap direct row,
     recall@1 of the quiet queries.
  16. [durable main] (run at the end of 3, after [sched]),
     ``serving.durability.DurableLSHService`` at [main]'s width: its
     snapshots and WAL under a ``tempfile.mkdtemp()`` directory (removed
     at the end; its filesystem and whether ``O_DIRECT`` was taken are
     printed), 12 rounds of a 256-item delete and a planted batch with a
     ``compact()`` after 8, a crash right after the next delete's commit
     (``FaultInjector``'s ``post_wal_append``), a fresh service's
     ``recover()``: 16 planted batches bit-equal to the crashed instance's
     answers, recall@1 over the surviving targets, K3 and K1 launched on
     both services; the snapshot's time and bytes, WAL ms a record, the
     recovery's load / restore / replay / reopen split, the batch mean
     beside [main]'s; K1 and K3 against their plain versions and timed.
  17. [durable ingest] (after the CP cell), benchmarks/durability.py's
     design in this script's code: a clustered dense (8, 8, 8) corpus of
     100,000 items, cp-e2lsh K = 4, L = 8, bucket_cap 64, max_deltas 20;
     1,024-item inserts and 256-item deletes through a plain service and a
     durable one (insert items/s both ways, the overhead beside the
     reference's 10% gate, printed), a snapshot, more rounds, a crash and
     a recovery bit-equal to the live service on 4 planted batches; a
     scheduler pass whose failed WAL appends degrade the tenant until
     ``recover_namespace()`` brings it back; the same at S = 2 (K1s).
  18. the LM substrate's serving path (after [collision]; no hand kernel
     lies on it, and the kernel counters, zeroed before each LM phase,
     stay at 0):
       - [lm phi3-lsh]: phi3-mini-3.8b with the paper's CP-SRP LSH
         attention (``get_config(arch, "long")``) at full width and depth
         (32 x 3072, bf16, seeded random weights on the card), 2 prompts of
         4,096 tokens from ``batch_at``: prefill and 31 greedy decode steps
         timed (CUDA events) beside their bounds, tokens/s, peak memory,
         the candidates a decode step attends; ``greedy_generate`` for 32
         steps equal to the timed loop's tokens up to a near tie; every
         logit finite, every id in the vocabulary, layer-0 key codes equal
         to a float64 evaluation except within the rounding bound of 0;
       - [lm phi3]: the same weights without ``lsh_proj``, exact
         attention: prefill 4,093 tokens and decode 3, against
         ``forward`` over the 4,096 at 0.05 of the largest |logit|; the
         LSH logits' relative gap to the exact ones (printed);
       - [lm archs]: the other eight archs at their published widths,
         depth cut (2 layers; llama4 one dense / MoE pair; zamba2 one
         group of 9; whisper and mamba2 whole), 2 prompts of 512 tokens
         (pixtral 1,536): decode against forward at the reference's TOL
         (MoE archs at the positions no pass dropped by capacity), prefill
         and decode times, bounds and peak memory.
  19. training on the LM substrate (after [lm archs]; no hand kernel lies
     on it either: the counters stay at 0), each line with the card's name
     and power limit:
       - [train mamba2]: ``python -m repro_torch.launch.train``'s ``main``
         at ``get_config("mamba2-130m")`` (24 x 768, bf16, remat
         "nothing"), the launcher's defaults (B = 8 x 256, lr 1e-3, warmup
         20), 30 steps, ``--ckpt-every 10`` under ``tempfile.mkdtemp()``:
         once with ``--fail-at 17`` (``InjectedFailure``), then resumed
         from step 10, and once uninterrupted in a second directory; the
         two final states bit-equal leaf for leaf (params and both
         moments), the mean loss of the last 5 steps below the first 5's;
         ms a step (CUDA events, forward+backward and the optimizer
         apart), tokens/s, peak memory, a checkpoint's save s and MB, the
         resume's s;
       - [train compress]: the same arch with ``--compress`` (K = 64,
         R = 2, ``min_size`` 4096), 10 steps: ``comm_ratio``, the
         compression's ms a step and its parts on the largest leaf
         (``blocks/w_xBC``: draw, sketch, Gram, solve, project), that
         leaf's factor bytes; every compressed leaf's projection meets its
         sketch within the ridge's residual, the loss finite throughout;
       - [train phi3]: phi3-mini-3.8b at full width and depth (32 x 3072,
         bf16, exact attention, remat "nothing", float32 moments), B = 2 x
         2,048 tokens, a warm-up step and 3 timed steps: ms a step
         (forward+backward and optimizer apart) beside its bound, tokens/s,
         peak memory, loss and ``grad_norm``; the first step's ce in (1,
         20), every gradient finite and nonzero in total;
       - [train phi3-lsh]: ``get_config("phi3-mini-3.8b", "long")`` at
         full width and depth, B = 1 x 4,096, 2 steps (backward through
         the bucket sort, the bucket-chunk attention and the unsort):
         ``lsh_proj``'s gradient exactly zero and the step multiplying it
         by 1 - lr * wd in bfloat16 rounding; ms a step, peak memory;
       - [train grads]: phi3 at full width cut to 2 layers, exact
         attention, float32, B = 2 x 256: the gradients under remat
         "nothing", "dots" and "none" bit-equal, and central differences
         along a seeded unit direction over the norm scales at eps and
         eps / 2, extrapolated (Richardson), against the gradient's
         directional derivative within 1e-3 of it (over all leaves
         printed).

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
import os
import re
import statistics
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
    print(f"[device] {name} x{count}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; allow_tf32 "
          f"{torch.backends.cuda.matmul.allow_tf32}, "
          f"allow_bf16_reduced_precision_reduction "
          f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")
    return name, count, smi_line()


def smi_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


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
    return q.with_leaves(f + NOISE * torch.randn(f.shape, generator=gen,
                                                 device=f.device)
                         for f in q.leaves)


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


# K1's cross-format branches, "mixed:<query>-<corpus>"
MIXED_BRANCHES = tuple(f"mixed:{q}-{c}" for q, c in (
    ("dense", "cp"), ("cp", "dense"), ("dense", "tt"), ("tt", "dense"),
    ("cp", "tt"), ("tt", "cp")))
SAMPLE_MODES = ("uniform", "weighted")
BRANCHES = ("multiprobe", "live_window", "segments", "scratch"
            ) + MIXED_BRANCHES + tuple(f"sample:{m}" for m in SAMPLE_MODES)
K1_WRAPPERS = ("fused_query", "fused_query_sharded")


def k1_instance(tr: int, qr: int, sample: bool = False) -> str:
    """K1's launch count of the instantiation fused_query_kernel<TR, QR>
    (or of its sampling twin) among a wrapper's branches ("k1:<0, 4>",
    "sample:<0, 4>")."""
    from repro_torch.kernels import fused_query as fq
    return ("sample:" if sample else "k1:") + fq.instance_name(tr, qr)


def read_counts() -> dict:
    """Launches and plain calls, K1's and K1s's launches by branch
    (``fused_query:multiprobe``, ``fused_query_sharded:live_window``,
    ...) and by instantiation (``fused_query:k1:<0, 4>``, ...) and their
    queries that used the global scratch (``fused_query:scratch``)."""
    from repro_torch.kernels import fused_query as fq
    fns = counters()
    counts = {name: getattr(fn, "launches" if name in COUNTED else "calls")
              for name, fn in fns.items()}
    names = BRANCHES + tuple(k1_instance(*key, sample=s) for key in fq.SHAPES
                             for s in (False, True))
    counts.update({f"{k}:{b}": fns[k].branches[b]
                   for k in K1_WRAPPERS for b in names})
    return counts


def zero_counts() -> None:
    fns = counters()
    for name, fn in fns.items():
        setattr(fn, "launches" if name in COUNTED else "calls", 0)
        if name in COUNTED:
            fn.lanes.clear()
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
    build_launches = read_counts()[hash_kernel] if hash_kernel else 0
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
    check_counts(counts, tag, tuple(k for k in (hash_kernel, "fused_query")
                                    if k))
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
    """(B, topk) re-rank scores of ``ids`` in float64 (0 where -1), qy
    across the two formats when they differ."""
    import torch
    from repro_torch.core import contractions
    valid = ids >= 0
    q = queries.with_leaves(t.double() for t in queries.leaves).index(
        (slice(None), None))
    sub = corpus.index(torch.where(valid, ids, 0).long())
    y = sub.with_leaves(t.double() for t in sub.leaves)
    qq, yy = q.self_inners(), y.self_inners()
    qy = contractions.pair_inners(q, y)
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
    name += {"tt": "-TT", "dense": "-dense"}.get(corpus.layout, "")
    if queries.layout != corpus.layout:
        name += f" ({queries.layout} queries)"
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
    """fp32 operations of one <X, Y> at true ranks, the reference's counts:
    CP, per (r, q) term the N d-long dots and the N-fold product; TT, the
    chain; dense, one prod(d)-long dot; across formats, the reference's
    left-to-right sweeps over the dense operand: dense x CP sum_k 2 R
    prod_{j>=k} d_j (the first factor against the whole row, then one
    diagonal contraction a mode), dense x TT sum_k 2 r_{k-1} r_k
    prod_{j>=k} d_j (each core against what is left of the row); CP x TT
    per mode and state entry (q, e) a d * r-long and a d-long sum."""
    if x.layout != y.layout:
        if "dense" in (x.layout, y.layout):
            other = y if x.layout == "dense" else x
            dims = tuple(other.dims)
            if other.layout == "cp":
                return sum(2 * other.rank * math.prod(dims[k:])
                           for k in range(len(dims)))
            r = tuple(other.ranks)
            return sum(2 * r[k] * r[k + 1] * math.prod(dims[k:])
                       for k in range(len(dims)))
        cp, tt = (x, y) if x.layout == "cp" else (y, x)
        ranks = tt.ranks
        return sum(2 * cp.rank * c * d * (a + 1)
                   for d, a, c in zip(tt.dims, ranks, ranks[1:]))
    if x.layout == "dense":
        return 2 * x.row_floats
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
    h_lib = cuda_ms([lambda x=x: library_raw(corpus.layout, x, p)
                     for x in xs], len(xs))
    print(f"[time] {f['name']} e2lsh-keys, {b_x} items x {t} hashes: "
          f"{h_ms:.4f} ms (plain {h_plain:.4f} ms; one fp32 torch.einsum "
          f"over the same operands, raw values, {h_lib:.4f} ms); bound "
          f"{h_bound:.4f} ms by {h_by} ({h_bytes / 1e6:.1f} MB, "
          f"{h_flops / 1e9:.2f} GFLOP, {pair} FLOP per (item, hash))")

    q_t, q_err, q_lib = query_hash_times(svc, queries)
    k1_t = k1_times(svc, queries, k1_args,
                    "K1-TT" if corpus.layout == "tt" else "K1")
    return (h_ms, h_plain, h_bound, h_by), k1_t, q_t, q_err, q_lib, h_lib


def query_hash_times(svc, queries):
    """The hash kernel's raw launch per batch of stacked queries on the
    card (CUDA events) beside its bound, its plain version's time and one
    fp32 ``torch.einsum`` over the same operands; held against its plain
    version on the first ``QUERY_HASH_BATCHES`` batches -> ((ms, plain ms,
    bound ms, bound by), the max error, the einsum's ms)."""
    idx = svc.index
    fam, corpus = idx.family, idx.effective_corpus()
    f = hash_fns(corpus.layout)
    p = fam.stacked_projection
    t = fam.num_tables * fam.num_codes
    proj = fam.projection.input_format(fam.projection.leaves, 1.0)
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
    return (q_ms, q_plain, q_bound, q_by), q_err, q_lib


def k1_times(svc, queries, k1_args, name, corpus=None, sample=None):
    """K1 (K1s) per query batch on the card (CUDA events, cycling the
    batches) beside its bound and its plain version's time on one batch;
    ``sample`` = (mode, key words) times the sampling instantiation (its
    bound is the top-k path's: the same reads and re-rank)."""
    from repro_torch.core import probing
    from repro_torch.kernels import fused_query as fq
    idx = svc.index
    fam = idx.family
    if corpus is None:
        corpus = idx.effective_corpus()
    values, offs, mults, qs, view, kw = k1_args
    kernel, plain, _ = k1_entry(view)
    if sample is not None:
        kw = dict(kw, mode=sample[0], key=sample[1])
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
    pair = fq.pair_shape(view.k1_table, qs)
    expansion = (probing.expansion_size(kw["kind"], kw["num_codes"])
                 if kw["probes"] > 1 else 0)
    window, may_scratch, smem = fq.launch_plan(
        view.k1_table, pair.rq, num_tables=kw["num_tables"],
        probes=kw["probes"], topk=kw["topk"], expansion=expansion,
        pair=pair, sample=sample is not None)
    table = view.k1_table
    inst = fq.instance(table.layout, pair.q_layout, pair.rq, table.rc,
                       pair.n_modes, pair.d)
    slots = fq.slot_plan(table.layout, pair.q_layout, kw["num_tables"],
                         max(table.caps), pair.n_modes, pair.d, pair.rq,
                         table.rc, kw["probes"], kw["topk"], expansion,
                         pair.df, sample is not None)
    rows = ""
    if table.layout == "dense":
        row = pair.d if pair.same else pair.df
        rows = (f"; dense rows through a {row}-float ring slot a warp"
                if slots else "; dense rows read in place")
    elif inst in fq.TT_RING:
        row = pair.n_modes * table.rc * pair.d * table.rc
        rows = (f"; TT rows through a {row}-float ring slot a warp"
                if slots else "; TT rows read in place")
    elif inst == (0, 16):
        rows = ("; CP rows staged, two a warp in two buffers" if slots
                else "; CP rows read in place")
    occ = fq.occupancy(table, pair.rq, smem, pair.q_layout,
                       sample=sample is not None)
    # a sampling window's 6-word slots may leave room for fewer blocks than
    # the instantiation's target (window_plan then plans one block fewer)
    planned = (fq.plan_blocks(smem, occ["target_blocks"]) if sample
               else occ["target_blocks"])
    threads, _, per_warp, _ = fq.SHAPES[inst]
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
          f"{k1_flops / 1e9:.3f} GFLOP); {fq.instance_name(*inst)}"
          f"{' sampling' if sample else ''}, "
          f"{threads // 32} warps, {per_warp} "
          f"row(s) a warp, {occ['registers']} registers a "
          f"thread, {occ['blocks_per_sm']} blocks per SM (target "
          f"{occ['target_blocks']}, planned {planned}), "
          f"{occ['local_bytes']} local bytes, "
          f"{smem} shared bytes per block, a {window}-slot shared window"
          f"{' with the global scratch' if may_scratch else ''}{rows}: "
          f"{scratch:.1f} queries per batch used the scratch")
    if occ["blocks_per_sm"] < planned:
        fail(f"{name}: {occ['blocks_per_sm']} blocks per SM, below the "
             f"{planned} K1's window was sized for")
    return k1_ms, k1_plain, k1_bound, k1_by


def phase_profile(svc, queries, tag, mode=None):
    """Where a query batch's time goes: torch.profiler over the main path's
    batches (in sampling ``mode``, batch i at ``sample_seed(i)``), device
    time by kernel and the device's busy share."""
    queries = queries[:64]

    def request(i):
        if mode is None:
            return dict(topk=TOPK)
        return dict(topk=TOPK, mode=mode, seed=sample_seed(i))
    svc.query_arrays(queries[0], **request(0))
    profile_calls(tag, f"{len(queries)} query batches",
                  [lambda i=i, q=q: svc.query_arrays(q, **request(i))
                   for i, q in enumerate(queries)])


def profile_calls(tag: str, what: str, calls, top: int = 8,
                  cpu_top: int = 0):
    """torch.profiler over ``calls`` run in turn (then one synchronize):
    the wall time, the device's busy and idle shares and the kernels with
    the most device time (and with ``cpu_top`` the operations with the
    most host time of their own). Returns the last call's result."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for call in calls:
            out = call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")
                   and e.self_device_time_total > 0), reverse=True)
    busy_ms = sum(r[0] for r in rows)
    print(f"[{tag}] {what} under the profiler: wall "
          f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"({busy_ms / wall_ms:.1%}); idle {1 - busy_ms / wall_ms:.1%}")
    for ms, count, key in rows[:top]:
        print(f"[{tag}]   {ms:9.3f} ms x{count:<4d} {key[:80]}")
    if cpu_top:
        host = sorted(((e.self_cpu_time_total / 1e3, e.count, e.key)
                       for e in prof.key_averages()
                       if e.self_cpu_time_total > 0), reverse=True)
        n_ops = sum(e.count for e in prof.key_averages()
                    if e.key.startswith("aten::"))
        print(f"[{tag}] host: {n_ops} aten operations, the most host time "
              f"of their own:")
        for ms, count, key in host[:cpu_top]:
            print(f"[{tag}]   {ms:9.3f} ms x{count:<5d} {key[:80]}")
    return out


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


# [mixed]: queries of another format than the corpus's, K1's six
# cross-format branches. [main]'s planted-neighbour queries converted
# exactly (densified; TT by diagonal cores of TT rank 4), the first
# ``batches`` batches of 1024 a pair, over [main]'s CP corpus (dense x CP,
# TT x CP), [dense-main]'s (CP x dense, TT x dense) and [cp-as-tt]
# ([main]'s 2^20 items converted exactly to TT: CP x TT, dense x TT); and
# dense x CP over [shard]'s 4 shards. recall@10 against brute force on the
# first ``recall_queries`` queries of a pair (``recall_at_k``: its
# cross-format scores in chunks of at most 2^24 intermediate floats).
# [cp-as-tt] is hashed by tt-e2lsh rank 4, L = K = 10 through K4; w = 2.0 as
# [main]: a TT-Rademacher projection, like the CP one, has E<T, X>^2 =
# ||X||^2, so the same width gives buckets of the same scale and a cap near
# [main]'s (printed beside it).
MIXED = dict(batches=32, recall_queries=64)
CP_AS_TT = dict(tag="cp-as-tt", kind="tt-e2lsh", rank=4, codes=10,
                tables=10, width=2.0)


def mixed_batches(queries, layout):
    """[main]'s first query batches (CP) in ``layout``, exactly."""
    from repro_torch.core.tensor_formats import cp_to_tt
    qs = queries[:MIXED["batches"]]
    if layout == "tt":
        return [cp_to_tt(q) for q in qs]
    if layout == "dense":
        return [densify(q) for q in qs]
    return list(qs)


def phase_mixed(tag, svc, batches, qids, inst):
    """One cross-format pair (or, for [tt8]'s TT queries, the same-format
    pair at other ranks) through ``svc.query_arrays`` on the card, the
    counters zeroed just before and read just after: the pair's K1 branch
    and its instantiation ``inst`` ((TR, QR)) must have launched and no
    plain version run; recall@1 (planted) at least RECALL1_MIN, recall@10
    against brute force (``recall_at_k``), batch latency; K1 against its
    plain version and float64, and its time beside its bound and the plain
    version's -> (its record, the results, recall@1)."""
    import torch
    from repro_torch.core.index import recall_at_k
    idx = svc.index
    qf = batches[0].layout
    corpus = idx.effective_corpus()
    instance = "fused_query:" + k1_instance(*inst)
    branch = (instance if qf == corpus.layout
              else f"fused_query:mixed:{qf}-{corpus.layout}")
    torch.cuda.synchronize()
    zero_counts()
    results, lat_ms = serve(svc, batches)
    torch.cuda.synchronize()
    counts = read_counts()
    latency_line(tag, svc, lat_ms)
    print(f"[{tag}] launches: {({k: v for k, v in counts.items() if v})}")
    check_counts(counts, tag, ("fused_query", branch, instance))
    hits1, n_q = check_results(
        results, [q.cpu().numpy() for q in qids[:len(batches)]],
        corpus.leaves[0].shape[0])
    nr = MIXED["recall_queries"]
    r10 = recall_at_k(idx, batches[0].index(slice(0, nr)), TOPK)["recall"]
    print(f"[{tag}] {qf} queries over a {corpus.layout} corpus: recall@1 "
          f"(planted) {hits1 / n_q:.4f} over {n_q} queries; recall@10 vs "
          f"brute force {r10:.4f} over {nr}")
    if hits1 / n_q < RECALL1_MIN:
        fail(f"{tag}: recall@1 {hits1 / n_q} below {RECALL1_MIN}")
    err, k1_args = k1_compare(svc, batches[0], f"{tag}, B={len(qids[0])}",
                              corpus=corpus)
    k1_t = k1_times(svc, batches, k1_args, f"K1 {tag}", corpus=corpus)
    return (record(f"fused_query[{tag}]", *K1_SOURCE, counts, branch, err,
                   k1_t), results, hits1 / n_q)


def pad_tt(x, rank: int):
    """A TT batch with its interior ranks zero-padded to ``rank`` (r_0 =
    r_N = 1 kept): the same tensor exactly."""
    from repro_torch.core.tensor_formats import TTTensor
    cores, last = [], len(x.cores) - 1
    for k, c in enumerate(x.cores):
        shape = c.shape[:-3] + (1 if k == 0 else rank, c.shape[-2],
                                1 if k == last else rank)
        out = c.new_zeros(shape)
        out[..., :c.shape[-3], :, :c.shape[-1]] = c
        cores.append(out)
    return TTTensor(tuple(cores), x.scale)


def phase_mixed_main(svc, qids, queries) -> tuple[list, list]:
    """[mixed] on [main]'s service: dense x CP (``<0, kDense>``), TT x CP
    (``<0, 4>``) and [mixed tt8 x cp], the same TT queries zero-padded to
    rank 8 (``<0, 16>``), whose recall@1 must equal TT x CP's -> (the
    records, the dense queries and their answers, for [shard]'s pair)."""
    from repro_torch.kernels import fused_query as fq
    out = []
    dense = mixed_batches(queries, "dense")
    rec, dense_results, _ = phase_mixed("mixed dense x cp", svc, dense, qids,
                                        (0, fq.DENSE))
    out.append(rec)
    tt = mixed_batches(queries, "tt")
    rec, _, r1 = phase_mixed("mixed tt x cp", svc, tt, qids, (0, 4))
    out.append(rec)
    rec, _, r8 = phase_mixed("mixed tt8 x cp", svc,
                             [pad_tt(q, 8) for q in tt], qids, (0, 16))
    out.append(rec)
    if r8 != r1:
        fail(f"mixed tt8 x cp: recall@1 {r8} differs from [mixed tt x cp]'s "
             f"{r1} on the same queries, their ranks zero-padded")
    print(f"[mixed tt8 x cp] recall@1 {r8:.4f} equals [mixed tt x cp]'s")
    return out, (dense, dense_results)


SAMPLE = dict(batches=64, passes=4, seed=7, chi_rows=8192, chi_members=20)
K1_SAMPLE_SOURCE = ("src/repro_torch/kernels/csrc/fused_query_sample.cu",
                    "src/repro/kernels/fused_query.py:235")
K1S_SAMPLE_SOURCE = ("src/repro_torch/kernels/csrc/fused_query_sample.cu",
                     "src/repro/kernels/fused_query.py:250")


def sample_seed(i: int) -> int:
    """The request seed of a sampling pass's batch i."""
    return SAMPLE["seed"] + i


def sample_key(seed: int) -> tuple:
    """The draw's key words of a request's ``seed``, as the service makes
    them (a CPU generator seeded with it)."""
    import torch
    from repro_torch.kernels import fused_query as fq
    return fq.sample_key_words(torch.Generator().manual_seed(seed))


def sample_serve(svc, batches, mode):
    """A warm-up batch, then batch i through ``query_arrays(mode=mode,
    seed=sample_seed(i))`` -> (results, host-clock latencies in ms)."""
    svc.query_arrays(batches[0], topk=TOPK, mode=mode, seed=sample_seed(0))
    svc.stats.reset()
    results, lat_ms = [], []
    for i, q in enumerate(batches):
        t0 = time.perf_counter()
        results.append(svc.query_arrays(q, topk=TOPK, mode=mode,
                                        seed=sample_seed(i)))
        lat_ms.append((time.perf_counter() - t0) * 1e3)
    return results, lat_ms


def check_samples(tag, results, topk_results, metric) -> None:
    """Every sampled batch: candidate counts equal to the top-k path's on
    the same batch; min(topk, n_cand) distinct ids, -1 after them; finite
    scores in the top-k path's order."""
    import numpy as np
    fill = -1 - np.arange(TOPK)
    for i, ((ids, sc, nc), (_, _, t_nc)) in enumerate(zip(results,
                                                          topk_results)):
        if not np.array_equal(nc, t_nc):
            fail(f"{tag}: batch {i}'s candidate counts differ from the top-k "
                 f"path's in {int((nc != t_nc).sum())} rows")
        valid = ids >= 0
        if not (valid.sum(1) == np.minimum(nc, TOPK)).all() or (
                valid[:, 1:] & ~valid[:, :-1]).any():
            fail(f"{tag}: batch {i} does not hold min(topk, n_cand) ids "
                 "before its fill")
        srt = np.sort(np.where(valid, ids, fill), axis=1)
        if (srt[:, 1:] == srt[:, :-1]).any():
            fail(f"{tag}: batch {i} drew an id twice")
        if not np.isfinite(sc[valid]).all():
            fail(f"{tag}: non-finite score on a drawn id")
        step = sc[:, 1:] - sc[:, :-1]
        if (valid[:, 1:] & ((step < 0) if metric == "euclidean"
                            else (step > 0))).any():
            fail(f"{tag}: drawn ids not in the top-k path's score order")


def sample_compare(svc, q, label, mode, seed, served):
    """K1 (K1s) in sample ``mode`` against its plain version on one batch,
    with the key words of request ``seed`` (``served``: what the service
    answered to that request, which must be the kernel's answer bit for
    bit): candidate counts equal and equal to the union's size; the drawn
    sets equal (in "weighted" but where ``parity.sample_mismatches`` allows
    2 ulps of a perturbed logit); every drawn id a member of the query's
    union (``fused_query.sample_union``); where the sets are equal, scores
    within ``parity.rerank_bound`` and ids in order but at near ties ->
    (max |kernel - plain| score, the arguments ``k1_times`` takes)."""
    import numpy as np
    import torch
    from repro_torch.kernels import fused_query as fq
    from repro_torch.kernels import parity
    idx = svc.index
    fam, view = idx.family, idx.store.view
    corpus = idx.effective_corpus()
    qs = q.stack()
    values = fam.raw_stacked(qs[1], q.scale)
    offs, mults = fam.offsets, idx._mults_t
    kw = dict(kind=fam.kind, w=fam.bucket_width, num_tables=fam.num_tables,
              num_codes=fam.num_codes, metric=idx.metric, topk=TOPK,
              probes=1)
    kernel, plain, name = k1_entry(view)
    key = sample_key(seed)
    ik, sk, nk = kernel(values, offs, mults, qs, mode=mode, key=key, **kw)
    ip, sp, np_ = plain(values, offs, mults, qs, mode=mode, key=key, **kw)
    segs, caps = view.k1_segments
    union = fq.sample_union(values, offs, mults, segs, kind=fam.kind,
                            w=fam.bucket_width, num_tables=fam.num_tables,
                            num_codes=fam.num_codes, caps=caps, probes=1)
    torch.cuda.synchronize()
    label = f"{name} {label}"
    for a, b in zip((ik, sk, nk), served):
        if not np.array_equal(a.cpu().numpy().view(np.int32),
                              b.view(np.int32)):
            fail(f"{label}: the served answer is not the kernel's on the "
                 "request's key")
    eff, _, valid = union
    if not (torch.equal(nk, np_)
            and torch.equal(nk, valid.sum(1, dtype=torch.int32))):
        fail(f"{label}: candidate counts differ from the plain version's "
             "or from the union's size")
    bad = parity.sample_mismatches(mode, key, ik, ip, union)
    if bad:
        fail(f"{label}: {bad} rows drew other members than the plain "
             "version")
    drawn = ik >= 0
    member = ((ik[:, :, None] == eff[:, None, :])
              & valid[:, None, :]).any(-1)
    if not bool(member[drawn].all()):
        fail(f"{label}: a drawn id is not in its query's probed union")
    rows = torch.tensor([set(a[a >= 0].tolist()) == set(b[b >= 0].tolist())
                         for a, b in zip(ik.cpu(), ip.cpu())],
                        device=ik.device)
    tol = parity.rerank_bound(idx.metric, q, corpus, ip, sp)
    same = (ik == ip) & (ip >= 0) & rows[:, None]
    err = torch.where(same, (sk - sp).abs(), 0.0)
    if bool((err > tol).any()):
        fail(f"{label}: scores outside the rounding bound (max err "
             f"{float(err.max()):.3g})")
    ties = parity.topk_mismatches(ik[rows], sk[rows], ip[rows], sp[rows],
                                  tol[rows])
    if ties:
        fail(f"{label}: {ties} slots in another order without a near tie")
    n_bits = int((same & (sk.view(torch.int32) == sp.view(torch.int32)))
                 .sum())
    print(f"[{label}]: n_cand equal to the plain version's and the union's "
          f"({int(nk.sum())} members over {len(segs)} segment(s)); drawn "
          f"sets equal in {int(rows.sum())} of {len(rows)} rows (the others "
          f"within 2 ulps of a perturbed logit), every drawn id a distinct "
          f"member; {int(drawn.sum())} drawn, {n_bits} of their scores bit "
          f"for bit equal, max |kernel - plain| {float(err.max()):.3g} "
          f"(bound median {float(tol[same].median()):.3g})")
    return float(err.max()), (values, offs, mults, qs, view, kw)


def sample_pass(tag, svc, batches, topk_results, mode, inst, source):
    """One sampling pass: the batches through ``query_arrays(mode=...,
    seed=...)`` with the counters zeroed just before and read just after
    (the wrapper's sampling launches and the instantiation ``inst``'s
    sampling twin must have run, no plain version), the latencies, the
    answers against the top-k path's counts (``check_samples``), K1 (K1s)
    against its plain version on the first batch (``sample_compare``) and
    its time beside its bound -> (its record, the results)."""
    import torch
    view = svc.index.store.view
    wrapper = "fused_query_sharded" if view.sharded else "fused_query"
    torch.cuda.synchronize()
    zero_counts()
    results, lat_ms = sample_serve(svc, batches, mode)
    torch.cuda.synchronize()
    counts = read_counts()
    latency_line(f"{tag} {mode}", svc, lat_ms)
    print(f"[{tag} {mode}] launches: "
          f"{({k: v for k, v in counts.items() if v})}")
    check_counts(counts, f"{tag} {mode}",
                 (wrapper, f"{wrapper}:sample:{mode}",
                  f"{wrapper}:" + k1_instance(*inst, sample=True)))
    if counts[f"{wrapper}:" + k1_instance(*inst)]:
        fail(f"{tag} {mode}: the top-k instantiation ran on a sampling "
             "request")
    check_samples(f"{tag} {mode}", results, topk_results,
                  svc.index.metric)
    err, k1_args = sample_compare(svc, batches[0],
                                  f"{tag} {mode}, B={len(topk_results[0][2])}",
                                  mode, sample_seed(0), results[0])
    name = ("K1s" if view.sharded else "K1") + f" {tag} {mode}"
    t = k1_times(svc, batches, k1_args, name,
                 sample=(mode, sample_key(sample_seed(0))))
    rec = record(f"{wrapper}[{tag} {mode}]", *source, counts,
                 f"{wrapper}:sample:{mode}", err, t)
    return rec, results


def sample_chi2(svc, q, n_cand, mode) -> None:
    """A chi-square of one query's draws: the first query of batch ``q``
    with at least ``chi_members`` members in its union, replicated over
    ``chi_rows`` rows (independent draws) at topk 1; expected counts
    uniform or in proportion to the members' raw hit counts (the plain
    ``sample_union``); the bound of tests/test_multiprobe.py, 2 df + 6
    sqrt(2 df) + 20."""
    import numpy as np
    import torch
    from repro_torch.kernels import fused_query as fq
    idx = svc.index
    fam, view = idx.family, idx.store.view
    rows = SAMPLE["chi_rows"]
    r = int(np.flatnonzero(n_cand >= SAMPLE["chi_members"])[0])
    rep = q.index(torch.full((rows,), r, dtype=torch.long, device="cuda"))
    x, st = rep.stack()
    segs, caps = view.k1_segments
    eff, mult, valid = fq.sample_union(
        fam.raw_stacked(st[:1], x.scale), fam.offsets, idx._mults_t, segs,
        kind=fam.kind, w=fam.bucket_width, num_tables=fam.num_tables,
        num_codes=fam.num_codes, caps=caps, probes=1)
    members = eff[0][valid[0]].tolist()
    weights = mult[0][valid[0]].tolist()
    ids, _, _ = svc.query_arrays(rep, topk=1, mode=mode,
                                 seed=sample_seed(1000))
    drawn = ids[:, 0]
    counts = {m: int((drawn == m).sum()) for m in members}
    if sum(counts.values()) != rows:
        fail(f"[sample chi2 {mode}]: a draw is not a member of the union")
    total = sum(weights) if mode == "weighted" else len(members)
    expected = {m: rows * (w if mode == "weighted" else 1) / total
                for m, w in zip(members, weights)}
    chi2 = sum((counts[m] - e) ** 2 / e for m, e in expected.items())
    df = len(members) - 1
    bound = 2 * df + 6 * (2 * df) ** 0.5 + 20
    print(f"[sample chi2 {mode}] one query (row {r}) with {len(members)} "
          f"members (raw hit counts {min(weights)}-{max(weights)}) over "
          f"{rows} rows at topk 1: chi2 {chi2:.2f}, df {df}, bound "
          f"{bound:.2f}")
    if chi2 >= bound:
        fail(f"[sample chi2 {mode}]: chi2 {chi2} past its bound {bound}")


def phase_sample(svc, queries, main_results) -> tuple[list, dict]:
    """[sample] on [main]'s service: its first ``batches`` query batches in
    each sampling mode (``sample_pass``), a request replayed bit for bit
    and another seed's draw differing, the chi-square of one query's
    draws; then [sample dense x cp]: [mixed dense x cp]'s first ``passes``
    batches sampled -> (the records, each mode's [main] answers, for
    [shard]'s pass)."""
    from repro_torch.kernels import fused_query as fq
    batches = queries[:SAMPLE["batches"]]
    records, answers = [], {}
    for mode in SAMPLE_MODES:
        rec, results = sample_pass("sample", svc, batches,
                                   main_results[:len(batches)], mode, (0, 0),
                                   K1_SAMPLE_SOURCE)
        records.append(rec)
        answers[mode] = results
        again = svc.query_arrays(batches[0], topk=TOPK, mode=mode,
                                 seed=sample_seed(0))
        other = svc.query_arrays(batches[0], topk=TOPK, mode=mode,
                                 seed=sample_seed(999))
        same_answers(again, results[0], f"sample {mode}: the replayed seed")
        # rows whose union exceeds topk draw a subset, which another seed
        # should change
        big = results[0][2] > TOPK
        moved = float((other[0] != results[0][0]).any(1)[big].mean())
        if moved < 0.5:
            fail(f"sample {mode}: another seed redrew only {moved:.3f} of "
                 f"the {int(big.sum())} rows with more than {TOPK} members")
        print(f"[sample {mode}] a seed replays its draw bit for bit; another "
              f"seed redraws {moved:.3f} of the {int(big.sum())} rows with "
              f"more than {TOPK} members")
        sample_chi2(svc, batches[0], main_results[0][2], mode)
    # the three modes in turns on the same batches: batch means side by side
    means = {m: [] for m in ("topk",) + SAMPLE_MODES}
    for _ in range(3):
        for m in means:
            if m == "topk":
                serve(svc, batches)
            else:
                sample_serve(svc, batches, m)
            means[m].append(svc.stats.total_ms / svc.stats.batches)
    print("[sample ab] batch mean ms, 3 turns of " + str(len(batches))
          + " batches each: " + "; ".join(
              f"{m} " + " / ".join(f"{x:.3f}" for x in v)
              for m, v in means.items()))
    phase_profile(svc, queries, "sample-profile", mode="weighted")
    dense = mixed_batches(queries, "dense")[:SAMPLE["passes"]]
    dense_top = [svc.query_arrays(q, topk=TOPK) for q in dense]
    for mode in SAMPLE_MODES:
        rec, _ = sample_pass("sample dense x cp", svc, dense, dense_top, mode,
                             (0, fq.DENSE), K1_SAMPLE_SOURCE)
        records.append(rec)
    return records, answers


def phase_cp_as_tt(cell, corpus, qids, queries) -> list:
    """[cp-as-tt]: [main]'s 2^20 CP items converted exactly to TT (TT rank
    4), a tt-e2lsh index through K4, queried with [main]'s CP queries (CP x
    TT, hashed by the TT projection on CP inputs) and densified (dense x
    TT), each pair with a profile of its batches; then [tt8] -> their
    records."""
    import torch
    from repro_torch.core.tensor_formats import cp_to_tt
    from repro_torch.serving.lsh_service import build_service
    c = CP_AS_TT
    tt = cp_to_tt(corpus)
    torch.cuda.synchronize()
    zero_counts()
    svc = build_service(torch.Generator(device="cuda").manual_seed(1),
                        c["kind"], cell["dims"], tt, num_codes=c["codes"],
                        num_tables=c["tables"], rank=c["rank"],
                        bucket_width=c["width"], device="cuda")
    torch.cuda.synchronize()
    counts = read_counts()
    del tt
    st = svc.stats
    stacked = svc.index.store.base.stacked
    print(f"[{c['tag']}] build_service over [main]'s {stacked.shape[0]} CP "
          f"items as TT (ranks {svc.index.effective_corpus().ranks}, "
          f"{math.prod(stacked.shape[1:])} floats an item stacked, "
          f"{stacked.numel() * 4 / 2**30:.2f} GiB), {c['kind']} "
          f"K={c['codes']} L={c['tables']} rank {c['rank']} w={c['width']}: "
          f"{st.build_s:.3f} s (hash {st.hash_s:.3f} s), cap "
          f"{svc.index.cap} ([main]'s: see its line); launches "
          f"{({k: v for k, v in counts.items() if v})}")
    check_counts(counts, c["tag"], ("tt_inner",))
    from repro_torch.kernels import fused_query as fq
    out = []
    for qf, qr in (("cp", 0), ("dense", fq.DENSE)):
        batches = mixed_batches(queries, qf)
        out.append(phase_mixed(f"mixed {qf} x tt", svc, batches, qids,
                               (4, qr))[0])
        phase_profile(svc, batches, f"mixed {qf} x tt profile")
    del svc
    torch.cuda.empty_cache()
    return out + phase_tt8(cell, corpus)


# [tt8]: [main]'s first 2^16 items as exact TT zero-padded to rank 8 (TT
# ranks 5-16: K1's <16, 0>, <16, kDense>, <8, 8> and <16, 16>, rows
# through their ring slots where the plan fits them), indexed as
# [cp-as-tt]; CP and dense planted-neighbour queries, and the CP queries as
# TT padded to rank 8 and to 16, as many batches as the other [mixed] pairs
TT8 = dict(tag="tt8", log2_corpus=16, rank=8, batches=MIXED["batches"],
           tt_ranks=(8, 16))


def phase_tt8(cell, corpus) -> list:
    """[tt8]: CP, dense and TT queries over a TT corpus of rank 8 -> their
    records (``phase_mixed``, its instantiation required): [mixed cp x
    tt8] (``<16, 0>``), [mixed dense x tt8] (``<16, kDense>``), then [tt8
    x tt8] and [tt16 x tt8], the CP queries as TT zero-padded to rank 8
    (``<8, 8>``) and to 16 (``<16, 16>``, the query's rank 16 over rows of
    rank 8); their recall@1 printed side by side."""
    import torch
    from repro_torch.core.tensor_formats import cp_to_tt
    from repro_torch.kernels import fused_query as fq
    from repro_torch.serving.lsh_service import build_service
    c, n = CP_AS_TT, 1 << TT8["log2_corpus"]
    base = corpus.index(slice(0, n))
    gen = torch.Generator(device="cuda").manual_seed(cell["seed"] + 8)
    svc = build_service(torch.Generator(device="cuda").manual_seed(1),
                        c["kind"], cell["dims"],
                        pad_tt(cp_to_tt(base), TT8["rank"]),
                        num_codes=c["codes"], num_tables=c["tables"],
                        rank=c["rank"], bucket_width=c["width"],
                        device="cuda")
    print(f"[{TT8['tag']}] [main]'s first {n} items as TT of ranks "
          f"{svc.index.effective_corpus().ranks}, {c['kind']} "
          f"K={c['codes']} L={c['tables']} rank {c['rank']} w={c['width']}: "
          f"cap {svc.index.cap}")
    perm = torch.randperm(n, generator=gen, device="cuda")
    qids = [perm[i * 1024:(i + 1) * 1024] for i in range(TT8["batches"])]
    cp_q = [make_queries(base, q, gen) for q in qids]
    out, recall = [], {}
    for qf, qr in (("cp", 0), ("dense", fq.DENSE)):
        tag = f"mixed {qf} x tt8"
        rec, _, recall[tag] = phase_mixed(tag, svc, mixed_batches(cp_q, qf),
                                          qids, (16, qr))
        out.append(rec)
    for rank in TT8["tt_ranks"]:
        tag = f"tt{rank} x tt8"
        tt_q = [pad_tt(cp_to_tt(q), rank) for q in cp_q]
        rec, _, recall[tag] = phase_mixed(tag, svc, tt_q, qids,
                                          (rank, rank))
        out.append(rec)
    print(f"[{TT8['tag']}] recall@1 (planted) of the same queries in each "
          "format: " + ", ".join(f"[{k}] {v:.4f}" for k, v in recall.items()))
    del svc
    return out


def phase_shard_mixed(svc, dense, dense_results):
    """[shard]'s service with [main]'s densified queries (dense x CP over 4
    shards): K1s's cross-format branch launched, every batch equal to the
    single-card answers bit for bit; K1s against its plain version, its
    time -> its record."""
    import torch
    torch.cuda.synchronize()
    zero_counts()
    results, lat_ms = serve(svc, dense)
    torch.cuda.synchronize()
    counts = read_counts()
    latency_line("shard-mixed", svc, lat_ms, " dense queries")
    branch = "fused_query_sharded:mixed:dense-cp"
    check_counts(counts, "shard-mixed", ("fused_query_sharded", branch))
    for i, (got, want) in enumerate(zip(results, dense_results)):
        same_answers(got, want, f"shard-mixed: batch {i} against [mixed "
                                "dense x cp]")
    print(f"[shard-mixed] all {len(results)} dense-query batches equal the "
          "single-card answers bit for bit (ids, scores, candidate counts)")
    err, k1_args = k1_compare(svc, dense[0], f"shard-mixed, dense x cp, "
                                             f"S={SHARD['shards']}")
    k1_t = k1_times(svc, dense, k1_args,
                    f"K1s dense x cp S={SHARD['shards']}")
    return record(f"fused_query_sharded[mixed dense x cp, "
                  f"S={SHARD['shards']}]", *K1S_SOURCE, counts, branch, err,
                  k1_t)


def phase_shard(cell, corpus, qids, queries, main_results, mixed=None,
                samples=None, keep=None):
    """[shard]: [main]'s corpus, family and queries through
    ``build_service(..., shards=4)`` (exact cap, T = 1), counters zeroed
    just before and read just after; every batch's ids, scores and
    candidate counts must equal [main]'s bit for bit (shard-count
    invariance); then K1s against its plain version, its time and a
    profile; with ``mixed`` ([mixed dense x cp]'s dense queries and
    answers) also ``phase_shard_mixed``; with ``samples`` ([sample]'s
    answers by mode) [shard sample]: K1s's sampling pass over the first
    ``passes`` batches, each equal to [main]'s draw at the same seed bit
    for bit -> the records. ``keep`` takes the answers and the latency
    summary for [mesh]."""
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
    if keep is not None:
        keep.update(shard=results, shard_summary=summary)
    del summary
    out = [record("fused_query_sharded", *K1S_SOURCE, counts,
                  "fused_query_sharded", k1_err, k1_t)]
    if mixed is not None:
        out.append(phase_shard_mixed(svc, *mixed))
    for mode, want in (samples or {}).items():
        n = SAMPLE["passes"]
        rec, got = sample_pass("shard sample", svc, queries[:n],
                               results[:n], mode, (0, 0), K1S_SAMPLE_SOURCE)
        for i, (g, w_) in enumerate(zip(got, want)):
            same_answers(g, w_, f"shard sample {mode}: batch {i} against "
                                "[main]'s draw")
        print(f"[shard sample {mode}] all {n} batches equal [main]'s draws "
              "at the same seeds bit for bit")
        out.append(rec)
    return out


def phase_shard_mut(cell, corpus, qids, args, keep=None):
    """[shard-mut]: [mut]'s script (bucket_cap 64, T = 4, max_deltas 8) over
    S = 4 shards: routed slabs, K1s's live-window branch over 4 x 9
    (shard, segment) pairs, shard-local ``compact()`` and ``rebalance()``,
    with counters zeroed just before and read just after each run; gates:
    occupancy within one item of even after the routed inserts, no deleted
    id returned, recall@1, the rebalanced index equal to a fresh sharded
    build bit for bit, and an exact-cap mutated sharded index equal to a
    fresh single-device one (ids and candidate counts). ``keep`` takes the
    insert batches, the query batches and the answers before and after
    the compaction and after the rebalance, for [mesh]."""
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
    mutated_results = results
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
    rebalanced = [svc.query_arrays(q, topk=TOPK) for q in queries[:8]]
    for q, got in zip(queries[:8], rebalanced):
        same_answers(got, fresh.query_arrays(q, topk=TOPK),
                     "shard-mut: rebalanced index vs a fresh sharded build")
    del fresh
    if keep is not None:
        keep["shard-mut"] = dict(batches=batches, queries=queries,
                                 results=mutated_results, compacted=results,
                                 rebalanced=rebalanced, family=fam)
    del mutated_results
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


# [mesh]: [shard] and [shard-mut] over an explicit mesh of SHARD["shards"]
# slots on cuda:0 (``axis_rules``), each slot's blocks on its own slot and
# one K1s launch a slot; then the same path over the machine's real cards
# (``resolve_mesh(torch.cuda.device_count())``). ``time_batches`` query
# batches time each slot's K1s; ``sched_queries`` single queries go through
# a ``ServingScheduler``; ``real_batches`` batches check the real-card mesh
# on a one-card machine.
MESH = dict(time_batches=32, sched_queries=512, real_batches=32,
            merge_reps=64)


def mesh_slot(svc, slot):
    """One mesh slot of ``svc`` as the service-like object ``k1_compare`` /
    ``k1_times`` read: the slot's store view (its base block, slab blocks
    and K1 table) with the service's family, metric and mults."""
    from types import SimpleNamespace
    idx = svc.index
    return SimpleNamespace(index=SimpleNamespace(
        family=idx.family, metric=idx.metric, _mults_t=idx._mults_t,
        store=SimpleNamespace(view=slot),
        effective_corpus=idx.effective_corpus))


def mesh_merge_ms(svc, query) -> float:
    """The S-way merge's time (CUDA events) on one batch's per-slot K1s
    outputs."""
    import torch
    from repro_torch.distributed import index_sharding
    from repro_torch.kernels.fused_query import fused_query_sharded
    idx = svc.index
    fam = idx.family
    x, q = query.stack()
    values = fam.raw_stacked(q, x.scale)
    outs = [fused_query_sharded(
        values, fam.offsets, idx._mults_t, (x, q), slot.seg_arrays(0),
        slot.delta_arrays, kind=fam.kind, w=fam.bucket_width,
        num_tables=fam.num_tables, num_codes=fam.num_codes,
        metric=idx.metric, topk=TOPK, cap=slot.base.cap,
        delta_caps=slot.delta_caps, table=slot.k1_table)
        for slot in idx.store.view.slots]
    ids, scores, nc = (torch.stack(p) for p in zip(*outs))
    return cuda_ms([lambda: index_sharding.merge_topk(idx.metric, TOPK, ids,
                                                      scores, nc)],
                   MESH["merge_reps"])


def phase_mesh(cell, corpus, qids, queries, keep):
    """[mesh]: [shard]'s service (exact cap, T = 1) built through
    ``build_service(..., shards=4)`` under ``axis_rules`` of an explicit
    4-slot mesh on cuda:0, every counter zeroed just before its 256
    batches and read just after. Fails unless every batch equals [shard]'s
    bit for bit, recall@1 >= RECALL1_MIN, K1s launched 4 times a batch
    and K3 once, with no plain version run. Prints the batch mean / median
    / p99 beside [shard]'s, each slot's device bytes, each slot's K1s
    against its plain version and its time, and the merge's time. Then
    [shard-mut]'s script on the mesh (bucket_cap 64, T = 4, the same
    inserts, deletes, compaction and rebalance): every answer equal to
    [shard-mut]'s; a snapshot of the mutated mesh store recovered by a
    ``DurableLSHService`` onto a new 4-slot mesh, its answers equal; 512
    single queries through a ``ServingScheduler``, each equal to a direct
    row; then ``resolve_mesh(torch.cuda.device_count())``: one slot a card
    (one on a one-card machine), its answers equal to [shard]'s -> the K1s
    record of the mesh path (the slots' times summed: a batch's K1s
    work)."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from repro_torch.distributed import index_sharding
    from repro_torch.distributed.sharding import Mesh, axis_rules
    from repro_torch.serving.durability import (DurableLSHService,
                                                write_snapshot)
    from repro_torch.serving.lsh_service import build_service
    from repro_torch.serving.scheduler import ServingScheduler
    t_phase = time.perf_counter()
    smi = smi_line()
    s = SHARD["shards"]
    n = corpus.leaves[0].shape[0]
    slots = [torch.device("cuda", 0)] * s

    def mesh_service(**extra):
        with axis_rules(Mesh(slots, ("shard",))):
            svc = build_service(
                torch.Generator(device="cuda").manual_seed(1), cell["kind"],
                cell["dims"], corpus, num_codes=cell["codes"],
                num_tables=cell["tables"], rank=cell["rank"],
                bucket_width=cell["width"], shards=s, device="cuda",
                **extra)
        if (svc.index.query_path != "shard_map"
                or svc.index.store.base.devices != tuple(slots)):
            fail(f"mesh: the index is not laid over the {s}-slot mesh")
        return svc

    # the query path: [shard] over the mesh
    svc = mesh_service()
    torch.cuda.synchronize()
    zero_counts()
    results, lat_ms = serve(svc, queries)
    torch.cuda.synchronize()
    counts = read_counts()
    n_b = len(queries) + 1             # serve's warm-up batch
    print(f"[mesh] launches on the main path: "
          f"{ {k: v for k, v in counts.items() if v} }")
    check_counts(counts, "mesh", ("cp_gram", "fused_query_sharded"))
    if (counts["fused_query_sharded"], counts["cp_gram"],
            counts["fused_query"]) != (s * n_b, n_b, 0):
        fail(f"mesh: K1s launched {counts['fused_query_sharded']} times and "
             f"K3 {counts['cp_gram']} over {n_b} batches of {s} slots "
             f"(want {s * n_b} and {n_b}), K1 {counts['fused_query']}")
    for i, (got, want) in enumerate(zip(results, keep["shard"])):
        same_answers(got, want, f"mesh: batch {i} against [shard]")
    hits1, n_q = check_results(results, [q.cpu().numpy() for q in qids], n)
    if hits1 / n_q < RECALL1_MIN:
        fail(f"mesh: recall@1 {hits1 / n_q} below {RECALL1_MIN}")
    summary = latency_line("mesh", svc, lat_ms, f" over {s} slots")
    ref = keep["shard_summary"]
    view = svc.index.store.view
    # each storage once: the corpus leaves are views of the stacked copy
    slot_bytes = [sum({t.untyped_storage().data_ptr():
                       t.untyped_storage().nbytes()
                       for t in slot.tensors()}.values())
                  for slot in view.slots]
    print(f"[mesh] on {smi}: all {len(results)} batches equal [shard]'s bit "
          f"for bit (ids, scores, candidate counts), recall@1 "
          f"{hits1 / n_q:.4f}; K1s {s} launches a batch, K3 one; batch mean "
          f"{summary['mean']:.4f} ms, median {summary['median']:.4f} ms, "
          f"p99 {summary['p99']:.4f} ms against [shard]'s {ref['mean']:.4f}"
          f" / {ref['median']:.4f} / {ref['p99']:.4f} ms in this run; "
          f"device bytes a slot {slot_bytes} (the home card holds no copy "
          f"of the sharded arrays)")
    corpus_eff = svc.index.effective_corpus()
    errs, times = [], []
    for i, slot in enumerate(view.slots):
        one = mesh_slot(svc, slot)
        err, k1_args = k1_compare(one, queries[0], f"mesh slot {i} of {s}, "
                                  f"B={len(qids[0])}", corpus=corpus_eff)
        times.append(k1_times(one, queries[:MESH["time_batches"]], k1_args,
                              f"K1s mesh slot {i} of {s}", corpus_eff))
        errs.append(err)
    merge_ms = mesh_merge_ms(svc, queries[0])
    print(f"[mesh] on {smi}: K1s a slot "
          f"{[round(t[0], 4) for t in times]} ms (sum "
          f"{sum(t[0] for t in times):.4f} ms a batch), the merge "
          f"(packed_select over {s} x {TOPK} rows) {merge_ms:.4f} ms")
    rec = record("fused_query_sharded[mesh]", *K1S_SOURCE, counts,
                 "fused_query_sharded", max(errs),
                 (sum(t[0] for t in times), sum(t[1] for t in times),
                  sum(t[2] for t in times), times[0][3]))
    del corpus_eff

    # 512 single queries through the scheduler, each equal to a direct row
    nq = MESH["sched_queries"]
    sq = queries[1].index(slice(0, nq))
    direct = svc.query_arrays(sq, topk=TOPK)
    sched = ServingScheduler({"mesh": svc}, max_batch=64, deadline_ms=2.0)
    try:
        futs = [sched.query(sq.index(i), tenant="mesh", topk=TOPK)
                for i in range(nq)]
        rows = [f.result(timeout=120) for f in futs]
    finally:
        sched.close()
    bad = [i for i, row in enumerate(rows)
           if not row_equal(row, row_of(direct, i))]
    if bad:
        fail(f"mesh: {len(bad)} scheduled queries differ from their direct "
             f"rows (first {bad[0]})")
    print(f"[mesh] {nq} single queries through the scheduler each equal "
          "their direct row bit for bit")
    del svc, sched, results

    # [shard-mut]'s script on the mesh
    m = keep["shard-mut"]
    msvc = mesh_service(bucket_cap=MUT["cap"], probes=MUT["probes"],
                        max_deltas=MUT["max_deltas"])
    _, _, note = mut_script("mesh-mut", msvc, m["batches"], n,
                            np.random.default_rng(17))
    if any(g.devices != tuple(slots) for g in msvc.index.store.deltas):
        fail("mesh-mut: a routed slab is not laid over the mesh")
    torch.cuda.synchronize()
    zero_counts()
    res, lat_ms = serve(msvc, m["queries"])
    torch.cuda.synchronize()
    counts_mut = read_counts()
    n_b = len(m["queries"]) + 1
    check_counts(counts_mut, "mesh-mut", (
        "cp_gram", "fused_query_sharded", "fused_query_sharded:multiprobe",
        "fused_query_sharded:live_window", "fused_query_sharded:segments"))
    if counts_mut["fused_query_sharded"] != s * n_b:
        fail(f"mesh-mut: K1s launched {counts_mut['fused_query_sharded']} "
             f"times over {n_b} batches of {s} slots")
    for i, (got, want) in enumerate(zip(res, m["results"])):
        same_answers(got, want, f"mesh-mut: batch {i} against [shard-mut]")
    latency_line("mesh-mut", msvc, lat_ms, f" over {s} slots")
    tmp = tempfile.mkdtemp(prefix="mesh_")
    try:
        t0 = time.perf_counter()
        write_snapshot(tmp, 0, msvc)
        snap_s = time.perf_counter() - t0
        msvc.compact()
        for i, (q, want) in enumerate(zip(m["queries"], m["compacted"])):
            same_answers(msvc.query_arrays(q, topk=TOPK), want,
                         f"mesh-mut: compacted batch {i} against "
                         "[shard-mut]'s")
        msvc.rebalance()
        for i, (q, want) in enumerate(zip(m["queries"], m["rebalanced"])):
            same_answers(msvc.query_arrays(q, topk=TOPK), want,
                         f"mesh-mut: rebalanced batch {i} against "
                         "[shard-mut]'s")
        if msvc.index.store.base.devices != tuple(slots):
            fail("mesh-mut: the rebalanced store left the mesh")
        del msvc
        with axis_rules(Mesh(slots, ("shard",))):
            dsvc = DurableLSHService(
                m["family"], tmp, shards=s, bucket_cap=MUT["cap"],
                probes=MUT["probes"], max_deltas=MUT["max_deltas"])
            t0 = time.perf_counter()
            dsvc.recover()
            rec_s = time.perf_counter() - t0
        if dsvc.index.store.base.devices != tuple(slots):
            fail("mesh: the recovered store is not laid over the mesh")
        for i, q in enumerate(m["queries"][:8]):
            same_answers(dsvc.query_arrays(q, topk=TOPK), res[i],
                         f"mesh: recovered batch {i} against the live "
                         "mutated mesh store")
        dsvc.close()
        del dsvc
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[mesh-mut] {note}; every batch equals [shard-mut]'s bit for bit "
          f"before and after compact() and after rebalance(); the mutated "
          f"store's snapshot {snap_s:.3f} s, recovered onto a new {s}-slot "
          f"mesh in {rec_s:.3f} s, 8 batches equal bit for bit")

    # the machine's real cards
    count = torch.cuda.device_count()
    mesh, axis = index_sharding.resolve_mesh(count, "cuda")
    cards = index_sharding.slot_devices(mesh, axis)
    rsvc = build_service(torch.Generator(device="cuda").manual_seed(1),
                         cell["kind"], cell["dims"], corpus,
                         num_codes=cell["codes"], num_tables=cell["tables"],
                         rank=cell["rank"], bucket_width=cell["width"],
                         shards=count, device="cuda")
    if (rsvc.index.query_path != "shard_map"
            or rsvc.index.store.base.devices != tuple(cards)):
        fail(f"mesh: shards={count} is not laid over the {count} cards")
    nr = len(queries) if count > 1 else MESH["real_batches"]
    zero_counts()
    real, lat_ms = serve(rsvc, queries[:nr])
    torch.cuda.synchronize()
    launched = read_counts()["fused_query_sharded"]
    if launched != count * (nr + 1):
        fail(f"mesh: K1s launched {launched} times over {nr + 1} batches "
             f"of {count} cards")
    for i, (got, want) in enumerate(zip(real, keep["shard"])):
        same_answers(got, want, f"mesh: real-card batch {i} against [shard]")
    if count > 1:
        latency_line("mesh cards", rsvc, lat_ms, f" over {count} cards")
        print(f"[mesh cards] {count} cards: every batch equals [shard]'s "
              "bit for bit")
    else:
        print(f"[mesh] resolve_mesh({count}) on this machine: one slot on "
              f"{cards[0]}, {nr} batches equal [shard]'s bit for bit; the "
              "multi-card figures (peer copies, one card's memory a shard) "
              "wait for a machine with more than one card")
    del rsvc
    print(f"[mesh] {time.perf_counter() - t_phase:.1f} s")
    return rec


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
    lib3 = cuda_ms([lambda: library_raw("cp", x3, p3)], 20)
    lib4 = cuda_ms([lambda: library_raw("tt", x4, p4)], 20)
    for name, t, what, lib in (
            ("K7", t7, f"({rows}, {k7c}) values", None),
            ("K3 e2lsh-keys", t3, "B=64 N=4 d=64 R=32 L=8 K=8 (warp kernel)",
             lib3),
            ("K4 srp-keys", t4, "B=32 N=4 d=32 R=16 L=4 K=8 (warp kernel)",
             lib4)):
        what += ("" if lib is None else
                 f"; one fp32 torch.einsum over the same operands, raw "
                 f"values, {lib:.4f} ms")
        print(f"[time] {name}, {what}: {t[0]:.4f} ms (plain {t[1]:.4f} ms); "
              f"bound {t[2]:.4f} ms by {t[3]}")
    return [record("srp_pack", *K6_SOURCE, counts, "srp_pack", 0.0, t6),
            record("e2lsh_quant", *K7_SOURCE, counts, "e2lsh_quant", 0.0, t7),
            dict(record("cp_gram[R=32]", *HASH_RECORDS["cp"][1:], counts,
                        "cp_gram", err3, t3), library_ms=lib3),
            dict(record("tt_inner[R=16]", *HASH_RECORDS["tt"][1:], counts,
                        "tt_inner", err4, t4), library_ms=lib4)]


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
    lib3 = cuda_ms([lambda: library_raw("cp", x3, p3)], 10)
    lib4 = cuda_ms([lambda: library_raw("tt", x4, p4)], 10)
    for name, t, lib in (("K3 e2lsh-keys, K=2000 (tiled)", t3, lib3),
                         ("K4 e2lsh-keys, K=1024 (tiled)", t4, lib4)):
        print(f"[time] {name}, {LIMITS['items']} items: {t[0]:.4f} ms "
              f"(plain {t[1]:.4f} ms; one fp32 torch.einsum over the same "
              f"operands, raw values, {lib:.4f} ms); bound {t[2]:.4f} ms by "
              f"{t[3]}")
    return [dict(record("cp_gram[K=2000]", *HASH_RECORDS["cp"][1:], counts,
                        "cp_gram", errs["cp"], t3), library_ms=lib3),
            dict(record("tt_inner[K=1024]", *HASH_RECORDS["tt"][1:], counts,
                        "tt_inner", errs["tt"], t4), library_ms=lib4),
            record("fused_query[tt, R=16]", *K1_SOURCE, counts,
                   "fused_query", k1_err, k1_t)]


# [dense-main] / [dense-cp]: [main]'s 2^20 CP corpus and its 256 query
# batches densified (1,728 floats an item); the naive e2lsh (a Gaussian
# (100, 1728) matrix) and the paper's CP-E2LSH (rank 3, materialized:
# 100 * 1728 * 3 <= 2^24) on the dense rows, w = 2.0 as [main] (their
# projections have unit variance, as cp-e2lsh's on CP data). Untimed: srp /
# cosine over the dense corpus at 2^16, e2lsh over [main]'s CP corpus at
# 2^16 (densified to hash, K1 re-ranks in CP), [mut]'s script on a dense
# 2^16 corpus (single-device and over 4 shards with rebalance) and 4,096
# items of (16, 16, 16, 16) (65,536-float rows read in place; cp-e2lsh at
# rank 4 past MATERIALIZE_LIMIT, the per-mode chain)
DENSE = dict(
    main=dict(tag="dense-main", kind="e2lsh", dims=(12, 12, 12), rhat=4,
              codes=10, tables=10, rank=3, width=2.0, hash_kernel=None),
    cp=dict(tag="dense-cp", kind="cp-e2lsh", dims=(12, 12, 12), rhat=4,
            codes=10, tables=10, rank=3, width=2.0, hash_kernel=None),
    small=1 << 16, every=17, srp=dict(codes=12, tables=4),
    mut=dict(cap=64, probes=4, inserts=2, deletes=2048, shards=4),
    big=dict(dims=(16, 16, 16, 16), n=4096, codes=10, tables=10, rank=4,
             width=2.0, every=16),
)


def densify(x, chunk: int = 16384):
    """A batched CP tensor -> its dense rows as a ``DenseTensor``, a chunk
    of items at a time (float32 throughout)."""
    import torch
    from repro_torch.core.projections import densify_batch
    from repro_torch.core.tensor_formats import DenseTensor
    n = x.leaves[0].shape[0]
    out = torch.empty((n,) + tuple(x.dims), device=x.device)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        out[s:e] = densify_batch(x.index(slice(s, e))).view(
            (e - s,) + tuple(x.dims))
    return DenseTensor(out, tuple(x.dims))


def dense_noisy(corpus, qid, gen):
    """Dense corpus rows ``qid`` plus NOISE / sqrt(prod d) Gaussian noise
    an entry (a noise of norm about NOISE, as [main]'s queries carry)."""
    import torch
    q = corpus.index(qid)
    noise = torch.randn(q.data.shape, generator=gen, device=q.device)
    return q.with_leaves([q.data + NOISE / q.row_floats ** 0.5 * noise])


def dense_storage(svc, tag) -> None:
    from repro_torch.core.lsh import naive_storage_size
    fam = svc.index.family
    naive = naive_storage_size(fam.projection.dims, fam.num_codes,
                               fam.num_tables)
    print(f"[{tag}] projection storage {fam.storage_size()} scalars "
          f"({fam.kind}); the naive method's {naive}")


def phase_dense_cell(cell, corpus, qids, queries, profile: bool,
                     cp_queries=None):
    """One timed dense cell: ``phase_main`` (recall@1, self-queries,
    recall@10, latency, peak memory), K1-dense against its plain version,
    the dense hash per query batch and K1-dense per batch (CUDA events)
    beside its byte bound; with ``cp_queries`` ([main]'s first CP batches)
    also [mixed] CP x dense and TT x dense on its service -> (the K1
    records, the summary)."""
    from repro_torch.kernels import fused_query as fq
    svc, counts, summary, _ = phase_main(cell, corpus, qids, queries)
    dense_storage(svc, cell["tag"])
    fam = svc.index.family
    qss = [q.stack()[1] for q in queries]
    h_ms = cuda_ms([lambda x=x: fam.raw_stacked(x, 1.0) for x in qss],
                   2 * len(qss))
    print(f"[{cell['tag']}] the dense hash (fp32 matrix products over "
          f"1,024-row chunks, TF32 off) per query batch: {h_ms:.4f} ms")
    k1_err, k1_args = k1_compare(svc, queries[0],
                                 f"{cell['tag']}, B={len(qids[0])}")
    k1_t = k1_times(svc, queries, k1_args, f"K1-dense {cell['tag']}")
    if profile:
        phase_profile(svc, queries, cell["tag"] + "-profile")
    records = [record(f"fused_query[{cell['tag']}]", *K1_SOURCE, counts,
                      "fused_query", k1_err, k1_t)]
    if cp_queries is not None:
        records += [phase_mixed(f"mixed {qf} x dense", svc,
                                mixed_batches(cp_queries, qf), qids,
                                (fq.DENSE, qr))[0]
                    for qf, qr in (("cp", 0), ("tt", 16))]
    del svc, k1_args
    return records, summary


def phase_dense_small(corpus, cp_corpus, gen) -> None:
    """srp / cosine over the dense corpus at 2^16, and e2lsh over [main]'s
    CP corpus at 2^16 (K1 re-ranks in CP): counters checked, K1 against its
    plain version."""
    from repro_torch.serving.lsh_service import build_service
    import torch
    n, every = DENSE["small"], DENSE["every"]
    c = DENSE["srp"]
    sub = corpus.index(slice(0, n))
    zero_counts()
    svc = build_service(gen, "srp", sub.dims, sub, metric="cosine",
                        num_codes=c["codes"], num_tables=c["tables"],
                        device="cuda")
    q = dense_noisy(sub, torch.arange(0, n, every, device="cuda"), gen)
    ids, _, nc = svc.query_arrays(q, topk=TOPK)
    counts = read_counts()
    print(f"[dense-srp] n={n} dense items, srp K={c['codes']} "
          f"L={c['tables']}, cap {svc.index.cap}: {float(nc.mean()):.1f} "
          f"candidates per query; launches {counts}")
    check_counts(counts, "dense-srp", ("fused_query",))
    k1_compare(svc, q, f"dense-srp / cosine, B={q.data.shape[0]}")
    del svc
    cell = DENSE["main"]
    sub = cp_corpus.index(slice(0, n))
    zero_counts()
    svc = build_service(gen, "e2lsh", cell["dims"], sub,
                        num_codes=cell["codes"], num_tables=cell["tables"],
                        bucket_width=cell["width"], device="cuda")
    q = make_queries(sub, torch.arange(0, n, every, device="cuda"), gen)
    ids, _, nc = svc.query_arrays(q, topk=TOPK)
    self_ids, _, _ = svc.query_arrays(sub.index(slice(0, 256)), topk=1)
    counts = read_counts()
    print(f"[e2lsh-cp] n={n} CP items under the naive e2lsh (densified to "
          f"hash), cap {svc.index.cap}: {float(nc.mean()):.1f} candidates "
          f"per query; self-queries first "
          f"{(self_ids[:, 0] == list(range(256))).mean():.4f}; launches "
          f"{counts}")
    check_counts(counts, "e2lsh-cp", ("fused_query",))
    if (self_ids[:, 0] != list(range(256))).any():
        fail("e2lsh-cp: a self-query did not return itself first")
    k1_compare(svc, q, f"e2lsh over CP rows, B={q.leaves[0].shape[0]}")


def phase_dense_mut(corpus, gen) -> list:
    """[mut]'s script on a dense 2^16 corpus (e2lsh, bucket_cap 64, T = 4,
    two inserts of 1,024, 2,048 deletes: K1-dense's live-window,
    multi-probe and segments branches), ``compact()`` against a fresh build
    bit for bit; then the same over 4 shards (K1s-dense), timed,
    ``rebalance()`` against a fresh sharded build -> the K1s record."""
    import numpy as np
    import torch
    from repro_torch.serving.lsh_service import build_service
    cell, m = DENSE["main"], DENSE["mut"]
    n = DENSE["small"]
    kw = dict(num_codes=cell["codes"], num_tables=cell["tables"],
              bucket_width=cell["width"], bucket_cap=m["cap"],
              probes=m["probes"], device="cuda")
    base = corpus.index(slice(0, n))
    adds = [corpus.index(slice(n + i * 1024, n + (i + 1) * 1024))
            for i in range(m["inserts"])]
    rng = np.random.default_rng(37)
    q = dense_noisy(base, torch.randint(0, n, (1024,), generator=gen,
                                        device="cuda"), gen)

    def script(svc):
        for a in adds:
            svc.insert(a)
        svc.delete(rng.choice(svc.index.size, m["deletes"], replace=False))
        return svc

    out = []
    for shards in (None, m["shards"]):
        tag = "dense-mut" if shards is None else "dense-shard-mut"
        k1 = "fused_query" if shards is None else "fused_query_sharded"
        zero_counts()
        svc = script(build_service(
            torch.Generator(device="cuda").manual_seed(1), cell["kind"],
            cell["dims"], base, shards=shards, **kw))
        got = svc.query_arrays(q, topk=TOPK)
        torch.cuda.synchronize()
        counts = read_counts()
        print(f"[{tag}] n={n} dense items + {m['inserts']} deltas of 1024, "
              f"{m['deletes']} deleted, bucket_cap {m['cap']}, "
              f"T={m['probes']}, shards {shards or 1}: "
              f"{float(got[2].mean()):.1f} candidates per query; launches "
              f"{counts}")
        check_counts(counts, tag, (k1, f"{k1}:multiprobe",
                                   f"{k1}:live_window", f"{k1}:segments"))
        err, k1_args = k1_compare(svc, q, f"{tag}, cap {m['cap']}, "
                                          f"T={m['probes']}",
                                  probes=m["probes"])
        if shards is not None:
            k1_t = k1_times(svc, [q], k1_args, f"K1s-dense {tag}")
            out.append(record(f"fused_query_sharded[{tag}]", *K1S_SOURCE,
                              counts, "fused_query_sharded", err, k1_t))
            svc.rebalance()
        else:
            svc.compact()
        fresh = build_service(None, cell["kind"], cell["dims"],
                              svc.index.effective_corpus(),
                              family=svc.index.family, shards=shards, **kw)
        same_answers(svc.query_arrays(q, topk=TOPK),
                     fresh.query_arrays(q, topk=TOPK),
                     f"{tag}: {'rebalanced' if shards else 'compacted'} vs "
                     "a fresh build")
        print(f"[{tag}] {'rebalance()' if shards else 'compact()'} answers "
              "as a fresh build, bit for bit")
        del svc, fresh
    return out


def phase_dense_big(gen) -> None:
    """4,096 items of (16, 16, 16, 16) (65,536-float rows: K1 reads the
    query in place too): e2lsh, and cp-e2lsh at rank 4 past
    MATERIALIZE_LIMIT (the hash's per-mode chain); counters checked, K1
    against its plain version, self-queries."""
    import torch
    from repro_torch.core import projections
    from repro_torch.core.tensor_formats import DenseTensor
    from repro_torch.serving.lsh_service import build_service
    c = DENSE["big"]
    d = 1
    for x in c["dims"]:
        d *= x
    data = torch.randn((c["n"],) + c["dims"], generator=gen,
                       device="cuda") / d ** 0.5
    corpus = DenseTensor(data, c["dims"])
    q = dense_noisy(corpus, torch.arange(0, c["n"], c["every"],
                                         device="cuda"), gen)
    for kind in ("e2lsh", "cp-e2lsh"):
        zero_counts()
        svc = build_service(gen, kind, c["dims"], corpus,
                            num_codes=c["codes"], num_tables=c["tables"],
                            rank=c["rank"], bucket_width=c["width"],
                            device="cuda")
        p = svc.index.family.projection
        chain = kind != "e2lsh" and p.materialized is None
        self_ids, _, _ = svc.query_arrays(corpus.index(slice(0, 64)), topk=1)
        counts = read_counts()
        how = (f" (the per-mode chain, past MATERIALIZE_LIMIT "
               f"{projections.MATERIALIZE_LIMIT})" if chain else "")
        print(f"[dense-big] {c['n']} items of {c['dims']}, {kind}{how}, "
              f"cap {svc.index.cap}; launches {counts}")
        if kind != "e2lsh" and not chain:
            fail("dense-big: cp-e2lsh at rank 4 was materialized")
        check_counts(counts, "dense-big", ("fused_query",))
        if (self_ids[:, 0] != list(range(64))).any():
            fail(f"dense-big {kind}: a self-query did not return itself")
        k1_compare(svc, q, f"dense-big {kind}, {d}-float rows")
        del svc


def run_dense(args) -> list:
    """The dense cells on [main]'s corpus and queries, densified ->
    their kernel records."""
    import torch
    cell = CELLS["cp"]
    n = 1 << args.log2_corpus
    gen = torch.Generator(device="cuda").manual_seed(cell["seed"])
    cp = hash_fns("cp")["data"](gen, cell["dims"], cell["rhat"], batch=n)
    perm = torch.randperm(n, generator=gen, device="cuda")
    qids = [perm[i * args.batch:(i + 1) * args.batch]
            for i in range(args.batches)]
    cp_queries = [make_queries(cp, q, gen) for q in qids]
    queries = [densify(q) for q in cp_queries]
    cp_queries = cp_queries[:MIXED["batches"]]
    t0 = time.perf_counter()
    corpus = densify(cp)
    torch.cuda.synchronize()
    print(f"[dense] [main]'s corpus densified: {n} x {corpus.row_floats} "
          f"floats ({corpus.data.numel() * 4 / 2**30:.2f} GiB) in "
          f"{time.perf_counter() - t0:.3f} s")
    gen = torch.Generator(device="cuda").manual_seed(41)
    phase_dense_small(corpus, cp, gen)
    del cp
    records = []
    summaries = {}
    for key, profile in (("main", True), ("cp", False)):
        recs, summaries[key] = phase_dense_cell(
            DENSE[key], corpus, qids, queries, profile,
            cp_queries if key == "main" else None)
        records += recs
        torch.cuda.empty_cache()
    del cp_queries
    records += phase_dense_mut(corpus, gen)
    del corpus, queries
    torch.cuda.empty_cache()
    phase_dense_big(gen)
    torch.cuda.empty_cache()
    return records


# [tables]: the paper's Tables 1 and 2 (benchmarks/table1_e2lsh.py,
# table2_srp.py): for N in {2, 3, 4}, d = 16, K = 16 in one table,
# projection rank 4, data rank 4 (w = 4 for E2LSH), the naive kind on CP
# input, CP and TT on CP input, CP and TT on TT input; batches of 1,024
# items for the device time per item
TABLES = dict(n_sweep=(2, 3, 4), d=16, codes=16, rank=4, rhat=4, w=4.0,
              batch=1024)
# [collision]: benchmarks/collision.py (dense x and noise of dims (8, 8, 8),
# M = 2000 codes in one table, rank 2, w = 4), then the tensorized kinds on
# their kernels' formats: CP pairs of rank 32 (x and the noise CP of rank
# 16 each, y their exact sum), the dense pairs in TT form (TT-SVD, ranks
# (8, 8), exact to fp32)
COLLISION = dict(dims=(8, 8, 8), m=2000, rank=2, w=4.0,
                 rs=(0.5, 1.0, 2.0, 4.0, 8.0),
                 mixes=(0.05, 0.2, 0.5, 1.0, 2.0), cp_rank=16, tt_rank=8)
# [host]: build_service(device=False) at [main]'s configuration over the
# first 2^18 items of [main]'s corpus; 64 batches of 1,024 noisy queries;
# 256 queries checked one at a time at T = 1 and T = 4
HOST = dict(log2_corpus=18, batches=64, checks=256, probes=(1, 4), seed=37)


def host_us(fn, warmup: int = 2, iters: int = 10) -> float:
    """benchmarks/common.time_fn on the card: the median host-clock time of
    one synchronized call, in microseconds, after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2] * 1e6


def hash_times(fam, xs, epilogue: str, reps: int = 20) -> tuple:
    """One K3 / K4 launch of ``fam`` on the batch ``xs`` (its stacked
    operands; ``epilogue`` one of the kernel's) -> ((kernel ms, plain ms,
    bound ms, bound_by), library ms: one fp32 ``torch.einsum`` over the same
    operands (``library_raw``), max |kernel - plain| raw). The bound reads
    each item's and each projection's row at its true ranks once, the
    offsets and multipliers once and writes the output once; it does
    ``inner_flops`` per (item, hash)."""
    import torch
    layout = xs.layout
    f = hash_fns(layout)
    x, p = fam.stack(xs), fam.stacked_projection
    scale = xs.scale * fam.projection.scale
    l, k = fam.num_tables, fam.num_codes
    offs = (fam.offsets.reshape(l, k) if fam.offsets is not None
            else torch.zeros((l, k), device=x.device))
    mults = torch.ones(k, dtype=torch.int64, device=x.device)
    kw = dict(epilogue=epilogue, w=fam.bucket_width or 1.0, scale=scale)
    args = (x, p, offs, mults)
    items = x.shape[0]
    proj = fam.projection.input_format(fam.projection.leaves, 1.0)
    out = items * l * (1 if epilogue.endswith("keys") else k)
    nbytes = 4 * (items * xs.row_floats + l * k * proj.row_floats
                  + 2 * l * k + k + out)
    flops = items * l * k * inner_flops(xs, proj)
    t = (cuda_ms([lambda: f["kernel"](*args, **kw)], reps),
         cuda_ms([lambda: f["plain"](*args, **kw)], 3),
         *bound_ms(nbytes, flops))
    lib = cuda_ms([lambda: library_raw(layout, x, p)], reps)
    err = float((f["kernel"](x, p, epilogue="raw", scale=scale)
                 - f["plain"](x, p, epilogue="raw", scale=scale))
                .abs().max())
    return t, lib, err


def codes_vs_plain(fam, xs, codes) -> tuple[int, int]:
    """The card's (B, L, K) ``codes`` of ``xs`` against the same family's
    plain path on the CPU (K3's / K4's plain versions for CP under CP and
    TT under TT, the same torch products for the other pairs) -> (codes
    that differ, boundary codes); fails if a code differs away from a
    bucket edge (E2LSH) or 0 (SRP), as ``parity.boundary_codes`` bounds
    them (``parity.family_raw_bound``)."""
    from repro_torch.kernels import parity
    fam_c, xs_c = fam.to("cpu"), xs.to("cpu")
    want = fam_c.hash_batch(xs_c)
    raw = fam_c.raw_stacked(fam_c.stack(xs_c), xs_c.scale)
    b, l, k = want.shape
    bound = parity.family_raw_bound(fam_c, xs_c)
    offs = fam_c.offsets.reshape(l, k) if fam_c.offsets is not None else None
    near = parity.boundary_codes(raw.reshape(b, l, k),
                                 bound.reshape(b, l, k), fam.kind, offs,
                                 fam.bucket_width)
    differ = codes.cpu() != want
    if bool((differ & ~near).any()):
        fail(f"{fam.kind} on {xs.layout} inputs: "
             f"{int((differ & ~near).sum())} codes differ from the plain "
             "version's away from a bucket edge")
    return int(differ.sum()), int(near.sum())


def table_storage(kind: str, n: int, d: int, k: int, r: int) -> int:
    """Tables 1-2's closed forms of projection storage: K N d R for CP,
    K (2 d R + (N - 2) d R^2) for TT, K d^N for the naive kinds."""
    if kind.startswith("cp-"):
        return k * n * d * r
    if kind.startswith("tt-"):
        return k * (2 * d * r + (n - 2) * d * r * r)
    return k * d ** n


def phase_tables(smi: str) -> list:
    """[tables]: Tables 1 and 2 on the card. Counters zeroed just before
    the rows and read just after: K3 and K4 launched, no plain version.
    Each row: projection storage (equal to its closed form), hash(x)'s time
    per call (``host_us``) and hash_batch's device time per item (CUDA
    events); hash(x) equal to row 0 of hash_batch; afterwards the codes
    against the plain version, boundary-aware -> K3's and K4's records at
    N = 4."""
    import torch
    from repro_torch.core import tensor_formats
    from repro_torch.core.lsh import make_family
    c = TABLES
    d, k, r, bsz = c["d"], c["codes"], c["rank"], c["batch"]
    gen = torch.Generator(device="cuda").manual_seed(31)
    print(f"[tables] on {smi}")
    rows, kernel_rows = [], {}
    torch.cuda.synchronize()
    zero_counts()
    for table, base in (("table1", "e2lsh"), ("table2", "srp")):
        for n in c["n_sweep"]:
            dims = (d,) * n
            xs_cp = tensor_formats.cp_random_data(gen, dims, c["rhat"],
                                                  batch=bsz)
            xs_tt = tensor_formats.tt_random_data(gen, dims, c["rhat"],
                                                  batch=bsz)
            for label, kind, xs in (
                    (f"{base}-naive", base, xs_cp),
                    (f"cp-{base}", f"cp-{base}", xs_cp),
                    (f"tt-{base}", f"tt-{base}", xs_cp),
                    (f"cp-{base}-ttinput", f"cp-{base}", xs_tt),
                    (f"tt-{base}-ttinput", f"tt-{base}", xs_tt)):
                fam = make_family(gen, kind, dims, num_codes=k,
                                  num_tables=1, rank=r, bucket_width=c["w"],
                                  device="cuda")
                x = xs.index(0)
                one = fam.hash(x)
                batch = fam.hash_batch(xs)
                if not torch.equal(one, batch[0]):
                    fail(f"[tables] {table} {label} N={n}: hash(x) differs "
                         "from row 0 of hash_batch")
                us = host_us(lambda: fam.hash(x))
                item_us = cuda_ms([lambda: fam.hash_batch(xs)], 10) * 1e3 \
                    / bsz
                storage = fam.storage_size()
                closed = table_storage(kind, n, d, k, r)
                if storage != closed:
                    fail(f"[tables] {table} {label} N={n}: storage "
                         f"{storage} scalars, closed form {closed}")
                rows.append(dict(table=table, label=label, n=n, fam=fam,
                                 xs=xs, codes=batch, storage=storage,
                                 us=us, item_us=item_us))
                if n == max(c["n_sweep"]) and fam.uses_kernel(xs.layout) \
                        and base == "e2lsh":
                    kernel_rows[xs.layout] = (fam, xs)
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"[tables] launches: {counts}")
    check_counts(counts, "tables", ("cp_gram", "tt_inner"))
    storage = {}
    for row in rows:
        n_diff, n_near = codes_vs_plain(row["fam"], row["xs"], row["codes"])
        storage[row["table"], row["label"], row["n"]] = row["storage"]
        print(f"[tables] {row['table']} {row['label']}/N{row['n']}d{d}: "
              f"storage {row['storage']} scalars (= the closed form); "
              f"hash(x) {row['us']:.1f} us a call (host clock, median of 10 "
              f"after 2 warm-ups); hash_batch of {bsz}: "
              f"{row['item_us']:.4f} us an item on the device; hash(x) = "
              f"row 0; {n_diff} of {row['codes'].numel()} codes differ from "
              f"the plain version's, {n_near} boundary codes")
    for table, base in (("table1", "e2lsh"), ("table2", "srp")):
        n = max(c["n_sweep"])
        cp, tt, naive = (storage[table, f"{p}{base}{s}", n]
                         for p, s in (("cp-", ""), ("tt-", ""),
                                      ("", "-naive")))
        if not cp < tt < naive:
            fail(f"[tables] {table} at N={n}: storage not CP {cp} < TT {tt} "
                 f"< naive {naive}")
        ratio = {m: storage[table, base + "-naive", m]
                 / storage[table, "cp-" + base, m] for m in c["n_sweep"]}
        ratios = ", ".join(f"N={m}: {r:.1f}x" for m, r in ratio.items())
        print(f"[tables] {table}: naive / CP storage {ratios}; at N={n} CP "
              f"{cp} < TT {tt} < naive {naive}")
    records = []
    for layout, (fam, xs) in sorted(kernel_rows.items()):
        t, lib, err = hash_times(fam, xs, "e2lsh")
        key, source, replaces = HASH_RECORDS[layout]
        print(f"[time] {hash_fns(layout)['name']} e2lsh codes, [tables] N="
              f"{max(c['n_sweep'])} d={d}, {bsz} items x {k} hashes: "
              f"{t[0]:.4f} ms (plain {t[1]:.4f} ms; one fp32 torch.einsum "
              f"{lib:.4f} ms); bound {t[2]:.5f} ms by {t[3]}")
        records.append(dict(record(f"{key}[tables]", source, replaces,
                                   counts, key, err, t), library_ms=lib))
    return records


def cp_concat(a, b, b_scale: float):
    """The CP tensor a + b_scale * b, exactly: a's and b's rank-1 terms side
    by side (rank R_a + R_b, scale 1; the scales folded into the first
    factor)."""
    import torch
    from repro_torch.core.tensor_formats import CPTensor
    first = torch.cat((a.factors[0] * a.scale,
                       b.factors[0] * (b.scale * b_scale)), -1)
    return CPTensor((first,) + tuple(
        torch.cat((fa, fb), -1)
        for fa, fb in zip(a.factors[1:], b.factors[1:])), 1.0)


def collision_pairs(x, noise, xc, nc):
    """Per E2LSH distance r and SRP mix, the pair (x, y) in each input
    format: dense (y = x + noise r / ||noise|| and y = x + mix noise, as
    benchmarks/collision.py), CP of rank 2 x 16 (the same construction on
    the CP pair (xc, nc), the noise scaled to ||xc|| for the SRP mixes) and
    the dense pairs in TT form -> {format: {"e2lsh" | "srp": [(r or cos,
    x, y)]}}."""
    import torch
    from repro_torch.core.tensor_formats import dense_to_tt
    c = COLLISION
    n_norm = float(noise.norm())
    xn = float(xc.self_inners().sqrt())
    nn = float(nc.self_inners().sqrt())
    x32 = cp_concat(xc, nc, 0.0)
    xc64 = xc.with_leaves(f.double() for f in xc.factors)

    def cosine(y):                       # <xc, y> / (|xc| |y|) in float64
        y64 = y.with_leaves(f.double() for f in y.factors)
        return float(xc64.pair_inners(y64)
                     / (xn * y64.self_inners().sqrt()))

    def tt(t):
        return dense_to_tt(t, c["tt_rank"])

    dense = {"e2lsh": [(r, x, x + noise * (r / n_norm)) for r in c["rs"]],
             "srp": []}
    for mix in c["mixes"]:
        y = x + mix * noise
        dense["srp"].append((float((x * y).sum() / (x.norm() * y.norm())),
                             x, y))
    cp = {"e2lsh": [(r, x32, cp_concat(xc, nc, r / nn)) for r in c["rs"]],
          "srp": []}
    for mix in c["mixes"]:
        y = cp_concat(xc, nc, mix * xn / nn)
        cp["srp"].append((cosine(y), x32, y))
    tx = tt(x)
    tts = {h: [(v, tx, tt(y)) for v, _, y in pairs]
           for h, pairs in dense.items()}
    torch.cuda.synchronize()
    return {"dense": dense, "cp": cp, "tt": tts}


def phase_collision(smi: str) -> list:
    """[collision]: benchmarks/collision.py on the card, every kind on the
    dense pairs, and the CP kinds on CP pairs (K3) and the TT kinds on TT
    pairs (K4), counters zeroed just before and read just after: K3 and K4
    launched, no plain version. Each (kind, input format): the empirical
    collision rate over M codes at every distance or mix against
    ``theory``, failing at |emp - p| >= 5 sqrt(p (1 - p) / M) + 0.015 (the
    reference's test), the largest deviation and hash(x)'s time per call
    -> K3's and K4's records at these shapes."""
    import torch
    from repro_torch.core import tensor_formats, theory
    from repro_torch.core.lsh import make_family
    c = COLLISION
    dims, m, w = c["dims"], c["m"], c["w"]
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(dims, generator=gen, device="cuda")
    noise = torch.randn(dims, generator=gen, device="cuda")
    xc = tensor_formats.cp_random_data(gen, dims, c["cp_rank"])
    nc = tensor_formats.cp_random_data(gen, dims, c["cp_rank"])
    pairs = collision_pairs(x, noise, xc, nc)
    print(f"[collision] on {smi}: dims {dims}, M={m} codes in one table, "
          f"rank {c['rank']}, w={w}")
    torch.cuda.synchronize()
    zero_counts()
    results, kernel_rows = [], {}
    for kind in ("cp-e2lsh", "tt-e2lsh", "e2lsh", "cp-srp", "tt-srp",
                 "srp"):
        e2 = kind.endswith("e2lsh")
        fam = make_family(gen, kind, dims, num_codes=m, num_tables=1,
                          rank=c["rank"], bucket_width=w, device="cuda")
        formats = ["dense"] + ([kind[:2]] if kind[:2] in ("cp", "tt")
                               else [])
        for fmt in formats:
            rows = pairs[fmt]["e2lsh" if e2 else "srp"]
            x0 = rows[0][1]
            cx = fam.hash(x0).reshape(-1)
            worst = 0.0
            for v, _, y in rows:
                emp = float((cx == fam.hash(y).reshape(-1)).float().mean())
                p = float(theory.e2lsh_collision_prob(v, w) if e2
                          else theory.srp_collision_prob(v))
                limit = 5.0 * math.sqrt(max(p * (1.0 - p), 1e-4) / m) + 0.015
                if abs(emp - p) >= limit:
                    fail(f"[collision] {kind} on {fmt} inputs at "
                         f"{'r' if e2 else 'cos'}={v:.4f}: empirical "
                         f"{emp:.4f} against p {p:.4f}, beyond {limit:.4f}")
                worst = max(worst, abs(emp - p))
            us = host_us(lambda: fam.hash(x0))
            results.append((kind, fmt, worst, us))
            if fmt != "dense":
                kernel_rows[fmt] = (fam, tensor_formats.batch_of_one(x0))
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"[collision] launches: {counts}")
    check_counts(counts, "collision", ("cp_gram", "tt_inner"))
    for kind, fmt, worst, us in results:
        print(f"[collision] collision/{kind} on {fmt} inputs: max |empirical "
              f"- theory| {worst:.4f} over "
              f"{len(c['rs']) if kind.endswith('e2lsh') else len(c['mixes'])} "
              f"{'distances' if kind.endswith('e2lsh') else 'mixes'}; "
              f"hash(x) {us:.1f} us a call")
    records = []
    for layout, (fam, xs) in sorted(kernel_rows.items()):
        t, lib, err = hash_times(fam, xs, "srp" if fam.kind.endswith("srp")
                                 else "e2lsh")
        key, source, replaces = HASH_RECORDS[layout]
        print(f"[time] {hash_fns(layout)['name']} {fam.kind} codes, "
              f"[collision] one item of rank {xs.rank} x {m} hashes: "
              f"{t[0]:.4f} ms (plain {t[1]:.4f} ms; one fp32 torch.einsum "
              f"{lib:.4f} ms); bound {t[2]:.5f} ms by {t[3]}")
        records.append(dict(record(f"{key}[collision]", source, replaces,
                                   counts, key, err, t), library_ms=lib))
    return records


def same_rows(tag, got, want, tol=None) -> int:
    """(ids, scores) of one query against a batch row: bit-equal, else ids
    equal except at near ties and scores within ``tol`` -> 1 if bit-equal,
    else 0; fails otherwise."""
    import numpy as np
    import torch
    from repro_torch.kernels import parity
    (gi, gs), (wi, ws) = got, want
    if gi.shape == wi.shape and np.array_equal(gi, wi) and \
            np.array_equal(gs, ws):
        return 1
    if tol is None or gi.shape != wi.shape or parity.topk_mismatches(
            *(torch.from_numpy(np.asarray(a)[None])
              for a in (gi, gs, wi, ws)),
            torch.from_numpy(np.full((1, len(wi)), tol, np.float32))):
        fail(f"[host] {tag}: {gi} {gs} against the batch row {wi} {ws}")
    return 0


def phase_host(cell, corpus) -> list:
    """[host]: ``build_service(device=False)`` (``HostLSHIndex``: the
    dict-of-buckets build, K3 hashing it, queries through K1) at [main]'s
    configuration over the first 2^18 items of [main]'s corpus, counters
    zeroed just before and read just after: recall@1 of 64 batches of
    1,024 noisy queries; then for 256 queries at T = 1 and T = 4 the dicts'
    candidates against a device index's ``candidates_batch`` over the same
    items and K1's n_candidates, ``query`` against ``query_batch`` and
    ``brute_force`` against ``brute_force_batch``; K1 against its plain
    version and timed -> K1's record."""
    import numpy as np
    import torch
    from repro_torch.core.index import (DeviceLSHIndex, brute_force,
                                        brute_force_batch)
    from repro_torch.serving.lsh_service import build_service
    c = HOST
    n = min(1 << c["log2_corpus"], corpus.leaves[0].shape[0])
    sub = corpus.index(slice(0, n))
    gen = torch.Generator(device="cuda").manual_seed(c["seed"])
    perm = torch.randperm(n, generator=gen, device="cuda")
    bsz = min(1024, n // c["batches"])
    qids = [perm[i * bsz:(i + 1) * bsz] for i in range(c["batches"])]
    queries = [make_queries(sub, q, gen) for q in qids]
    torch.cuda.synchronize()
    zero_counts()
    svc = build_service(torch.Generator(device="cuda").manual_seed(1),
                        cell["kind"], cell["dims"], sub,
                        num_codes=cell["codes"], num_tables=cell["tables"],
                        rank=cell["rank"], bucket_width=cell["width"],
                        device=False)
    build_launches = read_counts()["cp_gram"]
    results, lat_ms = serve(svc, queries)
    torch.cuda.synchronize()
    counts = read_counts()
    host = svc.index
    print(f"[host] build_service(device=False) over n={n} (the first "
          f"2^{c['log2_corpus']} items of [main]'s corpus), {cell['kind']} "
          f"K={cell['codes']} L={cell['tables']}: {type(host).__name__} on "
          f"{host.device}; build {svc.stats.build_s:.3f} s (hash "
          f"{host.hash_s:.3f} s, host dicts {host.dict_s:.3f} s, segment "
          f"sort {host.sort_s:.3f} s), {sum(len(t) for t in host._tables)} "
          f"buckets in {len(host._tables)} dicts")
    print(f"[host] launches on the host-mode path: {counts} (build: cp_gram "
          f"{build_launches})")
    check_counts(counts, "host", ("cp_gram", "fused_query"))
    summary = latency_line("host", svc, lat_ms)
    hits1, n_q = check_results(results, [q.cpu().numpy() for q in qids], n)
    print(f"[host] recall@1 (planted) {hits1 / n_q:.4f} over {n_q} queries")
    if hits1 / n_q < RECALL1_MIN:
        fail(f"host: recall@1 {hits1 / n_q} below {RECALL1_MIN}")
    dev = DeviceLSHIndex(host.family, metric=host.metric).build(sub)
    print(f"[host] the device index over the same items: build hash "
          f"{dev.hash_s:.3f} s, sort {dev.sort_s:.3f} s (the host build's "
          f"dicts {host.dict_s:.3f} s beside them)")
    q = queries[0].index(slice(0, c["checks"]))
    truth_ids, truth_scores = brute_force_batch(host.metric, q, sub, TOPK)
    bf_equal = 0
    for i in range(c["checks"]):
        bf_equal += same_rows(
            f"brute_force row {i}",
            brute_force(host.metric, q.index(i), sub, TOPK),
            (truth_ids[i], truth_scores[i]), tol=1e-5)
    for t in c["probes"]:
        cand, valid = dev.candidates_batch(q, probes=t)
        ids, scores, n_cand = host.query_batch(q, topk=TOPK, probes=t)
        ids, scores = ids.cpu().numpy(), scores.cpu().numpy()
        n_cand = n_cand.cpu().numpy()
        cand, valid = cand.cpu().numpy(), valid.cpu().numpy()
        sizes, q_equal = [], 0
        for i in range(c["checks"]):
            x = q.index(i)
            got = host.candidates(x, probes=t)
            want = np.sort(cand[i][valid[i]])
            if not np.array_equal(got, want):
                fail(f"[host] T={t} query {i}: the dicts' {got.size} "
                     f"candidates differ from the device index's "
                     f"candidates_batch ({want.size})")
            if got.size != n_cand[i]:
                fail(f"[host] T={t} query {i}: {got.size} candidates, K1 "
                     f"counted {n_cand[i]}")
            qi, qs, qn = host.query(x, topk=TOPK, probes=t)
            keep = ids[i] >= 0
            if qn != n_cand[i]:
                fail(f"[host] T={t} query {i}: query() counted {qn}, "
                     f"query_batch {n_cand[i]}")
            q_equal += same_rows(f"T={t} query {i}", (qi, qs),
                                 (ids[i][keep], scores[i][keep]))
            sizes.append(got.size)
        print(f"[host] T={t}: the dicts' candidates equal the device index's "
              f"candidates_batch and K1's n_candidates for all "
              f"{c['checks']} queries (mean {np.mean(sizes):.1f}, max "
              f"{max(sizes)}); query(x) equal to its query_batch row for "
              f"{q_equal} of {c['checks']}")
    print(f"[host] brute_force(x) equal to its brute_force_batch row bit for "
          f"bit for {bf_equal} of {c['checks']} (the others within near "
          f"ties)")
    k1_err, k1_args = k1_compare(svc, queries[0], f"host, B={bsz}")
    k1_t = k1_times(svc, queries, k1_args, "K1 host")
    del dev
    return [dict(record("fused_query[host]", *K1_SOURCE, counts,
                        "fused_query", k1_err, k1_t),
                 recall1=hits1 / n_q, batch_ms=summary["mean"])]


# ---------------------------------------------------------------------------
# [sched]: the serving scheduler's two lanes on two CUDA streams
# ---------------------------------------------------------------------------

SCHED = dict(max_batch=64, deadline_ms=2.0, shard_items=1 << 18,
             shard_extra=1 << 14, shards=4, capacity_reqs=4096,
             utilization=0.2, blocks=3, block_s=0.8, shard_every=8,
             insert=512, pause_frac=1.0, race=4096, race_deletes=1024,
             samples=8, seed=53, gate=1.5)


def lane_counts() -> dict:
    """K3, K1 and K1s launches by lane (the launching thread's name)."""
    fns = counters()
    return {f"{k}@{lane}": n for k in ("cp_gram", "fused_query",
                                       "fused_query_sharded")
            for lane, n in fns[k].lanes.items()}


def pct(lat, q) -> float:
    import numpy as np
    return float(np.percentile(lat, q)) if len(lat) else float("nan")


class Churn:
    """[sched]'s ingest traffic: while enabled, a cycle a tenant of a
    512-item insert, the delete of those items and the fold (``compact()``
    on "main", ``rebalance()`` on "shard"), each through the scheduler and
    waited for; a pause of ``pause_frac`` times the cycle after each. A
    cycle leaves each tenant's live corpus as it found it, so the quiet
    blocks' answers stay those of the pristine stores."""

    def __init__(self, sched, batches):
        import threading
        self.sched, self.batches = sched, batches
        self.swaps = {"main": 0, "shard": 0}
        self.errors: list = []
        self._go, self._idle = threading.Event(), threading.Event()
        self._idle.set()
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def cycle(self, k: int) -> None:
        import numpy as np
        for tenant, fold in (("main", self.sched.compact),
                             ("shard", self.sched.rebalance)):
            n0 = self.sched.service(tenant).index.size
            batch = self.batches[k % len(self.batches)]
            self.sched.insert(batch, tenant=tenant).result(timeout=120)
            self.sched.delete(np.arange(n0, n0 + SCHED["insert"]),
                              tenant=tenant).result(timeout=120)
            fold(tenant).result(timeout=120)
            self.swaps[tenant] += 1

    def _loop(self):
        k = 0
        while not self._stop:
            if not self._go.wait(timeout=0.02):
                continue
            if self._stop:
                return
            self._idle.clear()
            t0 = time.perf_counter()
            try:
                self.cycle(k)
            except Exception as exc:      # reported by the phase
                self.errors.append(exc)
            finally:
                self._idle.set()
            k += 1
            pause = SCHED["pause_frac"] * (time.perf_counter() - t0)
            end = time.perf_counter() + pause
            while time.perf_counter() < end and self._go.is_set():
                time.sleep(0.005)

    def enable(self):
        self._go.set()

    def disable(self):
        self._go.clear()
        self._idle.wait(120)

    def stop(self):
        self._stop = True
        self._go.set()
        self._thread.join(timeout=120)


def row_of(result, i):
    """Row ``i`` of a ``query_arrays`` result, as a scheduled request's
    (ids, scores, n_candidates)."""
    return result[0][i], result[1][i], int(result[2][i])


def row_equal(a, b) -> bool:
    """Two (ids, scores, n_candidates) rows bit for bit."""
    import numpy as np
    return (np.array_equal(a[0], b[0]) and int(a[2]) == int(b[2])
            and np.array_equal(np.asarray(a[1]).view(np.int32),
                               np.asarray(b[1]).view(np.int32)))


def open_loop(sched, items, rate, seed, duration_s):
    """Poisson arrivals at ``rate`` for ``duration_s`` -> (tenant index
    per request, item index per request, latency ms, results): every
    ``shard_every``-th request goes to "shard"; latency is completion minus
    the scheduled arrival (open loop: a response queued behind a stall
    keeps accruing)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    n = max(int(rate * duration_s), 16)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, size=n))
    done = np.zeros(n)
    tenant = (np.arange(n) % SCHED["shard_every"]
              == SCHED["shard_every"] - 1).astype(int)
    which = rng.integers(0, len(items[0]), size=n)
    which = np.where(tenant == 1, which % len(items[1]), which)
    futs = []
    t0 = time.perf_counter()
    for i in range(n):
        wait = arrivals[i] - (time.perf_counter() - t0)
        if wait > 0:
            time.sleep(wait)
        fut = sched.query(items[tenant[i]][which[i]], topk=TOPK,
                          tenant=("main", "shard")[tenant[i]])
        fut.add_done_callback(
            lambda f, i=i: done.__setitem__(i, time.perf_counter() - t0))
        futs.append(fut)
    results = [f.result(timeout=120) for f in futs]
    return tenant, which, (done - arrivals) * 1e3, results, \
        done.max() - arrivals[0]


def phase_sched(cell, corpus, qids, queries) -> None:
    """[sched]: [main]'s service ("main", the full-width path) and [shard]'s
    S = 4 service over the first 2^18 items ("shard", with a ``max_items``
    quota of 2^18 + 2^14) behind one ``ServingScheduler`` (``max_batch``
    64, ``deadline_ms`` 2.0): its query lane on a stream of the highest
    priority, its ingest lane on another. Counters zeroed just before the
    services are built and read after the scheduler closes. Single planted
    queries (one in eight to "shard") arrive open-loop (Poisson) at 20% of
    the closed-loop capacity measured through the scheduler, in
    alternating quiet and compacting blocks (``Churn``); per tenant and
    phase: p50 / p99 / p99.9 / max latency, goodput, the compacting / quiet
    p99 ratio beside the reference's 1.5, mean coalesced batch, swaps, K1,
    K1s and K3 launches by lane. Fails unless: quiet answers equal the
    direct batch's rows bit for bit; sampling requests replay by seed and
    never coalesce; the quota refuses and counts an insert past
    ``max_items``; 4,096 scheduled queries racing a compaction of a mutated
    store each equal the direct row on the pre- or the post-swap store bit
    for bit; every K1 / K1s / K3 counter moved on its lane and no plain
    version ran; recall@1 >= 0.95 over the quiet queries."""
    import gc

    import numpy as np
    import torch
    from repro_torch.core.tensor_formats import batch_of_one, cp_random_data
    from repro_torch.serving.lsh_service import build_service
    from repro_torch.serving.scheduler import (INGEST_LANE, QUERY_LANE,
                                               QuotaExceeded,
                                               ServingScheduler, TenantQuota)
    c = SCHED
    t_phase = time.perf_counter()
    smi = smi_line()
    gen = torch.Generator(device="cuda").manual_seed(c["seed"])
    n_shard = min(c["shard_items"], corpus.leaves[0].shape[0])
    sub = corpus.index(slice(0, n_shard))
    sqid = torch.randperm(n_shard, generator=gen, device="cuda")[:1024]
    shard_q = make_queries(sub, sqid, gen)
    batches = [cp_random_data(gen, cell["dims"], cell["rhat"],
                              batch=c["insert"]) for _ in range(4)]
    kw = dict(num_codes=cell["codes"], num_tables=cell["tables"],
              rank=cell["rank"], bucket_width=cell["width"], device="cuda")
    torch.cuda.synchronize()
    zero_counts()
    main_svc = build_service(torch.Generator(device="cuda").manual_seed(1),
                             cell["kind"], cell["dims"], corpus, **kw)
    shard_svc = build_service(torch.Generator(device="cuda").manual_seed(1),
                              cell["kind"], cell["dims"], sub,
                              shards=c["shards"], **kw)
    # the items of the traffic and the direct batches' rows for each
    nb = 4
    items = ([queries[b].index(i) for b in range(nb)
              for i in range(queries[b].leaves[0].shape[0])],
             [shard_q.index(i) for i in range(1024)])
    direct = (
        [np.concatenate(a) for a in zip(*[main_svc.query_arrays(
            queries[b], topk=TOPK) for b in range(nb)])],
        list(shard_svc.query_arrays(shard_q, topk=TOPK)))
    targets = (torch.cat(qids[:nb]).cpu().numpy(), sqid.cpu().numpy())
    # what a serving process does once its indexes are built: move the
    # heap it has so far to the collector's permanent generation, so that
    # a full collection scans only what serving allocates. Without it the
    # full collections, which stop every thread for 107-147 ms on this
    # heap, set the phase's p99 (PERF.md, [sched])
    gc.collect()
    gc.freeze()
    pauses, started = [], {}

    def on_gc(phase, info):
        if phase == "start":
            started["t"] = time.perf_counter()
        elif info["generation"] == 2:
            pauses.append((time.perf_counter() - started["t"]) * 1e3)

    gc.callbacks.append(on_gc)
    sched = ServingScheduler({"main": main_svc, "shard": shard_svc},
                             max_batch=c["max_batch"],
                             deadline_ms=c["deadline_ms"],
                             quotas={"shard": TenantQuota(
                                 max_items=n_shard + c["shard_extra"])})
    qs, ing = sched.streams[main_svc.device]
    default = torch.cuda.default_stream(main_svc.device).cuda_stream
    print(f"[sched] on {smi}: tenants main (n={corpus.leaves[0].shape[0]}, "
          f"{cell['kind']} K={cell['codes']} L={cell['tables']}) and shard "
          f"(S={c['shards']}, n={n_shard}, max_items "
          f"{n_shard + c['shard_extra']}); max_batch {c['max_batch']}, "
          f"deadline {c['deadline_ms']} ms; query stream priority "
          f"{qs.priority}, ingest {ing.priority} (streams {qs.cuda_stream:#x}"
          f", {ing.cuda_stream:#x}, default {default:#x})")
    if len({qs.cuda_stream, ing.cuda_stream, default}) != 3 or not (
            qs.priority < ing.priority):
        fail("sched: the lanes do not run on two streams of their own, the "
             "query lane's of the higher priority")
    churn = Churn(sched, batches)
    try:
        # warm both lanes, then the closed-loop capacity through the lanes
        [f.result(timeout=120) for f in [sched.query(x, topk=TOPK, tenant="main")
                                         for x in items[0][:256]]]
        churn.cycle(0)
        for _ in range(2):
            t0 = time.perf_counter()
            futs = [sched.query(items[0][i % len(items[0])], topk=TOPK,
                                tenant="main")
                    for i in range(c["capacity_reqs"])]
            [f.result(timeout=120) for f in futs]
            cap = c["capacity_reqs"] / (time.perf_counter() - t0)
        rate = c["utilization"] * cap
        print(f"[sched] closed-loop capacity {cap:.0f} req/s through the "
              f"scheduler ({c['capacity_reqs']} single queries submitted at "
              f"once, mean batch {sched.stats.mean_batch:.1f}); offered "
              f"{rate:.0f} req/s ({c['utilization']:.0%})")
        # sampling: replays by seed, never coalesces
        b0 = sched.stats.batches
        futs = [sched.query(items[0][i // 2], topk=TOPK, mode=mode,
                            seed=1000 + i // 2, tenant="main")
                for mode in ("uniform", "weighted")
                for i in range(2 * c["samples"])]
        got = [f.result(timeout=120) for f in futs]
        sched.flush(timeout=120)
        if sched.stats.batches - b0 != len(futs):
            fail(f"sched: {len(futs)} sampling requests ran in "
                 f"{sched.stats.batches - b0} batches: they coalesced")
        for j in range(0, len(got), 2):
            i, mode = (j % (2 * c["samples"])) // 2, (
                "uniform", "weighted")[j // (2 * c["samples"])]
            want = main_svc.query_arrays(batch_of_one(items[0][i]),
                                         topk=TOPK, mode=mode, seed=1000 + i)
            if not (row_equal(got[j], got[j + 1])
                    and row_equal(got[j], row_of(want, 0))):
                fail(f"sched: sampling request {j} ({mode}) did not replay "
                     "the direct draw at its seed")
        # the quota
        big = cp_random_data(gen, cell["dims"], cell["rhat"],
                             batch=c["shard_extra"] + 1)
        try:
            sched.insert(big, tenant="shard")
            fail("sched: an insert past max_items was admitted")
        except QuotaExceeded as exc:
            print(f"[sched] quota: {exc}")
        if shard_svc.stats.rejected != 1:
            fail(f"sched: rejected {shard_svc.stats.rejected} != 1")
        del big
        # alternating quiet and compacting blocks
        lat = {(t, p): [] for t in (0, 1) for p in ("quiet", "compacting")}
        wall = {p: 0.0 for p in ("quiet", "compacting")}
        coal = {p: [0, 0] for p in ("quiet", "compacting")}
        swaps = {p: {"main": 0, "shard": 0} for p in ("quiet",
                                                      "compacting")}
        lanes = {p: {} for p in ("quiet", "compacting")}
        quiet_checked = hits = rows = 0
        for k in range(2 * c["blocks"]):
            phase = ("quiet", "compacting")[k % 2]
            if phase == "compacting":
                churn.enable()
            r0, bt0 = sched.stats.requests, sched.stats.batches
            s0, l0 = dict(churn.swaps), lane_counts()
            tenant, which, lat_ms, results, w = open_loop(
                sched, items, rate, c["seed"] + k // 2, c["block_s"])
            if phase == "compacting":
                churn.disable()
            coal[phase][0] += sched.stats.requests - r0
            coal[phase][1] += sched.stats.batches - bt0
            wall[phase] += w
            for t in swaps[phase]:
                swaps[phase][t] += churn.swaps[t] - s0[t]
            for key, n in lane_counts().items():
                lanes[phase][key] = lanes[phase].get(key, 0) + n - l0.get(
                    key, 0)
            for t in (0, 1):
                lat[(t, phase)].append(lat_ms[tenant == t])
            if phase != "quiet":
                continue
            for i, (t, j) in enumerate(zip(tenant, which)):
                if not row_equal(results[i], row_of(direct[t], j)):
                    fail(f"sched: quiet request {i} ({('main', 'shard')[t]} "
                         f"item {j}) differs from the direct batch's row")
                quiet_checked += 1
                if t == 0:
                    hits += int(results[i][0][0] == targets[0][j])
                    rows += 1
        if churn.errors:
            fail(f"sched: the churn failed: {churn.errors[0]!r}")
        recall1 = hits / max(rows, 1)
        print(f"[sched] {quiet_checked} quiet answers equal the direct "
              f"batches' rows bit for bit; recall@1 (planted, main) "
              f"{recall1:.4f} over {rows}")
        if recall1 < RECALL1_MIN:
            fail(f"sched: recall@1 {recall1} below {RECALL1_MIN}")
        p99 = {}
        for t, name in ((0, "main"), (1, "shard")):
            for phase in ("quiet", "compacting"):
                x = np.concatenate(lat[(t, phase)])
                p99[(t, phase)] = pct(x, 99)
                print(f"[sched {name} {phase}] on {smi}: {len(x)} requests: "
                      f"p50 {pct(x, 50):.3f} ms, p99 {pct(x, 99):.3f} ms, "
                      f"p99.9 {pct(x, 99.9):.3f} ms, max {x.max():.3f} ms; "
                      f"goodput {len(x) / wall[phase]:.0f} req/s")
            print(f"[sched {name}] compacting / quiet p99 "
                  f"{p99[(t, 'compacting')] / p99[(t, 'quiet')]:.3f} (the "
                  f"reference's gate {c['gate']}, printed for comparison)")
        for phase in ("quiet", "compacting"):
            print(f"[sched {phase}] mean coalesced batch "
                  f"{coal[phase][0] / max(coal[phase][1], 1):.2f} over "
                  f"{coal[phase][1]} batches; swaps {swaps[phase]}; "
                  f"launches by lane {lanes[phase]}")
        if swaps["compacting"]["main"] < 1 or swaps["compacting"][
                "shard"] < 1:
            fail(f"sched: no swap ran in the compacting blocks: {swaps}")
        # 4,096 scheduled queries racing a compaction of a mutated store
        sched.insert(batches[0], tenant="main").result(timeout=120)
        sched.delete(np.arange(0, 2 * c["race_deletes"], 2),
                     tenant="main").result(timeout=120)
        pre = [np.concatenate(a) for a in zip(*[main_svc.query_arrays(
            queries[b], topk=TOPK) for b in range(nb)])]
        futs, swap = [], None
        for i in range(c["race"]):
            futs.append(sched.query(items[0][i], topk=TOPK, tenant="main"))
            if i == c["race"] // 8:
                swap = sched.compact("main")
        swap.result(timeout=120)
        raced = [f.result(timeout=120) for f in futs]
        post = [np.concatenate(a) for a in zip(*[main_svc.query_arrays(
            queries[b], topk=TOPK) for b in range(nb)])]
        n_pre = n_post = 0
        for i, r in enumerate(raced):
            ok = [row_equal(r, row_of(w, i)) for w in (pre, post)]
            if not any(ok):
                fail(f"sched: raced query {i} equals neither the pre- nor "
                     "the post-swap direct row")
            n_pre += ok[0]
            n_post += ok[1]
        print(f"[sched] race: {len(raced)} scheduled queries around a "
              f"compaction of a mutated store (+{c['insert']} items, "
              f"-{c['race_deletes']}): each equals the direct row on the pre-"
              f" ({n_pre}) or the post-swap store ({n_post}) bit for bit")
    finally:
        churn.stop()
        sched.close()
        gc.callbacks.remove(on_gc)
        gc.unfreeze()
    print(f"[sched] the interpreter's full collections during the phase: "
          f"{len(pauses)}, longest {max(pauses, default=0.0):.1f} ms (every "
          "thread stops for one)")
    torch.cuda.synchronize()
    counts = read_counts()
    by_lane = lane_counts()
    print(f"[sched] launches: {counts}")
    print(f"[sched] launches by lane: {by_lane}")
    check_counts(counts, "sched", ("cp_gram", "fused_query",
                                   "fused_query_sharded",
                                   "fused_query:sample:uniform",
                                   "fused_query:sample:weighted"))
    need = (f"cp_gram@{QUERY_LANE}", f"cp_gram@{INGEST_LANE}",
            f"fused_query@{QUERY_LANE}", f"fused_query_sharded@{QUERY_LANE}")
    if any(by_lane.get(k, 0) == 0 for k in need):
        fail(f"sched: a lane never launched its kernel: {by_lane}")
    if any(k.endswith(INGEST_LANE) and k.startswith("fused_query")
           for k in by_lane):
        fail("sched: K1 ran on the ingest lane")
    print(f"[sched] {time.perf_counter() - t_phase:.1f} s")
    del main_svc, shard_svc
    torch.cuda.empty_cache()


DURABLE = dict(rounds=8, after=4, deletes=256, batches=16, seed=61,
               no_snap=10 ** 9)
# benchmarks/durability.py's bench-ingest workload, and its gate
DURABLE_INGEST = dict(dims=(8, 8, 8), n=100_000, per_cluster=8, noise=0.15,
                      kind="cp-e2lsh", codes=4, tables=8, rank=2, width=16.0,
                      cap=64, max_deltas=20, insert=1024, delete=256,
                      rounds=8, batches=4, retries=2, seed=29,
                      shard_items=1 << 15, shards=2, gate=10.0)


def fs_of(path: str) -> str:
    """The filesystem type and mount point holding ``path`` (the longest
    mount point of /proc/self/mounts that contains it)."""
    real, best, kind = os.path.realpath(path), "", "unknown"
    with open("/proc/self/mounts") as f:
        for line in f:
            parts = line.split()
            mnt = parts[1].replace("\\040", " ")
            inside = real == mnt or real.startswith(mnt.rstrip("/") + "/")
            if inside and len(mnt) > len(best):
                best, kind = mnt, parts[2]
    return f"{kind} at {best}"


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, name))
               for root, _, names in os.walk(path) for name in names)


def recovery_line(svc) -> str:
    r = svc.last_recovery
    return (f"recovery {svc.stats.recovery_ms / 1e3:.3f} s (load "
            f"{r['load_s']:.3f} s, restore {r['install_s']:.3f} s, replay "
            f"{r['replay_s']:.3f} s of {r['records']} records, the WAL's "
            f"reopen {r['reopen_s']:.3f} s)")


def phase_durable_main(cell, corpus, qids, queries, main_mean) -> list:
    """[durable main]: ``DurableLSHService`` at [main]'s full width (its
    family, corpus and queries; ``snapshot_every`` out of reach), its
    snapshots and WAL under a ``tempfile.mkdtemp()`` directory removed at
    the end. 8 rounds of a 256-item delete (random live effective ids) and
    a planted batch, ``compact()`` (the epoch marker), 4 more rounds; then
    ``post_wal_append`` armed on the next delete, which commits and
    "crashes". A fresh service with the same family recovers from the
    directory. Fails unless 16 planted batches on the recovered store equal
    the crashed instance's answers bit for bit, recall@1 over the
    surviving targets is at least RECALL1_MIN, K3 and K1 launched on both
    services and no plain version ran. Prints the filesystem, whether
    ``O_DIRECT`` was taken, the build, snapshot 0's time and bytes, WAL ms
    a record, the recovery split, and the recovered store's batch mean
    beside [main]'s."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from repro_torch.core.lsh import make_family
    from repro_torch.serving.durability import (DurableLSHService,
                                                FaultInjector, InjectedCrash)
    c = DURABLE
    t_phase = time.perf_counter()
    smi = smi_line()
    n = corpus.leaves[0].shape[0]
    nb = c["batches"]
    tmp = tempfile.mkdtemp(prefix="durable_main_")
    try:
        fam = make_family(torch.Generator(device="cuda").manual_seed(1),
                          cell["kind"], cell["dims"],
                          num_codes=cell["codes"], num_tables=cell["tables"],
                          rank=cell["rank"], bucket_width=cell["width"],
                          device="cuda")
        inj = FaultInjector()
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        svc = DurableLSHService(fam, tmp, snapshot_every=c["no_snap"],
                                injector=inj).build(corpus)
        t_build = time.perf_counter() - t0
        snap0 = dir_bytes(os.path.join(tmp, "snap_000000000000"))
        print(f"[durable main] on {smi}: directory on {fs_of(tmp)}, "
              f"O_DIRECT {'taken' if svc.direct_io else 'refused'}; build "
              f"{t_build:.3f} s (the index {svc.stats.build_s:.3f} s, "
              f"snapshot 0 {svc.stats.snapshot_ms / 1e3:.3f} s, "
              f"{snap0 / 1e6:.1f} MB)")
        rng = np.random.default_rng(c["seed"])
        alive = np.ones(n, bool)

        def delete_round():
            live = np.flatnonzero(alive)
            eff = np.sort(rng.choice(live.size, size=c["deletes"],
                                     replace=False))
            try:
                svc.delete(eff)
            finally:               # a post-append crash applied it too
                alive[live[eff]] = False

        def targets(b):
            q = qids[b].cpu().numpy()
            return np.where(alive[q], np.cumsum(alive)[q] - 1, -1)

        for r in range(c["rounds"] + c["after"]):
            if r == c["rounds"]:
                svc.compact()
            delete_round()
            svc.query_arrays(queries[r], topk=TOPK)
        torch.cuda.synchronize()
        counts = read_counts()
        check_counts(counts, "durable main (live)", ("cp_gram",
                                                     "fused_query"))
        wal_rec = svc.stats.wal_ms / svc.stats.wal_appends
        inj.crash_at("post_wal_append")
        try:
            delete_round()
            fail("durable main: the armed post_wal_append never fired")
        except InjectedCrash:
            pass
        crashed = [svc.query_arrays(q, topk=TOPK) for q in queries[:nb]]
        tgts = [targets(b) for b in range(nb)]
        appends = svc.stats.wal_appends + 1
        svc.close()
        del svc
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        zero_counts()
        rec = DurableLSHService(fam, tmp,
                                snapshot_every=c["no_snap"]).recover()
        results, lat_ms = serve(rec, queries[:nb])
        torch.cuda.synchronize()
        counts = read_counts()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[durable main] {c['rounds'] + c['after'] + 1} deletes of "
          f"{c['deletes']} and a compact: {appends} WAL records, "
          f"{wal_rec:.3f} ms a record; {recovery_line(rec)}"
          f"; the directory removed: {not os.path.exists(tmp)}")
    print(f"[durable main] launches on the recovered service: "
          f"{({k: v for k, v in counts.items() if v})}")
    check_counts(counts, "durable main (recovered)", ("cp_gram",
                                                      "fused_query"))
    for b, (got, want) in enumerate(zip(results, crashed)):
        same_answers(got, want, f"durable main: recovered batch {b} "
                     "against the crashed instance's")
    hits1, n_q = check_results(results, tgts, rec.index.size)
    summary = latency_line("durable main", rec, lat_ms)
    print(f"[durable main] {nb} planted batches on the recovered store equal "
          f"the crashed instance's bit for bit; recall@1 (planted, "
          f"surviving) {hits1 / n_q:.4f} over {n_q}; batch mean "
          f"{summary['mean']:.3f} ms against [main]'s {main_mean:.3f} ms")
    if hits1 / n_q < RECALL1_MIN:
        fail(f"durable main: recall@1 {hits1 / n_q} below {RECALL1_MIN}")
    k1_err, k1_args = k1_compare(rec, queries[0], "durable main, recovered")
    k1_t = k1_times(rec, queries[:nb], k1_args, "K1 durable main")
    q_t, q_err, q_lib = query_hash_times(rec, queries[:nb])
    key, source, replaces = HASH_RECORDS["cp"]
    print(f"[durable main] {time.perf_counter() - t_phase:.1f} s")
    out = [record("fused_query[durable main]", *K1_SOURCE, counts,
                  "fused_query", k1_err, k1_t),
           dict(record(key + "[durable main query]", source, replaces,
                       counts, key, q_err, q_t), library_ms=q_lib)]
    del rec, k1_args
    torch.cuda.empty_cache()
    return out


def ingest_rounds(svc, inserts) -> list:
    """benchmarks/durability.py's cadence: a warm-up and ``rounds`` timed
    rounds of a 1,024-item insert (host items; the insert returns after
    its stream's sync) and a 256-item delete -> the timed inserts' wall
    times in us. The warm-up round's WAL appends are not counted."""
    import numpy as np
    c = DURABLE_INGEST
    rng = np.random.default_rng(7)
    times = []
    for r in range(c["rounds"] + 1):
        batch = inserts[r * c["insert"]:(r + 1) * c["insert"]]
        t0 = time.perf_counter()
        svc.insert(batch)
        t = (time.perf_counter() - t0) * 1e6
        svc.delete(rng.choice(svc.index.size, size=c["delete"],
                              replace=False))
        if r > 0:
            times.append(t)
        else:
            svc.stats.wal_ms, svc.stats.wal_appends = 0.0, 0
    return times


def phase_durable_ingest() -> list:
    """[durable ingest], benchmarks/durability.py's design in this script's
    code: a clustered dense (8, 8, 8) corpus of 100,000 items (8 a
    cluster, noise 0.15), cp-e2lsh K = 4, L = 8, rank 2, w = 16,
    ``bucket_cap`` 64, ``max_deltas`` 20; a warm-up and 8 timed rounds of
    1,024-item inserts and 256-item deletes through a plain ``LSHService``
    (WAL off), then through ``DurableLSHService`` (WAL on); a snapshot, 8
    more rounds, a crash and a recovery by a fresh service. Then one
    scheduler pass: ``pre_wal_append`` transient failures beyond
    ``ingest_retries`` degrade the tenant and its queries are shed;
    ``recover_namespace()`` brings it back and the next single query
    equals the direct batch's row. And at S = 2 over the first 2^15 items:
    two rounds, a crash after a delete's commit, a recovery. Fails unless
    the recovered answers on 4 planted batches equal the live durable
    service's bit for bit (S = 2: 2 batches), K1 <kDense, kDense> and K1s
    launched and no plain version ran. Prints insert items/s both ways,
    the overhead beside the reference's 10% gate (not enforced), WAL ms a
    record, the snapshot and the recovery."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from repro_torch.core.lsh import make_family
    from repro_torch.core.tensor_formats import as_batch
    from repro_torch.kernels import fused_query as fq
    from repro_torch.serving.durability import (DurableLSHService,
                                                FaultInjector, InjectedCrash,
                                                ServiceUnavailable,
                                                TransientIOError,
                                                latest_snapshot)
    from repro_torch.serving.lsh_service import LSHService
    from repro_torch.serving.scheduler import ServingScheduler
    c = DURABLE_INGEST
    t_phase = time.perf_counter()
    smi = smi_line()
    dims, b = c["dims"], c["insert"]
    gen = torch.Generator(device="cuda").manual_seed(c["seed"])
    n_clusters = max(c["n"] // c["per_cluster"], 1)
    centers = torch.randn((n_clusters,) + dims, generator=gen, device="cuda")
    corpus = (centers.repeat_interleave(c["per_cluster"], 0)[:c["n"]]
              + c["noise"] * torch.randn((c["n"],) + dims, generator=gen,
                                         device="cuda"))
    n_ins = (c["rounds"] + 1) * b
    # the inserts arrive from the host, as the reference's numpy batches
    inserts = (centers.repeat((n_ins // n_clusters + 1, 1, 1, 1))[:n_ins]
               + c["noise"] * torch.randn((n_ins,) + dims, generator=gen,
                                          device="cuda")).cpu()
    fam = make_family(gen, c["kind"], dims, num_codes=c["codes"],
                      num_tables=c["tables"], rank=c["rank"],
                      bucket_width=c["width"], device="cuda")
    kw = dict(metric="euclidean", bucket_cap=c["cap"],
              max_deltas=c["max_deltas"])
    plain = LSHService(fam, **kw).build(corpus)
    off_us = float(np.median(ingest_rounds(plain, inserts)))
    del plain
    torch.cuda.empty_cache()
    dense_k1 = "fused_query:" + k1_instance(fq.DENSE, fq.DENSE)
    tmp = tempfile.mkdtemp(prefix="durable_ingest_")
    sdir = tempfile.mkdtemp(prefix="durable_ingest_s2_")
    try:
        torch.cuda.synchronize()
        zero_counts()
        inj = FaultInjector()
        svc = DurableLSHService(fam, tmp, snapshot_every=DURABLE["no_snap"],
                                injector=inj, **kw).build(corpus)
        direct = svc.direct_io
        on_us = float(np.median(ingest_rounds(svc, inserts)))
        wal_rec = svc.stats.wal_ms / max(svc.stats.wal_appends, 1)
        t0, dump_ms = time.perf_counter(), svc.stats.snapshot_ms
        svc.snapshot()
        snap_ms = (time.perf_counter() - t0) * 1e3
        dump_ms = svc.stats.snapshot_ms - dump_ms
        snap_bytes = dir_bytes(os.path.join(
            tmp, f"snap_{latest_snapshot(tmp):012d}"))
        ingest_rounds(svc, inserts)           # the log suffix to replay
        inj.crash_at("post_wal_append")
        try:
            svc.delete(np.arange(0, 512, 2))
            fail("durable ingest: the armed post_wal_append never fired")
        except InjectedCrash:
            pass
        svc.close()
        eff = svc.index.effective_corpus().data
        qid = torch.randperm(eff.shape[0], generator=gen,
                             device="cuda")[:c["batches"] * 1024]
        batches = [eff[qid[i * 1024:(i + 1) * 1024]] + 0.02 * torch.randn(
            (1024,) + dims, generator=gen, device="cuda")
            for i in range(c["batches"])]
        live = [svc.query_arrays(q, topk=TOPK) for q in batches]
        del svc, eff
        torch.cuda.empty_cache()
        rinj = FaultInjector()
        rec = DurableLSHService(fam, tmp, snapshot_every=DURABLE["no_snap"],
                                injector=rinj, **kw).recover()
        rec_line = recovery_line(rec)
        got = [rec.query_arrays(q, topk=TOPK) for q in batches]
        for i, (g, w_) in enumerate(zip(got, live)):
            same_answers(g, w_, f"durable ingest: recovered batch {i} "
                         "against the live durable service's")
        # the scheduler: degrade on exhausted WAL retries, shed, recover
        with ServingScheduler({"ingest": rec}, max_batch=64, deadline_ms=2.0,
                              ingest_retries=c["retries"],
                              retry_backoff_ms=1.0) as sched:
            rinj.fail_transient("pre_wal_append", times=c["retries"] + 1)
            try:
                sched.insert(inserts[:b], tenant="ingest").result(
                    timeout=120)
                fail("durable ingest: an insert past its retries committed")
            except TransientIOError:
                pass
            if rec.health != "degraded":
                fail(f"durable ingest: health {rec.health!r} after the "
                     "retries ran out")
            try:
                sched.query(batches[0][0], tenant="ingest")
                fail("durable ingest: a degraded tenant's query was admitted")
            except ServiceUnavailable:
                shed = sched.stats.shed
            t0 = time.perf_counter()
            sched.recover_namespace("ingest").result(timeout=300)
            sched_ms = (time.perf_counter() - t0) * 1e3
            if rec.health != "serving":
                fail(f"durable ingest: health {rec.health!r} after "
                     "recover_namespace()")
            row = sched.query(batches[0][0], tenant="ingest",
                              topk=TOPK).result(timeout=120)
        want = rec.query_arrays(batches[0][:1], topk=TOPK)
        if not row_equal(row, row_of(want, 0)):
            fail("durable ingest: the scheduled query after the recovery "
                 "differs from the direct batch's row")
        # S = 2 over the first items: K1s on a recovered sharded store
        sub = corpus[:c["shard_items"]]
        sinj = FaultInjector()
        ssvc = DurableLSHService(fam, sdir, snapshot_every=DURABLE[
            "no_snap"], shards=c["shards"], injector=sinj, **kw).build(sub)
        srng = np.random.default_rng(11)
        for r in range(2):
            ssvc.insert(inserts[r * b:(r + 1) * b])
            ssvc.delete(srng.choice(ssvc.index.size, size=c["delete"],
                                    replace=False))
        sinj.crash_at("post_wal_append")
        try:
            ssvc.delete(np.arange(0, 64))
            fail("durable ingest S=2: the armed crash never fired")
        except InjectedCrash:
            pass
        ssvc.close()
        sq = [sub[torch.randint(0, sub.shape[0], (1024,), generator=gen,
                                device="cuda")] + 0.02 for _ in range(2)]
        slive = [ssvc.query_arrays(q, topk=TOPK) for q in sq]
        del ssvc
        srec = DurableLSHService(fam, sdir, snapshot_every=DURABLE[
            "no_snap"], shards=c["shards"], **kw).recover()
        for i, q in enumerate(sq):
            same_answers(srec.query_arrays(q, topk=TOPK), slive[i],
                         f"durable ingest S=2: recovered batch {i}")
        torch.cuda.synchronize()
        counts = read_counts()
        fs = fs_of(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(sdir, ignore_errors=True)
    off_ips, on_ips = b / (off_us / 1e6), b / (on_us / 1e6)
    overhead = (on_us - off_us) / off_us * 100.0
    print(f"[durable ingest] on {smi}: directory on {fs}, O_DIRECT "
          f"{'taken' if direct else 'refused'}; n={c['n']} dense "
          f"{dims}, {c['kind']} K={c['codes']} L={c['tables']}, bucket_cap "
          f"{c['cap']}, max_deltas {c['max_deltas']}")
    print(f"[durable ingest] insert of {b} items (median of {c['rounds']} "
          f"rounds): WAL off {off_us / 1e3:.3f} ms ({off_ips:.0f} items/s), "
          f"WAL on {on_us / 1e3:.3f} ms ({on_ips:.0f} items/s): overhead "
          f"{overhead:+.1f}% (the reference's gate {c['gate']:.0f}%, printed "
          f"for comparison); {wal_rec:.3f} ms a WAL record")
    print(f"[durable ingest] snapshot {snap_ms:.1f} ms (the store's dump "
          f"{dump_ms:.1f} ms, {snap_bytes / 1e6:.1f} MB; the rest the WAL's "
          f"rotation); crash after a committed delete; a fresh service's "
          f"{rec_line}; {c['batches']} planted batches equal the live "
          f"service's bit for bit")
    print(f"[durable ingest] scheduler: {c['retries'] + 1} failed WAL "
          f"appends degraded the tenant, {shed} request shed, "
          f"recover_namespace() {sched_ms:.1f} ms ({rec.stats.recoveries} "
          f"recoveries), then a single query equal to the direct row; S=2 "
          f"over {c['shard_items']} items recovered bit for bit; the "
          f"directories removed: "
          f"{not (os.path.exists(tmp) or os.path.exists(sdir))}")
    print(f"[durable ingest] launches: "
          f"{({k: v for k, v in counts.items() if v})}")
    check_counts(counts, "durable ingest", ("fused_query", dense_k1,
                                            "fused_query_sharded"))
    k1_err, k1_args = k1_compare(rec, as_batch(batches[0]),
                                 "durable ingest, recovered")
    k1_t = k1_times(rec, [as_batch(q) for q in batches], k1_args,
                    "K1-dense durable ingest")
    s_err, s_args = k1_compare(srec, as_batch(sq[0]),
                               "durable ingest S=2, recovered")
    s_t = k1_times(srec, [as_batch(q) for q in sq], s_args,
                   "K1s-dense durable ingest S=2")
    print(f"[durable ingest] {time.perf_counter() - t_phase:.1f} s")
    out = [record("fused_query[durable ingest]", *K1_SOURCE, counts,
                  "fused_query", k1_err, k1_t),
           record("fused_query_sharded[durable ingest S=2]", *K1S_SOURCE,
                  counts, "fused_query_sharded", s_err, s_t)]
    del rec, srec, k1_args, s_args
    torch.cuda.empty_cache()
    return out


LM_PHI3 = dict(arch="phi3-mini-3.8b", batch=2, prompt=4096, steps=32,
               max_len=4128, decode_check=3, seed=41, data_seed=43)
# [lm archs]: every other arch at its published widths; depth cut to fit
# one card and the phase's time (None: full depth). llama4's 2 layers are
# one dense / MoE pair, zamba2's 9 one group of 9 Mamba2 layers and its
# shared attention block.
LM_ARCHS = dict(batch=2, prompt=512, decode=4, seed=47, data_seed=53,
                depth={"stablelm-3b": 2, "gemma-7b": 2,
                       "mistral-large-123b": 2, "zamba2-7b": 9,
                       "pixtral-12b": 2, "whisper-tiny": None,
                       "mixtral-8x22b": 2, "llama4-maverick-400b-a17b": 2,
                       "mamba2-130m": None},
                # pixtral's 1,024 vision tokens fit in its prompt
                prompt_of={"pixtral-12b": 1536})
BF16_FLOPS = 989e12            # H100 SXM dense bf16, NVIDIA data sheet
# decode against forward (the reference's tests/test_models_smoke.py TOL):
# MoE capacity drops depend on the batch's token count
LM_TOL = {"mixtral-8x22b": 0.12, "llama4-maverick-400b-a17b": 0.12}
SRP_NEAR_UNITS = 32.0          # > the 30 roundings of one CP-SRP value


def nbytes(tree) -> int:
    """Bytes of the tensors in a params tree or a cache (dicts, tuples)."""
    import torch
    if isinstance(tree, dict):
        return sum(nbytes(v) for v in tree.values())
    if isinstance(tree, tuple):
        return sum(nbytes(v) for v in tree)
    return tree.numel() * tree.element_size() if isinstance(
        tree, torch.Tensor) else 0


def events_ms(fn):
    """(result, CUDA-event ms) of one call."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def lm_bounds(cfg, tokens: int, read_bytes: float) -> tuple:
    """(prefill bound ms, decode-step bound ms): 2 * active params *
    tokens FLOPs at bf16's dense peak; a decode step's weight and cache
    bytes at the HBM rate."""
    from repro_torch.models import params as P
    flops = 2.0 * P.count_active_params(cfg) * tokens
    return flops / BF16_FLOPS * 1e3, read_bytes / HBM_BYTES_PER_S * 1e3


def decode_weight_bytes(cfg, batch: int) -> float:
    """Weight bytes a decode step reads: every leaf, an MoE layer's
    experts only as many as the batch's tokens can pick."""
    from repro_torch.models import params as P
    total = P.count_params(cfg)
    if cfg.n_experts:
        specs = P.param_specs(cfg)["blocks"]
        experts = sum(math.prod(s.shape) for k, s in specs.items()
                      if k.startswith("we_"))
        used = min(cfg.n_experts, batch * cfg.top_k) / cfg.n_experts
        total -= experts * (1.0 - used)
    return total * 2.0 if cfg.dtype == "bfloat16" else total * 4.0


def top2_decided(cfg, logits, tol: float):
    """Per row: whether the masked top-2 gap exceeds ``tol``."""
    import torch
    from repro_torch.serving import engine
    top = torch.topk(engine.mask_pad(cfg, logits.float()), 2, dim=-1).values
    return (top[..., 0] - top[..., 1]) > tol


def srp_code_check(tag, cfg, proj, keys, codes) -> tuple:
    """Codes computed on the card against a float64 evaluation of the same
    expression on the same (bfloat16) keys: equal except where the value
    lies within SRP_NEAR_UNITS units of its terms' absolute sum of 0."""
    import torch
    from repro_torch.models import lsh_attention as LSH
    exact = LSH.srp_values(keys.double(), proj["f1"], proj["f2"])
    mag = LSH.srp_values(keys.double().abs(), proj["f1"].abs(),
                         proj["f2"].abs())
    near = (exact.abs() <= SRP_NEAR_UNITS * U * mag) & (mag > 0)
    weights = 1 << torch.arange(exact.shape[-1], device=keys.device)
    want = ((exact > 0).long() * weights).sum(-1)
    differ = codes.long() != want
    bad = differ & ~near.any(-1)
    if bool(bad.any()):
        fail(f"[{tag}] {int(bad.sum())} layer-0 key codes differ from the "
             f"float64 evaluation away from the boundary")
    return int(differ.sum()), int(near.any(-1).sum()), codes.numel()


def attended_candidates(cfg, params, cache, tok, cur: int) -> float:
    """Mean over (row, head) of the candidates layer 0's decode at ``cur``
    attends: min(C, |recent or same bucket|) of the cached positions and
    its own (called before the step writes its slot)."""
    import torch
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    from repro_torch.models import lsh_attention as LSH
    lp = {k: v[0] for k, v in params["blocks"].items()}
    with torch.inference_mode():
        x = L.embed_tokens(cfg, params, tok)
        pos = torch.full(tok.shape, cur, dtype=torch.int32, device=tok.device)
        q, _, _ = A.qkv_proj(cfg, lp, L.norm(cfg, x, lp["ln"]), pos)
        qc = LSH.srp_bucket_codes(q, params["lsh_proj"]["f1"],
                                  params["lsh_proj"]["f2"])[:, 0]
        cpos = cache.pos.clone()
        cpos[cur % cpos.shape[0]] = cur     # the step's own slot (R9)
        valid = (cpos >= 0) & (cpos <= cur)
        match = (cache.layers.codes[0] == qc[:, None, :]) & valid[None, :,
                                                                  None]
        recent = ((cur - cpos) < cfg.lsh_recent) & valid
        n = (match | recent[None, :, None]).sum(dim=1).float()
        w = cache.layers.k.shape[2]
        return float(torch.clamp(n, max=min(cfg.lsh_candidates, w)).mean())


def phase_lm_phi3_lsh(smi: str) -> dict:
    """[lm phi3-lsh]: phi3-mini-3.8b with the paper's CP-SRP LSH attention
    (``get_config(arch, "long")``) at full width and depth, bf16, random
    weights from a seeded generator on the card: ``batch_at``'s 2 prompts
    of 4,096 tokens, a timed prefill and 31 timed decode steps through the
    engine's step functions (greedy), then ``greedy_generate`` for 32
    steps, which must give the same tokens up to a near tie, and once more
    under torch.profiler (the device's busy share, the top kernels). Fails on a
    non-finite logit, an id past the vocabulary or a layer-0 key code
    that differs from its float64 evaluation off the boundary. Returns
    what [lm phi3] reuses."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic
    from repro_torch.models import params as P
    from repro_torch.serving import engine
    c = LM_PHI3
    cfg = get_config(c["arch"], "long")
    b, s, steps, max_len = c["batch"], c["prompt"], c["steps"], c["max_len"]
    gen = torch.Generator(device="cuda").manual_seed(c["seed"])
    (params, init_ms) = events_ms(lambda: P.init_params(cfg, gen,
                                                        device="cuda"))
    pbytes = nbytes(params)
    batch = synthetic.batch_at(
        synthetic.DataConfig(batch_size=b, seq_len=s, seed=c["data_seed"]),
        cfg, 0, device="cuda")
    print(f"[lm phi3-lsh] on {smi}: {cfg.name}, {cfg.n_layers} layers x "
          f"d_model {cfg.d_model}, {cfg.n_heads} heads of {cfg.hd} (CP modes "
          f"{P._factor_head_dim(cfg.hd)}), d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size} padded to {cfg.padded_vocab}, {cfg.dtype}; LSH "
          f"{cfg.lsh_num_hashes} hashes rank {cfg.lsh_rank}, chunk "
          f"{cfg.lsh_chunk}, {cfg.lsh_candidates} candidates, recency "
          f"{cfg.lsh_recent}; {P.count_params(cfg)} parameters, {pbytes} "
          f"bytes, drawn in {init_ms:.1f} ms; B={b} prompts of {s} tokens, "
          f"{steps} greedy steps, max_len {max_len}")
    prefill_step = engine.make_prefill_step(cfg, max_len)
    serve = engine.make_serve_step(cfg)
    torch.cuda.synchronize()
    zero_counts()
    prefill_step(params, batch)                 # warm-up: cuBLAS plans
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (last, cache), prefill_ms = events_ms(lambda: prefill_step(params,
                                                               batch))
    proj = params["lsh_proj"]
    differ, near, n_codes = srp_code_check(
        "lm phi3-lsh", cfg, proj, cache.layers.k[0][:, :s],
        cache.layers.codes[0][:, :s])
    tok = torch.argmax(engine.mask_pad(cfg, last), dim=-1)[:, None].to(
        torch.int32)
    logits_all, toks, step_ms = [last], [tok], []
    for i in range(steps - 1):
        cur = s + i
        if i == steps - 2:
            attended = attended_candidates(cfg, params, cache, tok, cur)
        (logits, cache), ms = events_ms(lambda: serve(params, cache, tok,
                                                      cur))
        step_ms.append(ms)
        logits_all.append(logits)
        tok = torch.argmax(engine.mask_pad(cfg, logits), dim=-1)[:, None].to(
            torch.int32)
        toks.append(tok)
    peak = torch.cuda.max_memory_allocated()
    kv_bytes = nbytes(cache.layers)
    del cache
    manual = torch.cat(toks, dim=1)
    finite = all(bool(torch.isfinite(x.float()).all()) for x in logits_all)
    if not finite:
        fail("[lm phi3-lsh] a logit is not finite")
    if bool((manual >= cfg.vocab_size).any()) or bool((manual < 0).any()):
        fail("[lm phi3-lsh] a generated id lies outside the vocabulary")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    generated = engine.greedy_generate(cfg, params, batch, steps=steps,
                                       max_len=max_len)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts = read_counts()
    profile_calls("lm phi3-lsh profile", f"greedy_generate ({steps} steps)",
                  [lambda: engine.greedy_generate(cfg, params, batch,
                                                  steps=steps,
                                                  max_len=max_len)])
    if bool((generated >= cfg.vocab_size).any()):
        fail("[lm phi3-lsh] greedy_generate gave an id past the vocabulary")
    scale = max(float(logits_all[0].float().abs().max()), 1.0)
    for row in range(b):
        for j in range(steps):
            if not bool(top2_decided(cfg, logits_all[j][row],
                                     1e-2 * scale)):
                break
            if int(generated[row, j]) != int(manual[row, j]):
                fail(f"[lm phi3-lsh] greedy_generate's token {j} of row "
                     f"{row} differs from the timed loop's")
    decode_ms = statistics.median(step_ms)
    cand = min(cfg.lsh_candidates, max_len)
    # a decode step reads the weights, every layer's codes and the C
    # candidates' K and V of each (row, head)
    step_bytes = (decode_weight_bytes(cfg, b)
                  + cfg.n_layers * b * max_len * cfg.n_kv_heads * 4
                  + 2 * cfg.n_layers * b * cfg.n_heads * cand * cfg.hd * 2)
    pre_bound, dec_bound = lm_bounds(cfg, b * s, step_bytes)
    print(f"[lm phi3-lsh] on {smi}: prefill {prefill_ms:.2f} ms for {b}x{s} "
          f"tokens (bound {pre_bound:.2f} ms: 2 x active params x tokens at "
          f"989 TFLOP/s bf16), decode {decode_ms:.3f} ms a token step "
          f"(median of steps 2-{steps}; min {min(step_ms):.3f}, max "
          f"{max(step_ms):.3f}; bound {dec_bound:.3f} ms: {step_bytes:.4g} "
          f"bytes of weights, codes and candidates at 3.35 TB/s), "
          f"{b * 1e3 / decode_ms:.1f} tokens/s; peak memory {peak} bytes "
          f"(parameters {pbytes}, LSH cache {kv_bytes}); greedy_generate "
          f"{steps} steps in {gen_s:.2f} s (host clock), tokens equal to the "
          f"timed loop's; a decode step selects {cand} candidates of "
          f"{max_len} slots per (row, head) and layer 0's last step "
          f"attends {attended:.1f} of them (same bucket or among the "
          f"{cfg.lsh_recent} most recent); layer-0 key codes against "
          f"float64: {differ} of {n_codes} differ, {near} within the "
          f"rounding bound of 0; port kernel launches on the LM path: "
          f"{ {k: v for k, v in counts.items() if v} }")
    print(f"[lm phi3-lsh] first tokens: {manual[:, :8].tolist()}")
    return dict(params=params, batch=batch, last=last.float())


def phase_lm_phi3(smi: str, lsh: dict) -> None:
    """[lm phi3]: the same weights without ``lsh_proj`` under
    ``get_config("phi3-mini-3.8b")`` (exact attention), the same prompts:
    prefill 4,093 tokens and decode 3 (each step attending its own token,
    R9), each held against ``forward`` over the 4,096 at the reference's
    tolerance 0.05 of the largest |logit|;
    and the relative gap between [lm phi3-lsh]'s next-token logits and the
    exact ones at the last prompt position (printed, not a check)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving import engine
    c = LM_PHI3
    cfg = get_config(c["arch"])
    params = {k: v for k, v in lsh["params"].items() if k != "lsh_proj"}
    batch = lsh["batch"]
    b, s, n = c["batch"], c["prompt"], c["decode_check"]
    s0 = s - n
    prefill_step = engine.make_prefill_step(cfg, s)
    serve = engine.make_serve_step(cfg)
    pre = dict(batch, tokens=batch["tokens"][:, :s0])
    torch.cuda.synchronize()
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    prefill_step(params, pre)                    # warm-up
    (last, cache), prefill_ms = events_ms(lambda: prefill_step(params, pre))
    outs, step_ms = [last.float()], []
    for cur in range(s0, s):
        (logits, cache), ms = events_ms(
            lambda: serve(params, cache, batch["tokens"][:, cur:cur + 1],
                          cur))
        outs.append(logits.float())
        step_ms.append(ms)
    kv_bytes = nbytes(cache.layers)
    del cache
    with torch.inference_mode():
        full, fwd_ms = events_ms(lambda: T.forward(cfg, params, batch)[0])
    peak = torch.cuda.max_memory_allocated()
    counts = read_counts()
    scale = max(float(full.float().abs().max()), 1.0)
    errs = [float((o - full[:, s0 - 1 + i].float()).abs().max())
            for i, o in enumerate(outs)]
    if not all(math.isfinite(e) for e in errs) or max(errs) >= 0.05 * scale:
        fail(f"[lm phi3] decode against forward: errors {errs} against "
             f"0.05 x {scale:.4f}")
    exact_last = full[:, s - 1].float()
    v = cfg.vocab_size
    gap = (lsh["last"][:, :v] - exact_last[:, :v]).norm(dim=-1) / \
        exact_last[:, :v].norm(dim=-1)
    same = (lsh["last"][:, :v].argmax(-1) == exact_last[:, :v].argmax(-1))
    decode_ms = statistics.median(step_ms)
    step_bytes = decode_weight_bytes(cfg, b) + kv_bytes
    pre_bound, dec_bound = lm_bounds(cfg, b * s0, step_bytes)
    print(f"[lm phi3] on {smi}: exact attention, same weights and prompts: "
          f"prefill {prefill_ms:.2f} ms for {b}x{s0} tokens (bound "
          f"{pre_bound:.2f} ms), decode {decode_ms:.3f} ms a token step "
          f"(median of {n}; bound {dec_bound:.3f} ms: weights and the "
          f"{kv_bytes}-byte KV cache at 3.35 TB/s), "
          f"{b * 1e3 / decode_ms:.1f} tokens/s, forward over {b}x{s} "
          f"{fwd_ms:.2f} ms; peak memory {peak} bytes; decode against "
          f"forward: max |error| {max(errs):.5f} over the prefill's last "
          f"and {n} decode logits, limit 0.05 x max |logit| "
          f"{scale:.4f} = {0.05 * scale:.4f}; port kernel launches: "
          f"{ {k: x for k, x in counts.items() if x} }")
    print(f"[lm phi3] LSH against exact attention at the last prompt "
          f"position: relative L2 gap of the next-token logits "
          f"{[round(float(g), 5) for g in gap]} per row, same argmax "
          f"{same.tolist()} (the paper's approximation; printed, not "
          f"checked)")


class MoEDrops:
    """Records, for every ``moe_block`` call of a pass, which tokens had
    an assignment dropped by capacity (``moe.route``'s ``keep``), by
    wrapping the transformer's ``moe_block``."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.models import layers as L
        from repro_torch.models import moe
        from repro_torch.models import transformer as T
        self._orig = T.moe_block

        def wrapped(cfg, lp, x):
            b, s, d = x.shape
            r = moe.route(cfg, lp, L.norm(cfg, x, lp["mlp_ln"]).reshape(
                b * s, d))
            self.calls.append(
                (~r.keep).reshape(b * s, cfg.top_k).any(-1).reshape(b, s))
            return self._orig(cfg, lp, x)
        T.moe_block = wrapped
        return self

    def __exit__(self, *exc):
        from repro_torch.models import transformer as T
        T.moe_block = self._orig

    def dropped(self, b: int, s: int):
        """(B, S) bool: any layer's call over (b, s) tokens dropped one."""
        import torch
        out = None
        for d in self.calls:
            if tuple(d.shape) == (b, s):
                out = d if out is None else out | d
        return out if out is not None else torch.zeros(
            (b, s), dtype=torch.bool)


def phase_lm_archs(smi: str) -> None:
    """[lm archs]: each other arch at its published widths, depth cut
    (LM_ARCHS), bf16 random weights: B = 2 prompts of 512 tokens (pixtral
    1,536, whisper with its 1,500 encoder frames), forward over the
    prompt, prefill of all but its last 4 tokens and 4 teacher-forced
    decode steps, each held against the forward logits at the reference's
    TOL (0.12 of the largest |logit| for mixtral and llama4, else 0.05);
    for the MoE archs at the positions where neither the forward nor the
    prefill dropped an assignment by capacity (counted and printed). Each
    arch's prefill and decode times, bounds and peak memory."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic
    from repro_torch.models import params as P
    from repro_torch.models import transformer as T
    from repro_torch.serving import engine
    c = LM_ARCHS
    b, n = c["batch"], c["decode"]
    zero_counts()
    for i, (arch, depth) in enumerate(c["depth"].items()):
        full = get_config(arch)
        cfg = full if depth is None else dataclasses.replace(
            full, n_layers=depth).validate()
        s = c["prompt_of"].get(arch, c["prompt"])
        s0 = s - n
        gen = torch.Generator(device="cuda").manual_seed(c["seed"] + i)
        torch.cuda.reset_peak_memory_stats()
        params = P.init_params(cfg, gen, device="cuda")
        pbytes = nbytes(params)
        batch = synthetic.batch_at(
            synthetic.DataConfig(batch_size=b, seq_len=s,
                                 seed=c["data_seed"]), cfg, 0,
            device="cuda")
        pre = dict(batch, tokens=batch["tokens"][:, :s0])
        prefill_step = engine.make_prefill_step(cfg, s)
        serve = engine.make_serve_step(cfg)
        drops = MoEDrops()
        with drops:
            with torch.inference_mode():
                logits, fwd_ms = events_ms(
                    lambda: T.forward(cfg, params, batch)[0])
            (last, cache), prefill_ms = events_ms(
                lambda: prefill_step(params, pre))
            outs, step_ms = [last.float()], []
            for cur in range(s0, s):
                (step, cache), ms = events_ms(
                    lambda: serve(params, cache,
                                  batch["tokens"][:, cur:cur + 1], cur))
                outs.append(step.float())
                step_ms.append(ms)
        peak = torch.cuda.max_memory_allocated()
        kv_bytes = nbytes(cache)
        del cache
        if not all(bool(torch.isfinite(o).all()) for o in outs):
            fail(f"[lm archs] {arch}: a decode logit is not finite")
        if drops.dropped(b, 1).any():
            fail(f"[lm archs] {arch}: a decode step dropped an assignment")
        skip = drops.dropped(b, s).clone()
        skip[:, s0 - 1] |= drops.dropped(b, s0)[:, s0 - 1]
        scale = max(float(logits.float().abs().max()), 1.0)
        tol = LM_TOL.get(arch, 0.05)
        held, worst, worst_skipped = 0, 0.0, 0.0
        for j, o in enumerate(outs):
            p = s0 - 1 + j
            err = (o - logits[:, p].float()).abs().amax(dim=-1)
            keep = ~skip[:, p].to(err.device)
            held += int(keep.sum())
            if bool(keep.any()):
                worst = max(worst, float(err[keep].max()))
            if bool((~keep).any()):
                worst_skipped = max(worst_skipped, float(err[~keep].max()))
        if held == 0 or not math.isfinite(worst) or worst >= tol * scale:
            fail(f"[lm archs] {arch}: decode against forward max |error| "
                 f"{worst:.5f} over {held} (row, position) pairs against "
                 f"{tol} x {scale:.4f}")
        decode_ms = statistics.median(step_ms)
        pre_bound, dec_bound = lm_bounds(
            cfg, b * s0, decode_weight_bytes(cfg, b) + kv_bytes)
        dropped = f"; {(n + 1) * b - held} of {(n + 1) * b} compared " \
            f"(row, position) pairs dropped by capacity, their max |error| " \
            f"{worst_skipped:.5f}" if cfg.n_experts else ""
        print(f"[lm archs] {arch} on {smi}: {cfg.n_layers} of "
              f"{full.n_layers} layers, d_model {cfg.d_model}, "
              f"{P.count_params(cfg)} parameters ({pbytes} bytes), "
              f"B={b} x {s} tokens: forward {fwd_ms:.2f} ms, prefill "
              f"{prefill_ms:.2f} ms for {b}x{s0} (bound {pre_bound:.3f} ms), "
              f"decode {decode_ms:.3f} ms a token step (median of {n}; "
              f"bound {dec_bound:.4f} ms), peak memory {peak} bytes; decode "
              f"against forward max |error| {worst:.5f} over {held} (row, "
              f"position) pairs, limit {tol} x {scale:.4f}{dropped}")
        del params, batch, pre, logits, outs, last
        torch.cuda.empty_cache()
    counts = read_counts()
    print(f"[lm archs] port kernel launches on the LM path: "
          f"{ {k: x for k, x in counts.items() if x} }")


TRAIN = dict(
    # [train mamba2]: the launcher's defaults, 30 steps, a checkpoint every
    # 10, a failure injected at 17 (resume from 10)
    mamba2=["--arch", "mamba2-130m", "--steps", "30", "--ckpt-every", "10",
            "--seed", "3"],
    fail_at=17, loss_window=5,
    compress=["--arch", "mamba2-130m", "--steps", "10", "--compress",
              "--seed", "5"],
    phi3=dict(arch="phi3-mini-3.8b", batch=2, seq=2048, steps=4, seed=7),
    phi3_lsh=dict(arch="phi3-mini-3.8b", batch=1, seq=4096, steps=2, seed=9),
    grads=dict(layers=2, batch=2, seq=256, seed=11, eps=1.0),
)
# bf16 products of a train step with remat "nothing": the forward twice
# and the backward's two products a forward product, 8 N T FLOPs
FP32_ATTN_FLOPS = 67e12


def train_ms(inner=None):
    """Timers for a train step: (wrap_step, install, restore, records).
    Each step's CUDA events bracket the step and the optimizer's
    ``update`` (or ``inner``, which calls it), so forward+backward is the
    step less the update; ``install`` puts the timed update in place of
    ``optimizer.update``, ``restore`` takes it out."""
    import torch
    from repro_torch.training import optimizer as O
    records = []
    orig_update = O.update
    call = inner or orig_update

    def timed_update(c, grads, state, params):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = call(c, grads, state, params)
        ev[1].record()
        records[-1]["update"] = ev
        return out

    def wrap(step_fn):
        def step(state, batch):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            records.append({})
            ev[0].record()
            out = step_fn(state, batch)
            ev[1].record()
            records[-1]["step"] = ev
            return out
        return step

    def install():
        O.update = timed_update

    def restore():
        O.update = orig_update

    return wrap, install, restore, records


def split_ms(records, skip: int = 0):
    """(step ms, update ms) means over the records after ``skip``."""
    import torch
    torch.cuda.synchronize()
    rs = records[skip:]
    step = [r["step"][0].elapsed_time(r["step"][1]) for r in rs]
    upd = [r["update"][0].elapsed_time(r["update"][1]) for r in rs]
    return statistics.mean(step), statistics.mean(upd)


def states_equal(a, b) -> tuple[int, int]:
    """(leaves compared, leaves differing) of two train states."""
    from repro_torch.training import checkpoint as ckpt_lib
    fa, fb = ckpt_lib._flatten(a), ckpt_lib._flatten(b)
    if list(fa) != list(fb):
        fail(f"[train] final states differ in structure")
    bad = [k for k in fa if not bool((fa[k] == fb[k]).all())
           or fa[k].dtype != fb[k].dtype]
    return len(fa), len(bad)


class TimedCheckpoints:
    """While active, times ``checkpoint.save`` (the synchronous calls:
    ``run_training``'s final save) and ``restore_latest`` (the resume),
    host clock, the card synchronized after a restore."""

    def __enter__(self):
        import torch
        from repro_torch.training import checkpoint as ckpt_lib
        self.save_s = self.restore_s = 0.0
        self._orig = (ckpt_lib.save, ckpt_lib.restore_latest)
        save, restore = self._orig

        def timed_save(directory, step, tree, meta=None, async_=False):
            t0 = time.perf_counter()
            out = save(directory, step, tree, meta=meta, async_=async_)
            if not async_:
                self.save_s = time.perf_counter() - t0
            return out

        def timed_restore(directory, like, device=None):
            t0 = time.perf_counter()
            out = restore(directory, like, device=device)
            torch.cuda.synchronize()
            self.restore_s = time.perf_counter() - t0
            return out
        ckpt_lib.save, ckpt_lib.restore_latest = timed_save, timed_restore
        return self

    def __exit__(self, *exc):
        from repro_torch.training import checkpoint as ckpt_lib
        ckpt_lib.save, ckpt_lib.restore_latest = self._orig


def phase_train_mamba2(smi: str) -> None:
    """[train mamba2]: the launcher's run with a failure and a resume
    against an uninterrupted one (bit-equal), the loss falling, ms a
    step, a checkpoint's save and resume."""
    import shutil
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic
    from repro_torch.launch import train as launch
    from repro_torch.models import params as P
    from repro_torch.training import checkpoint as ckpt_lib
    from repro_torch.training import optimizer as O
    from repro_torch.training import train_loop as TL
    from repro_torch.training.fault_tolerance import InjectedFailure
    c = TRAIN
    cfg = get_config("mamba2-130m")
    args = launch.parser().parse_args(c["mamba2"])
    dirs = [tempfile.mkdtemp(prefix="train_mamba2_") for _ in range(2)]
    try:
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        try:
            launch.main(c["mamba2"] + ["--ckpt-dir", dirs[0], "--fail-at",
                                       str(c["fail_at"])])
            fail("[train mamba2] --fail-at did not raise InjectedFailure")
        except InjectedFailure:
            pass
        if ckpt_lib.latest_step(dirs[0]) != 10:
            fail(f"[train mamba2] latest checkpoint after the failure is "
                 f"{ckpt_lib.latest_step(dirs[0])}, not 10")
        timed = TimedCheckpoints()
        with timed:
            resumed, hist_a = launch.train(c["mamba2"] + ["--ckpt-dir",
                                                          dirs[0]])
        if len(hist_a) != args.steps - 10:
            fail(f"[train mamba2] the resumed run took {len(hist_a)} steps, "
                 f"not {args.steps - 10}")
        wrap, install, restore, records = train_ms()
        install()
        try:
            full, hist = launch.train(c["mamba2"] + ["--ckpt-dir", dirs[1]],
                                      wrap_step=wrap)
        finally:
            restore()
        peak = torch.cuda.max_memory_allocated()
        step_ms, upd_ms = split_ms(records, skip=1)
        n, bad = states_equal(resumed, full)
        if bad:
            fail(f"[train mamba2] the resumed final state differs from the "
                 f"uninterrupted one in {bad} of {n} leaves")
        losses = [h["loss"] for h in hist]
        w = c["loss_window"]
        first, last = statistics.mean(losses[:w]), statistics.mean(losses[-w:])
        if not all(math.isfinite(x) for x in losses) or not last < first:
            fail(f"[train mamba2] loss did not fall: first {w} mean "
                 f"{first:.4f}, last {w} {last:.4f}")
        final = os.path.join(dirs[0], f"step_{args.steps:08d}")
        size = sum(os.path.getsize(os.path.join(final, f))
                   for f in os.listdir(final))
        save_s, resume_s = timed.save_s, timed.restore_s
        check_counts(read_counts(), "train mamba2", ())
        tc = TL.TrainConfig(adamw=O.AdamWConfig(
            peak_lr=args.lr, warmup_steps=args.warmup,
            decay_steps=max(args.steps, 10)))
        batch = synthetic.batch_at(synthetic.DataConfig(
            batch_size=args.batch, seq_len=args.seq, seed=args.seed), cfg,
            args.steps, device="cuda")
        step_fn = TL.make_train_step(cfg, tc)
        profile_calls("train mamba2 profile", "one train step",
                      [lambda: step_fn(full, batch)], cpu_top=8)
        tokens = args.batch * args.seq
        print(f"[train mamba2] on {smi}: {cfg.name} {cfg.n_layers} x "
              f"{cfg.d_model}, {P.count_params(cfg)} parameters, "
              f"{cfg.dtype}, remat {cfg.remat_policy!r}; B={args.batch} x "
              f"{args.seq} tokens, lr {args.lr}, warmup {args.warmup}, "
              f"{args.steps} steps; failure at {c['fail_at']}, resumed "
              f"from step 10: final state bit-equal to the uninterrupted "
              f"run's in all {n} leaves (params, mu, nu, step; "
              f"deterministic algorithms "
              f"{torch.are_deterministic_algorithms_enabled()}, nothing "
              f"forced); loss {losses[0]:.4f} -> {losses[-1]:.4f} (first "
              f"{w} mean {first:.4f}, last {w} {last:.4f}); "
              f"{step_ms:.2f} ms a step (forward+backward "
              f"{step_ms - upd_ms:.2f}, optimizer {upd_ms:.2f}; mean of "
              f"{len(records) - 1} after the first), "
              f"{tokens * 1e3 / step_ms:.0f} tokens/s, peak memory "
              f"{peak / 1e9:.2f} GB; checkpoint: the final synchronous "
              f"save {save_s:.3f} s for {size / 1e6:.1f} MB, the resume's "
              f"restore onto the card {resume_s:.3f} s")
    finally:
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)


def phase_train_compress(smi: str) -> None:
    """[train compress]: the launcher with --compress; comm_ratio, the
    compression's ms a step and its parts on the largest leaf, the
    projection meeting its sketch on every compressed leaf."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic
    from repro_torch.launch import train as launch
    from repro_torch.models import params as P
    from repro_torch.training import compression as C
    from repro_torch.training import train_loop as TL
    args = launch.parser().parse_args(TRAIN["compress"])
    cfg = get_config(args.arch)
    ccfg = C.CompressionConfig(min_size=4096)
    orig = C.roundtrip
    comp_ms = []

    def timed(*a, **k):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = orig(*a, **k)
        ev[1].record()
        comp_ms.append(ev)
        return out
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    C.roundtrip = timed
    try:
        state, hist = launch.train(TRAIN["compress"])
    finally:
        C.roundtrip = orig
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    ms = [a.elapsed_time(b) for a, b in comp_ms]
    losses = [h["loss"] for h in hist]
    if not all(math.isfinite(x) for x in losses):
        fail(f"[train compress] a loss is not finite: {losses}")
    ratio = hist[-1]["comm_ratio"]
    # the projection against its sketch on every compressed leaf of one
    # more step's gradients (with the final error state)
    batch = synthetic.batch_at(synthetic.DataConfig(
        batch_size=args.batch, seq_len=args.seq, seed=args.seed), cfg,
        args.steps, device="cuda")
    _, _, grads = TL.grads_of(cfg, state.params, batch)
    errs = dict(P.tree_leaves(state.compressor.error))
    worst, n_leaves, largest = 0.0, 0, None
    for i, (path, g) in enumerate(P.tree_leaves(grads)):
        ms_ = C._matricize_shape(tuple(g.shape))
        if ms_ is None or g.numel() < ccfg.min_size:
            continue
        d1, d2 = ms_
        fa, fb = C._factors(ccfg, ccfg.seed, args.steps, i, d1, d2, g.device)
        g2 = (g.float() + errs[path]).reshape(d1, d2)
        s = C._sketch(g2, fa, fb, ccfg.rank)
        back = C._sketch(C._project(s, fa, fb, ccfg.rank, ccfg.ridge),
                         fa, fb, ccfg.rank)
        resid = float((back - s).norm() / s.norm())
        worst = max(worst, resid)
        n_leaves += 1
        if largest is None or d1 + d2 > sum(largest[1].shape):
            largest = (path, g2, i)         # the most factor bytes
        del fa, fb
    # <P_k, G^> = s_k - lam alpha_k, lam = ridge * trace(M) / K: the
    # residual is about ridge; float32 sketches of ~1.4e6 terms add 1e-4
    bound = 10 * ccfg.ridge + 1e-3
    if not worst <= bound:
        fail(f"[train compress] a projection misses its sketch: relative "
             f"residual {worst:.3e} > {bound:.1e}")
    path, g2, i = largest
    d1, d2 = g2.shape
    parts = {}
    fa_fb, parts["draw"] = events_ms(lambda: C._factors(
        ccfg, ccfg.seed, args.steps, i, d1, d2, g2.device))
    fa, fb = fa_fb
    s, parts["sketch"] = events_ms(lambda: C._sketch(g2, fa, fb, ccfg.rank))
    m, parts["gram"] = events_ms(lambda: C._projection_gram(fa, fb,
                                                            ccfg.rank))
    alpha, parts["solve"] = events_ms(lambda: C._solve(m, s, ccfg.ridge))
    _, parts["project"] = events_ms(lambda: C._expand(alpha, fa, fb,
                                                      ccfg.rank))
    fbytes = (fa.numel() + fb.numel()) * fa.element_size()
    check_counts(read_counts(), "train compress", ())
    print(f"[train compress] on {smi}: {cfg.name}, --compress (K "
          f"{ccfg.num_projections}, R {ccfg.rank}, min_size "
          f"{ccfg.min_size}), {args.steps} steps of B={args.batch} x "
          f"{args.seq}: comm_ratio {ratio:.6f} (mean over {n_leaves} "
          f"compressed leaves), loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
          f"all finite; compression {statistics.mean(ms[1:]):.2f} ms a step "
          f"(mean of {len(ms) - 1} after the first); largest leaf {path} "
          f"({d1} x {d2}): draw {parts['draw']:.3f}, sketch "
          f"{parts['sketch']:.3f}, Gram {parts['gram']:.3f}, solve "
          f"{parts['solve']:.3f}, project {parts['project']:.3f} ms, "
          f"factors {fbytes} bytes; <P_k, G^> against s_k: max relative "
          f"residual {worst:.3e} over {n_leaves} leaves (limit "
          f"{bound:.1e}); peak memory {peak / 1e9:.2f} GB")


def phi3_bounds(cfg, tokens: int, n_params: int, seq: int, batch: int):
    """(bf16 products ms, f32 attention ms, AdamW bytes ms, sum) of a
    train step with remat "nothing"."""
    prod = 8.0 * n_params * tokens / BF16_FLOPS * 1e3
    # the chunked attention's two f32 products, 4 S^2 hd H a layer over the
    # causal half skipped by no one (every chunk is computed), run three
    # times (forward, remat, the chunk checkpoint) plus a 2x backward
    attn_fwd = 4.0 * batch * seq * seq * cfg.hd * cfg.n_heads * cfg.n_layers
    attn = 5.0 * attn_fwd / FP32_ATTN_FLOPS * 1e3
    adamw = 22.0 * n_params / HBM_BYTES_PER_S * 1e3
    return prod, attn, adamw, prod + attn + adamw


def grad_check(tag: str, grads) -> float:
    """Fails unless every gradient is finite and their total |g| is
    nonzero; returns the total."""
    import torch
    from repro_torch.models import params as P
    total = 0.0
    for path, g in P.tree_leaves(grads):
        if not bool(torch.isfinite(g).all()):
            fail(f"[{tag}] gradient {path} is not finite")
        total += float(g.float().abs().sum())
    if not total > 0.0:
        fail(f"[{tag}] every gradient is zero")
    return total


def phase_train_phi3(smi: str, lsh: bool) -> None:
    """[train phi3] / [train phi3-lsh]: train steps of phi3-mini-3.8b at
    full width and depth through the port's train step."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic
    from repro_torch.models import params as P
    from repro_torch.training import optimizer as O
    from repro_torch.training import train_loop as TL
    tag = "train phi3-lsh" if lsh else "train phi3"
    c = TRAIN["phi3_lsh" if lsh else "phi3"]
    cfg = get_config(c["arch"], "long" if lsh else "full")
    tc = TL.TrainConfig(adamw=O.AdamWConfig(peak_lr=3e-4, warmup_steps=1,
                                            decay_steps=100))
    zero_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(c["seed"])
    t0 = time.perf_counter()
    state, _ = TL.init_state(cfg, tc, gen, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    static = nbytes(state.params) + nbytes(state.opt.mu) + nbytes(
        state.opt.nu)
    dc = synthetic.DataConfig(batch_size=c["batch"], seq_len=c["seq"],
                              seed=c["seed"])
    checks = {}
    orig = O.update

    def inspect(cc, grads, st, params):
        if "grads" not in checks:
            checks["grads"] = grad_check(tag, grads)
            if lsh:
                for k in ("f1", "f2"):
                    if bool((grads["lsh_proj"][k] != 0).any()):
                        fail(f"[{tag}] lsh_proj/{k}'s gradient is not zero")
                checks["proj"] = {k: params["lsh_proj"][k].clone()
                                  for k in ("f1", "f2")}
        return orig(cc, grads, st, params)
    wrap, install, restore, records = train_ms(inner=inspect)
    step_fn = wrap(TL.make_train_step(cfg, tc))
    install()
    metrics, host_s = [], []
    try:
        for i in range(c["steps"]):
            t0 = time.perf_counter()
            batch = synthetic.batch_at(dc, cfg, i, device="cuda")
            state, m = step_fn(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
            host_s.append(time.perf_counter() - t0)
            if lsh and i == 0:
                wd = tc.adamw.weight_decay
                for k, before in checks["proj"].items():
                    want = (before.float() - m["lr"] * (
                        wd * before.float())).to(before.dtype)
                    if not torch.equal(state.params["lsh_proj"][k], want):
                        fail(f"[{tag}] lsh_proj/{k} after the step is not "
                             f"(1 - lr * wd) times it in bf16 rounding")
                del checks["proj"]
    finally:
        restore()
    peak = torch.cuda.max_memory_allocated()
    step_ms, upd_ms = split_ms(records, skip=1)
    if not lsh:
        step_fn = TL.make_train_step(cfg, tc)
        profile_calls(f"{tag} profile", "one train step",
                      [lambda: step_fn(state, batch)])
    ce0 = metrics[0]["ce"]
    if not 1.0 < ce0 < 20.0 or not all(math.isfinite(m["loss"])
                                       for m in metrics):
        fail(f"[{tag}] first ce {ce0} outside (1, 20) or a loss not finite")
    check_counts(read_counts(), tag, ())
    n = P.count_params(cfg)
    tokens = c["batch"] * c["seq"]
    prod, attn, adamw, total = phi3_bounds(cfg, tokens, n, c["seq"],
                                           c["batch"])
    what = (f"LSH attention ({cfg.lsh_num_hashes} hashes, chunk "
            f"{cfg.lsh_chunk}); lsh_proj's gradient exactly 0 and the step "
            f"scaled it by 1 - lr * wd in bf16 rounding" if lsh
            else "exact attention")
    bound = "" if lsh else (
        f" (bound {total:.1f} ms: bf16 products 8 N T = "
        f"{8.0 * n * tokens / 1e12:.1f} TFLOP {prod:.1f} ms at 989 "
        f"TFLOP/s, the f32 chunked attention {attn:.1f} ms at 67 TFLOP/s, "
        f"AdamW's 22 bytes a parameter {adamw:.1f} ms at 3.35 TB/s)")
    print(f"[{tag}] on {smi}: {cfg.name} {cfg.n_layers} x {cfg.d_model}, "
          f"{n} parameters, {cfg.dtype}, remat {cfg.remat_policy!r}, f32 "
          f"moments, {what}; B={c['batch']} x {c['seq']} tokens: "
          f"{step_ms:.1f} ms a step{bound}, forward+backward "
          f"{step_ms - upd_ms:.1f} ms, optimizer {upd_ms:.1f} ms (mean of "
          f"{len(records) - 1} after the warm-up), "
          f"{tokens * 1e3 / step_ms:.0f} tokens/s; peak memory "
          f"{peak / 1e9:.2f} GB (params + moments {static / 1e9:.2f} GB); "
          f"loss {[round(m['loss'], 4) for m in metrics]}, first ce "
          f"{ce0:.4f}, grad_norm {[round(m['grad_norm'], 4) for m in metrics]}"
          f", total |g| of the first step {checks['grads']:.4e}; host clock: "
          f"state drawn in {init_s:.2f} s, steps (with the batch) "
          f"{[round(x, 3) for x in host_s]} s")
    del state
    torch.cuda.empty_cache()


def phase_train_grads(smi: str) -> None:
    """[train grads]: remat policies bit-equal and a central difference on
    phi3 at full width, 2 layers, float32."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic
    from repro_torch.models import params as P
    from repro_torch.models import transformer as T
    from repro_torch.training import train_loop as TL
    c = TRAIN["grads"]
    base = dataclasses.replace(get_config("phi3-mini-3.8b"),
                               n_layers=c["layers"],
                               dtype="float32").validate()
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(c["seed"])
    params = P.init_params(base, gen, device="cuda")
    batch = synthetic.batch_at(synthetic.DataConfig(
        batch_size=c["batch"], seq_len=c["seq"], seed=c["seed"]), base, 0,
        device="cuda")
    grads, times = {}, {}
    for policy in ("nothing", "dots", "none"):
        cfg = dataclasses.replace(base, remat_policy=policy)
        TL.grads_of(cfg, params, batch)              # warm-up
        (loss, _, g), times[policy] = events_ms(
            lambda: TL.grads_of(cfg, params, batch))
        grads[policy] = (float(loss), dict(P.tree_leaves(g)))
        peak_p = torch.cuda.max_memory_allocated()
        times[policy] = (times[policy], peak_p)
        torch.cuda.reset_peak_memory_stats()
    ref_loss, ref = grads["nothing"]
    differ = {}
    for policy in ("dots", "none"):
        loss, g = grads[policy]
        bad = [p for p in ref if not torch.equal(g[p], ref[p])]
        worst = max((float((g[p] - ref[p]).abs().max()
                           / ref[p].abs().max().clamp(min=1e-30))
                     for p in bad), default=0.0)
        differ[policy] = (len(bad), worst, loss == ref_loss)
        if bad and worst > 1e-5:
            fail(f"[train grads] remat {policy!r} gradients differ from "
                 f"'nothing' in {len(bad)} leaves, relative {worst:.2e}")
    labels = batch["labels"].long()
    mask = labels >= 0

    def loss_at(d, step):
        """``loss_fn``'s value at p + step * d, its cross-entropy summed in
        float64 over the forward's float32 logits (a float32 sum of the 512
        per-token terms alone would round by ~1e-5)."""
        tree = TL.unflatten(params, [t + step * d[p] if p in d else t
                                     for p, t in P.tree_leaves(params)])
        with torch.no_grad():
            logits = T.forward(base, tree, batch)[0].double()
        ll = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
        ce = (torch.logsumexp(logits, dim=-1) - ll) * mask
        return float(ce.sum() / mask.sum())

    def directional(leaves, seed, eps):
        """(<grad, d>, fd(eps), fd(eps / 2), extrapolated) along a seeded
        Gaussian unit direction d over ``leaves``. fd(eps) = D + c eps^2
        + O(eps^4), so (4 fd(eps / 2) - fd(eps)) / 3 removes the
        third-order term."""
        dgen = torch.Generator(device="cuda").manual_seed(seed)
        d = {p: torch.randn(t.shape, generator=dgen, device="cuda")
             for p, t in P.tree_leaves(params) if p in leaves}
        norm = math.sqrt(sum(float((v * v).sum()) for v in d.values()))
        d = {p: v / norm for p, v in d.items()}
        deriv = sum(float((ref[p].double() * d[p].double()).sum())
                    for p in d)
        fds = [(loss_at(d, e) - loss_at(d, -e)) / (2 * e)
               for e in (eps, eps / 2)]
        return deriv, fds[0], fds[1], (4 * fds[1] - fds[0]) / 3
    # the checked direction spans the norm scales (every layer's two and
    # the final one: 15,360 entries), whose gradients carry the whole
    # backward from the head to layer 0; its derivative is large beside
    # the loss's float32 rounding (~2e-7 an evaluation on the card: the
    # forward's logits round independently across 512 tokens). Over all
    # 423M entries a unit direction's derivative is ~4e-5, so that noise is
    # 0.5% of it: printed, not checked.
    norms = [p for p, _ in P.tree_leaves(params)
             if p.split("/")[-1] in ("ln", "mlp_ln", "final_norm")]
    deriv, fd, fd_half, rich = directional(set(norms), c["seed"] + 1,
                                           c["eps"])
    bound = 1e-3 * abs(deriv) + 1e-8
    if not abs(rich - deriv) <= bound:
        fail(f"[train grads] along the norms: central differences {fd:.6e} "
             f"(eps {c['eps']}), {fd_half:.6e} (eps {c['eps'] / 2}), "
             f"extrapolated {rich:.6e} against <grad, d> {deriv:.6e}: "
             f"|difference| {abs(rich - deriv):.3e} > {bound:.3e}")
    all_d, all_fd, _, all_rich = directional(
        {p for p, _ in P.tree_leaves(params)}, c["seed"] + 2, c["eps"])
    check_counts(read_counts(), "train grads", ())
    print(f"[train grads] on {smi}: phi3-mini-3.8b at full width cut to "
          f"{c['layers']} of 32 layers, float32, exact attention, "
          f"B={c['batch']} x {c['seq']}: loss {ref_loss:.6f}; gradients "
          f"under remat 'dots' / 'none' against 'nothing': "
          f"{differ['dots'][0]} / {differ['none'][0]} of {len(ref)} leaves "
          f"differ (bit-equal where 0; worst relative "
          f"{differ['dots'][1]:.2e} / {differ['none'][1]:.2e}), losses "
          f"equal {differ['dots'][2]} / {differ['none'][2]}; "
          f"forward+backward ms and peak GB: "
          + ", ".join(f"{k} {v[0]:.1f} ms {v[1] / 1e9:.2f} GB"
                      for k, v in times.items())
          + f"; central differences along a seeded unit direction over "
          f"the {len(norms)} norm-scale leaves {fd:.6e} (eps {c['eps']}) "
          f"and {fd_half:.6e} (eps {c['eps'] / 2}), extrapolated "
          f"{rich:.6e} against <grad, d> {deriv:.6e}: |difference| "
          f"{abs(rich - deriv):.3e} ({abs(rich - deriv) / abs(deriv):.2e} "
          f"relative), limit {bound:.3e}; over all leaves (printed) "
          f"{all_fd:.6e}, extrapolated {all_rich:.6e} against {all_d:.6e}")
    del params, grads, ref
    torch.cuda.empty_cache()


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
    h_t, k1_t, hq_t, hq_err, hq_lib, h_lib = phase_times(svc, cell, queries,
                                                         k1_args)
    phase_profile(svc, queries, "tt-profile" if layout == "tt" else "profile")
    mixed_records, mixed = ([], None) if layout == "tt" else \
        phase_mixed_main(svc, qids, queries)
    if layout == "tt":
        n = SAMPLE["passes"]
        sample_records = [sample_pass("tt sample", svc, queries[:n],
                                      main_results[:n], mode, (4, 4),
                                      K1_SAMPLE_SOURCE)[0]
                          for mode in SAMPLE_MODES]
        samples = None
    else:
        sample_records, samples = phase_sample(svc, queries, main_results)
    key, source, replaces = HASH_RECORDS[layout]
    builds = main["build_launches"]
    records = [dict(record(key + "[build]", source, replaces, counts, key,
                           h_err, h_t), launches=builds, library_ms=h_lib),
               dict(record(key + "[query]", source, replaces, counts, key,
                           hq_err, hq_t), launches=counts[key] - builds,
                    library_ms=hq_lib),
               record("fused_query" + ("[tt]" if layout == "tt" else ""),
                      *K1_SOURCE, counts, "fused_query", k1_err, k1_t)]
    records += mixed_records + sample_records
    del svc, k1_args
    torch.cuda.empty_cache()
    if layout == "tt":
        phase_tt_mut(cell)
        phase_tt_shard(cell)
        return records
    keep = {}
    records += phase_shard(cell, corpus, qids, queries, main_results, mixed,
                           samples, keep)
    del main_results, mixed, samples
    torch.cuda.empty_cache()
    records += phase_cp_as_tt(cell, corpus, qids, queries)
    torch.cuda.empty_cache()
    records.append(phase_mp(cell, corpus, qids, queries, main))
    torch.cuda.empty_cache()
    records.append(phase_mut(cell, corpus, qids, args))
    torch.cuda.empty_cache()
    records.append(phase_shard_mut(cell, corpus, qids, args, keep))
    torch.cuda.empty_cache()
    records.append(phase_mesh(cell, corpus, qids, queries, keep))
    del keep
    torch.cuda.empty_cache()
    records.append(phase_ann_k8(cell, corpus, qids, queries))
    torch.cuda.empty_cache()
    records += phase_host(cell, corpus)
    torch.cuda.empty_cache()
    phase_sched(cell, corpus, qids, queries)
    torch.cuda.empty_cache()
    records += phase_durable_main(cell, corpus, qids, queries, main["mean"])
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
    kernels += phase_durable_ingest()
    torch.cuda.empty_cache()
    kernels += run_dense(args)
    torch.cuda.empty_cache()
    kernels += run_cell("tt", TT_LOG2_CORPUS, args)
    torch.cuda.empty_cache()
    kernels += phase_kernels()
    torch.cuda.empty_cache()
    kernels += phase_limits()
    torch.cuda.empty_cache()
    kernels += phase_tables(smi)
    torch.cuda.empty_cache()
    kernels += phase_collision(smi)
    torch.cuda.empty_cache()
    lsh = phase_lm_phi3_lsh(smi)
    torch.cuda.empty_cache()
    phase_lm_phi3(smi, lsh)
    del lsh
    torch.cuda.empty_cache()
    phase_lm_archs(smi)
    torch.cuda.empty_cache()
    t_train = time.perf_counter()
    phase_train_mamba2(smi)
    phase_train_compress(smi)
    torch.cuda.empty_cache()
    phase_train_phi3(smi, lsh=False)
    phase_train_phi3(smi, lsh=True)
    phase_train_grads(smi)
    print(f"[train] phases {time.perf_counter() - t_train:.1f} s")
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
