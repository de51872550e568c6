#!/usr/bin/env python3
"""Compare another tree of the port with this one on one NVIDIA H100.

    python3 chip_ab.py OTHER_TREE [--pairs 3] [--out build/ab]
                       [--parity PATH,...]

OTHER_TREE is another commit's ``git archive``, unpacked under the
git-ignored ``build/``. Each run is a process of its own that imports its
tree's ``chip_smoke`` and drives the CP cell [main] and the TT cell
[tt-main] through ``phase_main``, and [ann-k8] ([main]'s corpus and
queries at the example's K = 8) through ``build_service`` and ``serve``;
[main] serves its 256 batches three more times. The cross-format and dense
paths follow [main] on its corpus and queries (its first 32 batches in the
query format): [mixed dense x cp], [mixed tt x cp] and [mixed tt8 x cp]
(the TT queries zero-padded to rank 8) over [main]'s service,
[shard-mixed] (dense x CP over 4 shards, which must equal the single card
bit for bit), [mixed cp x tt] and [mixed dense x tt] over [cp-as-tt] (the
corpus converted exactly to TT), [mixed cp x tt8] and [mixed dense x tt8]
over [tt8] (the first 2^16 items as TT zero-padded to rank 8, queries of
its own items as ``chip_smoke.phase_tt8`` makes them), [tt8 x tt8] and
[tt16 x tt8] on the same service (those CP queries as TT padded to rank 8
and to 16: ``tt8tt8``, ``tt16tt8``), and the corpus
densified
under [dense-main] (e2lsh, with [mixed cp x dense] and [mixed tt x dense])
and [dense-cp] (cp-e2lsh), 64 batches each.
Runs alternate (other, this, this, other, ...). Each run prints one ``AB
{...}`` line: the batch means on the host clock, and K1's time on each path
and the hash kernel's build and query launches on [main] and [tt-main]
(CUDA events, ``phase_times`` / ``k1_times``). At the end the first 32
batches' ids, scores and candidate counts of every path and run are
compared bit for bit, and so are the hash kernel's raw values on the first
query batch and on the first 65,536-item build chunk and its keys on that
chunk; the paths named by ``--parity`` (of ``PATHS``: those whose
summation order the trees differ in) are compared bit for bit within a tree
and across trees within ``parity.rerank_bound`` (counts equal, ids equal
but at near ties);
the medians of each tree's batch means and the range of its kernel times
are printed. Before the paths, each run times the tree's K6 (``ops.srp_pack``)
at ``K6_SHAPES`` and one ``torch.amax`` over the first shape's values (the
read yardstick: what a pure read stream reaches on this card), prints
K6's registers from the tree's build log, and keeps K6's words at the
first ``K6_KEEP`` shapes, compared bit for bit across runs like the rest.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
KEEP = 32          # batches whose results are compared across runs
DENSE_BATCHES = 64  # batches served on [dense-main] and [dense-cp]
# every path's record in the summary, in the order the runs serve them
PATHS = ("cp", "annk8", "tt", "densemain", "densecp", "mixeddensecp",
         "shardmixed", "mixedttcp", "mixedtt8cp", "mixedcptt",
         "mixeddensett", "mixedcptt8", "mixeddensett8", "tt8tt8", "tt16tt8",
         "mixedcpdense", "mixedttdense")
TT8_LOG2 = 16      # [tt8]'s items: the first 2^16 of [main]'s corpus
TT8_RANK = 8
# K6 (srp_pack) shapes timed in each run: the [kernels] shape, the L*K of
# [main], a wide row, a narrow one; the words of the first K6_KEEP are kept
K6_SHAPES = ((1 << 20, 128), (1 << 20, 100), (1 << 16, 2000), (1 << 20, 8))
K6_KEEP = 2
L2_BYTES = 50 << 20


def k6_section(cs, arrays: dict) -> dict:
    """The tree's K6 at ``K6_SHAPES`` and the read yardstick (CUDA events,
    cycling inputs that together exceed the L2 cache) -> {shape: ms}, with
    the yardstick under "read"; K6's words at the first shapes go into
    ``arrays``."""
    import torch
    from repro_torch.kernels import _build, ops
    _build.lib()
    log = _build.BUILD_INFO.get("log", "")
    part = log.split("== srp_pack.cu", 1)[-1].split("== ", 1)[0]
    print("[build] K6 (srp_pack.cu): " + "; ".join(
        re.findall(r"Used \d+ registers[^\n]*", part)))
    gen = torch.Generator(device="cuda").manual_seed(19)
    times = {}
    for j, (b, k) in enumerate(K6_SHAPES):
        n_in = max(2, -(-3 * L2_BYTES // (b * k * 4)))
        vs = [torch.randn((b, k), generator=gen, device="cuda")
              for _ in range(n_in)]
        if j < K6_KEEP:
            arrays[f"k6_{b}x{k}"] = ops.srp_pack(vs[0]).cpu().numpy()
        ms = cs.cuda_ms([lambda v=v: ops.srp_pack(v) for v in vs], 20)
        bound = (b * k * 4 + b * -(-k // 32) * 8) / cs.HBM_BYTES_PER_S * 1e3
        print(f"[time] K6 ({b}, {k}): {ms:.4f} ms; byte bound {bound:.4f} ms,"
              f" {100 * bound / ms:.1f}%")
        times[f"{b}x{k}"] = ms
        if j == 0:
            read = cs.cuda_ms([lambda v=v: torch.amax(v) for v in vs], 20)
            rb = b * k * 4 / cs.HBM_BYTES_PER_S * 1e3
            print(f"[time] read yardstick: torch.amax over ({b}, {k}) fp32: "
                  f"{read:.4f} ms; its byte bound (the values read once) "
                  f"{rb:.4f} ms, {100 * rb / read:.1f}%")
            times["read"] = read
        del vs
    torch.cuda.empty_cache()
    return times


def one(tree: str, out: str, parity_paths=()) -> None:
    """One run of ``tree``: the paths, results saved to ``out`` (.npz),
    with ``parity.rerank_bound`` of each of ``parity_paths``' batches."""
    sys.path.insert(0, str(Path(tree) / "src"))
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    import chip_smoke as cs
    import repro_torch  # noqa: F401  (sets the float32 matmul flags)
    from repro_torch.core.tensor_formats import cp_to_tt
    from repro_torch.serving.lsh_service import build_service
    res, arrays = {"tree": tree}, {}
    res["k6"] = k6_section(cs, arrays)

    def keep(path, results):
        for i, name in enumerate(("ids", "scores", "ncand")):
            arrays[f"{path}_{name}"] = np.stack(
                [r[i] for r in results[:KEEP]])

    def timed(path, svc, batches, corpus=None):
        """Serve ``batches`` (a warm-up first), keep their results, time K1
        on them -> the path's record."""
        results, _ = cs.serve(svc, batches)
        keep(path, results)
        if path in parity_paths:
            from repro_torch.kernels import parity
            eff = svc.index.effective_corpus()
            arrays[f"{path}_tol"] = np.stack([parity.rerank_bound(
                svc.index.metric, q, eff, torch.as_tensor(r[0]).cuda(),
                torch.as_tensor(r[1]).cuda()).cpu().numpy()
                for q, r in zip(batches[:KEEP], results[:KEEP])])
        _, k1_args = cs.k1_compare(svc, batches[0], f"ab {path}",
                                   corpus=corpus)
        k1_t = cs.k1_times(svc, batches, k1_args, f"K1 {path}",
                           corpus=corpus)
        return results, dict(means=[svc.stats.total_ms / svc.stats.batches],
                             k1_ms=k1_t[0], hash_ms=None, query_ms=None)

    for layout, batches in (("cp", 256), ("tt", 64)):
        cell = dict(cs.CELLS[layout], hash_kernel=cs.HASH_RECORDS[layout][0])
        gen = torch.Generator(device="cuda").manual_seed(cell["seed"])
        n = 1 << 20
        corpus = cs.hash_fns(layout)["data"](gen, cell["dims"], cell["rhat"],
                                             batch=n)
        perm = torch.randperm(n, generator=gen, device="cuda")
        qids = [perm[i * 1024:(i + 1) * 1024] for i in range(batches)]
        queries = [cs.make_queries(corpus, q, gen) for q in qids]
        svc, _, main, results = cs.phase_main(cell, corpus, qids, queries)
        means = [main["mean"]]
        if layout == "cp":
            for _ in range(3):
                cs.serve(svc, queries)
                means.append(svc.stats.total_ms / svc.stats.batches)
            dense_q = [cs.densify(q) for q in queries[:KEEP]]
            tt_q = [cp_to_tt(q) for q in queries[:KEEP]]
            eff = svc.index.effective_corpus()
            mixed, res["mixeddensecp"] = timed("mixeddensecp", svc, dense_q,
                                              eff)
            _, res["mixedttcp"] = timed("mixedttcp", svc, tt_q, eff)
            _, res["mixedtt8cp"] = timed(
                "mixedtt8cp", svc, [cs.pad_tt(q, TT8_RANK) for q in tt_q],
                eff)
            del eff
        _, k1_args = cs.k1_compare(svc, queries[0], "ab")
        times = cs.phase_times(svc, cell, queries, k1_args)
        keep(layout, results)
        # the hash kernel's own outputs: raw on the first query batch, raw
        # and keys on the first build chunk
        f, fam = cs.hash_fns(layout), svc.index.family
        p = fam.stacked_projection
        q0 = queries[0]
        arrays[f"{layout}_raw_query"] = f["kernel"](
            q0.stack()[1], p, epilogue="raw",
            scale=q0.scale * fam.projection.scale).cpu().numpy()
        chunk = svc.index.store.base.stacked[:65536]
        scale = svc.index.effective_corpus().scale * fam.projection.scale
        arrays[f"{layout}_raw_build"] = f["kernel"](
            chunk, p, epilogue="raw", scale=scale).cpu().numpy()
        arrays[f"{layout}_keys_build"] = f["kernel"](
            chunk, p, fam.offsets.reshape(cell["tables"], cell["codes"]),
            svc.index._mults_t, epilogue="e2lsh-keys", w=cell["width"],
            scale=scale).cpu().numpy()
        res[layout] = dict(means=means, k1_ms=times[1][0],
                           hash_ms=times[0][0], query_ms=times[2][0])
        del svc, results, k1_args
        torch.cuda.empty_cache()
        if layout == "cp":  # [shard-mixed]: dense x CP over 4 shards
            svc = build_service(torch.Generator(device="cuda").manual_seed(1),
                                cell["kind"], cell["dims"], corpus,
                                num_codes=cell["codes"],
                                num_tables=cell["tables"], rank=cell["rank"],
                                bucket_width=cell["width"],
                                shards=cs.SHARD["shards"], device="cuda")
            got, res["shardmixed"] = timed("shardmixed", svc, dense_q)
            for i, (g, w) in enumerate(zip(got, mixed)):
                cs.same_answers(g, w, f"ab shard-mixed batch {i}")
            del svc, got, mixed
            torch.cuda.empty_cache()
            # [cp-as-tt]: CP and dense queries over the corpus as TT
            c = dict(cs.CP_AS_TT, dims=cell["dims"])
            svc = build_service(torch.Generator(device="cuda").manual_seed(1),
                                c["kind"], c["dims"], cp_to_tt(corpus),
                                num_codes=c["codes"], num_tables=c["tables"],
                                rank=c["rank"], bucket_width=c["width"],
                                device="cuda")
            _, res["mixedcptt"] = timed("mixedcptt", svc, queries[:KEEP])
            _, res["mixeddensett"] = timed("mixeddensett", svc, dense_q)
            del svc
            torch.cuda.empty_cache()
            # [tt8]: CP and dense queries over TT rows of rank 8
            m = 1 << TT8_LOG2
            base = corpus.index(slice(0, m))
            g8 = torch.Generator(device="cuda").manual_seed(cell["seed"] + 8)
            p8 = torch.randperm(m, generator=g8, device="cuda")
            cp8 = [cs.make_queries(base, p8[i * 1024:(i + 1) * 1024], g8)
                   for i in range(KEEP)]
            svc = build_service(torch.Generator(device="cuda").manual_seed(1),
                                c["kind"], c["dims"],
                                cs.pad_tt(cp_to_tt(base), TT8_RANK),
                                num_codes=c["codes"], num_tables=c["tables"],
                                rank=c["rank"], bucket_width=c["width"],
                                device="cuda")
            _, res["mixedcptt8"] = timed("mixedcptt8", svc, cp8)
            _, res["mixeddensett8"] = timed("mixeddensett8", svc,
                                            [cs.densify(q) for q in cp8])
            for rank in (8, 16):  # TT queries padded to rank 8 and to 16
                path = f"tt{rank}tt8"
                _, res[path] = timed(path, svc, [
                    cs.pad_tt(cp_to_tt(q), rank) for q in cp8])
            del svc, base, cp8
            torch.cuda.empty_cache()
        if layout == "cp":  # [ann-k8]: the example's K = 8
            svc = build_service(torch.Generator(device="cuda").manual_seed(1),
                                cell["kind"], cell["dims"], corpus,
                                num_codes=8, num_tables=cell["tables"],
                                rank=cell["rank"],
                                bucket_width=cell["width"], device="cuda")
            results, _ = cs.serve(svc, queries)
            _, k1_args = cs.k1_compare(svc, queries[0], "ab ann-k8")
            k1_t = cs.k1_times(svc, queries, k1_args, "K1 ann-k8")
            keep("annk8", results)
            res["annk8"] = dict(means=[svc.stats.total_ms / svc.stats.batches],
                                k1_ms=k1_t[0], hash_ms=None, query_ms=None)
            del svc, results, k1_args
            # [dense-main] and [dense-cp]: the corpus and queries densified
            dense = cs.densify(corpus)
            dense_q = [cs.densify(q) for q in queries[:DENSE_BATCHES]]
            cp_q = queries[:KEEP]
            del corpus
            torch.cuda.empty_cache()
            for key in ("main", "cp"):
                c = cs.DENSE[key]
                svc = build_service(
                    torch.Generator(device="cuda").manual_seed(1), c["kind"],
                    c["dims"], dense, num_codes=c["codes"],
                    num_tables=c["tables"], rank=c["rank"],
                    bucket_width=c["width"], device="cuda")
                path = c["tag"].replace("-", "")
                _, res[path] = timed(path, svc, dense_q)
                if key == "main":  # CP and TT queries over dense rows
                    _, res["mixedcpdense"] = timed("mixedcpdense", svc, cp_q)
                    _, res["mixedttdense"] = timed("mixedttdense", svc, tt_q)
                del svc
                torch.cuda.empty_cache()
            del dense, dense_q, cp_q, tt_q
        else:
            del corpus
        del queries
        torch.cuda.empty_cache()
    np.savez(out, **arrays)
    print("AB " + json.dumps(res))


def parity_verdict(runs, path) -> str:
    """The first run of each tree on ``path``: candidate counts equal, and
    ids and scores within ``parity.rerank_bound`` (the larger of the two
    trees' bounds) -> a summary line."""
    import numpy as np
    import torch
    sys.path.insert(0, str(HERE / "src"))
    from repro_torch.kernels import parity
    a, b = runs[0][2], next(r[2] for r in runs if r[0] != runs[0][0])
    if not np.array_equal(a[f"{path}_ncand"], b[f"{path}_ncand"]):
        return "candidate counts DIFFER"
    ia, ib = (torch.from_numpy(x[f"{path}_ids"]).flatten(0, 1) for x in (a, b))
    sa, sb = (torch.from_numpy(x[f"{path}_scores"]).flatten(0, 1)
              for x in (a, b))
    tol = torch.from_numpy(np.maximum(a[f"{path}_tol"],
                                      b[f"{path}_tol"])).flatten(0, 1)
    same = (ia == ib) & (ib >= 0)
    err = (sa - sb).abs()[same]
    bad = parity.topk_mismatches(ia, sa, ib, sb, tol)
    ok = bool((err <= tol[same]).all()) and bad == 0
    return (f"{'within' if ok else 'OUTSIDE'} the rounding bound: counts "
            f"equal, {int((ia != ib).sum())} id slots differ ({bad} without "
            f"a near tie), max |score difference| {float(err.max()):.3g} "
            f"(bound's median {float(tol[same].median()):.3g}), "
            f"{int((sa.view(torch.int32) != sb.view(torch.int32)).sum())} "
            f"of {sa.numel()} scores not bit-equal")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other")
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--out", default=str(HERE / "build" / "ab"))
    ap.add_argument("--parity",
                    type=lambda s: tuple(x for x in s.split(",") if x),
                    default=(), metavar="PATH,...",
                    help="paths compared across trees within "
                         "parity.rerank_bound, of: " + ", ".join(PATHS))
    ap.add_argument("--one", nargs=2, metavar=("TREE", "NPZ"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not set(args.parity) <= set(PATHS):
        ap.error(f"unknown paths {sorted(set(args.parity) - set(PATHS))}")
    if args.one:
        one(*args.one, args.parity)
        return 0
    import numpy as np
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    order = [args.other, str(HERE), str(HERE), args.other] * args.pairs
    order = order[:2 * args.pairs]
    runs = []
    for i, tree in enumerate(order):
        npz = out / f"run{i}.npz"
        proc = subprocess.run([sys.executable, __file__, args.other,
                               "--one", tree, str(npz), "--parity",
                               ",".join(args.parity)],
                              capture_output=True, text=True, timeout=900)
        (out / f"run{i}.log").write_text(proc.stdout + proc.stderr)
        line = [x for x in proc.stdout.splitlines() if x.startswith("AB ")]
        if proc.returncode != 0 or not line:
            print(f"run {i} ({tree}) failed: see {out / f'run{i}.log'}; its "
                  f"end:\n{(proc.stdout + proc.stderr)[-3000:]}")
            return 1
        runs.append((tree, json.loads(line[0][3:]), np.load(npz)))
        print(f"run {i}: {line[0]}")
    first = runs[0][2]
    for key in first.files:
        if key.endswith("_tol"):
            continue
        if key.split("_")[0] in args.parity:
            for tree in (args.other, str(HERE)):
                mine = [r[2] for r in runs if r[0] == tree]
                same = all(np.array_equal(mine[0][key].view(np.int32),
                                          r[key].view(np.int32))
                           for r in mine)
                print(f"[ab] {key} {first[key].shape}: bit-equal across "
                      f"{tree}'s runs: {same}")
            continue
        same = all(np.array_equal(first[key].view(np.int32),
                                  r[2][key].view(np.int32)) for r in runs)
        print(f"[ab] {key} {first[key].shape}: bit-equal across all runs: "
              f"{same}")
    for path in args.parity:
        print(f"[ab] {path}: across trees {parity_verdict(runs, path)}")
    for tree in (args.other, str(HERE)):
        mine = [r[1] for r in runs if r[0] == tree]
        for path in PATHS:
            means = [m for r in mine for m in r[path]["means"]]
            k1 = [r[path]["k1_ms"] for r in mine]
            hk = [r[path]["hash_ms"] for r in mine
                  if r[path]["hash_ms"] is not None]
            hq = [r[path]["query_ms"] for r in mine
                  if r[path].get("query_ms") is not None]
            print(f"[ab] {tree} {path}: batch mean ms median "
                  f"{statistics.median(means):.4f} (min {min(means):.4f}, "
                  f"max {max(means):.4f}, {len(means)} serves); K1 ms "
                  f"{min(k1):.4f}-{max(k1):.4f}" + (
                      f"; hash kernel ms: build launch {min(hk):.4f}-"
                      f"{max(hk):.4f}, query launch {min(hq):.4f}-"
                      f"{max(hq):.4f}" if hk else ""))
        for shape in mine[0]["k6"]:
            t = [r["k6"][shape] for r in mine]
            print(f"[ab] {tree} K6 {shape}: ms {min(t):.4f}-{max(t):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
