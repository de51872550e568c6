#!/usr/bin/env python3
"""Compare another tree of the port with this one on one NVIDIA H100.

    python3 chip_ab.py OTHER_TREE [--pairs 3] [--out build/ab]

OTHER_TREE is another commit's ``git archive``, unpacked under the
git-ignored ``build/``. Each run is a process of its own that imports its
tree's ``chip_smoke`` and drives the CP cell [main] and the TT cell
[tt-main] through ``phase_main``; CP serves its 256 batches three more
times. Runs alternate (other, this, this, other, ...). Each run prints one
``AB {...}`` line: the batch means on the host clock, and K1's and the hash
kernel's times (CUDA events, ``phase_times``). At the end the first 32
batches' ids, scores and candidate counts of every run are compared bit
for bit, and the medians of each tree's batch means are printed. Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
KEEP = 32          # batches whose results are compared across runs


def one(tree: str, out: str) -> None:
    """One run of ``tree``: both cells, results saved to ``out`` (.npz)."""
    sys.path.insert(0, str(Path(tree) / "src"))
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    import chip_smoke as cs
    import repro_torch  # noqa: F401  (sets the float32 matmul flags)
    res, arrays = {"tree": tree}, {}
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
        _, k1_args = cs.k1_compare(svc, queries[0], "ab")
        h_t, k1_t = cs.phase_times(svc, cell, queries, k1_args)
        for i, name in enumerate(("ids", "scores", "ncand")):
            arrays[f"{layout}_{name}"] = np.stack(
                [r[i] for r in results[:KEEP]])
        res[layout] = dict(means=means, k1_ms=k1_t[0], hash_ms=h_t[0])
        del svc, corpus, queries, results, k1_args
        torch.cuda.empty_cache()
    np.savez(out, **arrays)
    print("AB " + json.dumps(res))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other")
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--out", default=str(HERE / "build" / "ab"))
    ap.add_argument("--one", nargs=2, metavar=("TREE", "NPZ"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        one(*args.one)
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
                               "--one", tree, str(npz)],
                              capture_output=True, text=True, timeout=900)
        (out / f"run{i}.log").write_text(proc.stdout + proc.stderr)
        line = [x for x in proc.stdout.splitlines() if x.startswith("AB ")]
        if proc.returncode != 0 or not line:
            print(f"run {i} ({tree}) failed: see {out / f'run{i}.log'}")
            return 1
        runs.append((tree, json.loads(line[0][3:]), np.load(npz)))
        print(f"run {i}: {line[0]}")
    first = runs[0][2]
    for key in first.files:
        same = all(np.array_equal(first[key].view(np.int32),
                                  r[2][key].view(np.int32)) for r in runs)
        print(f"[ab] {key} {first[key].shape}: bit-equal across all runs: "
              f"{same}")
    for tree in (args.other, str(HERE)):
        mine = [r[1] for r in runs if r[0] == tree]
        for layout in ("cp", "tt"):
            means = [m for r in mine for m in r[layout]["means"]]
            k1 = [r[layout]["k1_ms"] for r in mine]
            hk = [r[layout]["hash_ms"] for r in mine]
            print(f"[ab] {tree} {layout}: batch mean ms median "
                  f"{statistics.median(means):.4f} (min {min(means):.4f}, "
                  f"max {max(means):.4f}, {len(means)} serves); K1 ms "
                  f"{min(k1):.4f}-{max(k1):.4f}; hash kernel ms "
                  f"{min(hk):.4f}-{max(hk):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
