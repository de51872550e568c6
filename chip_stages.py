#!/usr/bin/env python3
"""Time K3's and K4's thread kernels by stage on one NVIDIA card.

    python3 chip_stages.py TREE [TREE ...]

For each TREE (this checkout, ``.``, or another commit's ``git archive``
unpacked under the git-ignored ``build/``), in a process of its own, copies
its ``src/repro_torch/kernels/csrc`` into ``build/stages/<i>/``, stamps
``cp_gram.cu`` and ``tt_inner.cu`` with ``clock64()`` (thread 0 of every
block writes its stage cycles into a device array), builds that copy with
the tree's own ``_build`` and runs K3 and K4 at the serving shapes of
[main] (CP (12, 12, 12), data rank 4, rank 3, L = K = 10) and [tt-main] (TT
(16,)*4, ranks 4, L = K = 10): the build launch (65,536 items,
``e2lsh-keys``) and the query launch (1,024 items, ``raw``). Prints per
launch the time (CUDA events, the stamped build), grid, registers and
blocks per SM of the stamped kernel, mean cycles a block and each stage's
share. Two source forms are known: the first design's (one thread per
(item, table) in K3, per (item, hash) in K4, a table's hashes in a block)
and the tiled design's (register tiles of items x hashes, blocks from
``plan``); the stamps change the timing a little, so compare shares, not
times. Needs a CUDA card and ``nvcc``.

    python3 chip_stages.py --k1 TREE [TREE ...]

stamps K1 (``fused_query.cuh``) instead: thread 0 of each query's block
adds its cycles to five stages (the prologue: the query row staged or
densified, the keys and qq; the probes' ``warp_bound`` searches; the window
and its dedup; the re-rank; the selection and the output) and the card's
``%globaltimer`` at the query's start and end. A source with the stamp
hooks (``K1_STAMP``, empty unless defined) gets the macros defined in the
copy; a source without them (the first dense-query design's) is patched
at its stage boundaries.
It runs [main]'s corpus and its first ``K1_BATCHES`` query batches as in
``chip_smoke.py``: [mixed dense x cp] and [mixed tt x cp] (dense queries
and TT ones, the CP queries converted exactly, over [main]'s CP service),
and [mixed tt8 x cp] (the TT queries zero-padded to rank 8), then
[cp-as-tt] (the corpus converted exactly to TT, tt-e2lsh rank 4) under
[mixed cp x tt] (the CP queries) and [mixed dense x tt] (densified), then
[tt8] ([main]'s first 2^16 items as TT zero-padded to rank 8, indexed as
[cp-as-tt]) under [mixed cp x tt8] and [mixed dense x tt8] (CP queries of
its own items, as ``chip_smoke.phase_tt8`` makes them, and densified) and
[tt8 x tt8] / [tt16 x tt8] (those queries as TT padded to rank 8 / 16),
[limits tt16] (``chip_smoke.phase_limits``' TT rank-16 index and its 256
queries), then
the corpus densified under [dense-main] (e2lsh, with [mixed cp x dense] and
[mixed tt x dense] on its service) and [dense-cp] (cp-e2lsh). Each cell
runs the instantiation the tree's own plan picks (``instance``). Prints
per cell K1's instantiation and time (CUDA events, the stamped build), the
stage shares of the summed query cycles, the re-rank's cycles a candidate
(the block's, and a warp's: the block's times its warps), and the
launch's timeline: its span, the share of the span the resident blocks
were busy, and the drain after the last query started. Where the source
marks the re-rank's yy and qy (``K1_PART``; the first ``<16, 0>`` design,
``tt_chains`` then ``cp_tt_chain``, is marked in the copy), warp 0's
cycles in each are printed too (``rerank_parts``:
each part's share of the re-rank and its cycles a candidate a warp).

    python3 chip_stages.py --k1 --cells "mixed cp x tt,mixed dense x tt" TREE

stamps only the cells named (their tags, comma-separated), and

    python3 chip_stages.py --k1 --unstamped [--cells ...] TREE [TREE ...]

builds each tree's K1 as it is and prints only its time, registers and
ptxas' spill bytes per cell (comparing variants' builds in one call).
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent

STAMPS = "\nnamespace { __device__ long long g_st[1 << 17][6]; }\n"
READ = """
extern "C" int {name}(void* host, size_t bytes) {{
  return (int)cudaMemcpyFromSymbol(host, g_st, bytes);
}}
"""
# per block: six stage fields; "total" is always the last one written
FIELDS = {
    "first": ("staging", "chain / Gram", "epilogue"),
    "tiled": ("stage issue", "stage wait", "chain / Gram", "end barrier",
              "epilogue"),
}
WRITE = ("  if (threadIdx.x == 0) {{\n"
         "    const long long blk = blockIdx.x + (long long)gridDim.x *\n"
         "        (blockIdx.y + (long long)gridDim.y * blockIdx.z);\n"
         "    const long long f[6] = {{{fields}}};\n"
         "    for (int i = 0; i < 6; ++i) g_st[blk][i] = f[i];\n"
         "  }}\n")


def patch(src: str, pairs) -> str:
    for old, new in pairs:
        if old not in src:
            raise SystemExit(f"chip_stages: cannot stamp, {old[:60]!r} not "
                             "found")
        src = src.replace(old, new, 1)
    return src


def stamp_first(cp: str, tt: str) -> tuple[str, str]:
    """The first design: K3 stages once, then each thread walks its
    table's hashes (Gram, then the epilogue's push); K4 stages each mode
    between two barriers."""
    cp = patch(cp, [
        ("namespace {\n\nconstexpr int RMAX", STAMPS + "namespace {\n\n"
         "constexpr int RMAX"),
        ("  extern __shared__ float smem[];\n  const int F = N * D * RX;",
         "  extern __shared__ float smem[];\n  const long long c0 = clock64();"
         "\n  long long tg = 0, te = 0;\n  const int F = N * D * RX;"),
        ("  __syncthreads();\n  const int zi = tid % bb;",
         "  __syncthreads();\n  const long long c1 = clock64();\n"
         "  const int zi = tid % bb;"),
        ("    const float* pk = pl + (size_t)k * N * PK;\n",
         "    const long long ta = clock64();\n"
         "    const float* pk = pl + (size_t)k * N * PK;\n"),
        ("    tail.push(ea, z, l, k0 + k, __fmul_rn(scale, v));\n  }\n"
         "  tail.finish(ea, z, l);\n}",
         "    const float vv = __fmul_rn(scale, v);\n"
         "    const long long tb = clock64();\n"
         "    tail.push(ea, z, l, k0 + k, vv);\n"
         "    tg += tb - ta;\n    te += clock64() - tb;\n  }\n"
         "  tail.finish(ea, z, l);\n  const long long c2 = clock64();\n"
         + WRITE.format(fields="c1 - c0, tg, c2 - c1 - tg, 0, 0, c2 - c0")
         + "}"),
    ]) + READ.format(name="stages_cp_read")
    tt = patch(tt, [
        ("namespace {\n\nconstexpr int RMAX", STAMPS + "namespace {\n\n"
         "constexpr int RMAX"),
        ("  float v = 0.f;\n  for (int n = 0; n < N; ++n) {\n"
         "    __syncthreads();",
         "  float v = 0.f;\n  const long long c0 = clock64();\n"
         "  long long ts = 0, tc = 0, tq;\n"
         "  for (int n = 0; n < N; ++n) {\n    tq = clock64();\n"
         "    __syncthreads();"),
        ("    __syncthreads();\n    if (!active) continue;",
         "    __syncthreads();\n    const long long tr = clock64();\n"
         "    ts += tr - tq;\n    if (!active) continue;"),
        ("        for (int e = 0; e < RT; ++e) s[c][e] = sn[c][e];\n    }\n"
         "  }\n",
         "        for (int e = 0; e < RT; ++e) s[c][e] = sn[c][e];\n    }\n"
         "    tc += clock64() - tr;\n  }\n  const long long c1 = clock64();\n"),
        ("    tail.finish(ea, z0 + zz, l0 + lt);\n  }\n}",
         "    tail.finish(ea, z0 + zz, l0 + lt);\n  }\n"
         "  const long long c2 = clock64();\n"
         + WRITE.format(fields="ts, tc, c2 - c1, 0, 0, c2 - c0") + "}"),
    ]) + READ.format(name="stages_tt_read")
    return cp, tt


def stamp_tiled(cp: str, tt: str) -> tuple[str, str]:
    """The tiled design: K3 stages once and each thread runs its register
    tile; K4 steps over slice chunks (stage issue, the wait for the
    copies and the top barrier, chain, the end barrier)."""
    cp = patch(cp, [
        ("namespace {\n\nconstexpr int RMAX", STAMPS + "namespace {\n\n"
         "constexpr int RMAX"),
        ("  extern __shared__ float4 smem4[];\n  const int LK = ea.L * ea.K;\n"
         "  const int hb = blockIdx.x % nhb;  // hash blocks of one item",
         "  extern __shared__ float4 smem4[];\n"
         "  const long long c0 = clock64();\n  const int LK = ea.L * ea.K;\n"
         "  const int hb = blockIdx.x % nhb;  // hash blocks of one item"),
        ("  cp_async_wait<0>();\n  __syncthreads();\n\n  const int lane",
         "  cp_async_wait<0>();\n  __syncthreads();\n"
         "  const long long c1 = clock64();\n\n  const int lane"),
        ("  __syncthreads();  // every thread is done with the staged rows",
         "  const long long c2 = clock64();\n"
         "  __syncthreads();  // every thread is done with the staged rows"),
        ("  block_epilogue(ea, vs, BH, z0, nz, h0, h0 + nh);\n}",
         "  block_epilogue(ea, vs, BH, z0, nz, h0, h0 + nh);\n"
         "  const long long c3 = clock64();\n"
         + WRITE.format(fields="0, c1 - c0, c2 - c1, 0, c3 - c2, c3 - c0")
         + "}"),
    ]) + READ.format(name="stages_cp_read")
    tt = patch(tt, [
        ("namespace {\n\nconstexpr int RMAX", STAMPS + "namespace {\n\n"
         "constexpr int RMAX"),
        ("  // zeroed stages",
         "  const long long c0 = clock64();\n"
         "  long long cs = 0, cw = 0, cc = 0, cb = 0;\n  // zeroed stages"),
        ("    const int ns = min(kSlices, D - ch * kSlices);\n"
         "    if (step + 1 < steps) {\n"
         "      stage(step + 1, (step + 1) & 1);\n",
         "    const int ns = min(kSlices, D - ch * kSlices);\n"
         "    const long long ta = clock64();\n    long long tb = ta;\n"
         "    if (step + 1 < steps) {\n"
         "      stage(step + 1, (step + 1) & 1);\n      tb = clock64();\n"),
        ("    __syncthreads();\n    // row (a, ii) of item",
         "    __syncthreads();\n    const long long tc = clock64();\n"
         "    cs += tb - ta;\n    cw += tc - tb;\n    // row (a, ii) of item"),
        ("    __syncthreads();  // every thread is done with this buffer\n  }",
         "    const long long td = clock64();\n"
         "    __syncthreads();  // every thread is done with this buffer\n"
         "    cc += td - tc;\n    cb += clock64() - td;\n  }\n"
         "  const long long c1 = clock64();"),
        ("  block_epilogue(ea, vs, BH, z0, nz, h0, h0 + nh);\n}",
         "  block_epilogue(ea, vs, BH, z0, nz, h0, h0 + nh);\n"
         "  const long long c2 = clock64();\n"
         + WRITE.format(fields="cs, cw, cc, cb, c2 - c1, c2 - c0") + "}"),
    ]) + READ.format(name="stages_tt_read")
    return cp, tt


def one(tree: str, index: int) -> None:
    """Stamp, build and run one tree's K3 and K4 (prints ``STAGES`` lines)."""
    import ctypes
    import re
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import torch
    import repro_torch  # noqa: F401  (sets the float32 matmul flags)
    from repro_torch.core import projections, tensor_formats
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import cp_gram as k3
    from repro_torch.kernels import tt_inner as k4
    out = HERE / "build" / "stages" / str(index)
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(Path(tree) / "src/repro_torch/kernels/csrc", out / "csrc")
    cp = (out / "csrc/cp_gram.cu").read_text()
    tt = (out / "csrc/tt_inner.cu").read_text()
    form = "first" if "tail.push(" in cp else "tiled"
    cp, tt = (stamp_first if form == "first" else stamp_tiled)(cp, tt)
    (out / "csrc/cp_gram.cu").write_text(cp)
    (out / "csrc/tt_inner.cu").write_text(tt)
    _build.CSRC, _build.BUILD_ROOT = out / "csrc", out / "_build"
    lib = _build.lib()
    regs = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"Compiling entry function '\w*?(cp_gram_kernel|tt_inner_kernel)"
        r"ILi4E[^']*'.*?Used (\d+) registers", _build.BUILD_INFO["log"],
        re.S)}
    for name in ("stages_cp_read", "stages_tt_read"):
        getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cells = {
        "K3": (k3.cp_gram, (12, 12, 12), 4, 3, tensor_formats.cp_random_data,
               projections.sample_cp_projection, ops._stack_cp_batch,
               ops._stack_cp_proj, lib.stages_cp_read, "cp_gram_kernel"),
        "K4": (k4.tt_inner, (16,) * 4, 4, 4, tensor_formats.tt_random_data,
               projections.sample_tt_projection, ops._stack_tt_batch,
               ops._stack_tt_proj, lib.stages_tt_read, "tt_inner_kernel"),
    }
    for name, (kern, dims, rhat, rank, data, proj, sx, sp, read,
               entry) in cells.items():
        p = sp(proj(gen, 100, dims, rank), 10)
        offs = torch.rand((10, 10), generator=gen, device="cuda") * 2.0
        mults = torch.randint(0, 1 << 32, (10,), generator=gen, device="cuda",
                              dtype=torch.int64) | 1
        for what, b, epi in (("build", 65536, "e2lsh-keys"),
                             ("query", 1024, "raw")):
            x = sx(data(gen, dims, rhat, batch=b))
            kw = dict(epilogue=epi, w=2.0)
            args = (x, p, offs, mults) if epi != "raw" else (x, p)
            kern(*args, **kw)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                kern(*args, **kw)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / 20
            kern(*args, **kw)
            torch.cuda.synchronize()
            grid, occ = launch_shape(form, name, b, dims, rhat, rank, sms)
            buf = (ctypes.c_longlong * (grid * 6))()
            err = read(ctypes.addressof(buf), grid * 48)
            if err:
                raise SystemExit(f"chip_stages: reading stamps: error {err}")
            rows = [buf[6 * i:6 * i + 6] for i in range(grid)]
            total = statistics.mean(r[5] for r in rows)
            shares = {f: statistics.mean(r[i] for r in rows) / total
                      for i, f in enumerate(FIELDS[form])}
            print("STAGES " + json.dumps(dict(
                tree=tree, form=form, kernel=name, launch=what, items=b,
                ms=ms, grid=grid, registers=regs.get(entry), **occ,
                cycles_per_block=total,
                max_cycles=max(r[5] for r in rows), shares=shares)))


# K1's stamps: per query, five stage sums (cycles of thread 0 of its block),
# their total, %globaltimer at the query's start and end, and two parts of
# the re-rank where the source marks them (K1_PART_BEGIN, K1_PART(0) after
# yy, K1_PART(1) after qy: warp 0's cycles in each)
K1_MACROS = r"""
namespace { __device__ long long g_k1[1 << 17][10]; }
#define K1_STAMP_BEGIN                                                  \
  long long k1s_t = clock64(), k1s_f[5] = {0, 0, 0, 0, 0};             \
  long long k1s_p[2] = {0, 0}, k1s_pt = 0;                             \
  unsigned long long k1s_g0;                                           \
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(k1s_g0));
#define K1_STAMP(i)                                                     \
  {                                                                    \
    const long long k1s_n = clock64();                                 \
    k1s_f[i] += k1s_n - k1s_t;                                         \
    k1s_t = k1s_n;                                                     \
  }
#define K1_PART_BEGIN k1s_pt = clock64();
#define K1_PART(i)                                                      \
  {                                                                    \
    const long long k1s_n = clock64();                                 \
    k1s_p[i] += k1s_n - k1s_pt;                                        \
    k1s_pt = k1s_n;                                                    \
  }
#define K1_STAMP_END(q)                                                 \
  if (threadIdx.x == 0) {                                              \
    unsigned long long k1s_g1;                                         \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(k1s_g1));         \
    long long k1s_s = 0;                                               \
    for (int k1s_i = 0; k1s_i < 5; ++k1s_i) {                          \
      g_k1[q][k1s_i] = k1s_f[k1s_i];                                   \
      k1s_s += k1s_f[k1s_i];                                           \
    }                                                                  \
    g_k1[q][5] = k1s_s;                                                \
    g_k1[q][6] = (long long)k1s_g0;                                    \
    g_k1[q][7] = (long long)k1s_g1;                                    \
    g_k1[q][8] = k1s_p[0];                                             \
    g_k1[q][9] = k1s_p[1];                                             \
  }
"""
# the first <16, 0> re-rank design (yy by tt_chains, then qy by cp_tt_chain),
# marked in two parts in a source that has the stage hooks but no parts
K1_PARTS_16_0 = (
    "        tt_chains<TR>(yr[0], RC, yr[0], RC, nullptr, 0, nullptr, 0, N, "
    "D, sb,\n                      lane, tyy, tqy);\n"
    "        tqy[0] = cp_tt_chain(qf, RQ, yr[0], RC, N, D, sb, lane);\n",
    "        K1_PART_BEGIN\n"
    "        tt_chains<TR>(yr[0], RC, yr[0], RC, nullptr, 0, nullptr, 0, N, "
    "D, sb,\n                      lane, tyy, tqy);\n        K1_PART(0)\n"
    "        tqy[0] = cp_tt_chain(qf, RQ, yr[0], RC, N, D, sb, lane);\n"
    "        K1_PART(1)\n")
K1_FIELDS = ("prologue", "probes", "window + dedup", "re-rank",
             "select + output")
K1_READ = """
extern "C" int {name}(void* host, size_t bytes) {{
  return (int)cudaMemcpyFromSymbol(host, g_k1, bytes);
}}
"""
K1_BATCHES = 8
# the cells --k1 stamps, in order
K1_CELLS = ("mixed dense x cp", "mixed tt x cp", "mixed tt8 x cp",
            "mixed cp x tt", "mixed dense x tt", "mixed cp x tt8",
            "mixed dense x tt8", "tt8 x tt8", "tt16 x tt8", "limits tt16",
            "dense-main", "mixed cp x dense", "mixed tt x dense", "dense-cp")
TT8_CELLS = {"mixed cp x tt8", "mixed dense x tt8", "tt8 x tt8",
             "tt16 x tt8"}


def stamp_k1(cuh: str) -> tuple[str, str]:
    """The K1 header stamped -> (its text, the form: "hooks" where the
    source carries ``K1_STAMP`` hooks, "first" for one without them,
    patched at its stage boundaries)."""
    head = "#include <stdint.h>\n"
    if "K1_STAMP(" in cuh:
        pairs = [(head, head + K1_MACROS)]
        if "K1_PART(" not in cuh and K1_PARTS_16_0[0] in cuh:
            pairs.append(K1_PARTS_16_0)
        return patch(cuh, pairs), "hooks"
    return patch(cuh, [
        (head, head + K1_MACROS),
        ("  const int warp = tid >> 5, lane = tid & 31;\n\n"
         "  // the query row the re-rank reads",
         "  const int warp = tid >> 5, lane = tid & 31;\n  K1_STAMP_BEGIN\n\n"
         "  // the query row the re-rank reads"),
        ("  for (int i = tid; i < 2 * wcap; i += kThreads) region[i] = "
         "kEmpty;\n  __syncthreads();\n",
         "  for (int i = tid; i < 2 * wcap; i += kThreads) region[i] = "
         "kEmpty;\n  __syncthreads();\n  K1_STAMP(0)\n"),
        ("    __syncthreads();\n    if (tid == 0) {\n      ncand_s = 0;\n",
         "    __syncthreads();\n    K1_STAMP(1)\n    if (tid == 0) {\n"
         "      ncand_s = 0;\n"),
        ("    __syncthreads();\n    const int n_cand = ncand_s;\n",
         "    __syncthreads();\n    K1_STAMP(2)\n"
         "    const int n_cand = ncand_s;\n"),
        ("    cp_async_wait<0>();\n  }\n  __syncthreads();\n",
         "    cp_async_wait<0>();\n    K1_STAMP(3)\n  }\n  __syncthreads();\n"
         "  K1_STAMP(3)\n"),
        ("    if (scratch_s) atomicAdd(scratch_queries, 1ull);\n  }\n}",
         "    if (scratch_s) atomicAdd(scratch_queries, 1ull);\n  }\n"
         "  K1_STAMP(4)\n  K1_STAMP_END(b)\n}"),
    ]), "first"


def k1_instance(fq, table, pair) -> tuple[int, int]:
    """(TR, QR) of K1's instantiation for a launch over ``table``, by the
    tree's own plan (older trees pick a cross pair's instantiation without
    the CP or TT operand's modes and dims)."""
    key = (table.layout, pair.q_layout, pair.rq, table.rc)
    try:
        return fq.instance(*key, pair.n_modes, pair.d)
    except TypeError:
        return fq.instance(*key)


def k1_one(tree: str, index: int, cells=None, stamped=True) -> None:
    """Stamp, build and run one tree's K1 on the cross-format and dense
    cells (``cells``: the tags to run, all by default; prints ``STAGES``
    lines)."""
    import ctypes
    import re
    root = Path(tree).resolve()
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(0, str(root))
    import torch
    import chip_smoke as cs
    import repro_torch  # noqa: F401  (sets the float32 matmul flags)
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_query as fq
    from repro_torch.serving.lsh_service import build_service
    out = HERE / "build" / "stages" / f"k1-{index}"
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(root / "src/repro_torch/kernels/csrc", out / "csrc")
    readers = {"fused_query.cu": "stages_k1_read",
               "fused_query_mixed.cu": "stages_k1m_read"}
    form = "unstamped"
    if stamped:
        cuh, form = stamp_k1((out / "csrc/fused_query.cuh").read_text())
        (out / "csrc/fused_query.cuh").write_text(cuh)
        for src, name in readers.items():
            f = out / "csrc" / src
            f.write_text(f.read_text() + K1_READ.format(name=name))
    _build.CSRC, _build.BUILD_ROOT = out / "csrc", out / "_build"
    lib = _build.lib()
    log = _build.BUILD_INFO["log"]
    regs, spills = {}, {}
    for m in re.finditer(r"Compiling entry function '(\w*fused_query_kernel"
                         r"\w*)'.*?(\d+) bytes spill stores.*?Used (\d+) "
                         r"registers", log, re.S):
        regs[m.group(1)] = int(m.group(3))
        spills[m.group(1)] = int(m.group(2))
    for name in readers.values() if stamped else ():
        getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cell = cs.CELLS["cp"]
    n = 1 << 20
    gen = torch.Generator(device="cuda").manual_seed(cell["seed"])
    corpus = cs.hash_fns("cp")["data"](gen, cell["dims"], cell["rhat"],
                                       batch=n)
    perm = torch.randperm(n, generator=gen, device="cuda")
    qids = [perm[i * 1024:(i + 1) * 1024] for i in range(K1_BATCHES)]
    cp_queries = [cs.make_queries(corpus, q, gen) for q in qids]
    queries = [cs.densify(q) for q in cp_queries]

    def run(tag, c, data, batches=queries, more=()):
        """Stamp ``tag`` on a ``c`` service over ``data``, then each of
        ``more`` ((tag, query batches)) on the same service."""
        if cells is not None and not {tag, *(m[0] for m in more)} & cells:
            return
        svc = build_service(torch.Generator(device="cuda").manual_seed(1),
                            c["kind"], c["dims"], data,
                            num_codes=c["codes"], num_tables=c["tables"],
                            rank=c["rank"], bucket_width=c["width"],
                            metric=c.get("metric", "euclidean"),
                            device="cuda")
        for t, b in ((tag, batches), *more):
            if cells is None or t in cells:
                stamp(t, svc, b)
        del svc

    def stamp(tag, svc, batches):
        idx, fam = svc.index, svc.index.family
        view = idx.store.view
        kernel, _, _ = cs.k1_entry(view)
        kw = dict(kind=fam.kind, w=fam.bucket_width,
                  num_tables=fam.num_tables, num_codes=fam.num_codes,
                  metric=idx.metric, topk=cs.TOPK, probes=1)
        qss = [q.stack() for q in batches]
        pair = fq.pair_shape(view.k1_table, qss[0])
        tr, qr = k1_instance(fq, view.k1_table, pair)
        mangled = f"ILi{tr}ELi{qr}E"
        reader = "stages_k1_read" if tr == qr else "stages_k1m_read"
        vals = [fam.raw_stacked(q[1], q[0].scale) for q in qss]
        args = [(v, fam.offsets, idx._mults_t, q) for v, q in zip(vals, qss)]
        ms = cs.cuda_ms([lambda a=a: kernel(*a, **kw) for a in args],
                        3 * len(args))
        _, _, ncand = kernel(*args[0], **kw)
        torch.cuda.synchronize()
        b = vals[0].shape[0]
        if not stamped:
            print("STAGES " + json.dumps(dict(
                tree=tree, form=form, kernel="K1", cell=tag,
                instance=[tr, qr], queries=b,
                ms=ms, registers=[v for k, v in regs.items() if mangled in k],
                spill_stores=[v for k, v in spills.items() if mangled in k],
                candidates_mean=float(ncand.double().mean()),
                candidates_max=float(ncand.max()))), flush=True)
            return
        buf = (ctypes.c_longlong * (b * 10))()
        err = getattr(lib, reader)(ctypes.addressof(buf), b * 80)
        if err:
            raise SystemExit(f"chip_stages: reading K1 stamps: error {err}")
        rows = [buf[10 * i:10 * i + 10] for i in range(b)]
        total = sum(r[5] for r in rows)
        shares = {f: sum(r[i] for r in rows) / total
                  for i, f in enumerate(K1_FIELDS)}
        _, _, smem = fq.launch_plan(view.k1_table, pair.rq,
                                    num_tables=kw["num_tables"], probes=1,
                                    topk=kw["topk"], expansion=0, pair=pair)
        occ = fq.occupancy(view.k1_table, pair.rq, smem, pair.q_layout)
        slots = sms * occ["blocks_per_sm"]
        starts = sorted(r[6] for r in rows)
        ends = sorted(r[7] for r in rows)
        span = ends[-1] - starts[0]
        busy = sum(r[7] - r[6] for r in rows)
        nc = ncand.double()
        warps = fq.SHAPES[tr, qr][0] // 32
        per_cand = sum(r[3] for r in rows) / max(float(nc.sum()), 1.0)
        # the re-rank's marked parts (yy, qy), where the source has them:
        # warp 0's cycles a candidate it scored, times the warps
        parts = {}
        if any(r[8] or r[9] for r in rows):
            rerank = sum(r[3] for r in rows)
            for i, name in ((8, "yy"), (9, "qy")):
                part = sum(r[i] for r in rows)
                parts[name] = dict(
                    share_of_rerank=part / rerank,
                    warp_cycles_per_candidate=part / max(
                        float(nc.sum()), 1.0) * warps)
        print("STAGES " + json.dumps(dict(
            tree=tree, form=form, kernel="K1", cell=tag, instance=[tr, qr],
            queries=b, ms=ms,
            registers={k: v for k, v in regs.items() if mangled in k},
            spill_stores=[v for k, v in spills.items() if mangled in k],
            blocks_per_sm=occ["blocks_per_sm"], smem=smem,
            candidates_mean=float(nc.mean()), candidates_max=float(nc.max()),
            cycles_per_query=total / b,
            max_cycles=max(r[5] for r in rows),
            rerank_cycles_per_candidate=per_cand, warps=warps,
            rerank_warp_cycles_per_candidate=per_cand * warps,
            span_us=span / 1e3,
            busy_share=busy / (span * min(slots, b)),
            drain_us=(ends[-1] - starts[-1]) / 1e3,
            shares=shares, rerank_parts=parts)), flush=True)

    from repro_torch.core.tensor_formats import cp_to_tt
    tt_queries = [cp_to_tt(q) for q in cp_queries]
    run("mixed dense x cp", cell, corpus,
        more=(("mixed tt x cp", tt_queries),
              ("mixed tt8 x cp", [cs.pad_tt(q, 8) for q in tt_queries])))
    c = dict(cs.CP_AS_TT, dims=cell["dims"])
    if cells is None or {"mixed cp x tt", "mixed dense x tt"} & cells:
        tt = cp_to_tt(corpus)
        run("mixed cp x tt", c, tt, cp_queries)
        run("mixed dense x tt", c, tt)
        del tt
        torch.cuda.empty_cache()
    if cells is None or TT8_CELLS & cells:
        # [tt8]: chip_smoke.phase_tt8's corpus and queries: CP, densified,
        # and as TT padded to rank 8 (<8, 8>) and to rank 16 (<16, 16>)
        m = 1 << 16
        base = corpus.index(slice(0, m))
        g8 = torch.Generator(device="cuda").manual_seed(cell["seed"] + 8)
        p8 = torch.randperm(m, generator=g8, device="cuda")
        cp8 = [cs.make_queries(base, p8[i * 1024:(i + 1) * 1024], g8)
               for i in range(K1_BATCHES)]
        tt8 = cs.pad_tt(cp_to_tt(base), 8)
        run("mixed cp x tt8", c, tt8, cp8,
            more=(("mixed dense x tt8", [cs.densify(q) for q in cp8]),
                  ("tt8 x tt8", [cs.pad_tt(cp_to_tt(q), 8) for q in cp8]),
                  ("tt16 x tt8",
                   [cs.pad_tt(cp_to_tt(q), 16) for q in cp8])))
        del tt8, base, cp8
        torch.cuda.empty_cache()
    if cells is None or "limits tt16" in cells:
        # chip_smoke.phase_limits' TT rank-16 index (<16, 16>, rows read in
        # place) and its 256 queries
        from repro_torch.core.tensor_formats import tt_random_data
        lt = cs.LIMITS["tt"]
        g16 = torch.Generator(device="cuda").manual_seed(29)
        tt16 = tt_random_data(g16, lt["dims"], lt["rhat"], batch=lt["n"])
        q16 = cs.make_queries(tt16, torch.arange(0, lt["n"], lt["every"],
                                                 device="cuda"), g16)
        run("limits tt16", dict(kind="tt-srp", dims=lt["dims"],
                                codes=lt["codes"], tables=lt["tables"],
                                rank=lt["rank"], width=1.0, metric="cosine"),
            tt16, [q16])
        del tt16, q16
        torch.cuda.empty_cache()
    dense_cells = {"dense-main", "mixed cp x dense", "mixed tt x dense",
                   "dense-cp"}
    if cells is not None and not dense_cells & cells:
        return
    dense = cs.densify(corpus)
    del corpus
    torch.cuda.empty_cache()
    run("dense-main", cs.DENSE["main"], dense,
        more=(("mixed cp x dense", cp_queries),
              ("mixed tt x dense", tt_queries)))
    torch.cuda.empty_cache()
    run("dense-cp", cs.DENSE["cp"], dense)
    torch.cuda.empty_cache()


def launch_shape(form, name, b, dims, rhat, rank, sms):
    """(grid blocks, block description) of a tree's launch at this shape."""
    n, d = len(dims), dims[0]
    if form == "first":
        from repro_torch.kernels.cp_gram import block_items
        from repro_torch.kernels.tt_inner import block_shape
        if name == "K3":
            bb, lb, kb = block_items(n, d, rhat, 10, 10, rank, b)
            return (-(-b // bb) * -(-10 // lb) * -(-10 // kb),
                    dict(block=f"{bb} items x {lb} tables", threads=bb * lb))
        bb, lb, kb = block_shape(d, rhat, rank, 10, 10, b)
        return (-(-b // bb) * -(-10 // lb) * -(-10 // kb),
                dict(block=f"{bb} items x {lb * kb} hashes",
                     threads=bb * lb * kb))
    if name == "K3":
        from repro_torch.kernels.cp_gram import plan
        lp = plan(b, 10, 10, rhat, rank, n, d, sms)
    else:
        from repro_torch.kernels.tt_inner import plan
        lp = plan(b, 10, 10, rhat, rank, d, sms)
    return lp.blocks, dict(block=f"{lp.block_items} items x "
                                 f"{lp.block_hashes} hashes",
                           threads=lp.threads, smem=lp.smem)


def parse(argv):
    """The command line (the module's docstring says what each mode does;
    ``--child INDEX`` runs one tree in this process, as ``main`` starts
    it)."""
    ap = argparse.ArgumentParser(
        prog="chip_stages.py", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("trees", nargs="+", metavar="TREE")
    ap.add_argument("--k1", action="store_true",
                    help="stamp K1 on its cells instead of K3 / K4")
    ap.add_argument("--cells", type=lambda s: set(s.split(",")),
                    help="with --k1: the cells to run, their tags "
                         f"comma-separated, of: {', '.join(K1_CELLS)}")
    ap.add_argument("--unstamped", action="store_true",
                    help="with --k1: build each tree's K1 as it is and "
                         "print its time, registers and spill bytes")
    ap.add_argument("--child", type=int, metavar="INDEX",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not args.k1 and (args.cells or args.unstamped):
        ap.error("--cells and --unstamped go with --k1")
    if args.cells and not args.cells <= set(K1_CELLS):
        ap.error(f"unknown cells {sorted(args.cells - set(K1_CELLS))}")
    if args.child is not None and len(args.trees) != 1:
        ap.error("--child runs one tree")
    return args


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    if args.child is not None:
        if args.k1:
            k1_one(args.trees[0], args.child, args.cells,
                   not args.unstamped)
        else:
            one(args.trees[0], args.child)
        return 0
    flags = ["--k1"] if args.k1 else []
    if args.cells:
        flags += ["--cells", ",".join(sorted(args.cells))]
    if args.unstamped:
        flags.append("--unstamped")
    for i, tree in enumerate(args.trees):
        proc = subprocess.run([sys.executable, __file__, *flags, "--child",
                               str(i), tree], capture_output=True,
                              text=True, timeout=900)
        lines = [x for x in proc.stdout.splitlines()
                 if x.startswith("STAGES ")]
        if proc.returncode != 0 or not lines:
            print(f"chip_stages: {tree} failed:\n{proc.stdout[-2000:]}"
                  f"{proc.stderr[-4000:]}")
            return 1
        print("\n".join(lines), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
