"""Hash epilogues and probe helpers as plain PyTorch (reference:
``repro.kernels.epilogues``).

The first half turns a (B, L, K) block of scaled raw <P, X> values into the
fused hash output; the CUDA kernel K3 computes the same thing in registers:

  "raw"        (B, L, K) float32   the values themselves
  "e2lsh"      (B, L, K) int32     floor((v + b) / w)
  "srp"        (B, L, K) int32     1 iff v > 0
  "e2lsh-keys" (B, L)    uint32    radix combine of the e2lsh codes
  "srp-keys"   (B, L)    uint32    radix combine of the srp codes
  "srp-packed" (B, L, K/32) uint32 sign bits packed little-endian

uint32 values live in int64 tensors in [0, 2^32) (PyTorch has no unsigned
searchsorted, sum or shift), masked with ``U32_MASK`` after every wrap.

The second half is the probe epilogue the query path composes (binary
search, cap-wide masked window gather, sort-dedup, order-key packing and the
packed top-k). ``kernels.fused_query.fused_query_plain`` is built from these
exactly as the reference's ``_fused_query_kernel`` composes them; the CUDA
kernel K1 runs the same stages in shared memory.
"""

from __future__ import annotations

import torch

EPILOGUES = ("raw", "e2lsh", "srp", "e2lsh-keys", "srp-keys", "srp-packed")

U32_MASK = 0xFFFFFFFF
# Packed-selection sentinels, with the reference's unsigned meaning: an
# invalid slot carries the largest uint32 order key and the largest int32 id.
PROBE_PAD_KEY = 0xFFFFFFFF
PROBE_PAD_ID = 0x7FFFFFFF


def mul_u32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod 2^32 for int64 tensors holding uint32 values, without
    int64 overflow: b is split into 16-bit halves, every partial product
    stays below 2^48."""
    lo = a * (b & 0xFFFF)
    hi = (a * (b >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & U32_MASK


def div_w(x: torch.Tensor, w: float) -> torch.Tensor:
    """x / w in float32 as a true division. A tensor divisor on purpose:
    PyTorch's CUDA division by a Python scalar multiplies by its reciprocal,
    which floors differently next to bucket edges (ROADMAP.md, R4)."""
    return x / torch.full_like(x, w)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """{0, 1} (or bool) along the last axis -> uint32 words in int64, bit j
    of word w = bits[..., 32w + j] (little-endian; the tail word padded
    with zeros)."""
    k = bits.shape[-1]
    b64 = torch.nn.functional.pad(bits.to(torch.int64), (0, -k % 32))
    words = b64.reshape(*bits.shape[:-1], -(-k // 32), 32)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    return (words << shifts).sum(-1)


def as_int32_bits(u: torch.Tensor) -> torch.Tensor:
    """int64 uint32 values -> int32 tensor with the same bit patterns."""
    return (u - ((u >> 31) << 32)).to(torch.int32)


def out_struct(b: int, l: int, k: int, epilogue: str):
    """(shape, dtype) of a fused hash output."""
    if epilogue == "raw":
        return (b, l, k), torch.float32
    if epilogue in ("e2lsh", "srp"):
        return (b, l, k), torch.int32
    if epilogue in ("e2lsh-keys", "srp-keys"):
        return (b, l), torch.int64
    if epilogue == "srp-packed":
        return (b, l, -(-k // 32)), torch.int64
    raise ValueError(f"epilogue must be one of {EPILOGUES}, got {epilogue!r}")


def apply_epilogue(v: torch.Tensor, offs: torch.Tensor | None,
                   mults: torch.Tensor | None, *, epilogue: str,
                   w: float) -> torch.Tensor:
    """(B, L, K) scaled raw values -> the fused hash output.

    offs: (L, K) float32 E2LSH offsets (ignored by srp/raw); mults: (K,)
    uint32 values in int64 (read by the *-keys modes only).
    """
    out_struct(*v.shape, epilogue)  # validates the mode
    if epilogue == "raw":
        return v
    if epilogue.startswith("e2lsh"):
        codes = torch.floor(div_w(v + offs.reshape(v.shape[1:])[None], w))
        codes = codes.to(torch.int32)
    else:
        codes = (v > 0).to(torch.int32)
    if epilogue in ("e2lsh", "srp"):
        return codes
    if epilogue.endswith("keys"):
        u = codes.to(torch.int64) & U32_MASK
        return mul_u32(u, mults.reshape(-1).to(torch.int64)).sum(-1) & U32_MASK
    return pack_bits(codes)     # srp-packed


# ---------------------------------------------------------------------------
# Probe epilogue: bucket windows -> dedup -> packed (id, score) selection
# ---------------------------------------------------------------------------


def probe_windows(sorted_keys, perm, keys, cap, live, win=None):
    """Raw probe windows, pre-dedup -> (ids (B, W) local ids, hit (B, W)).

    ``keys`` is (L, B) single-probe or (L, T, B) multi-probe; the probe axis
    folds into the window axis W = L[*T]*cap, query-major, table-major,
    probe-major, window-minor. The same local id recurs once per probed
    bucket that holds it; ``dedup_windows`` masks the recurrences.

    Dense window (``win`` None): gather the first ``cap`` sorted positions
    after the side='left' binary search and keep the slots still inside the
    bucket (same key) whose item is live (``live`` is the (m+1,) lookup,
    entry m False). Live window (``win`` = (live_rank (L, m+1), live_pos
    (L, m))): the bucket's live members hold the live ranks
    [live_rank[start], live_rank[end]) with ``end`` from the side='right'
    search over the whole table, and slot j gathers perm[live_pos[rank0 +
    j]] while rank0 + j is below that bound: live and in-bucket by
    construction, so no key or liveness re-check.
    """
    nt, m = sorted_keys.shape
    lead = keys.shape[1:]                                 # ([T,] B)
    flat = keys.reshape(nt, -1).contiguous()
    top = max(m - 1, 0)
    starts = torch.searchsorted(sorted_keys, flat, side="left")
    if win is None:
        pos = starts[..., None] + torch.arange(cap, device=keys.device)
        posc = torch.clamp(pos, max=top).reshape(nt, -1)
        key_at = torch.gather(sorted_keys, 1, posc).reshape(pos.shape)
        ids = torch.gather(perm, 1, posc).reshape(pos.shape)
        hit = (pos < m) & (key_at == flat[..., None]) & live[ids.long()]
    else:
        live_rank, live_pos = win
        ends = torch.searchsorted(sorted_keys, flat, side="right")
        rank0 = torch.gather(live_rank, 1, starts)
        rank_end = torch.gather(live_rank, 1, ends)
        j = rank0[..., None] + torch.arange(cap, device=keys.device)
        hit = j < rank_end[..., None]
        jc = torch.clamp(j, max=top).reshape(nt, -1)
        pos = torch.gather(live_pos, 1, jc).long()
        ids = torch.gather(perm, 1, pos).reshape(j.shape)
    b = lead[-1]
    ids = ids.reshape(nt, *lead, cap).movedim(-2, 0).reshape(b, -1)
    hit = hit.reshape(nt, *lead, cap).movedim(-2, 0).reshape(b, -1)
    return ids, hit


def dedup_windows(ids, hit, m):
    """(ids, hit) raw windows -> (cand (B, W) sorted local ids, valid).

    Each row's hits sorted ascending (misses carry the ``m`` sentinel and
    sink to the tail), duplicates masked, so each local id appears at most
    once. ``cand`` keeps the sentinel on invalid slots."""
    b = ids.shape[0]
    cand = torch.sort(torch.where(hit, ids, m), dim=1).values
    dup = torch.cat([torch.zeros((b, 1), dtype=torch.bool, device=ids.device),
                     cand[:, 1:] == cand[:, :-1]], dim=1)
    valid = (cand < m) & ~dup
    return cand, valid


def order_key_bits(metric, scores):
    """f32 scores -> uint32 keys (int64) whose unsigned order is the
    metric's rank order (ascending distance / descending similarity): flip
    all bits of negatives, set the sign bit of non-negatives. Bijective."""
    order = scores if metric == "euclidean" else -scores
    bits = order.contiguous().view(torch.int32).to(torch.int64) & U32_MASK
    return torch.where((bits >> 31) != 0, (~bits) & U32_MASK,
                       bits | 0x80000000)


def decode_order_key(metric, key32):
    """Inverse of ``order_key_bits``, exact on every bit pattern."""
    bits = torch.where((key32 >> 31) != 0, key32 & 0x7FFFFFFF,
                       (~key32) & U32_MASK)
    order = as_int32_bits(bits).view(torch.float32)
    return order if metric == "euclidean" else -order


def pack_candidates(metric, eid, scores, valid):
    """Scored candidates -> (hi (B, W) uint32 order keys in int64, lo (B, W)
    int32 effective ids), pad key / pad id on invalid slots."""
    key32 = order_key_bits(metric, scores)
    hi = torch.where(valid, key32, PROBE_PAD_KEY)
    lo = torch.where(valid, eid.to(torch.int32), PROBE_PAD_ID)
    return hi, lo


def packed_select(metric, topk, hi, lo):
    """Packed top-k: one sort on the (order key, effective id) pair ->
    (ids (B, topk) with -1 fill, scores (B, topk) with +inf / -inf fill).

    The pair is folded into one signed int64, (hi - 2^31) * 2^32 + lo, whose
    order is the lexicographic (hi, lo) order (lo is a non-negative int32).
    """
    b, width = hi.shape
    packed = (hi - (1 << 31)) * (1 << 32) + lo.to(torch.int64)
    s = torch.sort(packed, dim=1).values
    k = min(topk, width)
    s = s[:, :k]
    shi = (s >> 32) + (1 << 31)
    slo = (s & U32_MASK).to(torch.int32)
    sv = shi != PROBE_PAD_KEY
    bad = float("inf") if metric == "euclidean" else float("-inf")
    ids = torch.where(sv, slo, -1)
    scores = torch.where(sv, decode_order_key(metric, shi), bad)
    if k < topk:
        ids = torch.nn.functional.pad(ids, (0, topk - k), value=-1)
        scores = torch.nn.functional.pad(scores, (0, topk - k), value=bad)
    return ids, scores
