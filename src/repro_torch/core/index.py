"""The device-resident (K, L) LSH index (reference: ``repro.core.index``).

``DeviceLSHIndex.build`` hashes a CP or TT corpus in batches through K3
(CP) or K4 (TT) (``segments.bucket_keys``), sorts each table once and keeps
one immutable base segment that holds the corpus stacked in the kernels'
layout; ``query_batch`` runs K3 / K4 (``raw``) and K1 per query batch.
Everything lives on the index's ``device`` ("cuda" unless the caller asks
for the CPU, where the kernels' plain versions run).

This slice serves the immutable base segment with the exact default cap,
single-probe top-k queries. Mutations (insert / delete / compact), the
explicit ``bucket_cap``, multi-probe and the sampling modes are queued
(ROADMAP.md), as are the sharded and host indexes.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.core import segments
from repro_torch.core.lsh import LSHFamily, make_mults
from repro_torch.core.segments import StoreView, bucket_keys, build_segment
from repro_torch.kernels.ops import mults_tensor

QUERY_MODES = ("topk", "uniform", "weighted")


def _check_metric(metric: str) -> None:
    if metric not in ("euclidean", "cosine"):
        raise ValueError(metric)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class DeviceLSHIndex:
    """Device-resident (K, L) index over a batched CP or TT corpus (the
    family's format); ``query_batch``
    returns (ids (B, topk) int32 with -1 fill, scores (B, topk) float32 with
    +inf / -inf fill, n_candidates (B,) int32) on the family's device."""

    family: LSHFamily
    metric: str = "euclidean"  # or "cosine"
    seed: int = 0
    bucket_cap: int | None = None

    store: StoreView | None = None
    hash_s: float = 0.0        # build time in the K3 / K4 hash, synchronized
    sort_s: float = 0.0        # build time in the table sort, synchronized

    def __post_init__(self):
        _check_metric(self.metric)
        if self.bucket_cap is not None:
            raise NotImplementedError(
                "bucket_cap (the live-window probe) is queued in ROADMAP.md; "
                "this slice serves the exact default cap")
        self._mults = make_mults(self.seed, self.family.num_codes)
        self._mults_t = mults_tensor(self._mults, self.device)

    @property
    def device(self) -> torch.device:
        return self.family.device

    @property
    def size(self) -> int:
        return self.store.base.slots if self.store is not None else 0

    @property
    def cap(self) -> int:
        return self.store.base.cap

    @property
    def sorted_keys(self) -> torch.Tensor:
        return self.store.base.sorted_keys

    @property
    def perm(self) -> torch.Tensor:
        return self.store.base.perm

    def effective_corpus(self):
        """The live corpus the returned ids index into."""
        return self.store.base.corpus

    def build(self, corpus, batch_size: int = 65536) -> "DeviceLSHIndex":
        """Hash ``corpus`` in batches of ``batch_size`` and sort the tables.
        Keys do not depend on the batch size; 65536 items per hash launch
        keep the card busy (the reference hashes 2048 at a time)."""
        if corpus.device != self.device:
            raise ValueError(f"corpus on {corpus.device}, family on "
                             f"{self.device}")
        self.family.check_inputs(corpus)
        _sync(self.device)
        t0 = time.perf_counter()
        keys = bucket_keys(self.family, self._mults_t, corpus, batch_size)
        _sync(self.device)
        t1 = time.perf_counter()
        seg = build_segment(keys, corpus, warn_layout=type(self).__name__)
        _sync(self.device)
        self.hash_s, self.sort_s = t1 - t0, time.perf_counter() - t1
        self.store = StoreView.base_only(seg)
        return self

    def query_batch(self, queries, topk: int = 10, *,
                    probes: int = 1, mode: str = "topk", rng=None):
        """-> (ids (B, topk), scores (B, topk), n_candidates (B,)) tensors:
        K3 / K4 projects the batch, K1 probes, re-ranks and selects."""
        if mode not in QUERY_MODES:
            raise ValueError(
                f"unknown query mode {mode!r}; expected one of {QUERY_MODES}")
        if mode != "topk":
            raise NotImplementedError(
                f"mode={mode!r} (sampling from the probed union) is queued in "
                "ROADMAP.md")
        view = self.store
        return segments.segmented_query(
            self.family, view.all_arrays, self._mults_t, queries,
            metric=self.metric, topk=topk, caps=view.all_caps,
            probes=int(probes))


# ---------------------------------------------------------------------------
# References / evaluation
# ---------------------------------------------------------------------------


def _score_matrix(metric: str, queries, corpus,
                  chunk: int | None = None) -> torch.Tensor:
    """(B, n) exact in-format scores, the corpus taken ``chunk`` items at a
    time (by default 2^21 floats of item rows, so that the (B, chunk) Grams
    or TT chain steps bound the memory)."""
    if chunk is None:
        chunk = max(1, (1 << 21) // corpus.row_floats)
    qq = queries.self_inners()
    qb = queries.index((slice(None), None))
    n = corpus.leaves[0].shape[0]
    out = []
    for s in range(0, n, chunk):
        part = corpus.index(slice(s, min(s + chunk, n)))
        yy = part.self_inners()
        qy = qb.pair_inners(part.index((None,)))
        if metric == "euclidean":
            d2 = qq[:, None] + yy[None] - 2.0 * qy
            out.append(torch.sqrt(torch.clamp(d2, min=0.0)))
        else:
            nq = torch.sqrt(torch.clamp(qq, min=0.0))
            ny = torch.sqrt(torch.clamp(yy, min=0.0))
            out.append(qy / (nq[:, None] * ny[None]))
    return torch.cat(out, dim=1)


def brute_force_batch(metric: str, queries, corpus, topk: int = 10):
    """Exact top-k over the whole corpus -> (ids (B, topk) int64 numpy,
    scores (B, topk) numpy); score ties resolve to the lower id."""
    _check_metric(metric)
    scores = _score_matrix(metric, queries, corpus)
    order = torch.argsort(scores if metric == "euclidean" else -scores,
                          dim=1, stable=True)[:, :topk]
    return (order.cpu().numpy(),
            torch.gather(scores, 1, order).cpu().numpy())


def recall_at_k(index, queries, topk: int = 10,
                probes: int = 1) -> dict[str, float]:
    """Mean recall@k of ``index.query_batch`` against brute force."""
    truth, _ = brute_force_batch(index.metric, queries,
                                 index.effective_corpus(), topk)
    ids, _, n_cand = index.query_batch(queries, topk=topk, probes=probes)
    ids = ids.cpu().numpy()
    n_q = truth.shape[0]
    hits = sum(len(set(t) & set(row[row >= 0].tolist()))
               for t, row in zip(truth.tolist(), ids))
    return {
        "recall": hits / max(n_q * topk, 1),
        "mean_candidates": float(n_cand.sum().item()) / max(n_q, 1),
        "corpus_size": index.size,
    }
