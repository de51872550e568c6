"""The exact reference of the port, ``brute_force`` / ``brute_force_batch``
(``repro_torch.core.index``), on the CPU.

* A query's row does not depend on the batch it comes in: ``brute_force``
  of query i equals row i of ``brute_force_batch`` bit for bit, as do the
  rows of a permuted sub-batch, for same-format and cross-format pairs
  and both metrics. (The contractions' BLAS reductions order their sums
  by the operands' shapes, so the scores are formed a query row at a
  time.)
* The scores against the one-pass batched contraction (every query
  against every item at once): ids equal except at near ties, scores
  within ``parity.rerank_bound``.
"""

import numpy as np
import pytest
import torch

import torch_bridge as tb
from repro_torch.core import brute_force, brute_force_batch, contractions
from repro_torch.core.index import _score_matrix
from repro_torch.core.projections import densify_batch
from repro_torch.core.tensor_formats import DenseTensor, cp_to_tt
from repro_torch.kernels import parity

N, B, TOPK = 53, 11, 5


def _formats(layout, leaves):
    cp = tb.torch_cp(leaves, 0.5)
    if layout == "cp":
        return cp
    if layout == "tt":
        return cp_to_tt(cp)
    return DenseTensor(densify_batch(cp).reshape((-1,) + cp.dims), cp.dims)


def _pair(qf, cf, seed=6):
    corpus, queries = tb.cp_fixture(N, B, seed=seed)
    return _formats(qf, queries), _formats(cf, corpus)


def _one_pass(metric, queries, corpus):
    """The batched form: every query against every item in one
    contraction."""
    qq = queries.self_inners()
    yy = corpus.self_inners()
    qy = contractions.pair_inners(queries.index((slice(None), None)),
                                  corpus.index((None,)))
    if metric == "euclidean":
        return torch.sqrt(torch.clamp(qq[:, None] + yy[None] - 2.0 * qy,
                                      min=0.0))
    return qy / (torch.sqrt(torch.clamp(qq, min=0.0))[:, None]
                 * torch.sqrt(torch.clamp(yy, min=0.0))[None])


PAIRS = [("cp", "cp"), ("tt", "tt"), ("dense", "dense"), ("dense", "cp"),
         ("cp", "tt"), ("tt", "dense")]


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("qf,cf", PAIRS)
def test_a_row_does_not_depend_on_its_batch(qf, cf, metric):
    queries, corpus = _pair(qf, cf)
    ids, scores = brute_force_batch(metric, queries, corpus, TOPK)
    for i in range(B):
        got = brute_force(metric, queries.index(i), corpus, TOPK)
        np.testing.assert_array_equal(got[0], ids[i])
        np.testing.assert_array_equal(got[1].view(np.int32),
                                      scores[i].view(np.int32))
    order = np.random.default_rng(1).permutation(B)[:7]
    sub_ids, sub_scores = brute_force_batch(
        metric, queries.index(torch.from_numpy(order)), corpus, TOPK)
    np.testing.assert_array_equal(sub_ids, ids[order])
    np.testing.assert_array_equal(sub_scores.view(np.int32),
                                  scores[order].view(np.int32))


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("qf,cf", PAIRS)
def test_matches_the_one_pass_contraction(qf, cf, metric):
    queries, corpus = _pair(qf, cf, seed=8)
    ids, scores = brute_force_batch(metric, queries, corpus, TOPK)
    full = _one_pass(metric, queries, corpus)
    order = torch.argsort(full if metric == "euclidean" else -full, dim=1,
                          stable=True)[:, :TOPK]
    want_ids, want = order, torch.gather(full, 1, order)
    tol = parity.rerank_bound(metric, queries, corpus, want_ids, want)
    got_ids, got = torch.from_numpy(ids), torch.from_numpy(scores)
    assert parity.topk_mismatches(got_ids, got, want_ids, want, tol) == 0
    same = got_ids == want_ids
    assert bool(((got - want).abs()[same] <= tol[same]).all())
    assert ids.dtype == np.int64 and ids.shape == (B, TOPK)


def test_empty_batch_and_chunked_corpus():
    queries, corpus = _pair("cp", "cp")
    ids, scores = brute_force_batch("euclidean", queries.index(slice(0, 0)),
                                    corpus, TOPK)
    assert ids.shape == (0, TOPK) and scores.shape == (0, TOPK)
    whole = _score_matrix("euclidean", queries, corpus)
    assert whole.shape == (B, N)
    chunked = _score_matrix("euclidean", queries, corpus, chunk=7)
    tol = parity.rerank_bound("euclidean", queries, corpus,
                              torch.arange(N).expand(B, N), whole)
    assert bool(((chunked - whole).abs() <= tol).all())
