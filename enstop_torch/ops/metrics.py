"""Topic-quality metrics: log lift and UMass-style coherence (a copy of
``enstop_tpu/ops/metrics.py``, which is numpy and scipy only).

Vectorised forms of the reference's numba metrics: the document
co-occurrence counts of a topic's top words come from one boolean Gram
matrix ``(X[:, top] > 0)^T @ (X[:, top] > 0)``. They run on the host: the
inputs are the top-n columns of the corpus, and the metrics are diagnostics
after a fit, not part of the EM loop.
"""

from __future__ import annotations

import numpy as np
from scipy.sparse import issparse, csc_matrix

from ..utils import normalized

__all__ = [
    "log_lift",
    "mean_log_lift",
    "coherence",
    "mean_coherence",
]


def _empirical_word_probs(data):
    probs = np.array(data.sum(axis=0)).squeeze().astype(np.float64)
    return probs / probs.sum()


def _log_lift_single(topics_row, empirical_probs, n=-1):
    """Reference utils.py:44-85: mean of P(w|z)/P(w) over top-n (or all) words."""
    if n <= 0:
        mask = empirical_probs > 0
        total = np.sum(topics_row[mask] / empirical_probs[mask])
        return np.log(total / topics_row.shape[0])
    top_words = np.argsort(topics_row)[-n:]
    probs = empirical_probs[top_words]
    mask = probs > 0
    total = np.sum(topics_row[top_words][mask] / probs[mask])
    return np.log(total / n)


def log_lift(topics, z, data, n_words=-1):
    """Log lift of one topic (reference utils.py:88-117)."""
    normalized_topics = normalized(np.array(topics, dtype=np.float64), axis=1)
    empirical_probs = _empirical_word_probs(data)
    return _log_lift_single(normalized_topics[z], empirical_probs, n=n_words)


def mean_log_lift(topics, data, n_words=-1):
    """Average log lift over all topics (reference utils.py:120-147).

    Note: the reference normalizes a copy but then evaluates the *unnormalized*
    topics (utils.py:142-146); since pLSA topics are already l1-normalized the two
    agree — we evaluate the normalized topics.
    """
    normalized_topics = normalized(np.array(topics, dtype=np.float64), axis=1)
    empirical_probs = _empirical_word_probs(data)
    return float(
        np.mean(
            [
                _log_lift_single(normalized_topics[z], empirical_probs, n=n_words)
                for z in range(topics.shape[0])
            ]
        )
    )


def _coherence_single(topics, z, n, Xbool_csc, n_docs_per_word):
    """Reference utils.py:160-204: sum over ordered top-word pairs (i<j, words in
    ascending-probability order) of log((co_occur + 1) / n_docs_per_word[w_i])."""
    top_words = np.argsort(topics[z])[-n:]
    sub = Xbool_csc[:, top_words]  # (n_docs, n)
    co = np.asarray((sub.T @ sub).todense()).astype(np.float64)  # pair co-occurrence
    denom = n_docs_per_word[top_words].astype(np.float64)
    total = 0.0
    for i in range(n - 1):
        if denom[i] == 0:
            continue
        total += np.sum(np.log((co[i, i + 1 :] + 1.0) / denom[i]))
    return total


def _as_bool_csc(data):
    if issparse(data):
        csc = data.tocsc()
    else:
        csc = csc_matrix(np.asarray(data))
    out = csc.copy()
    out.data = (out.data > 0).astype(np.float64)
    out.eliminate_zeros()
    return out


def coherence(topics, z, data, n_words=20):
    """Coherence of one topic (reference utils.py:207-240)."""
    Xb = _as_bool_csc(data)
    n_docs_per_word = np.array((Xb > 0).sum(axis=0)).squeeze()
    return _coherence_single(np.asarray(topics), z, n_words, Xb, n_docs_per_word)


def mean_coherence(topics, data, n_words=20):
    """Average coherence over all topics (reference utils.py:243-273)."""
    topics = np.asarray(topics)
    Xb = _as_bool_csc(data)
    n_docs_per_word = np.array((Xb > 0).sum(axis=0)).squeeze()
    return float(
        np.mean(
            [
                _coherence_single(topics, z, n_words, Xb, n_docs_per_word)
                for z in range(topics.shape[0])
            ]
        )
    )
