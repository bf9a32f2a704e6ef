"""Seeded synthetic bag-of-words corpora with known topic structure.

A NumPy copy of ``enstop_tpu/synthetic.py``, so the port builds the same
corpus for the same seed without importing the JAX package.

This environment has no network access, so the reference's 20-Newsgroups
evaluation corpus (notebooks/EnsTop with 20-Newsgroups.ipynb) cannot be fetched.
These generators produce corpora with 20NG's shape — Zipfian vocabulary, latent
topic mixture documents — plus ground-truth dominant-topic labels, so the
notebook's end-to-end evaluation (argmax doc clustering scored with ARI/AMI
against labels) can be reproduced hermetically.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = ["synthetic_corpus", "twenty_newsgroups_shape", "sparse_corpus"]


def synthetic_corpus(
    n_docs=2000,
    n_words=5000,
    n_topics=20,
    tokens_per_doc=120,
    doc_topic_alpha=0.2,
    zipf_exponent=1.05,
    background_weight=0.0,
    seed=0,
):
    """Generate ``(X_csr, labels)``: a topic-mixture corpus and each document's
    dominant latent topic (the notebook's clustering ground truth).

    ``background_weight``: probability that a token is drawn from the global
    Zipf background instead of its topic's distribution — shared stop-word-like
    mass that makes recovery 20NG-hard instead of clean-synthetic-easy.  The
    default 0.0 draws nothing extra from the RNG stream, so corpora generated
    before this knob existed are bit-identical."""
    rng = np.random.RandomState(seed)
    zipf = 1.0 / np.arange(1, n_words + 1) ** zipf_exponent
    zipf /= zipf.sum()
    topics = np.stack([np.roll(zipf, rng.randint(n_words)) for _ in range(n_topics)])
    topics_cdf = np.cumsum(topics, axis=1)
    doc_topic = rng.dirichlet(np.full(n_topics, doc_topic_alpha), size=n_docs)
    labels = np.argmax(doc_topic, axis=1)

    lengths = rng.poisson(tokens_per_doc, size=n_docs) + 20
    doc_ids = np.repeat(np.arange(n_docs), lengths)
    T = doc_ids.shape[0]

    # per-token topic via the Gumbel trick (vectorized categorical sampling)
    g = rng.gumbel(size=(T, n_topics))
    tok_topic = np.argmax(np.log(doc_topic[doc_ids] + 1e-12) + g, axis=1)

    # per-token word via inverse-CDF within each topic group
    tok_word = np.empty(T, dtype=np.int64)
    u = rng.random_sample(T)
    for z in range(n_topics):
        mask = tok_topic == z
        tok_word[mask] = np.searchsorted(topics_cdf[z], u[mask])
    if background_weight > 0.0:
        bg = rng.random_sample(T) < background_weight
        tok_word[bg] = np.searchsorted(np.cumsum(zipf), u[bg])
    tok_word = np.clip(tok_word, 0, n_words - 1)

    # integer dtype: these are raw term counts, which the estimators pass
    # through unchanged (float inputs are treated as pre-normalized data and
    # get l1-row-normalized by standardize_input, reference utils.py:276-280)
    X = sp.csr_matrix(
        (np.ones(T, np.int64), (doc_ids, tok_word)), shape=(n_docs, n_words)
    )
    X.sum_duplicates()
    return X, labels


def twenty_newsgroups_shape(seed=0):
    """A corpus with the reference benchmark's exact scale (~18.8k docs, 25k
    vocab, ~2.7M nnz, 20 topics) — the shape behind BASELINE.md's numbers."""
    return synthetic_corpus(
        n_docs=18846, n_words=25000, n_topics=20, tokens_per_doc=155, seed=seed
    )


def sparse_corpus(n, m, nnz, seed=0):
    """A Zipf-vocabulary count matrix of ``nnz`` draws, the JAX package's
    sparse benchmark corpus (a NumPy copy of ``synth`` in
    ``scripts/bench_sparse.py``): rows uniform, columns Zipf with exponent
    1.05 (word 0 takes about a tenth of the draws at 141,000 words), counts
    1 + Poisson(1.2), duplicates summed. ``sparse_corpus(250_000, 141_000,
    19_000_000)`` is its config C, ``(100_000, 141_000, 6_200_000)`` C'."""
    rng = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, m + 1) ** 1.05
    p /= p.sum()
    rows = rng.randint(0, n, nnz).astype(np.int64)
    cols = rng.choice(m, size=nnz, p=p).astype(np.int64)
    vals = (1 + rng.poisson(1.2, nnz)).astype(np.float32)
    X = sp.coo_matrix((vals, (rows, cols)), shape=(n, m)).tocsr()
    X.sum_duplicates()
    return X
