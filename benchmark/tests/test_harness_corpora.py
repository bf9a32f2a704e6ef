"""The device corpus generator, on the CPU at a small scale."""

import numpy as np
import pytest
from corpora import topic_mixture

SPEC = {"generator": "topic_mixture", "n_docs": 300, "n_words": 500, "n_topics": 6,
        "tokens_per_doc": 40, "doc_topic_alpha": 0.2, "zipf_exponent": 1.05, "n_heldout": 120}


def test_shapes_counts_and_split():
    c = topic_mixture.make(SPEC, 2**31 + 5, "cpu")
    X, H = c["train"], c["heldout"]
    assert X.shape == (300, 500) and H.shape == (120, 500)
    for M in (X, H):
        assert M.data.dtype == np.int64 and M.indices.dtype == np.int32
        assert M.has_sorted_indices and M.has_canonical_format
        assert (M.data > 0).all()
        lengths = np.asarray(M.sum(axis=1)).ravel()
        assert lengths.min() >= 20  # Poisson + 20 tokens: no empty document
    # every token is counted once: tokens a document average about 40 + 20
    assert 50 < np.asarray(X.sum(axis=1)).mean() < 70


def test_same_seed_same_corpus_other_seed_other():
    a = topic_mixture.make(SPEC, 7, "cpu")["train"]
    b = topic_mixture.make(SPEC, 7, "cpu")["train"]
    c = topic_mixture.make(SPEC, 8, "cpu")["train"]
    assert (a != b).nnz == 0
    assert (a != c).nnz > 0


@pytest.mark.parametrize("block", [64, 1 << 23])
def test_token_blocks_do_not_change_the_draws_count(block, monkeypatch):
    monkeypatch.setattr(topic_mixture, "TOKEN_BLOCK", block)
    X = topic_mixture.make(SPEC, 11, "cpu")["train"]
    assert X.shape == (300, 500) and X.nnz > 0


def test_twenty_newsgroups_nnz_a_document():
    """The 20NG configuration's 155 tokens give twenty_newsgroups_shape's
    143.9 nonzeros a document (2,711,701 over 18,846) within 2 %."""
    import json
    from pathlib import Path

    spec = json.loads((Path(__file__).parents[1] / "configs" / "20ng-k20.json").read_text())
    per_doc = topic_mixture.nnz_per_doc(spec["corpus"], seed=3, n_docs=3000)
    assert abs(per_doc / (2_711_701 / 18_846) - 1) < 0.02
