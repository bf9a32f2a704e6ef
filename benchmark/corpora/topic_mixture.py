"""Topic-mixture bag-of-words corpora, made on the device from a seed.

The semantics of ``enstop_torch/synthetic.py``'s ``synthetic_corpus``,
rewritten as torch on the device so that a run pays no host generation:
each latent topic is a Zipf distribution over the vocabulary, rolled by a
random offset (drawing word ``j`` from the Zipf law and emitting
``(j + offset) mod n_words`` is drawing from the rolled law); each document
mixes the topics by a Dirichlet(``doc_topic_alpha``) draw, has
Poisson(``tokens_per_doc``) + 20 tokens, and draws each token's topic from
its mixture and the token's word from that topic. Repeated words are summed
into int64 counts. The held-out documents (``n_heldout``) come from the
same topics and are the last rows drawn.

Every draw comes from one ``torch.Generator`` on ``device`` seeded with the
run's seed, in a fixed order and in blocks of a fixed size, so a seed gives
the same corpus on the same kind of device. Nothing is written to disk.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

TOKEN_BLOCK = 1 << 23  # tokens drawn at once: bounds the (block, topics) gathers


def _csr(keys, counts, n_docs, n_words):
    rows = torch.div(keys, n_words, rounding_mode="floor")
    indptr = torch.zeros(n_docs + 1, dtype=torch.int64, device=keys.device)
    indptr[1:] = torch.bincount(rows, minlength=n_docs).cumsum(0)
    return sp.csr_matrix(
        (counts.cpu().numpy(), (keys % n_words).to(torch.int32).cpu().numpy(),
         indptr.to(torch.int32).cpu().numpy()), shape=(n_docs, n_words))


def make(spec, seed, device):
    """``{"train": csr, "heldout": csr or None}`` for the corpus ``spec`` (the
    ``corpus`` group of a configuration file), both int64 counts with int32
    indices, sorted and free of duplicates."""
    n_train, n_words = int(spec["n_docs"]), int(spec["n_words"])
    n_docs = n_train + int(spec.get("n_heldout", 0))
    n_topics = int(spec["n_topics"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    f64 = dict(dtype=torch.float64, device=device)

    zipf_cdf = torch.cumsum(
        torch.arange(1, n_words + 1, **f64) ** -float(spec["zipf_exponent"]), 0)
    zipf_cdf /= zipf_cdf[-1].clone()
    offsets = torch.randint(0, n_words, (n_topics,), generator=gen, device=device)
    gamma = torch._standard_gamma(
        torch.full((n_docs, n_topics), float(spec["doc_topic_alpha"]), **f64), generator=gen)
    topic_cdf = torch.cumsum(gamma, 1)
    topic_cdf /= topic_cdf[:, -1:].clone()
    lengths = torch.poisson(torch.full((n_docs,), float(spec["tokens_per_doc"]), **f64),
                            generator=gen).to(torch.int64) + 20
    doc_of = torch.repeat_interleave(torch.arange(n_docs, device=device), lengths)
    del gamma, lengths

    keys = torch.empty_like(doc_of)
    for lo in range(0, doc_of.numel(), TOKEN_BLOCK):
        docs = doc_of[lo:lo + TOKEN_BLOCK]
        u = torch.rand((docs.numel(), 2), generator=gen, **f64)
        topic = torch.searchsorted(topic_cdf[docs], u[:, :1].contiguous()).squeeze(1).clamp_(max=n_topics - 1)
        word = torch.searchsorted(zipf_cdf, u[:, 1].contiguous()).clamp_(max=n_words - 1)
        keys[lo:lo + docs.numel()] = docs * n_words + (word + offsets[topic]) % n_words
    del doc_of, topic_cdf
    keys, counts = torch.unique(keys, sorted=True, return_counts=True)

    split = int(torch.searchsorted(keys, torch.tensor(n_train * n_words, device=device)))
    train = _csr(keys[:split], counts[:split], n_train, n_words)
    heldout = None
    if n_docs > n_train:
        heldout = _csr(keys[split:] - n_train * n_words, counts[split:], n_docs - n_train,
                       n_words)
    del keys, counts
    return {"train": train, "heldout": heldout}


def nnz_per_doc(spec, seed=0, n_docs=2000, device="cpu"):
    """The mean nonzeros a document of ``spec`` holds, from ``n_docs``
    documents: how ``tokens_per_doc`` is calibrated against a source's nnz."""
    X = make(dict(spec, n_docs=n_docs, n_heldout=0), seed, device)["train"]
    return X.nnz / n_docs


__all__ = ["make", "nnz_per_doc"]
_ = np  # numpy arrays are what scipy receives
