"""EnsTop's ensemble with NMF runs (``EnsembleTopics(model="nmf")``), written
out plainly: each bootstrap run replayed from the call's ``random_state`` and
the final embedding against the frozen stable topics, by Kullback-Leibler
multiplicative updates in float64.

The semantics are the reference library's (lmcinnes/enstop v0.2.6
``enstop_.py``: ``nmf_topics`` and the NMF branch of ``ensemble_fit``) as the
JAX package runs them, at ``solver="mu"``, ``beta_loss=1``, ``init="random"``
and the other defaults:

* **Seeds.** A call ``EnsembleTopics(model="nmf", random_state=seed)`` draws
  from ``RandomState(seed)`` one ``randint(2**31 - 1)`` a run, all up front:
  run ``i``'s seed is the ``i``-th (:func:`run_seeds`).
* **A run.** ``RandomState(run seed).randint(0, n_docs, n_docs)`` picks the
  rows of the resample, repeats and order as drawn (:func:`resample`). A
  fresh ``RandomState(run seed)`` then draws the start, ``W0 = |rand(n_docs,
  k)|`` and ``H0 = |rand(k, n_words)|`` in that order, in float64, which the
  program rounds to float32 (:func:`start`; the rounded values are the
  start here too).
* **Updates** (:func:`mu`), ``n_iter`` = 200 of them, W first and then H
  against the new W; at each nonzero ``x = X[d, w]`` the ratio
  ``x / max(s, 1e-30)`` with ``s = (W H)[d, w]``, nothing computed at the
  zeros::

      W <- W * ((X / WH) H^T) / max(H 1 + l1 + l2 W, 1e-30)
      H <- H * (W^T (X / WH)) / max(1^T W + l1 + l2 H, 1e-30)

  with ``l1 = alpha * l1_ratio`` and ``l2 = alpha * (1 - l1_ratio)`` on both
  factors (``alpha`` is 0 by default). A run's topics are H's rows,
  l1-normalised.
* **Combine.** As in :mod:`.ensemble`, whose checks (Hellinger distances,
  trustworthiness, HDBSCAN, the cluster pairing and the merge) the NMF
  ensemble's combine shares.
* **Embedding** (:func:`embedding`). W alone against the frozen stable topics
  (``H = components_``, as the program hands them on, in float32), from
  ``W0 = |RandomState(seed).rand(n_docs, n_stable)|`` rounded to float32,
  200 updates over the corpus itself (no resample).

It departs from scikit-learn's ``NMF(solver="mu",
beta_loss="kullback-leibler")`` (``_fit_multiplicative_update``) where the
reference library does: (1) a fixed 200 updates and no ``tol`` test
(scikit-learn measures the loss every 10 and stops within ``tol=1e-4``);
(2) at ``init="random"`` the start is ``|rand|``, unscaled (scikit-learn
draws ``sqrt(X.mean() / k) |standard_normal|``); (3) ``alpha`` is one
unscaled constant for both factors (the pre-1.0 semantics; scikit-learn 1.x
scales ``alpha_W`` by ``n_features`` and ``alpha_H`` by ``n_samples``). And
where the arithmetic guards differ: (4) scikit-learn raises ``WH`` at the
nonzeros to float32's epsilon (1.2e-7) before the ratio, here to 1e-30;
(5) it sets a denominator that is 0 to float32's epsilon, here any below
1e-30 to 1e-30; (6) it sets H's entries below float64's epsilon (2.2e-16)
to 0 after each update, here none. With no regulariser and a positive
start, (4) and (5) never act at counts; (6) moves an entry by less than
2.2e-16.

A pass over the corpus is two sparse products, as :mod:`.plsa_wide` runs
them: ``s`` sampled at the nonzeros (``torch.sparse.sampled_addmm``) and the
numerator, ``R H^T`` over the doc-major matrix of ratios or ``R^T W`` over the
word-major one (``torch.sparse.mm``), each over blocks of rows that hold
about ``BLOCK_BYTES / (8 k)`` nonzeros, so that one block's factor rows come
to about 1 GiB in float64. Everything is float64 (``mode="exact"``) unless
``mode="bf16r"``, the control: float32 with the ratio ``x / s`` and the
products' operands rounded to bfloat16. Float32 products run in full
float32: TF32 is switched off on import (by :mod:`.plsa_wide`).
"""

from __future__ import annotations

import numpy as np
import torch

from .ensemble import clusters_of, hellinger, match, merge, trustworthiness
from .plsa_wide import TINY, _bf16, _csr, _rownorm, corpus_of

N_ITER = 200


def run_seeds(seed, n_runs):
    """Each run's seed of a call seeded ``seed``."""
    rng = np.random.RandomState(seed)
    return [int(rng.randint(np.iinfo(np.int32).max)) for _ in range(n_runs)]


def resample(csr, run_seed):
    """The run's row resample of ``csr``."""
    n = csr.shape[0]
    return csr.tocsr()[np.random.RandomState(run_seed).randint(0, n, size=n)]


def start(n_docs, n_words, k, run_seed):
    """The run's ``(W0, H0)`` as the program starts from them (float32)."""
    rng = np.random.RandomState(run_seed)
    W0 = np.abs(rng.rand(n_docs, k)).astype(np.float32)
    return W0, np.abs(rng.rand(k, n_words)).astype(np.float32)


def _ratios(corpus, x, W, HT, bf16r):
    """``x / max(s, 1e-30)`` at the nonzeros, doc-major, ``s = (W H)[d, w]``."""
    c = corpus
    s = torch.empty_like(x)
    for lo, hi, a, b in c.doc_blocks:
        pattern = _csr(c.crow, c.cols[a:b], x[a:b], lo, hi, c.m)
        s[a:b] = torch.sparse.sampled_addmm(pattern, W[lo:hi], HT.t(), beta=0.0).values()
    s.clamp_min_(TINY)
    return _bf16(_bf16(x) / _bf16(s)) if bf16r else x / s


def _update_W(corpus, x, W, H, l1, l2, bf16r):
    c = corpus
    HT = H.t().contiguous()
    ratio = _ratios(c, x, W, HT, bf16r)
    op = _bf16(HT) if bf16r else HT
    num = torch.empty_like(W)
    for lo, hi, a, b in c.doc_blocks:
        num[lo:hi] = _csr(c.crow, c.cols[a:b], ratio[a:b], lo, hi, c.m) @ op
    return W * num / (H.sum(1)[None, :] + l1 + l2 * W).clamp_min(TINY)


def _update_H(corpus, x, W, H, l1, l2, bf16r):
    c = corpus
    ratio_t = _ratios(c, x, W, H.t().contiguous(), bf16r)[c.perm]
    op = _bf16(W) if bf16r else W
    num_t = torch.empty((c.m, W.shape[1]), dtype=W.dtype, device=W.device)
    for lo, hi, a, b in c.word_blocks:
        num_t[lo:hi] = _csr(c.wcrow, c.wcols[a:b], ratio_t[a:b], lo, hi, c.n) @ op
    return H * num_t.t() / (W.sum(0)[:, None] + l1 + l2 * H).clamp_min(TINY)


def mu(corpus, W0, H0, n_iter=N_ITER, update_H=True, alpha=0.0, l1_ratio=0.0, mode="exact"):
    """``n_iter`` KL multiplicative updates from ``(W0, H0)`` over ``corpus``
    (:func:`.plsa_wide.corpus_of`); returns ``(W, H)`` on its device."""
    bf16r = mode == "bf16r"
    dtype = torch.float32 if bf16r else torch.float64
    dev = corpus.vals.device
    W, H = (torch.as_tensor(np.asarray(a)).to(device=dev, dtype=dtype) for a in (W0, H0))
    x = corpus.vals.to(dtype)
    l1, l2 = float(alpha) * float(l1_ratio), float(alpha) * (1.0 - float(l1_ratio))
    for _ in range(int(n_iter)):
        W = _update_W(corpus, x, W, H, l1, l2, bf16r)
        if update_H:
            H = _update_H(corpus, x, W, H, l1, l2, bf16r)
    return W, H


def run(csr, k, seed, i, device, n_runs=16, n_iter=N_ITER, mode="exact"):
    """Run ``i`` of ``EnsembleTopics(n_components=k, model="nmf", n_starts=n_runs,
    random_state=seed).fit(csr)``: ``(W, H)``; its topics are
    ``_rownorm(H)``."""
    run_seed = run_seeds(seed, n_runs)[i]
    B = resample(csr, run_seed)
    W0, H0 = start(*B.shape, k, run_seed)
    return mu(corpus_of(B, k, device), W0, H0, n_iter, mode=mode)


def topics(H):
    """A run's topics: H's rows, l1-normalised."""
    return _rownorm(H)


def embedding(csr, stable_topics, seed, device, n_iter=N_ITER, mode="exact", corpus=None):
    """The call's final embedding: W against the frozen ``stable_topics``
    (n_stable, n_words) from the call's own draw."""
    k = stable_topics.shape[0]
    W0 = np.abs(np.random.RandomState(seed).rand(csr.shape[0], k)).astype(np.float32)
    corpus = corpus_of(csr, k, device) if corpus is None else corpus
    H = np.asarray(stable_topics, dtype=np.float32)
    return mu(corpus, W0, H, n_iter, update_H=False, mode=mode)[0]


def relative_row_l1(answer, reference):
    """Each row's l1 gap from the reference's row over the reference row's l1
    norm (an empty row reads 0), in float64."""
    ref = torch.as_tensor(reference).double()
    ans = torch.as_tensor(np.asarray(answer)).to(device=ref.device, dtype=torch.float64)
    return (ans - ref).abs().sum(1) / ref.abs().sum(1).clamp_min(TINY)
