"""The sparse O(nnz) EM path (counterpart of ``enstop_tpu/ops/sell.py``).

The corpus is stored by its nonzeros, as the reference does, in two sort
orders on the device (:class:`~.cuda_sparse.Side`): doc-major for the
``P(z|d)`` half of a step (the doc pass, B) and word-major for the ``P(w|z)``
half (the word pass, A). Memory and work scale with the nonzeros, not with the
``n x m`` rectangle, so a corpus whose dense rectangle would not fit on the
card fits here. One EM step is the two passes; the refit is the doc pass
alone. On the card the passes are the CUDA kernels of ``csrc/em_sparse.cu``
(TPU kernels ``_make_word_pass_kernel`` and ``_make_doc_pass_kernel``), on the
CPU their plain versions; both compute the function of the JAX package's
XLA SELL path and Pallas chunk path.

``e_step_thresh`` is honoured exactly here: with a threshold above
``THRESH_MATERIAL`` an unnormalized product ``P(w|z) P(z|d)`` at or below it
drops from the numerator and the normalizer; the log-likelihood is never
thresholded. The sample weight multiplies only the ``P(w|z)`` accumulation
and the log-likelihood, never ``P(z|d)``.

One layout serves every ``kind`` (``"auto"``, ``"sell"``, ``"chunks"``): the
JAX package's two layouts exist because the TPU has no per-lane gather and
its chunk kernels have a scalar-prefetch cap; the card has neither limit.

Not ported, each for a reason:

* ``lane``, ``bd``, ``bw``, ``chunk``, ``build_tables`` and
  ``segsum="gather"``: TPU layout knobs (segment width for the vector lanes,
  tile shapes under the SMEM scalar-prefetch cap, the gather-form segment
  table). The segments here are cut at a fixed ``SEG_LEN``.
* ``_bucket_rows`` and ``_bucket_doc_inputs``: they pad shapes so that
  similar corpora reuse compiled XLA programs; eager PyTorch compiles nothing.
* ``_fallback_to_chunks`` and the ``src`` pin: a workaround for a remote
  compiler that rejected large SELL programs, and a fallback of a kind the
  port does not have.
"""

from __future__ import annotations

import torch

from ..profiling import count, span
from ..utils import standardize_input
from .cuda_sparse import build_side, doc_pass, word_pass
from .data import resolve_device, ship_coo
from .fit import em_fit_loop

__all__ = ["THRESH_MATERIAL", "PreparedSell", "prepare_sell", "word_side", "em_step_sell",
           "refit_step_sell", "log_likelihood_sell", "sell_fit", "sell_refit"]

# The dense paths treat e_step_thresh <= this as a numerical no-op; above it
# (the ensemble's 1e-16 and anything larger) the exact masked form runs.
THRESH_MATERIAL = 1e-30
_TINY = 1e-30
KINDS = ("auto", "sell", "chunks")


def word_side(rows, cols, vals, n_words, n_docs):
    """The word-major :class:`~.cuda_sparse.Side` of a row-major COO: one
    stable sort by column keeps each column's rows in order."""
    order = torch.sort(cols, stable=True).indices
    return build_side(cols[order], rows[order], vals[order], n_words, n_docs)


class PreparedSell:
    """A device-resident sparse corpus reusable across fits (the sparse
    counterpart of :class:`~.driver.PreparedCounts`): its doc-major side
    ``doc`` and word-major side ``word``."""

    __slots__ = ("doc", "word", "n", "m", "nnz", "backend")

    def __init__(self, doc, word, n, m):
        self.doc = doc
        self.word = word
        self.n = n
        self.m = m
        self.nnz = doc.nnz
        self.backend = "sparse"

    @property
    def shape(self):
        return (self.n, self.m)

    @property
    def device(self):
        return self.doc.device


def prepare_sell(X, standardize=True, kind="auto", device="cuda"):
    """Ship a corpus's nonzeros to ``device`` once and build both sort orders
    there. ``standardize`` l1-normalizes float inputs, like the estimators do.
    ``kind``: ``"auto"``, ``"sell"`` and ``"chunks"`` all name this one layout."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, not {kind!r}")
    dev = resolve_device(device)
    if standardize:
        X = standardize_input(X)
    n, m = X.shape
    rows, cols, vals = ship_coo(X, dev)
    with span("stage.layout"):
        doc = build_side(rows, cols, vals, n, m)  # row-major order is doc-major
        return PreparedSell(doc, word_side(rows, cols, vals, m, n), n, m)


def _ones(zd):
    return torch.ones(zd.shape[0], dtype=torch.float32, device=zd.device)


def _normalize(num):
    return num / num.sum(dim=1, keepdim=True).clamp_min(_TINY)


def em_step_sell(prep, zd, wz, w=None, thresh=None, compute_ll=True):
    """One exact EM step on a :class:`PreparedSell` with unpadded factors
    ``zd`` (n, k) and ``wz`` (k, m); returns ``(next_zd, next_wz, ll_of_inputs)``.
    ``thresh``: None for the plain E-step, or the exact ``e_step_thresh``."""
    w = _ones(zd) if w is None else w
    wzT = wz.t().contiguous()
    AT, ll = word_pass(prep.word, zd, wzT, w, thresh, compute_ll)
    B, _ = doc_pass(prep.doc, zd, wzT, w, thresh, compute_ll=False)
    # with a threshold the accumulators already hold the old factor
    num_zd = B if thresh is not None else zd * B
    num_wz = AT.t() if thresh is not None else wz * AT.t()
    return _normalize(num_zd), _normalize(num_wz), ll


def refit_step_sell(prep, zd, wz, w=None, thresh=None, compute_ll=True):
    """Frozen-topics step, the doc pass alone: ``(next_zd, ll_of_inputs)``."""
    B, ll = doc_pass(prep.doc, zd, wz.t().contiguous(), _ones(zd) if w is None else w,
                     thresh, compute_ll)
    return _normalize(B if thresh is not None else zd * B), ll


def log_likelihood_sell(prep, zd, wz, w=None):
    """The log-likelihood over the nonzeros (never thresholded), from the doc
    pass with its accumulator discarded."""
    return doc_pass(prep.doc, zd, wz.t().contiguous(), _ones(zd) if w is None else w)[1]


def _on_device(a, dev):
    """``a`` as a float32 tensor on ``dev``; a copy from the host waits for it."""
    if not (isinstance(a, torch.Tensor) and a.device == dev):
        count("host_syncs")
    return torch.as_tensor(a, dtype=torch.float32, device=dev)


def _fit_inputs(prep, p_z_given_d, p_w_given_z, sample_weight, e_step_thresh):
    dev = prep.device
    zd = _on_device(p_z_given_d, dev)
    wz = _on_device(p_w_given_z, dev)
    if zd.shape != (prep.n, wz.shape[0]) or wz.shape[1] != prep.m:
        raise ValueError(f"factors {tuple(zd.shape)} and {tuple(wz.shape)} do not fit the "
                         f"corpus {prep.shape}")
    w = _ones(zd) if sample_weight is None else _on_device(sample_weight, dev)
    thresholded = e_step_thresh is not None and e_step_thresh > THRESH_MATERIAL
    return zd.contiguous(), wz.contiguous(), w, float(e_step_thresh) if thresholded else None


def sell_fit(prep, p_z_given_d, p_w_given_z, sample_weight=None, n_iter=100,
             n_iter_per_test=10, tolerance=0.001, e_step_thresh=1e-32):
    """EM fit on a :class:`PreparedSell` through :func:`~.fit.em_fit_loop`.
    Returns ``(zd, wz, n_steps, final_ll, ll_trace, n_tests)``, the factors as
    tensors on the corpus's device."""
    zd, wz, w, thresh = _fit_inputs(prep, p_z_given_d, p_w_given_z, sample_weight,
                                    e_step_thresh)

    def step(state):
        new_zd, new_wz, ll = em_step_sell(prep, state[0], state[1], w, thresh, compute_ll=False)
        return (new_zd, new_wz), ll

    res = em_fit_loop(step, lambda s: log_likelihood_sell(prep, s[0], s[1], w), (zd, wz),
                      n_iter, n_iter_per_test, tolerance)
    return res.state[0], res.state[1], res.n_steps, res.final_ll, res.ll_trace, res.n_tests


def sell_refit(prep, p_z_given_d, topics, sample_weight=None, n_iter=50,
               n_iter_per_test=10, tolerance=0.005, e_step_thresh=1e-32):
    """Frozen-topics refit on a :class:`PreparedSell`; returns the same tuple
    as :func:`sell_fit`."""
    zd, wz, w, thresh = _fit_inputs(prep, p_z_given_d, topics, sample_weight, e_step_thresh)

    def step(state):
        new_zd, ll = refit_step_sell(prep, state[0], state[1], w, thresh, compute_ll=False)
        return (new_zd, state[1]), ll

    res = em_fit_loop(step, lambda s: log_likelihood_sell(prep, s[0], s[1], w), (zd, wz),
                      n_iter, n_iter_per_test, tolerance)
    return res.state[0], res.state[1], res.n_steps, res.final_ll, res.ll_trace, res.n_tests
