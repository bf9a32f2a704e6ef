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

import warnings

import numpy as np
import torch

from ..profiling import span
from ..utils import standardize_input
from .cuda_sparse import _ones_if_none, build_side, doc_pass, word_pass
from .data import _on_device, _Staged, _weighted, resolve_device, ship_coo
from .em import _rownorm
from .fit import em_fit_loop

__all__ = ["THRESH_MATERIAL", "PreparedSell", "prepare_sell", "word_side", "em_step_sell",
           "refit_step_sell", "log_likelihood_sell", "sell_fit", "sell_refit"]

# The dense paths treat e_step_thresh <= this as a numerical no-op; above it
# (the ensemble's 1e-16 and anything larger) the exact masked form runs.
THRESH_MATERIAL = 1e-30
KINDS = ("auto", "sell", "chunks")


def _material_thresh(e_step_thresh):
    """``e_step_thresh`` as the threshold the sparse passes apply exactly, or
    None where it cannot fire in float32 (at or below ``THRESH_MATERIAL``)."""
    if e_step_thresh is not None and e_step_thresh > THRESH_MATERIAL:
        return float(e_step_thresh)
    return None


def word_side(rows, cols, vals, n_words, n_docs):
    """The word-major :class:`~.cuda_sparse.Side` of a row-major COO: one
    stable sort by column keeps each column's rows in order."""
    order = torch.sort(cols, stable=True).indices
    return build_side(cols[order], rows[order], vals[order], n_words, n_docs)


class PreparedSell(_Staged):
    """A device-resident sparse corpus reusable across fits (the sparse
    counterpart of :class:`~.driver.PreparedCounts`): its doc-major side
    ``doc`` and word-major side ``word``. Its fit (:class:`~.data._Staged`)
    is the plain loop on :func:`em_step_sell`, the factors at the layout's own
    shapes (n, k) and (k, m)."""

    __slots__ = ("doc", "word", "n", "m", "nnz", "backend")

    def __init__(self, doc, word, n, m):
        self.doc = doc
        self.word = word
        self.n = n
        self.m = m
        self.nnz = doc.nnz
        self.backend = "sparse"

    @property
    def device(self):
        return self.doc.device

    def _padded(self, k):
        return self.n, k, self.m

    def _pad(self, zd, wz):
        return zd, wz

    def _weights(self, sample_weight):
        return np.asarray(sample_weight, np.float32) if _weighted(sample_weight) else None

    def _steps(self, precision, path):
        if precision == "fast":
            warnings.warn(
                "precision='fast' (bf16 E-step responsibilities) is a dense kernel mode; "
                f"the {path} path runs at default precision",
                stacklevel=3,
            )

    def _fit(self, zd, wz, w, n_iter, n_iter_per_test, tolerance, steps=None,
             e_step_thresh=None, refit=False):
        zd, wz = self._place(zd, wz)
        if zd.shape != (self.n, wz.shape[0]) or wz.shape[1] != self.m:
            raise ValueError(f"factors {tuple(zd.shape)} and {tuple(wz.shape)} do not fit the "
                             f"corpus {self.shape}")
        w = _ones_if_none(None if w is None else _on_device(w, self.device), zd)
        thresh = _material_thresh(e_step_thresh)

        def step(state):
            if refit:
                new_zd, ll = refit_step_sell(self, *state, w, thresh, compute_ll=False)
                return (new_zd, state[1]), ll
            new_zd, new_wz, ll = em_step_sell(self, *state, w, thresh, compute_ll=False)
            return (new_zd, new_wz), ll

        return em_fit_loop(step, lambda s: log_likelihood_sell(self, *s, w),
                           (zd.contiguous(), wz.contiguous()), n_iter, n_iter_per_test, tolerance)


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


def em_step_sell(prep, zd, wz, w=None, thresh=None, compute_ll=True):
    """One exact EM step on a :class:`PreparedSell` with unpadded factors
    ``zd`` (n, k) and ``wz`` (k, m); returns ``(next_zd, next_wz, ll_of_inputs)``.
    ``thresh``: None for the plain E-step, or the exact ``e_step_thresh``."""
    w = _ones_if_none(w, zd)
    wzT = wz.t().contiguous()
    AT, ll = word_pass(prep.word, zd, wzT, w, thresh, compute_ll)
    B, _ = doc_pass(prep.doc, zd, wzT, w, thresh, compute_ll=False)
    # with a threshold the accumulators already hold the old factor
    num_zd = B if thresh is not None else zd * B
    num_wz = AT.t() if thresh is not None else wz * AT.t()
    return _rownorm(num_zd), _rownorm(num_wz), ll


def refit_step_sell(prep, zd, wz, w=None, thresh=None, compute_ll=True):
    """Frozen-topics step, the doc pass alone: ``(next_zd, ll_of_inputs)``."""
    B, ll = doc_pass(prep.doc, zd, wz.t().contiguous(), w, thresh, compute_ll)
    return _rownorm(B if thresh is not None else zd * B), ll


def log_likelihood_sell(prep, zd, wz, w=None):
    """The log-likelihood over the nonzeros (never thresholded), from the doc
    pass with its accumulator discarded."""
    return doc_pass(prep.doc, zd, wz.t().contiguous(), w)[1]


def sell_fit(prep, p_z_given_d, p_w_given_z, sample_weight=None, n_iter=100,
             n_iter_per_test=10, tolerance=0.001, e_step_thresh=1e-32):
    """EM fit on a :class:`PreparedSell` through :func:`~.fit.em_fit_loop`.
    Returns ``(zd, wz, n_steps, final_ll, ll_trace, n_tests)``, the factors as
    tensors on the corpus's device."""
    res = prep._fit(p_z_given_d, p_w_given_z, sample_weight, n_iter, n_iter_per_test, tolerance,
                    e_step_thresh=e_step_thresh)
    return (*res.state, *res[1:])


def sell_refit(prep, p_z_given_d, topics, sample_weight=None, n_iter=50,
               n_iter_per_test=10, tolerance=0.005, e_step_thresh=1e-32):
    """Frozen-topics refit on a :class:`PreparedSell`; returns the same tuple
    as :func:`sell_fit`."""
    res = prep._fit(p_z_given_d, topics, sample_weight, n_iter, n_iter_per_test, tolerance,
                    e_step_thresh=e_step_thresh, refit=True)
    return (*res.state, *res[1:])
