"""Streamed, out-of-core pLSA estimator (counterpart of
``enstop_tpu/models/streamed.py``).

The work is :mod:`enstop_torch.models.streamed_core`'s: host memory O(nnz),
device memory O(block), each EM iteration streaming every block to the card
once, the convergence log-likelihood coming from the same stream.
``block_size`` is the number of documents a block.
"""

from __future__ import annotations

import numpy as np

from ..utils import _check_sample_weight, check_random_state
from .base import (TopicModelBase, check_counts, reinsert_zero_rows, split_zero_rows,
                   validate_corpus)
from .streamed_core import streamed_fit_core, streamed_refit_core

__all__ = ["StreamedPLSA"]


class StreamedPLSA(TopicModelBase):
    """pLSA for corpora whose nonzeros do not fit on the card.

    Where they fit, ``PLSA(backend="sparse")`` keeps them there and streams
    nothing. Parameters are the JAX package's, plus ``device`` (``"cuda"`` by
    default; a CUDA device that is missing raises, nothing falls back to the
    CPU). ``backend`` is accepted and not used, as in the JAX package. Fitted
    attributes: ``components_``, ``embedding_``, ``history_``, ``n_iter_``,
    ``fit_info_`` (with the bytes shipped) and ``training_data_``.
    """

    def __init__(
        self,
        n_components=10,
        init="random",
        block_size=65536,
        n_iter=100,
        n_iter_per_test=10,
        tolerance=0.001,
        e_step_thresh=1e-32,
        transform_random_seed=42,
        random_state=None,
        backend="auto",
        device="cuda",
    ):
        self.n_components = n_components
        self.init = init
        self.block_size = block_size
        self.n_iter = n_iter
        self.n_iter_per_test = n_iter_per_test
        self.tolerance = tolerance
        self.e_step_thresh = e_step_thresh
        self.transform_random_seed = transform_random_seed
        self.random_state = random_state
        self.backend = backend
        self.device = device

    def fit_transform(self, X, y=None, sample_weight=None):
        """Fit and return the document embedding ``P(z|d)``; all-zero
        documents come back as zero rows."""
        X, sample_weight = validate_corpus(X, sample_weight)
        data, good_rows, zero_rows_found = split_zero_rows(X)
        U, V, n_steps, ll_trace, info = streamed_fit_core(
            data,
            self.n_components,
            sample_weight=sample_weight[good_rows] if zero_rows_found else sample_weight,
            init=self.init,
            block_docs=self.block_size,
            n_iter=self.n_iter,
            n_iter_per_test=self.n_iter_per_test,
            tolerance=self.tolerance,
            e_step_thresh=self.e_step_thresh,
            random_state=self.random_state,
            device=self.device,
        )
        if zero_rows_found:
            self.embedding_ = reinsert_zero_rows(U, good_rows, X.shape[0], self.n_components)
        else:
            self.embedding_ = U
        self.components_ = V
        self.training_data_ = X
        self.n_iter_ = n_steps
        self.history_ = np.asarray(ll_trace, dtype=np.float64)
        self.fit_info_ = info
        return self.embedding_

    def transform(self, X, y=None, sample_weight=None):
        """Embed new documents against the fitted topics (the streamed
        refit: 50 iterations, a test every 5, tolerance 1e-3, the fit's
        ``e_step_thresh``)."""
        X = check_counts(X)
        self._validate_transform_input(X)
        if sample_weight is not None:
            sample_weight = _check_sample_weight(sample_weight, X)
        return streamed_refit_core(
            X,
            self.components_,
            sample_weight=sample_weight,
            block_docs=self.block_size,
            n_iter=50,
            n_iter_per_test=5,
            tolerance=0.001,
            e_step_thresh=self.e_step_thresh,
            random_state=check_random_state(self.transform_random_seed),
            device=self.device,
        )
