"""PLSA estimator (counterpart of ``enstop_tpu/models/plsa.py``).

``fit`` / ``fit_transform`` / ``transform``; fitted attributes
``components_``, ``embedding_``, ``history_``, ``n_iter_``, ``fit_info_`` and
``training_data_``. On ``device="cuda"`` each EM step runs the hand-written
CUDA kernels (the dense B pass and the word pass, or with
``backend="sparse"`` the two sparse passes); on ``device="cpu"`` it is plain
PyTorch.
"""

from __future__ import annotations

import numpy as np

from ..ops.data import _is_staged
from ..ops.driver import plsa_fit, plsa_refit
from ..profiling import request, span
from ..utils import _check_sample_weight, check_random_state
from .base import (TopicModelBase, check_counts, reinsert_zero_rows, split_zero_rows,
                   validate_corpus)


class PLSA(TopicModelBase):
    """Probabilistic Latent Semantic Analysis on PyTorch.

    Parameters are the JAX package's, plus ``device`` (``"cuda"`` by default;
    a CUDA device that is missing raises, nothing falls back to the CPU).
    ``backend`` is ``"auto"``, ``"cuda"`` or ``"torch"`` (which must match the
    device), or ``"sparse"``, the O(nnz) path on either device.
    ``precision``: ``"default"`` and ``"highest"`` run the fp32 kernel;
    ``"fast"`` runs its bf16-responsibilities mode (the factors move at bf16
    rounding level, the log-likelihood stays fp32; the sparse path warns and
    runs fp32). ``e_step_thresh`` above 1e-30 routes the fit to the sparse
    path, which applies it exactly; ``transform`` passes no threshold.
    """

    def __init__(
        self,
        n_components=10,
        init="random",
        n_iter=100,
        n_iter_per_test=10,
        tolerance=0.001,
        e_step_thresh=1e-32,
        transform_random_seed=42,
        random_state=None,
        backend="auto",
        precision="default",
        device="cuda",
    ):
        self.n_components = n_components
        self.init = init
        self.n_iter = n_iter
        self.n_iter_per_test = n_iter_per_test
        self.tolerance = tolerance
        self.e_step_thresh = e_step_thresh
        self.transform_random_seed = transform_random_seed
        self.random_state = random_state
        self.backend = backend
        self.precision = precision
        self.device = device

    def _fit_args(self):
        return dict(
            init=self.init, n_iter=self.n_iter, n_iter_per_test=self.n_iter_per_test,
            tolerance=self.tolerance, e_step_thresh=self.e_step_thresh,
            random_state=self.random_state, backend=self.backend,
            precision=self.precision, return_info=True, device=self.device,
        )

    def _record(self, info):
        self.history_ = info["ll_trace"]
        self.n_iter_ = info["n_steps"]
        self.fit_info_ = info

    def fit_transform(self, X, y=None, sample_weight=None):
        """Fit and return the document embedding ``P(z|d)``.

        ``X`` may be a scipy sparse or dense matrix, a
        :class:`~enstop_torch.ops.driver.PreparedCounts` or a
        :class:`~enstop_torch.ops.sell.PreparedSell`; for the two prepared
        kinds validation and zero-row handling are skipped (zero rows come
        back as zero embeddings) and ``training_data_`` is None. The fit is
        a request ``fit`` (:mod:`enstop_torch.profiling`) whose record is
        kept as ``fit_info_["trace"]``.
        """
        with request("fit", estimator=type(self).__name__, backend=self.backend) as req:
            info = self._fit(X, sample_weight)
        info["trace"] = req.record
        return self.embedding_

    def _fit(self, X, sample_weight):
        """The fit's spans ``validate``, then those of ``plsa_fit``, then
        ``finish``; returns the info dict."""
        prepared = _is_staged(X)
        with span("validate"):
            if prepared:
                sample_weight = _check_sample_weight(sample_weight, X, dtype=np.float32)
                data, zero_rows_found = X, False
            else:
                X, sample_weight = validate_corpus(X, sample_weight)
                data, good_rows, zero_rows_found = split_zero_rows(X)
                if zero_rows_found:
                    sample_weight = sample_weight[good_rows]
        U, V, info = plsa_fit(data, self.n_components, sample_weight=sample_weight,
                              **self._fit_args())
        with span("finish"):
            self._record(info)
            if zero_rows_found:
                U = reinsert_zero_rows(U, good_rows, X.shape[0], self.n_components)
            self.embedding_, self.components_ = U, V
            self.training_data_ = None if prepared else X
        return info

    def transform(self, X, y=None):
        """Embed new documents against the fitted topics (a refit of
        ``P(z|d)`` only: 50 iterations, a test every 5, tolerance 1e-3). A
        request ``transform`` that only a running profiler sees: no fitted
        attribute changes here."""
        with request("transform", estimator=type(self).__name__, backend=self.backend):
            with span("validate"):
                X = check_counts(X)
                self._validate_transform_input(X)
                random_state = check_random_state(self.transform_random_seed)
                sample_weight = _check_sample_weight(None, X, dtype=np.float32)
            return plsa_refit(
                X,
                self.components_,
                sample_weight=sample_weight,
                n_iter=50,
                n_iter_per_test=5,
                tolerance=0.001,
                random_state=random_state,
                backend=self.backend,
                precision=self.precision,
                device=self.device,
            )
