"""Shared estimator machinery (counterpart of ``enstop_tpu/models/base.py``,
written without scikit-learn): corpus validation, zero-row handling, the
constructor-signature ``get_params`` and ``.npz`` checkpoints in the JAX
package's format."""

from __future__ import annotations

import inspect
import json

import numpy as np
import scipy.sparse as sp

from ..ops.metrics import coherence, log_lift, mean_coherence, mean_log_lift
from ..utils import _check_sample_weight, standardize_input

# JAX-package backends that have no meaning here; a checkpoint naming one
# loads with the port's "auto"
_JAX_BACKENDS = ("xla", "pallas")


class NotFittedError(ValueError, AttributeError):
    """An estimator was used before it was fitted (scikit-learn's
    ``NotFittedError`` has the same two bases)."""


def check_counts(X, dtype=None):
    """A CSR copy of a 2-D, numeric, finite count matrix (``dtype`` casts),
    the checks of the JAX package's ``check_array``; raises ``ValueError``."""
    if sp.issparse(X):
        X = sp.csr_matrix(X)
    else:
        X = np.asarray(X)
        if X.ndim != 2:
            raise ValueError(f"Expected a 2-D count matrix, got {X.ndim}-D input")
        X = sp.csr_matrix(X)
    if not np.issubdtype(X.dtype, np.number):
        raise ValueError(f"Count matrix must be numeric, not {X.dtype}")
    if dtype is not None:
        X = X.astype(dtype)
    if np.issubdtype(X.dtype, np.floating) and not np.all(np.isfinite(X.data)):
        raise ValueError("Input contains NaN or infinity")
    return X


def validate_corpus(X, sample_weight=None):
    """Dense/sparse 2-D check + standardize_input + non-negativity check +
    CSR coercion; returns ``(X_csr, sample_weight)``."""
    if sp.issparse(X):
        X = X.tocsr()
        values = X.data
    else:
        X = np.asarray(X)
        values = X
    if X.ndim != 2:
        raise ValueError(f"Expected a 2-D count matrix, got {X.ndim}-D input")
    if X.shape[0] < 1:
        raise ValueError("Found an empty count matrix (0 documents)")
    if not np.issubdtype(values.dtype, np.number):
        raise ValueError(f"Count matrix must be numeric, not {values.dtype}")
    if np.issubdtype(values.dtype, np.floating) and not np.all(np.isfinite(values)):
        raise ValueError("Input contains NaN or infinity")
    X = standardize_input(X)
    if not sp.issparse(X):
        X = sp.csr_matrix(X)
    sample_weight = _check_sample_weight(sample_weight, X, dtype=np.float32)
    if sample_weight.size and not np.any(sample_weight > 0):
        raise ValueError("All sample weights are zero: the weighted pLSA "
                         "M-step is undefined.")
    if np.any(X.data < 0):
        raise ValueError(
            "PLSA is only valid for matrices with non-negative entries "
            "(Negative values in data passed to fit)"
        )
    return X, sample_weight


def split_zero_rows(X):
    """Remove all-zero document rows before fitting.

    Returns ``(X_nonzero, good_rows_mask, any_removed)``.
    """
    row_sums = np.asarray(X.sum(axis=1)).ravel()
    good_rows = row_sums != 0
    if not np.all(good_rows):
        return X[good_rows], good_rows, True
    return X, good_rows, False


def reinsert_zero_rows(embedding, good_rows, n_rows, k):
    """Re-insert zero embeddings for removed rows."""
    out = np.zeros((n_rows, k), dtype=embedding.dtype)
    out[good_rows] = embedding
    return out


class TopicModelBase:
    """Fit plumbing and checkpointing.

    Fitted attributes: ``components_`` (k, n_words), ``embedding_``
    (n_docs, k), ``training_data_``.
    """

    @classmethod
    def _param_names(cls):
        sig = inspect.signature(cls.__init__)
        return [p.name for p in sig.parameters.values()
                if p.name != "self" and p.kind == p.POSITIONAL_OR_KEYWORD]

    def get_params(self, deep=True):
        return {name: getattr(self, name) for name in self._param_names()}

    def set_params(self, **params):
        valid = self._param_names()
        for name, value in params.items():
            if name not in valid:
                raise ValueError(f"Invalid parameter {name!r} for {type(self).__name__}")
            setattr(self, name, value)
        return self

    def __repr__(self):
        args = ", ".join(f"{k}={v!r}" for k, v in self.get_params().items())
        return f"{type(self).__name__}({args})"

    def fit(self, X, y=None, sample_weight=None):
        self.fit_transform(X, sample_weight=sample_weight)
        return self

    def _validate_transform_input(self, X):
        """Fitted-state + feature-count guard shared by every transform."""
        if not hasattr(self, "components_"):
            raise NotFittedError(
                f"This {type(self).__name__} instance is not fitted yet; call "
                "fit (or load a checkpoint) before transform"
            )
        if X.shape[1] != self.components_.shape[1]:
            raise ValueError(
                f"X has {X.shape[1]} features, but {type(self).__name__} "
                f"is expecting {self.components_.shape[1]} features as input"
            )

    @property
    def n_features_in_(self):
        if not hasattr(self, "components_"):
            raise AttributeError("n_features_in_ is only available after fit")
        return self.components_.shape[1]

    # -- checkpoint / resume: the .npz format of the JAX package's save() ----

    def save(self, path):
        """Persist fitted state to an ``.npz`` checkpoint."""
        payload = {
            "components_": self.components_,
            "embedding_": self.embedding_,
            "params_json": np.frombuffer(
                json.dumps(
                    {k: v for k, v in self.get_params().items()
                     if isinstance(v, (int, float, str, bool, type(None)))}
                ).encode(),
                dtype=np.uint8,
            ),
            "class_name": np.frombuffer(type(self).__name__.encode(), dtype=np.uint8),
        }
        if hasattr(self, "history_"):
            payload["history_"] = np.asarray(self.history_)
        np.savez_compressed(path, **payload)

    @classmethod
    def load(cls, path, device=None):
        """Restore an estimator from a checkpoint written by :meth:`save` here
        or by the JAX package's ``save()``. ``device`` overrides the
        constructor default. ``TopicModelBase.load`` builds the class the
        checkpoint records; a subclass refuses a checkpoint of another class."""
        with np.load(path, allow_pickle=False) as z:
            saved_class = bytes(z["class_name"]).decode()
            if cls is TopicModelBase:
                cls = _estimator_class(saved_class)
                if cls is None:
                    raise ValueError(
                        f"Checkpoint was saved by unknown estimator class {saved_class!r}")
            elif saved_class != cls.__name__ and _estimator_class(saved_class) is not cls:
                raise ValueError(
                    f"Checkpoint at {str(path)!r} was saved by {saved_class!r}; load it "
                    f"with {saved_class}.load(...) (or TopicModelBase.load(...) to "
                    f"dispatch), not {cls.__name__}.load(...)"
                )
            params = json.loads(bytes(z["params_json"]).decode())
            history = z["history_"] if "history_" in z else None
            model = cls.from_state(z["components_"], z["embedding_"], history, params)
        if device is not None:
            model.device = device
        return model

    @classmethod
    def from_state(cls, components, embedding, history=None, params=None):
        """An estimator holding the given fitted arrays. ``params`` keeps the
        constructor arguments this class has; a JAX-only backend name
        becomes this class's default backend."""
        names = cls._param_names()
        params = {k: v for k, v in (params or {}).items() if k in names}
        if params.get("backend") in _JAX_BACKENDS:
            params["backend"] = inspect.signature(cls.__init__).parameters["backend"].default
        model = cls(**params)
        model.components_ = np.asarray(components)
        model.embedding_ = np.asarray(embedding)
        if history is not None:
            model.history_ = np.asarray(history)
        return model

    def warm_start_factors(self):
        """The ``(P(z|d), P(w|z))`` tuple accepted by ``init=`` to resume EM."""
        return (np.asarray(self.embedding_), np.asarray(self.components_))

    # -- topic-quality metrics -------------------------------------------------

    def _metric_data(self, data):
        """The corpus the metrics count co-occurrences in: ``data``, else the
        stored ``training_data_``, which is None after a fit on prepared input
        and after :meth:`load`."""
        if data is not None:
            return data
        stored = getattr(self, "training_data_", None)
        if stored is None:
            raise ValueError(
                "No training data is stored on this model (it was fitted on a prepared "
                "corpus, or restored via load()). Pass the count matrix explicitly: "
                "model.coherence(data=X) / model.log_lift(data=X)."
            )
        return stored

    def _metric(self, mean_fn, one_fn, topic_num, n_words, data):
        if not isinstance(topic_num, int) and topic_num is not None:
            raise ValueError("Topic number must be an integer or None.")
        data = self._metric_data(data)
        n_topics = self.components_.shape[0]
        if topic_num is None:
            return mean_fn(self.components_, data, n_words)
        if 0 <= topic_num < n_topics:
            return one_fn(self.components_, topic_num, data, n_words)
        raise ValueError(f"Topic number must be in range 0 to {n_topics}")

    def coherence(self, topic_num=None, n_words=20, data=None):
        """Mean (or one topic's) coherence of the fitted topics against
        ``data``, by default the stored ``training_data_``."""
        return self._metric(mean_coherence, coherence, topic_num, n_words, data)

    def log_lift(self, topic_num=None, n_words=20, data=None):
        """Mean (or one topic's) log lift of the fitted topics against
        ``data``, by default the stored ``training_data_``."""
        return self._metric(mean_log_lift, log_lift, topic_num, n_words, data)


def _estimator_class(name):
    """The port's estimator class a checkpoint's recorded name stands for, or
    None. The JAX package records ``"TPUPLSA"`` for a ``GPUPLSA`` (there it is
    an alias); here ``TPUPLSA`` is the alias of ``GPUPLSA``."""
    from .accelerated import GPUPLSA
    from .ensemble import EnsembleTopics
    from .mesh import BlockParallelPLSA, DistributedPLSA
    from .plsa import PLSA
    from .streamed import StreamedPLSA

    classes = {c.__name__: c for c in (PLSA, EnsembleTopics, StreamedPLSA, GPUPLSA,
                                       BlockParallelPLSA, DistributedPLSA)}
    classes["TPUPLSA"] = GPUPLSA
    return classes.get(name)
