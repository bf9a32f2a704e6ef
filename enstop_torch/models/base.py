"""Shared estimator machinery (counterpart of ``enstop_tpu/models/base.py``,
written without scikit-learn): corpus validation, zero-row handling, the
constructor-signature ``get_params``, scikit-learn's metadata routing and
``.npz`` checkpoints in the JAX package's format."""

from __future__ import annotations

import inspect
import json
import sys
import warnings

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


_RESHAPE = ("Reshape your data either using array.reshape(-1, 1) if your data has a "
            "single feature or array.reshape(1, -1) if it contains a single sample.")


def _reject_complex(X):
    if X.dtype.kind == "c":
        raise ValueError(f"Complex data not supported\n{X}\n")


def _assert_all_finite(values):
    """scikit-learn's finiteness check: float values only, one sum first."""
    if values.dtype.kind != "f":
        return
    with np.errstate(over="ignore"):
        if np.isfinite(values.sum()):
            return
    if np.isnan(values).any():
        raise ValueError("Input contains NaN.")
    if np.isinf(values).any():
        raise ValueError(f"Input contains infinity or a value too large for {values.dtype!r}.")


def check_array(X, dtype=None):
    """The rules of scikit-learn's ``check_array(X, accept_sparse="csr",
    dtype=dtype or "numeric")``, which the JAX package runs, with its
    exception types and wording: a 2-D numeric, finite matrix with at least
    one sample and one feature. Sparse input of any format comes back as a
    ``csr_matrix``, dense input as an ndarray; ``object`` input is cast to
    float64 (``dtype`` casts everything), ``bool`` stays ``bool``, complex
    input raises before any cast. Copies only where it converts."""
    if isinstance(X, np.matrix):
        raise TypeError(
            "np.matrix is not supported. Please convert to a numpy array with np.asarray. "
            "For more information see: "
            "https://numpy.org/doc/stable/reference/generated/numpy.matrix.html")
    if sp.issparse(X):
        _reject_complex(X)
        if X.ndim != 2:
            raise ValueError(f"Expected 2D input, got input with shape {X.shape}.\n{_RESHAPE}")
        X = sp.csr_matrix(X)
        if dtype is None and X.dtype.kind == "O":
            dtype = np.float64
        if dtype is not None and X.dtype != dtype:
            X = X.astype(dtype)
        _assert_all_finite(X.data)
    else:
        numeric = dtype is None
        if numeric and getattr(getattr(X, "dtype", None), "kind", None) == "O":
            dtype = np.float64
        with warnings.catch_warnings():
            warnings.simplefilter("error", np.exceptions.ComplexWarning)
            try:
                X = np.asarray(X, dtype=dtype)
            except np.exceptions.ComplexWarning as err:
                raise ValueError(f"Complex data not supported\n{X}\n") from err
        _reject_complex(X)
        if X.ndim == 0:
            raise ValueError(f"Expected 2D array, got scalar array instead:\narray={X}.\n"
                             f"{_RESHAPE}")
        if X.ndim == 1:
            raise ValueError(f"Expected 2D array, got 1D array instead:\narray={X}.\n"
                             f"{_RESHAPE}")
        if numeric and X.dtype.kind in "USV":
            raise ValueError("dtype='numeric' is not compatible with arrays of bytes/strings."
                             "Convert your data to numeric values explicitly instead.")
        if X.ndim >= 3:
            raise ValueError(f"Found array with dim {X.ndim}, while dim <= 2 is required.")
        _assert_all_finite(X)
    if X.shape[0] < 1:
        raise ValueError(f"Found array with {X.shape[0]} sample(s) (shape={X.shape}) while a "
                         "minimum of 1 is required.")
    if X.shape[1] < 1:
        raise ValueError(f"Found array with {X.shape[1]} feature(s) (shape={X.shape}) while "
                         "a minimum of 1 is required.")
    return X


def check_counts(X, dtype=None):
    """:func:`check_array`, as a ``csr_matrix``."""
    X = check_array(X, dtype=dtype)
    return X if sp.issparse(X) else sp.csr_matrix(X)


def validate_corpus(X, sample_weight=None):
    """check_array + standardize_input + non-negativity check + CSR coercion;
    returns ``(X_csr, sample_weight)``."""
    X = standardize_input(check_array(X))
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


def _sklearn_module(name, caller):
    """The loaded scikit-learn module ``name``, for the hooks that only
    scikit-learn calls. The port imports no scikit-learn: without it loaded,
    ``caller`` cannot answer and says so."""
    module = sys.modules.get(name)
    if module is None:
        raise RuntimeError(f"{caller} is scikit-learn's API ({name}); scikit-learn is not "
                           "loaded")
    return module


# scikit-learn's SIMPLE_METHODS: the methods whose metadata a router can route
_ROUTED_METHODS = ("fit", "partial_fit", "predict", "predict_proba", "predict_log_proba",
                   "decision_function", "score", "split", "transform", "inverse_transform")
_NOT_METADATA = ("X", "y", "Y", "Xt", "yt")
_UNCHANGED = "$UNCHANGED$"  # scikit-learn's default of a set_*_request argument
_ROUTING = "sklearn.utils._metadata_requests"


def _metadata_of(cls, method):
    """The metadata ``cls.method`` takes, as scikit-learn reads them off its
    signature: the named parameters after ``self`` other than the data."""
    fn = getattr(cls, method, None)
    if not inspect.isfunction(fn):
        return []
    return [p.name for p in list(inspect.signature(fn).parameters.values())[1:]
            if p.name not in _NOT_METADATA and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]


class _RequestMethod:
    """``set_{method}_request``, as scikit-learn's ``RequestMethod`` descriptor
    builds it on a ``BaseEstimator``: keyword-only ``keys``, the loaded
    scikit-learn's checks and wording, ``self`` returned."""

    def __init__(self, method, keys):
        self.method, self.keys = method, keys

    def __get__(self, instance, owner):
        method, keys = self.method, self.keys

        def request(*args, **kwargs):
            routing = _sklearn_module(_ROUTING, f"set_{method}_request")
            return routing.RequestMethod(method, keys).__get__(instance, owner)(*args, **kwargs)

        request.__name__ = request.__qualname__ = f"set_{method}_request"
        request.__doc__ = (f"Request (True), refuse (False), leave unset (None) or alias (a "
                           f"string) each of {keys} for ``{method}`` under scikit-learn's "
                           "metadata routing; returns the estimator.")
        request.__signature__ = inspect.Signature(
            [inspect.Parameter("self", inspect.Parameter.POSITIONAL_OR_KEYWORD)]
            + [inspect.Parameter(key, inspect.Parameter.KEYWORD_ONLY, default=_UNCHANGED)
               for key in keys])
        return request


def _add_request_methods(cls):
    """Give ``cls`` a ``set_{method}_request`` for each routed method that
    takes metadata, as scikit-learn's ``_MetadataRequester.__init_subclass__``
    gives a ``BaseEstimator``."""
    for method in _ROUTED_METHODS:
        keys = _metadata_of(cls, method)
        if keys:
            setattr(cls, f"set_{method}_request", _RequestMethod(method, sorted(keys)))


class TopicModelBase:
    """Fit plumbing, metadata routing and checkpointing.

    Fitted attributes: ``components_`` (k, n_words), ``embedding_``
    (n_docs, k), ``training_data_``.
    """

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        _add_request_methods(cls)

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

    def fit(self, X, y=None, sample_weight=None, **fit_params):
        self.fit_transform(X, sample_weight=sample_weight, **fit_params)
        return self

    def fit_transform(self, X, y=None, **fit_params):
        """``fit`` then ``transform`` of ``X``, as scikit-learn's
        ``TransformerMixin``; each estimator overrides it with a fit that
        embeds in one pass."""
        return self.fit(X, y, **fit_params).transform(X)

    # -- scikit-learn's metadata routing ------------------------------------------
    # The JAX package's estimators inherit it from BaseEstimator. Here the
    # requests live in the same attribute (``_metadata_request``, which
    # sklearn.base.clone copies) and the MetadataRequest objects are the loaded
    # scikit-learn's, as routers deep-copy and read them.

    def _get_metadata_request(self):
        routing = _sklearn_module(_ROUTING, "get_metadata_routing")
        if hasattr(self, "_metadata_request"):
            return routing.get_routing_for_object(self._metadata_request)
        requests = routing.MetadataRequest(owner=self)
        for method in _ROUTED_METHODS:
            for key in _metadata_of(type(self), method):
                getattr(requests, method).add_request(param=key, alias=None)
        return requests

    def get_metadata_routing(self):
        """scikit-learn's ``MetadataRequest`` of this estimator: which
        metadata each method takes and whether a router passes it on."""
        return self._get_metadata_request()

    def __sklearn_tags__(self):
        """The JAX package's scikit-learn tags (those of a ``TransformerMixin,
        BaseEstimator`` with counts-only sparse input, a refit ``transform``
        and float32 factors). Only scikit-learn's ``get_tags`` calls this, so
        the tag classes come from its loaded module; the port imports no
        scikit-learn."""
        tags = _sklearn_module("sklearn.utils._tags", "__sklearn_tags__")
        return tags.Tags(
            estimator_type=None,
            target_tags=tags.TargetTags(required=False),
            transformer_tags=tags.TransformerTags(preserves_dtype=[]),
            input_tags=tags.InputTags(sparse=True, positive_only=True),
            non_deterministic=True,
        )

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


_add_request_methods(TopicModelBase)


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
