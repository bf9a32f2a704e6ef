"""Numeric primitives, input standardisation and sample-weight handling
(counterpart of ``enstop_tpu/utils.py``, written without scikit-learn)."""

from __future__ import annotations

import numbers

import numpy as np
import scipy.sparse as sp

__all__ = [
    "normalize",
    "normalized",
    "standardize_input",
    "check_random_state",
    "_check_sample_weight",
]


def normalize(ndarray, axis=0):
    """l1-normalize a 2D array along ``axis`` **in place**; zero-sum slices
    are left untouched."""
    if axis not in (0, 1):
        raise ValueError("axis must be 0 or 1")
    marginal = ndarray.sum(axis=axis, keepdims=True)
    ndarray /= np.where(marginal > 0.0, marginal, 1.0)
    return ndarray


def normalized(array, axis=1):
    """Out-of-place l1 normalisation along ``axis``; zero slices stay zero."""
    marginal = array.sum(axis=axis, keepdims=True)
    return array / np.where(marginal > 0.0, marginal, 1.0)


def standardize_input(input_matrix):
    """l1-row-normalize float-typed inputs (a copy); pass count data through
    unchanged. Follows scikit-learn's ``normalize(norm="l1")``: sparse rows
    are summed in float64, dense rows in the input's dtype; zero rows stay
    zero."""
    if input_matrix.dtype not in (np.float32, np.float64):
        return input_matrix
    if sp.issparse(input_matrix):
        X = sp.csr_matrix(input_matrix, copy=True)
        row_of = np.repeat(np.arange(X.shape[0]), np.diff(X.indptr))
        sums = np.bincount(row_of, weights=np.abs(X.data.astype(np.float64)),
                           minlength=X.shape[0])
        sums[sums == 0.0] = 1.0
        X.data = (X.data / sums[row_of]).astype(X.dtype)
        return X
    X = np.asarray(input_matrix)
    norms = np.abs(X).sum(axis=1)
    norms[norms == 0.0] = 1.0
    return X / norms[:, np.newaxis]


def check_random_state(seed):
    """``None`` -> numpy's global RandomState, an int -> a new one seeded with
    it, a RandomState -> itself."""
    if seed is None or seed is np.random:
        return np.random.mtrand._rand
    if isinstance(seed, numbers.Integral):
        return np.random.RandomState(seed)
    if isinstance(seed, np.random.RandomState):
        return seed
    raise ValueError(f"{seed!r} cannot be used to seed a numpy.random.RandomState")


def _check_sample_weight(sample_weight, X, dtype=None):
    """Validate sample weights; ``None`` becomes an all-ones vector."""
    n_samples = X.shape[0]
    if dtype is not None and dtype not in (np.float32, np.float64):
        dtype = np.float64
    if sample_weight is None:
        return np.ones(n_samples, dtype=dtype)
    if isinstance(sample_weight, numbers.Number):
        return np.full(n_samples, sample_weight, dtype=dtype)
    sample_weight = np.asarray(sample_weight)
    if dtype is None:
        dtype = sample_weight.dtype if sample_weight.dtype in (np.float32, np.float64) \
            else np.float64
    sample_weight = np.ascontiguousarray(sample_weight, dtype=dtype)
    if sample_weight.ndim != 1:
        raise ValueError("Sample weights must be 1D array or scalar")
    if sample_weight.shape != (n_samples,):
        raise ValueError(
            "sample_weight.shape == {}, expected {}!".format(
                sample_weight.shape, (n_samples,)
            )
        )
    if not np.all(np.isfinite(sample_weight)):
        raise ValueError("Sample weights contain NaN or infinity")
    return sample_weight
