"""Fit and refit drivers: host-side orchestration around the EM loops
(counterpart of ``enstop_tpu/ops/driver.py``).

Initialise the factors on the host, stage the counts on the device as a
zero-padded dense matrix (or as the sparse layout of :mod:`.sell`), run the
EM loop, undo the padding.

Backends, resolved from the explicit ``device``:

``"cuda"``    the hand-written CUDA kernels of :mod:`.cuda_em` (``device="cuda"``)
``"torch"``   the plain PyTorch ops of :mod:`.em` (``device="cpu"``)
``"sparse"``  the O(nnz) path of :mod:`.sell` on either device (its kernels
              on ``"cuda"``, their plain versions on ``"cpu"``); the only path
              that applies ``e_step_thresh`` exactly
``"auto"``    whichever of the dense two matches the device; raw input with a
              materially firing ``e_step_thresh`` (> 1e-30) runs ``"sparse"``

A :class:`PreparedCounts` always runs dense and a :class:`~.sell.PreparedSell`
sparse, whatever the threshold, as in the JAX package.
"""

from __future__ import annotations

import time
import warnings

import numpy as np
import scipy.sparse as sp
import torch

from ..utils import check_random_state, standardize_input
from . import cuda_em, em as em_ops
from .data import (COL_MULTIPLE, ROW_MULTIPLE, pad_factors, pad_vector, resolve_device,
                   round_up, ship_coo, unpad_factors)
from .fit import em_fit_loop, em_fit_loop_folded
from .init import plsa_init
from .sell import THRESH_MATERIAL, PreparedSell, prepare_sell, sell_fit, sell_refit, word_side

__all__ = [
    "PreparedCounts", "prepare_counts", "plsa_fit", "plsa_refit",
    "resolve_device", "resolve_backend", "kernel_steps", "plain_steps",
    "fit_padded", "refit_padded",
]


def resolve_backend(backend, device):
    if backend == "sparse":
        return backend
    expected = "cuda" if device.type == "cuda" else "torch"
    if backend == "auto":
        return expected
    if backend not in ("cuda", "torch"):
        raise ValueError(f"Unrecognized backend {backend!r}")
    if backend != expected:
        raise ValueError(f"backend={backend!r} does not run on device {str(device)!r}; "
                         f"use {expected!r}")
    return backend


def _sparse_route(X, backend, e_step_thresh):
    """True where the JAX package runs the sparse path: ``backend="sparse"``
    or a :class:`PreparedSell`, or raw input under ``backend="auto"`` with a
    threshold that fires; a :class:`PreparedCounts` never."""
    if isinstance(X, PreparedSell) or backend == "sparse":
        return True
    return (backend == "auto" and not isinstance(X, PreparedCounts)
            and e_step_thresh is not None and e_step_thresh > THRESH_MATERIAL)


def _warn_fast_unsupported(path):
    warnings.warn(
        "precision='fast' (bf16 E-step responsibilities) is a dense kernel mode; "
        f"the {path} path runs at default precision",
        stacklevel=3,
    )


def kernel_steps(precision="default", word=None):
    """The step functions of the fit loops, through the :mod:`.cuda_em`
    wrappers (kernels on CUDA tensors, plain ops on CPU tensors). ``word``:
    the word-major nonzeros of the X the steps get (``PreparedCounts.word``)."""
    cuda_em._check_precision(precision)

    def em(X, zd, wz, w):
        return cuda_em.em_step_fused(X, zd, wz, w, compute_ll=False, precision=precision,
                                     word=word)

    def em_ll(X, zd, wz, w):
        return cuda_em.em_step_fused(X, zd, wz, w, compute_ll=True, precision=precision,
                                     word=word)

    def refit(X, zd, wz, w):
        return cuda_em.refit_step_fused(X, zd, wz, w, compute_ll=False, precision=precision)

    def ll(X, zd, wz, w):
        return cuda_em.log_likelihood_fused(X, zd, wz, w, precision=precision)

    return {"em": em, "em_ll": em_ll, "refit": refit, "ll": ll}


def plain_steps(precision="default"):
    """The same step functions from the plain PyTorch ops on any device: the
    reference the kernels are held against (the bf16-responsibilities steps
    at ``"fast"``)."""
    if cuda_em._check_precision(precision):
        em, refit = em_ops.em_step_bf16r, em_ops.refit_step_bf16r
    else:
        em, refit = em_ops.em_step_dense, em_ops.refit_step_dense
    return {"em": em, "em_ll": em, "refit": refit, "ll": em_ops.log_likelihood_dense}


def fit_padded(Xd, zd, wz, w, n_iter, n_iter_per_test, tolerance, steps):
    """EM on padded device tensors with the folded-LL loop; a FitResult."""
    def step(state, fn):
        new_zd, new_wz, ll = fn(Xd, state[0], state[1], w)
        return (new_zd, new_wz), ll

    return em_fit_loop_folded(
        lambda s: step(s, steps["em_ll"]), lambda s: step(s, steps["em"]),
        lambda s: steps["ll"](Xd, s[0], s[1], w),
        (zd, wz), n_iter, n_iter_per_test, tolerance,
    )


def refit_padded(Xd, zd, wz, w, n_iter, n_iter_per_test, tolerance, steps):
    """Frozen-topics EM on padded device tensors; a FitResult."""
    def step(state):
        new_zd, ll = steps["refit"](Xd, state[0], state[1], w)
        return (new_zd, state[1]), ll

    return em_fit_loop(step, lambda s: steps["ll"](Xd, s[0], s[1], w),
                       (zd, wz), n_iter, n_iter_per_test, tolerance)


def _nnz_of(X):
    return int(X.nnz) if sp.issparse(X) else int(np.count_nonzero(X))


def _resolve_x_dtype(X, x_dtype, will_standardize=True):
    """``"auto"`` -> bfloat16 exactly when it is lossless (integer-valued
    counts <= 256), else float32; bfloat16 forces bfloat16 and any other
    dtype float32, as in the JAX package."""
    if x_dtype != "auto":
        return torch.bfloat16 if str(x_dtype) in ("bfloat16", "torch.bfloat16") else torch.float32
    vals = X.data if sp.issparse(X) else np.asarray(X).ravel()
    if vals.size == 0:
        return torch.float32
    if np.issubdtype(vals.dtype, np.integer):
        return torch.bfloat16 if vals.max() <= 256 else torch.float32
    if np.issubdtype(vals.dtype, np.floating) and not will_standardize:
        # float-typed but integral counts are bf16-exact when <= 256, valid
        # only when no l1-normalization follows
        if vals.size <= 50_000_000 and np.all(vals == np.round(vals)):
            return torch.bfloat16 if vals.max() <= 256 else torch.float32
    return torch.float32


def _stage_dense(X, device, x_dtype):
    """Stage the zero-padded ``(round_up(n, 8), round_up(m, 128))`` rectangle
    on ``device``, and its word-major nonzeros (the EM step's A is summed over
    them, one owner per word). The corpus ships as COO (O(nnz) bytes) and is
    densified on the device with one scatter; each (row, col) is unique, and
    bf16 is chosen only where it holds the counts exactly. Returns
    ``(Xd, n, m, word)``."""
    n, m = X.shape
    n_pad = round_up(max(n, 1), ROW_MULTIPLE)
    m_pad = round_up(max(m, 1), COL_MULTIPLE)
    rows, cols, vals = ship_coo(X, device)
    vals = vals.to(x_dtype)
    Xd = torch.zeros((n_pad, m_pad), dtype=x_dtype, device=device)
    Xd[rows, cols] = vals
    return Xd, n, m, word_side(rows, cols, vals, m_pad, n_pad)


class PreparedCounts:
    """A device-resident, padded count matrix reusable across fits, with its
    word-major nonzeros ``word`` (a :class:`~.cuda_sparse.Side`)."""

    __slots__ = ("device_array", "n", "m", "nnz", "backend", "word")

    def __init__(self, device_array, n, m, nnz, backend, word):
        self.device_array = device_array
        self.n = n
        self.m = m
        self.nnz = nnz
        self.backend = backend
        self.word = word

    @property
    def shape(self):
        return (self.n, self.m)


def prepare_counts(X, backend="auto", x_dtype="auto", standardize=True, device="cuda"):
    """Densify, pad, and ship a count matrix to ``device`` once.

    ``x_dtype``: ``"auto"`` stores bf16 exactly when that is lossless
    (integer counts <= 256), otherwise float32. ``standardize`` l1-normalizes
    float inputs, like the estimators do.
    """
    dev = resolve_device(device)
    backend = resolve_backend(backend, dev)
    if backend == "sparse":
        raise ValueError("prepare_counts stages the dense layout; use prepare_sell for "
                         "backend='sparse'")
    x_dtype = _resolve_x_dtype(X, x_dtype, will_standardize=standardize)
    if standardize:
        X = standardize_input(X)
    Xd, n, m, word = _stage_dense(X, dev, x_dtype)
    return PreparedCounts(Xd, n, m, _nnz_of(X), backend, word)


def _weights(sample_weight, n, n_pad, device):
    w = np.asarray(sample_weight, dtype=np.float32) if _weighted(sample_weight) else np.ones(
        n, np.float32)
    return torch.from_numpy(pad_vector(w, n_pad)).to(device)


def _stage_or_reuse(X, backend, x_dtype, device):
    """A :class:`PreparedCounts` of ``X`` (``X`` itself when it is one)."""
    if isinstance(X, PreparedCounts):
        return X
    dev = resolve_device(device)
    backend = resolve_backend(backend, dev)
    Xd, n, m, word = _stage_dense(X, dev, _resolve_x_dtype(X, x_dtype))
    return PreparedCounts(Xd, n, m, _nnz_of(X), backend, word)


def _check_prepared_init(X, init):
    if isinstance(X, (PreparedCounts, PreparedSell)) and init != "random" and not isinstance(
            init, (tuple, list)):
        raise ValueError(
            f"{type(X).__name__} supports init='random' or an explicit factor "
            "tuple; data-dependent inits need the raw matrix"
        )


def _weighted(sample_weight):
    return sample_weight is not None and bool(np.any(np.asarray(sample_weight) != 1.0))


def _info(n_steps, final_ll, ll_trace, n_tests, wall, nnz, k, backend):
    return {
        "n_steps": n_steps,
        "log_likelihood": final_ll,
        "ll_trace": ll_trace[:n_tests],
        "wall_time_s": wall,
        "nnz_k_updates_per_s": n_steps * nnz * k / max(wall, 1e-9),
        "backend": backend,
    }


def plsa_fit(
    X,
    k,
    sample_weight=None,
    init="random",
    n_iter=100,
    n_iter_per_test=10,
    tolerance=0.001,
    e_step_thresh=1e-32,
    random_state=None,
    backend="auto",
    x_dtype="auto",
    precision="default",
    return_info=False,
    device="cuda",
):
    """Fit pLSA factors ``(P(z|d), P(w|z))`` to a count matrix, a
    :class:`PreparedCounts` or a :class:`~.sell.PreparedSell`. Returns numpy
    float32 factors, and with ``return_info`` a dict with ``n_steps``,
    ``log_likelihood``, ``ll_trace``, ``wall_time_s``,
    ``nnz_k_updates_per_s`` and ``backend``.

    ``precision``: ``"default"`` and ``"highest"`` both run the fp32 kernel;
    ``"fast"`` runs its bf16-responsibilities mode (the LL sweep stays fp32).
    The sparse path has no such mode: ``"fast"`` warns there and runs fp32.
    ``e_step_thresh`` above 1e-30 routes raw input under ``backend="auto"``
    to the sparse path, the only one that applies it (exactly).
    """
    rng = check_random_state(random_state)
    cuda_em._check_precision(precision)
    _check_prepared_init(X, init)
    if _sparse_route(X, backend, e_step_thresh):
        if precision == "fast":
            _warn_fast_unsupported("sparse")
        return _plsa_fit_sparse(X, k, sample_weight, init, n_iter, n_iter_per_test,
                                tolerance, e_step_thresh, rng, return_info, device)
    prep = _stage_or_reuse(X, backend, x_dtype, device)
    p_z_given_d, p_w_given_z = plsa_init(X, k, init=init, rng=rng)
    Xd = prep.device_array
    dev = Xd.device
    zd, wz = pad_factors(p_z_given_d, p_w_given_z, Xd.shape[0], Xd.shape[1])
    w = _weights(sample_weight, prep.n, Xd.shape[0], dev)

    t0 = time.perf_counter()
    res = fit_padded(Xd, torch.from_numpy(zd).to(dev), torch.from_numpy(wz).to(dev),
                     w, n_iter, n_iter_per_test, tolerance, kernel_steps(precision, prep.word))
    zd_f, wz_f = res.state[0].cpu().numpy(), res.state[1].cpu().numpy()  # sync
    wall = time.perf_counter() - t0
    zd_out, wz_out = unpad_factors(zd_f, wz_f, prep.n, prep.m, k)
    if not return_info:
        return zd_out, wz_out
    return zd_out, wz_out, _info(res.n_steps, res.final_ll, res.ll_trace, res.n_tests, wall,
                                 prep.nnz, k, prep.backend)


def _plsa_fit_sparse(X, k, sample_weight, init, n_iter, n_iter_per_test, tolerance,
                     e_step_thresh, rng, return_info, device):
    """The sparse-backend fit: O(nnz) memory and work, exact ``e_step_thresh``.
    Standardization is the estimators' job, as on the dense path."""
    prep = X if isinstance(X, PreparedSell) else prepare_sell(X, standardize=False,
                                                              device=device)
    p_z_given_d, p_w_given_z = plsa_init(prep, k, init=init, rng=rng)
    weight = np.asarray(sample_weight, np.float32) if _weighted(sample_weight) else None
    t0 = time.perf_counter()
    zd, wz, n_steps, final_ll, ll_trace, n_tests = sell_fit(
        prep, p_z_given_d, p_w_given_z, sample_weight=weight, n_iter=n_iter,
        n_iter_per_test=n_iter_per_test, tolerance=tolerance, e_step_thresh=e_step_thresh)
    zd_out, wz_out = zd.cpu().numpy(), wz.cpu().numpy()  # sync
    wall = time.perf_counter() - t0
    if not return_info:
        return zd_out, wz_out
    return zd_out, wz_out, _info(n_steps, final_ll, ll_trace, n_tests, wall, prep.nnz, k,
                                 "sparse")


def plsa_refit(
    X,
    topics,
    sample_weight=None,
    n_iter=50,
    n_iter_per_test=10,
    tolerance=0.005,
    e_step_thresh=1e-32,
    random_state=None,
    backend="auto",
    x_dtype="auto",
    precision="default",
    device="cuda",
):
    """Fit only ``P(z|d)`` against frozen ``topics``; returns it as numpy.
    Routes to the sparse path as :func:`plsa_fit` does."""
    rng = check_random_state(random_state)
    cuda_em._check_precision(precision)
    k = topics.shape[0]
    p_z_given_d = rng.rand(X.shape[0], k)
    p_z_given_d /= p_z_given_d.sum(axis=1, keepdims=True)
    p_z_given_d = p_z_given_d.astype(np.float32)
    topics = np.asarray(topics, dtype=np.float32)
    if _sparse_route(X, backend, e_step_thresh):
        if precision == "fast":
            _warn_fast_unsupported("sparse refit")
        prep = X if isinstance(X, PreparedSell) else prepare_sell(X, standardize=False,
                                                                  device=device)
        weight = np.asarray(sample_weight, np.float32) if _weighted(sample_weight) else None
        zd = sell_refit(prep, p_z_given_d, topics, sample_weight=weight, n_iter=n_iter,
                        n_iter_per_test=n_iter_per_test, tolerance=tolerance,
                        e_step_thresh=e_step_thresh)[0]
        return zd.cpu().numpy()
    prep = _stage_or_reuse(X, backend, x_dtype, device)
    Xd = prep.device_array
    dev = Xd.device
    zd, wz = pad_factors(p_z_given_d, topics, Xd.shape[0], Xd.shape[1])
    w = _weights(sample_weight, prep.n, Xd.shape[0], dev)
    res = refit_padded(Xd, torch.from_numpy(zd).to(dev), torch.from_numpy(wz).to(dev),
                       w, n_iter, n_iter_per_test, tolerance, kernel_steps(precision))
    return res.state[0].cpu().numpy()[:prep.n, :k]
