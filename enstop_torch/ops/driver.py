"""Fit and refit drivers: host-side orchestration around the EM loops
(counterpart of ``enstop_tpu/ops/driver.py``).

Initialise the factors on the host, stage the counts on the device as a
zero-padded dense matrix, run the EM loop, undo the padding.

Backends, resolved from the explicit ``device``:

``"cuda"``   the hand-written CUDA kernels of :mod:`.cuda_em` (``device="cuda"``)
``"torch"``  the plain PyTorch ops of :mod:`.em` (``device="cpu"``)
``"auto"``   whichever of the two matches the device

The sparse backend, and with it a materially firing ``e_step_thresh``, is not
ported yet and raises ``NotImplementedError``.
"""

from __future__ import annotations

import time

import numpy as np
import scipy.sparse as sp
import torch

from ..utils import check_random_state, standardize_input
from . import cuda_em, em as em_ops
from .data import (COL_MULTIPLE, ROW_MULTIPLE, pad_dense_counts, pad_factors, pad_vector,
                   round_up, unpad_factors)
from .fit import em_fit_loop, em_fit_loop_folded
from .init import plsa_init

__all__ = [
    "PreparedCounts", "prepare_counts", "plsa_fit", "plsa_refit",
    "resolve_device", "resolve_backend", "kernel_steps", "plain_steps",
    "fit_padded", "refit_padded",
]

# thresholds above this fire in f32 and need the exact (sparse) E-step
THRESH_MATERIAL = 1e-30


def resolve_device(device):
    """``torch.device`` for ``device``; raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r}, but torch.cuda.is_available() is False; "
            "pass device='cpu' for the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', not {device!r}")
    return dev


def resolve_backend(backend, device):
    if backend == "sparse":
        raise NotImplementedError(
            "backend='sparse' (the O(nnz) path) is not ported yet (ROADMAP.md)"
        )
    expected = "cuda" if device.type == "cuda" else "torch"
    if backend == "auto":
        return expected
    if backend not in ("cuda", "torch"):
        raise ValueError(f"Unrecognized backend {backend!r}")
    if backend != expected:
        raise ValueError(f"backend={backend!r} does not run on device {str(device)!r}; "
                         f"use {expected!r}")
    return backend


def _check_thresh(e_step_thresh):
    if e_step_thresh is not None and e_step_thresh > THRESH_MATERIAL:
        raise NotImplementedError(
            f"e_step_thresh={e_step_thresh} fires in float32 and needs the exact "
            "sparse E-step, which is not ported yet (ROADMAP.md)"
        )


def kernel_steps(precision="default"):
    """The step functions of the fit loops, through the :mod:`.cuda_em`
    wrappers (kernels on CUDA tensors, plain ops on CPU tensors)."""
    cuda_em._check_precision(precision)

    def em(X, zd, wz, w):
        return cuda_em.em_step_fused(X, zd, wz, w, compute_ll=False, precision=precision)

    def em_ll(X, zd, wz, w):
        return cuda_em.em_step_fused(X, zd, wz, w, compute_ll=True, precision=precision)

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
    on ``device``. A sparse corpus ships as COO (O(nnz) bytes) and is densified
    on the device with one scatter; each (row, col) is unique after
    ``sum_duplicates``, and bf16 is chosen only where it holds the counts
    exactly. Dense input is padded on the host and copied."""
    n, m = X.shape
    if not sp.issparse(X):
        Xd, n, m = pad_dense_counts(X)
        return torch.from_numpy(Xd).to(device=device, dtype=x_dtype), n, m
    n_pad = round_up(max(n, 1), ROW_MULTIPLE)
    m_pad = round_up(max(m, 1), COL_MULTIPLE)
    Xc = X.tocsr(copy=True)
    Xc.sum_duplicates()
    coo = Xc.tocoo()
    rows = torch.from_numpy(coo.row.astype(np.int64)).to(device)
    cols = torch.from_numpy(coo.col.astype(np.int64)).to(device)
    vals = torch.from_numpy(coo.data.astype(np.float32)).to(device)
    Xd = torch.zeros((n_pad, m_pad), dtype=x_dtype, device=device)
    Xd[rows, cols] = vals.to(x_dtype)
    return Xd, n, m


class PreparedCounts:
    """A device-resident, padded count matrix reusable across fits."""

    __slots__ = ("device_array", "n", "m", "nnz", "backend")

    def __init__(self, device_array, n, m, nnz, backend):
        self.device_array = device_array
        self.n = n
        self.m = m
        self.nnz = nnz
        self.backend = backend

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
    x_dtype = _resolve_x_dtype(X, x_dtype, will_standardize=standardize)
    if standardize:
        X = standardize_input(X)
    Xd, n, m = _stage_dense(X, dev, x_dtype)
    return PreparedCounts(Xd, n, m, _nnz_of(X), backend)


def _weights(sample_weight, n, n_pad, device):
    weighted = sample_weight is not None and bool(np.any(np.asarray(sample_weight) != 1.0))
    w = np.asarray(sample_weight, dtype=np.float32) if weighted else np.ones(n, np.float32)
    return torch.from_numpy(pad_vector(w, n_pad)).to(device)


def _stage_or_reuse(X, backend, x_dtype, device):
    if isinstance(X, PreparedCounts):
        return X.device_array, X.n, X.m, X.nnz, X.backend
    dev = resolve_device(device)
    backend = resolve_backend(backend, dev)
    Xd, n, m = _stage_dense(X, dev, _resolve_x_dtype(X, x_dtype))
    return Xd, n, m, _nnz_of(X), backend


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
    """Fit pLSA factors ``(P(z|d), P(w|z))`` to a count matrix or a
    :class:`PreparedCounts`. Returns numpy float32 factors, and with
    ``return_info`` a dict with ``n_steps``, ``log_likelihood``, ``ll_trace``,
    ``wall_time_s`` and ``nnz_k_updates_per_s``.

    ``precision``: ``"default"`` and ``"highest"`` both run the fp32 kernel;
    ``"fast"`` runs its bf16-responsibilities mode (the LL sweep stays fp32).
    """
    rng = check_random_state(random_state)
    steps = kernel_steps(precision)
    prepared = isinstance(X, PreparedCounts)
    if backend == "auto" and not prepared:
        _check_thresh(e_step_thresh)
    if prepared and init != "random" and not isinstance(init, (tuple, list)):
        raise ValueError(
            "PreparedCounts supports init='random' or an explicit factor "
            "tuple; data-dependent inits need the raw matrix"
        )
    Xd, n, m, nnz, backend = _stage_or_reuse(X, backend, x_dtype, device)
    p_z_given_d, p_w_given_z = plsa_init(X, k, init=init, rng=rng)
    dev = Xd.device
    zd, wz = pad_factors(p_z_given_d, p_w_given_z, Xd.shape[0], Xd.shape[1])
    w = _weights(sample_weight, n, Xd.shape[0], dev)

    t0 = time.perf_counter()
    res = fit_padded(Xd, torch.from_numpy(zd).to(dev), torch.from_numpy(wz).to(dev),
                     w, n_iter, n_iter_per_test, tolerance, steps)
    zd_f, wz_f = res.state[0].cpu().numpy(), res.state[1].cpu().numpy()  # sync
    wall = time.perf_counter() - t0
    zd_out, wz_out = unpad_factors(zd_f, wz_f, n, m, k)
    if not return_info:
        return zd_out, wz_out
    return zd_out, wz_out, {
        "n_steps": res.n_steps,
        "log_likelihood": res.final_ll,
        "ll_trace": res.ll_trace[: res.n_tests],
        "wall_time_s": wall,
        "nnz_k_updates_per_s": res.n_steps * nnz * k / max(wall, 1e-9),
        "backend": backend,
    }


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
    """Fit only ``P(z|d)`` against frozen ``topics``; returns it as numpy."""
    rng = check_random_state(random_state)
    steps = kernel_steps(precision)
    k = topics.shape[0]
    if backend == "auto" and not isinstance(X, PreparedCounts):
        _check_thresh(e_step_thresh)
    Xd, n, m, _nnz, _backend = _stage_or_reuse(X, backend, x_dtype, device)
    p_z_given_d = rng.rand(n, k)
    p_z_given_d /= p_z_given_d.sum(axis=1, keepdims=True)
    p_z_given_d = p_z_given_d.astype(np.float32)
    dev = Xd.device
    zd, wz = pad_factors(p_z_given_d, np.asarray(topics, dtype=np.float32),
                         Xd.shape[0], Xd.shape[1])
    w = _weights(sample_weight, n, Xd.shape[0], dev)
    res = refit_padded(Xd, torch.from_numpy(zd).to(dev), torch.from_numpy(wz).to(dev),
                       w, n_iter, n_iter_per_test, tolerance, steps)
    return res.state[0].cpu().numpy()[:n, :k]
