"""The reference's import path ``plsa`` (counterpart of ``enstop_tpu/plsa.py``):
``enstop_torch.plsa.plsa_fit_inner`` is the reference's
``enstop.plsa.plsa_fit_inner``, and so on.

Besides the estimator and the functional fits it exports the reference's
module-public kernel API with its numba calling convention: the COO arrays
passed separately, the output arrays mutated in place *and* returned, the
norm scratch arrays filled. Each step function ships its inputs to
``device`` (the card by default), runs the exact COO semantics of
:mod:`.ops.coo` there (the ``(nnz, k)`` responsibilities materialised, the
threshold applied with ``>``) and writes the result back into the caller's
numpy arrays.

``plsa_fit_inner`` and ``plsa_refit_inner`` keep the reference's schedule
exactly (a test at ``i % n_iter_per_test == 0`` against the pre-loop
log-likelihood, ``change == 0`` stops; the refit's gate on a positive
log-likelihood, which never holds, so all ``n_iter`` steps run), but run each
step on the O(nnz) sparse passes (:func:`.ops.sell.em_step_sell`,
:func:`.ops.sell.refit_step_sell`: kernels #8 and #9 on the card, their plain
versions on the CPU). Any threshold above 0 runs the passes' thresholded
modes: the reference's 1e-32 fires on float32 products of small
probabilities, so it is not the no-op that the estimators treat it as. The
factors stay on the device; only the tested log-likelihoods come back to the
host, at test points.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.plsa import PLSA
from .ops import coo as _coo
from .ops.cuda_sparse import build_side
from .ops.data import resolve_device
from .ops.driver import plsa_fit, plsa_refit
from .ops.init import plsa_init
from .ops.sell import PreparedSell, em_step_sell, log_likelihood_sell, refit_step_sell, word_side

__all__ = [
    "PLSA",
    "plsa_fit",
    "plsa_refit",
    "plsa_init",
    "norm",
    "plsa_e_step",
    "plsa_m_step",
    "plsa_m_step_w_sample_weight",
    "log_likelihood",
    "plsa_refit_m_step",
    "plsa_fit_inner",
    "plsa_refit_inner",
]


def norm(x):
    """l2-norm of a vector."""
    return float(np.linalg.norm(x))


def _coo_on(X_rows, X_cols, X_vals, dev):
    return (torch.as_tensor(np.asarray(X_rows), dtype=torch.int64, device=dev),
            torch.as_tensor(np.asarray(X_cols), dtype=torch.int64, device=dev),
            torch.as_tensor(np.asarray(X_vals), dtype=torch.float32, device=dev))


def _f32(a, dev):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)


def _write(out, value):
    """Copy a tensor into the caller's array in place, in the array's dtype."""
    out[:] = value.cpu().numpy().astype(out.dtype, copy=False)
    return out


def plsa_e_step(
    X_rows,
    X_cols,
    X_vals,
    p_w_given_z,
    p_z_given_d,
    p_z_given_wd,
    probability_threshold=1e-32,
    device="cuda",
):
    """E-step: responsibilities ``P(z|w,d)`` per nonzero, written into
    ``p_z_given_wd`` (nnz, k) and returned."""
    dev = resolve_device(device)
    rows, cols, vals = _coo_on(X_rows, X_cols, X_vals, dev)
    resp = _coo.e_step_coo(rows, cols, vals, _f32(p_z_given_d, dev), _f32(p_w_given_z, dev),
                           probability_threshold=probability_threshold)
    return _write(p_z_given_wd, resp)


def _fill_norms(rows, vals, resp, sample_weight, norm_pwz, norm_pdz):
    """The norm scratch arrays hold the un-normalised factor row sums on
    return (the weight on ``norm_pwz`` only), summed in float64."""
    xw = vals.double()[:, None] * resp.double()
    if norm_pwz is not None:
        xw_w = xw if sample_weight is None else xw * sample_weight.double()[rows][:, None]
        _write(norm_pwz, xw_w.sum(dim=0))
    if norm_pdz is not None:
        sums = torch.zeros(norm_pdz.shape[0], dtype=torch.float64, device=xw.device)
        _write(norm_pdz, sums.index_add_(0, rows, xw.sum(dim=1)))


def _m_step(X_rows, X_cols, X_vals, p_w_given_z, p_z_given_d, p_z_given_wd, sample_weight,
            norm_pwz, norm_pdz, device, frozen_topics=False):
    dev = resolve_device(device)
    rows, cols, vals = _coo_on(X_rows, X_cols, X_vals, dev)
    resp = _f32(p_z_given_wd, dev)
    w = None if sample_weight is None else _f32(sample_weight, dev)
    pzd, pwz = _coo.m_step_coo(rows, cols, vals, resp, p_z_given_d.shape[0],
                               p_w_given_z.shape[1], sample_weight=w)
    if not frozen_topics:
        _write(p_w_given_z, pwz)
    _write(p_z_given_d, pzd)
    _fill_norms(rows, vals, resp, w, norm_pwz, norm_pdz)
    return p_w_given_z, p_z_given_d


def plsa_m_step(
    X_rows, X_cols, X_vals, p_w_given_z, p_z_given_d, p_z_given_wd, norm_pwz, norm_pdz,
    device="cuda",
):
    """M-step: re-estimate ``P(w|z)`` and ``P(z|d)`` from the
    responsibilities, in place; returns both."""
    return _m_step(X_rows, X_cols, X_vals, p_w_given_z, p_z_given_d, p_z_given_wd, None,
                   norm_pwz, norm_pdz, device)


def plsa_m_step_w_sample_weight(
    X_rows,
    X_cols,
    X_vals,
    p_w_given_z,
    p_z_given_d,
    p_z_given_wd,
    sample_weight,
    norm_pwz,
    norm_pdz,
    device="cuda",
):
    """Weighted M-step: the weight applies to the ``P(w|z)`` accumulation and
    its normaliser only, never to ``P(z|d)``."""
    return _m_step(X_rows, X_cols, X_vals, p_w_given_z, p_z_given_d, p_z_given_wd,
                   sample_weight, norm_pwz, norm_pdz, device)


def log_likelihood(X_rows, X_cols, X_vals, p_w_given_z, p_z_given_d, sample_weight,
                   device="cuda"):
    """The weighted data log-likelihood over the nonzeros, as a float."""
    dev = resolve_device(device)
    rows, cols, vals = _coo_on(X_rows, X_cols, X_vals, dev)
    return float(_coo.log_likelihood_coo(rows, cols, vals, _f32(p_z_given_d, dev),
                                         _f32(p_w_given_z, dev),
                                         sample_weight=_f32(sample_weight, dev)))


def plsa_refit_m_step(
    X_rows,
    X_cols,
    X_vals,
    p_w_given_z,
    p_z_given_d,
    p_z_given_wd,
    sample_weight,
    norm_pdz,
    device="cuda",
):
    """Refit M-step: the topics frozen, only ``P(z|d)`` re-estimated (as in
    the reference, ``sample_weight`` does not enter it)."""
    return _m_step(X_rows, X_cols, X_vals, p_w_given_z, p_z_given_d, p_z_given_wd, None,
                   None, norm_pdz, device, frozen_topics=True)


def _sides(X_rows, X_cols, X_vals, n, m, dev, word=True):
    """The caller's COO as a :class:`~.ops.sell.PreparedSell` (the values as
    given: no standardising); without ``word`` only the doc-major side, all
    that a refit reads."""
    rows, cols, vals = _coo_on(X_rows, X_cols, X_vals, dev)
    order = torch.sort(rows, stable=True).indices
    rows, cols, vals = rows[order], cols[order], vals[order]
    return PreparedSell(build_side(rows, cols, vals, n, m),
                        word_side(rows, cols, vals, m, n) if word else None, n, m)


def _weights(sample_weight, n, dev):
    if sample_weight is None:
        return torch.ones(n, dtype=torch.float32, device=dev)
    return _f32(sample_weight, dev)


def _threshold(e_step_thresh):
    """The passes' threshold: any value above 0 is applied exactly."""
    return float(e_step_thresh) if e_step_thresh is not None and e_step_thresh > 0 else None


def plsa_fit_inner(
    X_rows,
    X_cols,
    X_vals,
    p_w_given_z,
    p_z_given_d,
    sample_weight,
    n_iter=100,
    n_iter_per_test=10,
    tolerance=0.001,
    e_step_thresh=1e-32,
    use_sample_weights=False,
    device="cuda",
):
    """EM from the caller's factors, the reference's schedule exactly: a test
    at ``i % n_iter_per_test == 0`` against the pre-loop log-likelihood (the
    log-likelihood always weighted by ``sample_weight``; the M-step's
    ``P(w|z)`` only with ``use_sample_weights``). Writes the fitted factors
    into ``p_z_given_d`` and ``p_w_given_z`` and returns
    ``(p_z_given_d, p_w_given_z)``."""
    dev = resolve_device(device)
    n, m = p_z_given_d.shape[0], p_w_given_z.shape[1]
    prep = _sides(X_rows, X_cols, X_vals, n, m, dev)
    zd, wz = _f32(p_z_given_d, dev), _f32(p_w_given_z, dev)
    w = _weights(sample_weight, n, dev)
    # the doc pass leaves P(z|d) unweighted, so this weight reaches P(w|z) only
    w_step = w if use_sample_weights else torch.ones_like(w)
    thresh = _threshold(e_step_thresh)

    previous_log_likelihood = float(log_likelihood_sell(prep, zd, wz, w))
    for i in range(n_iter):
        zd, wz, _ = em_step_sell(prep, zd, wz, w_step, thresh, compute_ll=False)
        if i % n_iter_per_test == 0:
            current_log_likelihood = float(log_likelihood_sell(prep, zd, wz, w))
            change = np.abs(current_log_likelihood - previous_log_likelihood)
            if change == 0 or change / np.abs(current_log_likelihood) < tolerance:
                break
            previous_log_likelihood = current_log_likelihood

    _write(p_w_given_z, wz)
    _write(p_z_given_d, zd)
    return p_z_given_d, p_w_given_z


def plsa_refit_inner(
    X_rows,
    X_cols,
    X_vals,
    topics,
    p_z_given_d,
    sample_weight,
    n_iter=50,
    n_iter_per_test=10,
    tolerance=0.005,
    e_step_thresh=1e-32,
    device="cuda",
):
    """Frozen-topics EM from the caller's ``p_z_given_d``, the reference's
    schedule exactly, its convergence gate included: the gate asks for a
    positive log-likelihood, which never holds, so all ``n_iter`` steps run.
    Writes the result into ``p_z_given_d`` and returns it."""
    dev = resolve_device(device)
    n, m = p_z_given_d.shape[0], topics.shape[1]
    prep = _sides(X_rows, X_cols, X_vals, n, m, dev, word=False)
    zd, wz = _f32(p_z_given_d, dev), _f32(topics, dev)
    w = _weights(sample_weight, n, dev)
    thresh = _threshold(e_step_thresh)

    previous_log_likelihood = float(log_likelihood_sell(prep, zd, wz, w))
    for i in range(n_iter):
        zd, _ = refit_step_sell(prep, zd, wz, w, thresh, compute_ll=False)
        if i % n_iter_per_test == 0:
            current_log_likelihood = float(log_likelihood_sell(prep, zd, wz, w))
            if current_log_likelihood > 0:
                change = np.abs(current_log_likelihood - previous_log_likelihood)
                if change / np.abs(current_log_likelihood) < tolerance:
                    break
                previous_log_likelihood = current_log_likelihood

    return _write(p_z_given_d, zd)
