"""Exact reference-semantics EM on COO nonzeros (counterpart of
``enstop_tpu/ops/coo.py``), in plain PyTorch.

The ``(nnz, k)`` responsibilities are materialized, and the ``e_step_thresh``
cutoff applies exactly: an unnormalized product ``P(w|z) P(z|d)`` at or below
the threshold drops from both the numerator and the normalizer (``>`` keeps
it). The log-likelihood is never thresholded. The sample weight goes on
``P(w|z)`` and the log-likelihood, never on ``P(z|d)``. Segment sums are
``index_add_`` over document and word ids.

This is the numerical oracle of the sparse passes (:mod:`.cuda_sparse`,
:mod:`.sell`). Zero-valued entries contribute nothing, so the arrays may be
padded with them.
"""

from __future__ import annotations

import torch

__all__ = ["e_step_coo", "m_step_coo", "em_step_coo", "log_likelihood_coo"]

_TINY = 1e-30


def e_step_coo(rows, cols, vals, p_z_given_d, p_w_given_z, probability_threshold=1e-32):
    """Responsibilities ``P(z|w,d)`` for each nonzero, ``(nnz, k)``; rows whose
    surviving mass is zero stay all-zero."""
    v = p_z_given_d[rows, :] * p_w_given_z[:, cols].t()
    v = torch.where(v > probability_threshold, v, 0.0)
    return v / v.sum(dim=1, keepdim=True).clamp_min(_TINY)


def m_step_coo(rows, cols, vals, resp, n, m, sample_weight=None):
    """M-step by segment sums; returns ``(P(z|d) (n, k), P(w|z) (k, m))``."""
    xw = vals[:, None].float() * resp
    xw_words = xw if sample_weight is None else xw * sample_weight[rows][:, None]
    k = resp.shape[1]
    pwz = torch.zeros((m, k), dtype=xw.dtype, device=xw.device).index_add_(0, cols, xw_words).t()
    pwz = pwz / pwz.sum(dim=1, keepdim=True).clamp_min(_TINY)
    pzd = torch.zeros((n, k), dtype=xw.dtype, device=xw.device).index_add_(0, rows, xw)
    pzd = pzd / pzd.sum(dim=1, keepdim=True).clamp_min(_TINY)
    return pzd, pwz


def em_step_coo(rows, cols, vals, p_z_given_d, p_w_given_z, n, m, sample_weight=None,
                probability_threshold=1e-32):
    """One exact EM step; also returns the log-likelihood of the input factors."""
    resp = e_step_coo(rows, cols, vals, p_z_given_d, p_w_given_z, probability_threshold)
    ll = log_likelihood_coo(rows, cols, vals, p_z_given_d, p_w_given_z, sample_weight)
    pzd, pwz = m_step_coo(rows, cols, vals, resp, n, m, sample_weight)
    return pzd, pwz, ll


def log_likelihood_coo(rows, cols, vals, p_z_given_d, p_w_given_z, sample_weight=None):
    """``sum_nnz w_d * x * log(max(sum_z P(z|d) P(w|z), 1e-30))``."""
    s = (p_z_given_d[rows, :] * p_w_given_z[:, cols].t()).sum(dim=1)
    term = torch.where(vals > 0, vals * torch.log(s.clamp_min(_TINY)), 0.0)
    if sample_weight is not None:
        term = term * sample_weight[rows]
    return term.sum()
