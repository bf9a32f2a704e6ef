"""pLSA EM in matmul form: the plain PyTorch versions (counterpart of
``enstop_tpu/ops/em.py``).

With the E-step substituted into the M-step, one EM pass is

    S   = P(z|d) @ P(w|z)                    predicted P(w|d)
    R   = X / max(S, 1e-30)  where X > 0, else 0
    A   = (w * P(z|d))^T @ R                 (k, m), sample-weighted
    B   = R @ P(w|z)^T                       (n, k), never weighted
    P(w|z) <- rownorm(P(w|z) * A)
    P(z|d) <- rownorm(P(z|d) * B)
    LL(inputs) = sum(w * X * log max(S, 1e-30))

These functions run on any device. On the CPU they are the port's fit path;
on the GPU they are the reference the CUDA kernels of :mod:`.cuda_em` are
checked against. Zero padding of ``X`` and the factors is absorbing.

``CALLS`` counts calls of each accumulator function, so a run can show which
path it took.
"""

from __future__ import annotations

import torch

_TINY = 1e-30  # guard for S -> 0; stays in the f32 normal range

CALLS = {"em": 0, "refit": 0, "ll": 0}


def _rownorm(a):
    """l1-normalize rows; all-zero rows stay zero."""
    return a / a.sum(dim=-1, keepdim=True).clamp_min(_TINY)


def _responsibilities(X, p_z_given_d, p_w_given_z):
    Xf = X.float()
    S = p_z_given_d @ p_w_given_z
    nz = Xf > 0
    Ssafe = S.clamp_min(_TINY)
    R = torch.where(nz, Xf / Ssafe, 0.0)
    return Xf, nz, Ssafe, R


def _weighted_ll(Xf, nz, Ssafe, sample_weight):
    llmat = torch.where(nz, Xf * torch.log(Ssafe), 0.0)
    if sample_weight is None:
        return llmat.sum()
    return (llmat * sample_weight.float()[:, None]).sum()


def em_accumulators_dense(X, p_z_given_d, p_w_given_z, sample_weight=None):
    """The raw per-pass quantities ``(A, B, ll)``: ``A`` (k, m) weighted,
    ``B`` (n, k) unweighted, ``ll`` the log-likelihood of the input factors."""
    CALLS["em"] += 1
    Xf, nz, Ssafe, R = _responsibilities(X, p_z_given_d, p_w_given_z)
    ll = _weighted_ll(Xf, nz, Ssafe, sample_weight)
    zd_w = p_z_given_d if sample_weight is None else (
        p_z_given_d * sample_weight.float()[:, None])
    A = zd_w.t() @ R
    B = R @ p_w_given_z.t()
    return A, B, ll


def em_step_dense(X, p_z_given_d, p_w_given_z, sample_weight=None):
    """One full EM step; returns ``(next_zd, next_wz, ll_of_inputs)``."""
    A, B, ll = em_accumulators_dense(X, p_z_given_d, p_w_given_z, sample_weight)
    return _rownorm(p_z_given_d * B), _rownorm(p_w_given_z * A), ll


def refit_accumulators_dense(X, p_z_given_d, p_w_given_z, sample_weight=None):
    """``(B, ll)`` with frozen topics; the weight enters the LL only."""
    CALLS["refit"] += 1
    Xf, nz, Ssafe, R = _responsibilities(X, p_z_given_d, p_w_given_z)
    return R @ p_w_given_z.t(), _weighted_ll(Xf, nz, Ssafe, sample_weight)


def refit_step_dense(X, p_z_given_d, p_w_given_z, sample_weight=None):
    """One EM step with frozen topics: only ``P(z|d)`` updates. Like the
    reference refit M-step, ``sample_weight`` is ignored in the accumulation."""
    B, ll = refit_accumulators_dense(X, p_z_given_d, p_w_given_z, sample_weight)
    return _rownorm(p_z_given_d * B), ll


def log_likelihood_dense(X, p_z_given_d, p_w_given_z, sample_weight=None):
    """``sum_nnz w_d * x * log(max(sum_z P(w|z) P(z|d), 1e-30))``."""
    CALLS["ll"] += 1
    Xf = X.float()
    nz = Xf > 0
    Ssafe = (p_z_given_d @ p_w_given_z).clamp_min(_TINY)
    return _weighted_ll(Xf, nz, Ssafe, sample_weight)
