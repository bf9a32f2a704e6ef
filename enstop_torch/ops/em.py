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

``precision="fast"`` has its own accumulators (``*_bf16r``), the
counterpart of ``_tile_math(bf16_r=True)`` in
``enstop_tpu/ops/pallas_em_variants.py``: ``S`` stays float32, the ratio is
``R = bf16(bf16(X) / bf16(max(S, 1e-30)))``, and the products take
``bf16(w * P(z|d))`` and ``bf16(P(w|z))`` with float32 accumulation (every
bf16 operand is widened to float32 first, so a bf16 product is exact and the
sums stay float32 on any device). The log-likelihood stays float32.

``em_accumulators_ratio`` is the plain version of the TPU experiment's
step in ``scripts/exp_divide_pipeline.py`` (``_make_em_call``): ``A`` and
``B`` without the LL, the ratio in one of seven modes (``RATIO_MODES``,
:func:`ratio`). ``"f32div"`` is :func:`em_accumulators_dense`'s ``A`` and
``B``, ``"bf16r"`` :func:`em_accumulators_bf16r`'s.

``batched_accumulators_dense`` is the plain version of the batched kernel
(``csrc/em_batch.cu``): the accumulators of R runs that share one X, run by
run, so no (R, n, m) tensor is ever made.

``CALLS`` counts calls of each accumulator function, so a run can show which
path it took.
"""

from __future__ import annotations

import torch

_TINY = 1e-30  # guard for S -> 0; stays in the f32 normal range

CALLS = {"em": 0, "refit": 0, "ll": 0, "em_bf16r": 0, "refit_bf16r": 0, "batch": 0,
         "em_ratio": 0}
# the E-step's ratio modes of scripts/exp_divide_pipeline.py (MODES), in its
# order: a mode's index is the kernels' RATIO (csrc/lane_walk.cuh)
RATIO_MODES = ("f32div", "recip_mul", "lax_recip", "nr1", "nr2", "bf16recip_x32", "bf16r")


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


def _products(R, p_z_given_d, p_w_given_z, sample_weight):
    """``A = (w * P(z|d))^T R`` and ``B = R P(w|z)^T``."""
    zd_w = p_z_given_d if sample_weight is None else (
        p_z_given_d * sample_weight.float()[:, None])
    return zd_w.t() @ R, R @ p_w_given_z.t()


def em_accumulators_dense(X, p_z_given_d, p_w_given_z, sample_weight=None):
    """The raw per-pass quantities ``(A, B, ll)``: ``A`` (k, m) weighted,
    ``B`` (n, k) unweighted, ``ll`` the log-likelihood of the input factors."""
    CALLS["em"] += 1
    Xf, nz, Ssafe, R = _responsibilities(X, p_z_given_d, p_w_given_z)
    A, B = _products(R, p_z_given_d, p_w_given_z, sample_weight)
    return A, B, _weighted_ll(Xf, nz, Ssafe, sample_weight)


def batched_accumulators_dense(X, zds, wzs, ws=None):
    """``(A (R, k, m), B (R, n, k))`` of R runs that share ``X``: run ``r``'s
    ``A`` weighted by ``ws[r]`` (``ws`` (R, n) or None), ``B`` never. Each
    run's pair is :func:`em_accumulators_dense`'s, computed one run at a time."""
    CALLS["batch"] += 1
    As, Bs = [], []
    for r in range(zds.shape[0]):
        R = _responsibilities(X, zds[r], wzs[r])[3]
        A, B = _products(R, zds[r], wzs[r], None if ws is None else ws[r])
        As.append(A)
        Bs.append(B)
    return torch.stack(As), torch.stack(Bs)


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


def _bf16(a):
    """Round to bfloat16 and widen back to float32."""
    return a.to(torch.bfloat16).float()


def _responsibilities_bf16r(X, p_z_given_d, p_w_given_z):
    Xf = X.float()
    Ssafe = (p_z_given_d @ p_w_given_z).clamp_min(_TINY)
    # X = 0 gives R = 0 exactly (bf16(S_safe) >= 1e-30 > 0), so no mask
    R = _bf16(_bf16(Xf) / _bf16(Ssafe))
    return Xf, Xf > 0, Ssafe, R


def em_accumulators_bf16r(X, p_z_given_d, p_w_given_z, sample_weight=None):
    """:func:`em_accumulators_dense` with bf16 responsibilities
    (``precision="fast"``): ``A`` weighted, ``B`` never, the LL float32."""
    CALLS["em_bf16r"] += 1
    Xf, nz, Ssafe, R = _responsibilities_bf16r(X, p_z_given_d, p_w_given_z)
    ll = _weighted_ll(Xf, nz, Ssafe, sample_weight)
    zd_w = p_z_given_d if sample_weight is None else (
        p_z_given_d * sample_weight.float()[:, None])
    A = _bf16(zd_w).t() @ R
    B = R @ _bf16(p_w_given_z).t()
    return A, B, ll


def em_step_bf16r(X, p_z_given_d, p_w_given_z, sample_weight=None):
    """One full EM step at ``precision="fast"``."""
    A, B, ll = em_accumulators_bf16r(X, p_z_given_d, p_w_given_z, sample_weight)
    return _rownorm(p_z_given_d * B), _rownorm(p_w_given_z * A), ll


def refit_accumulators_bf16r(X, p_z_given_d, p_w_given_z, sample_weight=None):
    """:func:`refit_accumulators_dense` with bf16 responsibilities; the weight
    enters the LL only."""
    CALLS["refit_bf16r"] += 1
    Xf, nz, Ssafe, R = _responsibilities_bf16r(X, p_z_given_d, p_w_given_z)
    return R @ _bf16(p_w_given_z).t(), _weighted_ll(Xf, nz, Ssafe, sample_weight)


def refit_step_bf16r(X, p_z_given_d, p_w_given_z, sample_weight=None):
    """One frozen-topics step at ``precision="fast"``."""
    B, ll = refit_accumulators_bf16r(X, p_z_given_d, p_w_given_z, sample_weight)
    return _rownorm(p_z_given_d * B), ll


def ratio(x, den, mode):
    """``x / den`` in ratio mode ``mode`` (``den`` already ``max(S, 1e-30)``),
    float32, as ``csrc/lane_walk.cuh`` states the modes: ``f32div`` divides,
    ``recip_mul`` and ``lax_recip`` multiply by the correctly rounded
    ``1 / den``; ``nr1``, ``nr2`` and ``bf16recip_x32`` multiply by the bf16
    reciprocal of ``bf16(den)`` (here correctly rounded) after one, two or no
    Newton steps ``y (2 - den y)``; ``bf16r`` is ``bf16(bf16(x) / bf16(den))``."""
    if mode == "f32div":
        return x / den
    if mode in ("recip_mul", "lax_recip"):
        return x * (1.0 / den)
    if mode == "bf16r":
        return _bf16(_bf16(x) / _bf16(den))
    if mode not in RATIO_MODES:
        raise ValueError(f"unknown ratio mode {mode!r}; one of {RATIO_MODES}")
    y = _bf16(1.0 / _bf16(den))
    for _ in range({"nr1": 1, "nr2": 2}.get(mode, 0)):
        y = y * (2.0 - den * y)
    return x * y


def em_accumulators_ratio(X, p_z_given_d, p_w_given_z, sample_weight=None, mode="f32div"):
    """``(A, B)`` of one EM step, no LL, with ``R = ratio(X, max(S, 1e-30),
    mode)``: ``A`` weighted, ``B`` never. ``"bf16r"`` also rounds the
    products' operands, as :func:`em_accumulators_bf16r` does; the other
    modes keep them float32."""
    Ssafe = (p_z_given_d @ p_w_given_z).clamp_min(_TINY)
    R = ratio(X.float(), Ssafe, mode)
    CALLS["em_ratio"] += 1
    if mode != "bf16r":
        return _products(R, p_z_given_d, p_w_given_z, sample_weight)
    zd_w = p_z_given_d if sample_weight is None else (
        p_z_given_d * sample_weight.float()[:, None])
    return _bf16(zd_w).t() @ R, R @ _bf16(p_w_given_z).t()
