"""pLSA by expectation maximisation, written out plainly over the nonzeros.

This is the semantics the port has to reproduce, from the reference
library (lmcinnes/enstop ``plsa.py``: ``plsa_e_step``, ``plsa_m_step``,
``plsa_fit_inner``, ``plsa_refit_inner``, ``log_likelihood``):

* E step, for each nonzero ``x = X[d, w]``:
  ``P(z|w,d) = P(z|d) P(w|z) / sum_z' P(z'|d) P(w|z')``;
* M step: ``P(w|z) ∝ sum_d x P(z|w,d)`` (each document's terms times its
  sample weight) and ``P(z|d) ∝ sum_w x P(z|w,d)``, each row normalised;
* the log-likelihood ``sum x w_d log sum_z P(z|d) P(w|z)``, with the sum
  floored at 1e-30;
* the schedule: a test after step 1 and then every ``n_iter_per_test``
  steps; a test stops the fit at that step when the relative change of the
  log-likelihood, ``|cur - prev| / |cur|``, is below ``tolerance`` or the
  change is 0; ``n_iter`` steps at most;
* the random init: ``RandomState(seed)``, ``rand(k, n_words)`` then
  ``rand(n_docs, k)``, rows normalised, stored as float32; the refit
  (``transform``) draws ``rand(n_docs, k)`` from ``RandomState(42)``.

The arithmetic is float64 (``mode="exact"``) unless ``mode="bf16r"``, the
control: float32 with the E step's ratio ``x / sum`` and the products'
operands rounded to bfloat16, the step a faster implementation would take.

The corpus is held as COO on a torch device and every pass runs over it in
blocks of ``BLOCK`` nonzeros, so no (nnz, k) array exists at once.

A test decision within ``DECIDE_MARGIN`` of the threshold can go either way
in float32 arithmetic; the reference then keeps the state of that test
point as a candidate and goes on, and an answer is judged against the
nearest candidate (:mod:`.compare`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

TINY = 1e-30
BLOCK = 1 << 22
DECIDE_MARGIN = 2e-5  # on |cur - prev| / |cur|: float32 sums agree far closer


class Coo(NamedTuple):
    rows: torch.Tensor   # int64
    cols: torch.Tensor   # int64
    vals: torch.Tensor   # float64
    n: int
    m: int


def coo_of(csr, device):
    """The nonzeros of a scipy CSR matrix on ``device``."""
    csr = csr.tocsr()
    rows = np.repeat(np.arange(csr.shape[0], dtype=np.int64), np.diff(csr.indptr))
    return Coo(torch.from_numpy(rows).to(device),
               torch.from_numpy(csr.indices.astype(np.int64)).to(device),
               torch.from_numpy(csr.data.astype(np.float64)).to(device), *csr.shape)


def _normalised_rows(a):
    """Rows l1-normalised in float64, zero rows left alone, as float32."""
    s = a.sum(axis=1, keepdims=True)
    return (a / np.where(s > 0.0, s, 1.0)).astype(np.float32)


def random_init(n_docs, n_words, k, seed):
    """``(P(z|d), P(w|z))`` of the fit's random init for ``seed``."""
    rng = np.random.RandomState(seed)
    wz = rng.rand(k, n_words)
    zd = rng.rand(n_docs, k)
    return _normalised_rows(zd), _normalised_rows(wz)


def refit_init(n_docs, k, seed=42):
    """``P(z|d)`` of the refit's init."""
    return _normalised_rows(np.random.RandomState(seed).rand(n_docs, k))


def _bf16(a):
    return a.to(torch.bfloat16).to(a.dtype)


def _rownorm(a):
    return a / a.sum(dim=1, keepdim=True).clamp_min(TINY)


def em_pass(coo, zd, wz, weight=None, refit=False, mode="exact"):
    """One EM step from ``(zd, wz)``: ``((zd', wz'), LL(zd, wz))``; with
    ``refit`` the topics stay as they are."""
    bf16r = mode == "bf16r"
    wzT = wz.t().contiguous()
    B = torch.zeros_like(zd)
    A_T = None if refit else torch.zeros_like(wzT)
    ll = torch.zeros((), dtype=zd.dtype, device=zd.device)
    for lo in range(0, coo.vals.numel(), BLOCK):
        r, c = coo.rows[lo:lo + BLOCK], coo.cols[lo:lo + BLOCK]
        x = coo.vals[lo:lo + BLOCK].to(zd.dtype)
        zr, wc = zd[r], wzT[c]
        s = (zr * wc).sum(1).clamp_min(TINY)
        w = None if weight is None else weight[r]
        ll += (x * torch.log(s) if w is None else w * x * torch.log(s)).sum()
        if bf16r:
            ratio, zr, wc = _bf16(_bf16(x) / _bf16(s)), _bf16(zr), _bf16(wc)
        else:
            ratio = x / s
        B.index_add_(0, r, wc * ratio[:, None])
        if not refit:
            A_T.index_add_(0, c, zr * (ratio if w is None else ratio * w)[:, None])
    new_zd = _rownorm(zd * B)
    new_wz = wz if refit else _rownorm(wz * A_T.t())
    return (new_zd, new_wz), ll


def _decide(prev, cur, tolerance):
    """``"stop"``, ``"go"`` or ``"either"`` for a test of ``cur`` after ``prev``."""
    change = abs(cur - prev)
    ratio = change / abs(cur) if cur != 0.0 else (0.0 if change == 0.0 else np.inf)
    if tolerance > 0.0 and ratio < tolerance - DECIDE_MARGIN:
        return "stop"
    if abs(ratio - tolerance) <= DECIDE_MARGIN:
        return "either"
    return "go"


class Candidate(NamedTuple):
    n_steps: int
    zd: torch.Tensor
    wz: torch.Tensor


def em(coo, zd0, wz0, n_iter, n_iter_per_test, tolerance, weight=None, refit=False,
       mode="exact"):
    """Run the schedule from numpy ``(zd0, wz0)``; the list of
    :class:`Candidate` answers, the fit's own stopping point last."""
    dtype = torch.float32 if mode == "bf16r" else torch.float64
    dev = coo.vals.device
    state = tuple(torch.as_tensor(a).to(device=dev, dtype=dtype) for a in (zd0, wz0))
    w = None if weight is None else torch.as_tensor(weight).to(device=dev, dtype=dtype)
    npt = max(int(n_iter_per_test), 1)
    candidates = []
    if n_iter <= 0:
        return [Candidate(0, *state)]
    nxt, prev = em_pass(coo, *state, weight=w, refit=refit, mode=mode)
    prev = float(prev)
    steps = 0
    while steps < n_iter:
        state, steps = nxt, steps + 1
        tested = steps == 1 or (steps - 1) % npt == 0
        if steps < n_iter:
            nxt, ll = em_pass(coo, *state, weight=w, refit=refit, mode=mode)
        elif tested:
            ll = em_pass(coo, *state, weight=w, refit=True, mode=mode)[1]
        if tested:
            cur = float(ll)
            verdict = _decide(prev, cur, float(tolerance))
            prev = cur
            if verdict == "stop":
                break
            if verdict == "either":
                candidates.append(Candidate(steps, *(a.clone() for a in state)))
    candidates.append(Candidate(steps, *state))
    return candidates


def fit(csr, k, seed, n_iter, n_iter_per_test, tolerance, device, mode="exact"):
    """The candidates of ``PLSA(n_components=k, random_state=seed, ...)
    .fit(csr)``: zero rows are set aside before the init, as the reference
    library does, and come back as zero rows of ``P(z|d)``."""
    csr = csr.tocsr()
    good = np.diff(csr.indptr) > 0
    sub = csr[good] if not good.all() else csr
    zd0, wz0 = random_init(sub.shape[0], sub.shape[1], k, seed)
    out = []
    for c in em(coo_of(sub, device), zd0, wz0, n_iter, n_iter_per_test, tolerance,
                mode=mode):
        zd = c.zd
        if not good.all():
            zd = torch.zeros((csr.shape[0], k), dtype=c.zd.dtype, device=c.zd.device)
            zd[torch.from_numpy(good).to(zd.device)] = c.zd
        out.append(Candidate(c.n_steps, zd, c.wz))
    return out


def refit(csr, topics, device, n_iter=50, n_iter_per_test=5, tolerance=1e-3, mode="exact"):
    """The candidates of ``PLSA.transform(csr)`` against ``topics`` (k, n_words)."""
    csr = csr.tocsr()
    zd0 = refit_init(csr.shape[0], topics.shape[0])
    return em(coo_of(csr, device), zd0, np.asarray(topics, np.float32), n_iter,
              n_iter_per_test, tolerance, refit=True, mode=mode)
