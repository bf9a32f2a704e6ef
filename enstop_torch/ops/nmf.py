"""Non-negative matrix factorization (counterpart of ``enstop_tpu/ops/nmf.py``).

Two solvers:

* coordinate descent on the Frobenius loss (:func:`nmf_cd`), a NumPy copy of
  scikit-learn 1.9's ``solver="cd"`` (``_fit_coordinate_descent`` and the
  Cython sweep ``_update_cdnmf_fast``) with its NNDSVD and random starts. It
  serves ``init="nmf"`` (:func:`nmf_frobenius_init`, scikit-learn's
  ``non_negative_factorization(init="nndsvd", solver="cd", tol=1e-2,
  max_iter=100)``, which the JAX package calls) and the ensemble's
  ``solver="cd"``. It runs on the host: a sweep is ``k`` passes over the rows
  of a thin ``(n, k)`` factor. Within one component the rows' updates are
  independent, so each pass is one vectorised update of a column.
* multiplicative updates (:func:`nmf_fit_mu`), KL or Frobenius, in torch on
  ``device``: the ensemble's ``model="nmf"`` runs. The JAX package computes
  their products densely in XLA, not in a Pallas kernel. Here the KL
  update's two products are the pLSA sparse passes with unnormalised
  factors: with ``s = (W H)[d, w]`` at each nonzero, ``(X / WH) H^T`` is the
  doc pass's B of ``(W, H^T)`` and ``(X / WH)^T W`` the word pass's A, so KL
  runs on kernels #8 and #9 (``csrc/em_sparse.cu``) in O(nnz k) with no
  dense X. The Frobenius update needs ``W H`` everywhere: it densifies the
  corpus on the device and multiplies with ``torch.matmul`` in full float32
  (TF32 off). The TPU's 8/128 padding is not carried over.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..cluster.distances import full_fp32_matmul
from ..profiling import count, span
from ..utils import check_random_state
from .cuda_sparse import doc_pass, word_pass
from .data import resolve_device, ship_coo
from .em import _TINY
from .init import nndsvd_init, randomized_svd
from .sell import prepare_sell

__all__ = ["nmf_cd", "nmf_frobenius_init", "nmf_fit_mu"]



def _as_float_matrix(X):
    """A CSR matrix or ndarray of float64, or float32 when ``X`` is float32
    (scikit-learn's ``check_array(dtype=[np.float64, np.float32])``)."""
    dtype = np.float32 if X.dtype == np.float32 else np.float64
    if sp.issparse(X):
        X = sp.csr_matrix(X)
        return X if X.dtype == dtype else X.astype(dtype)
    return np.asarray(X, dtype=dtype)


def _sklearn_start(X, k, init, rng):
    """scikit-learn's ``_initialize_nmf`` for ``"nndsvd"`` and ``"random"``:
    its own NNDSVD loop (the vectorised :func:`~.init.nndsvd_init` rounds
    the norms differently), entries below 1e-6 set to 0."""
    n, m = X.shape
    if init == "random":
        avg = np.sqrt(X.mean() / k)
        H = avg * rng.standard_normal(size=(k, m)).astype(X.dtype, copy=False)
        W = avg * rng.standard_normal(size=(n, k)).astype(X.dtype, copy=False)
        return np.abs(W), np.abs(H)
    if init != "nndsvd":
        raise ValueError(f"the cd solver starts from 'nndsvd' or 'random', not {init!r}")
    if k > min(n, m):
        raise ValueError(f"init='nndsvd' needs n_components <= min(n_samples, n_features); "
                         f"got {k} for {X.shape}")
    U, S, V = randomized_svd(X, k, rng)
    W, H = np.zeros_like(U), np.zeros_like(V)
    W[:, 0] = np.sqrt(S[0]) * np.abs(U[:, 0])
    H[0, :] = np.sqrt(S[0]) * np.abs(V[0, :])
    for j in range(1, k):
        x, y = U[:, j], V[j, :]
        x_p, y_p = np.maximum(x, 0), np.maximum(y, 0)
        x_n, y_n = np.abs(np.minimum(x, 0)), np.abs(np.minimum(y, 0))
        x_p_nrm, y_p_nrm = np.sqrt(np.dot(x_p, x_p)), np.sqrt(np.dot(y_p, y_p))
        x_n_nrm, y_n_nrm = np.sqrt(np.dot(x_n, x_n)), np.sqrt(np.dot(y_n, y_n))
        m_p, m_n = x_p_nrm * y_p_nrm, x_n_nrm * y_n_nrm
        if m_p > m_n:
            u, v, sigma = x_p / x_p_nrm, y_p / y_p_nrm, m_p
        else:
            u, v, sigma = x_n / x_n_nrm, y_n / y_n_nrm, m_n
        lbd = np.sqrt(S[j] * sigma)
        W[:, j] = lbd * u
        H[j, :] = lbd * v
    W[W < 1e-6] = 0
    H[H < 1e-6] = 0
    return W, H


def _cd_sweep(X, W, Ht, l1_reg, l2_reg):
    """One pass over the components of ``W`` (in place) against fixed
    ``Ht``; returns the sum of the projected gradients' magnitudes."""
    k = Ht.shape[1]
    HHt = Ht.T @ Ht
    XHt = np.asarray(X @ Ht)
    if l2_reg != 0.0:
        HHt.flat[:: k + 1] += l2_reg
    if l1_reg != 0.0:
        XHt -= l1_reg
    violation = W.dtype.type(0)
    for t in range(k):
        grad = W @ HHt[t] - XHt[:, t]
        pg = np.where(W[:, t] == 0, np.minimum(grad, 0), grad)
        violation += np.abs(pg).sum()
        if HHt[t, t] != 0:
            W[:, t] = np.maximum(W[:, t] - grad / HHt[t, t], 0)
    return violation


def nmf_cd(X, k, init="nndsvd", tol=1e-4, max_iter=200, l1_reg=0.0, l2_reg=0.0,
           random_state=None):
    """Frobenius NMF ``X ~ W H`` by coordinate descent, as scikit-learn's
    ``NMF(solver="cd", shuffle=False)``: W then H each sweep, stopping when
    the sweep's violation falls to ``tol`` of the first sweep's. ``l1_reg``
    and ``l2_reg`` are the scaled terms scikit-learn applies to both
    factors. Returns ``(W, H, n_iter)`` in ``X``'s float type."""
    X = _as_float_matrix(X)
    if (X.data if sp.issparse(X) else X).min(initial=0) < 0:
        raise ValueError("Negative values in data passed to NMF")
    rng = check_random_state(random_state)
    W, H = _sklearn_start(X, k, init, rng)
    W, Ht = np.ascontiguousarray(W), np.ascontiguousarray(H.T)
    XT = X.T
    violation_init = None
    for n_iter in range(1, max_iter + 1):
        violation = _cd_sweep(X, W, Ht, l1_reg, l2_reg)
        violation += _cd_sweep(XT, Ht, W, l1_reg, l2_reg)
        if n_iter == 1:
            violation_init = violation
        if violation_init == 0 or violation / violation_init <= tol:
            break
    return W, Ht.T, n_iter


def nmf_frobenius_init(X, k, rng):
    """The quick Frobenius NMF behind pLSA's ``init="nmf"``: scikit-learn's
    ``non_negative_factorization(init="nndsvd", solver="cd", beta_loss=2,
    tol=1e-2, max_iter=100, random_state=rng)``. Returns ``(W, H)``."""
    W, H, _ = nmf_cd(X, k, init="nndsvd", tol=1e-2, max_iter=100, random_state=rng)
    return W, H


def _dense_on(X, device):
    """``X`` as a dense float32 tensor on ``device``, scattered there from
    its nonzeros."""
    rows, cols, vals = ship_coo(X, device)
    out = torch.zeros(X.shape, dtype=torch.float32, device=device)
    out[rows, cols] = vals
    return out


def _mu_step_kl(prep, W, H, l1_reg, l2_reg, update_H):
    """One KL multiplicative update of W, then (``update_H``) of H against
    the new W, on the sparse layout ``prep``; the regularisers enter the
    denominators, as in scikit-learn's ``mu`` solver."""
    HT = H.t().contiguous()
    num_W, _ = doc_pass(prep.doc, W, HT, compute_ll=False)  # (X / WH) H^T
    W = W * num_W / (H.sum(1)[None, :] + l1_reg + l2_reg * W).clamp_min(_TINY)
    if update_H:
        num_HT, _ = word_pass(prep.word, W, HT, compute_ll=False)  # (X / WH)^T W
        H = H * num_HT.t() / (W.sum(0)[:, None] + l1_reg + l2_reg * H).clamp_min(_TINY)
    return W, H


def _mu_step_frobenius(X, W, H, l1_reg, l2_reg, update_H):
    with full_fp32_matmul():
        den = (W @ H) @ H.t() + l1_reg + l2_reg * W
        W = W * (X @ H.t()) / den.clamp_min(_TINY)
        if update_H:
            den = W.t() @ (W @ H) + l1_reg + l2_reg * H
            H = H * (W.t() @ X) / den.clamp_min(_TINY)
    return W, H


def nmf_fit_mu(X, k, beta_loss=1, n_iter=200, init="nndsvd", update_H=True, H_init=None,
               alpha=0.0, l1_ratio=0.0, random_state=None, device="cuda"):
    """NMF by multiplicative updates on ``device``; returns ``(W, H)`` as
    float32 numpy.

    ``beta_loss``: 1 (or ``"kullback-leibler"``) for KL, 2 for Frobenius.
    With ``update_H=False`` and ``H_init`` only ``W`` is solved for, against
    the frozen topics (the ensemble's final embedding). ``alpha`` and
    ``l1_ratio`` follow the reference's (pre-1.0 scikit-learn) semantics:
    one unscaled constant for both factors, ``l1 = alpha * l1_ratio`` and
    ``l2 = alpha * (1 - l1_ratio)`` in the update denominators.

    Inside an open request (:mod:`enstop_torch.profiling`) the fit is two
    spans, ``nmf.stage`` and ``nmf.mu``, as :func:`_fit_mu` opens them.
    """
    return _fit_mu(X, k, beta_loss, n_iter, init, update_H, H_init, alpha, l1_ratio,
                   random_state, device, "nmf")


def _fit_mu(X, k, beta_loss, n_iter, init, update_H, H_init, alpha, l1_ratio, random_state,
            device, where):
    """:func:`nmf_fit_mu` with its spans named ``<where>.stage`` (the start
    drawn on the host and copied up, and the corpus staged: ``prepare_sell``
    for KL, the dense scatter for Frobenius; it ends waiting for the device)
    and ``<where>.mu`` (the ``n_iter`` updates up to the factors read back).
    The ensemble names them ``runs.*`` for its bootstrap runs and ``refit.*``
    for its embedding. No span or counter runs per update."""
    rng = check_random_state(random_state)
    dev = resolve_device(device)
    n, m = X.shape
    with span(f"{where}.stage"):
        if H_init is not None:
            H0 = np.asarray(H_init, dtype=np.float32)
            W0 = np.abs(rng.rand(n, k))
        elif isinstance(init, (tuple, list)):
            W0, H0 = init
        elif init == "nndsvd":
            W0, H0 = nndsvd_init(X, k, rng)
            # multiplicative updates cannot leave an exact zero
            W0, H0 = np.maximum(W0, 1e-8), np.maximum(H0, 1e-8)
        else:
            W0, H0 = np.abs(rng.rand(n, k)), np.abs(rng.rand(k, m))
        W = torch.from_numpy(np.array(W0, dtype=np.float32)).to(dev)
        H = torch.from_numpy(np.array(H0, dtype=np.float32)).to(dev)
        count("host_syncs", 2)  # each copy from pageable memory waits
        if beta_loss in (1, "kullback-leibler"):
            Xd, step = prepare_sell(X, standardize=False, device=dev), _mu_step_kl
        else:
            Xd, step = _dense_on(X, dev), _mu_step_frobenius
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    l1_reg = float(alpha) * float(l1_ratio)
    l2_reg = float(alpha) * (1.0 - float(l1_ratio))
    with span(f"{where}.mu"):
        for _ in range(int(n_iter)):
            W, H = step(Xd, W, H, l1_reg, l2_reg, bool(update_H))
        count("host_syncs", 2)  # both factors read back
        return W.cpu().numpy(), H.cpu().numpy()
