"""Factor initialization for pLSA (counterpart of ``enstop_tpu/ops/init.py``).

Host NumPy, drawing from the same ``RandomState`` stream in the same order as
the JAX package, so both start from identical factors for the same seed.
``"nndsvd"`` needs a randomized SVD, which the JAX package takes from
scikit-learn; :func:`randomized_svd` here is a NumPy and SciPy copy of
scikit-learn 1.9's ``randomized_svd(M, k, random_state=rng)`` that makes the
same draws in the same order. ``"nmf"`` runs :func:`~.nmf.nmf_frobenius_init`.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg
import scipy.sparse as sp

from ..utils import check_random_state, normalize

__all__ = ["plsa_init", "nndsvd_init", "randomized_svd"]


def _svd_flip(u, v, u_based_decision=True):
    """scikit-learn's ``svd_flip``: the largest entry (by magnitude) of each
    column of ``u`` (or row of ``v``) made positive, in place."""
    basis = u.T if u_based_decision else v
    signs = np.sign(basis[np.arange(basis.shape[0]), np.argmax(np.abs(basis), axis=1)])
    u *= signs[np.newaxis, :]
    v *= signs[:, np.newaxis]
    return u, v


def randomized_svd(M, n_components, rng, n_oversamples=10):
    """Rank-``n_components`` randomized SVD ``(U, S, Vt)`` of a dense or
    scipy sparse ``M`` (never densified), as scikit-learn computes it:
    ``n_iter="auto"`` (7 power iterations when ``n_components`` is below a
    tenth of the smaller side, else 4), LU-normalised power iterations, the
    Gaussian test matrix drawn from ``rng`` (float32 for float32 ``M``), the
    transposed problem when ``M`` is wide, and the sign flip."""
    rng = check_random_state(rng)
    if not sp.issparse(M):
        M = np.asarray(M)
    n_random = n_components + n_oversamples
    n_samples, n_features = M.shape
    n_iter = 7 if n_components < 0.1 * min(M.shape) else 4
    transpose = n_samples < n_features
    if transpose:
        M = M.T

    Q = rng.normal(size=(M.shape[1], n_random))
    if M.dtype == np.float32:
        Q = Q.astype(np.float32, copy=False)
    if n_iter > 2:
        def normalizer(a):
            return scipy.linalg.lu(a, permute_l=True, check_finite=False)
    else:
        def normalizer(a):
            return a, None
    for _ in range(n_iter):
        Q, _ = normalizer(M @ Q)
        Q, _ = normalizer(M.T @ Q)
    Q, _ = scipy.linalg.qr(M @ Q, mode="economic", check_finite=False)

    B = Q.T @ M
    Uhat, s, Vt = scipy.linalg.svd(B, full_matrices=False, lapack_driver="gesdd")
    U = Q @ Uhat
    # transposed: the decision rests on the rows of Vt, which are the
    # original problem's left vectors
    U, Vt = _svd_flip(U, Vt, u_based_decision=not transpose)
    if transpose:
        return Vt[:n_components, :].T, s[:n_components], U[:, :n_components].T
    return U[:, :n_components], s[:n_components], Vt[:n_components, :]


def nndsvd_init(X, k, rng):
    """Nonnegative double-SVD initialization (Boutsidis and Gallopoulos
    2008), vectorized over components as the JAX package does: from a
    rank-``k`` randomized SVD keep ``sqrt(s0)`` times the absolute leading
    pair, and for each later component whichever sign half of the
    singular-vector pair carries the larger norm product, as unit vectors
    times ``sqrt(s_j * mass)``. Returns ``(doc_seed (n, k), word_seed (k, m))``."""
    U, S, Vt = randomized_svd(X, k, rng)
    doc_seed = np.empty_like(U)
    word_seed = np.empty_like(Vt)
    doc_seed[:, 0] = np.sqrt(S[0]) * np.abs(U[:, 0])
    word_seed[0, :] = np.sqrt(S[0]) * np.abs(Vt[0, :])

    u_pos, u_neg = np.clip(U[:, 1:], 0, None), np.clip(-U[:, 1:], 0, None)
    v_pos, v_neg = np.clip(Vt[1:], 0, None), np.clip(-Vt[1:], 0, None)
    u_pos_n, u_neg_n = np.linalg.norm(u_pos, axis=0), np.linalg.norm(u_neg, axis=0)
    v_pos_n, v_neg_n = np.linalg.norm(v_pos, axis=1), np.linalg.norm(v_neg, axis=1)
    pos_mass, neg_mass = u_pos_n * v_pos_n, u_neg_n * v_neg_n
    keep_pos = pos_mass > neg_mass  # ties keep the negative half
    u_half = np.where(keep_pos[None, :], u_pos, u_neg)
    v_half = np.where(keep_pos[:, None], v_pos, v_neg)
    u_norm = np.where(keep_pos, u_pos_n, u_neg_n)
    v_norm = np.where(keep_pos, v_pos_n, v_neg_n)
    weight = np.sqrt(S[1:] * np.where(keep_pos, pos_mass, neg_mass))
    # normalise, then scale: the JAX package's order of operations, so both
    # give the same float64 values
    doc_seed[:, 1:] = weight * (u_half / np.maximum(u_norm, 1e-30))
    word_seed[1:, :] = weight[:, None] * (v_half / np.maximum(v_norm, 1e-30)[:, None])
    return doc_seed, word_seed


def plsa_init(X, k, init="random", rng=None):
    """Initialize ``(P(z|d), P(w|z))``: float32 arrays of shapes ``(n, k)``
    and ``(k, m)``, l1-normalized along rows.

    ``init`` is ``"random"``, ``"nndsvd"``, ``"nmf"`` (the last two need the
    count matrix itself) or an explicit ``(P(z|d), P(w|z))`` tuple.
    """
    rng = check_random_state(rng)
    n, m = X.shape

    if init == "random":
        p_w_given_z = rng.rand(k, m)
        p_z_given_d = rng.rand(n, k)
    elif init == "nndsvd":
        p_z_given_d, p_w_given_z = nndsvd_init(X, k, rng)
    elif init == "nmf":
        from .nmf import nmf_frobenius_init

        p_z_given_d, p_w_given_z = nmf_frobenius_init(X, k, rng)
    elif isinstance(init, (tuple, list)):
        p_z_given_d, p_w_given_z = init
        p_z_given_d = np.array(p_z_given_d, dtype=np.float64, copy=True)
        p_w_given_z = np.array(p_w_given_z, dtype=np.float64, copy=True)
    else:
        raise ValueError("Unrecognized init {}".format(init))

    normalize(p_w_given_z, axis=1)
    normalize(p_z_given_d, axis=1)
    return (
        np.ascontiguousarray(p_z_given_d, dtype=np.float32),
        np.ascontiguousarray(p_w_given_z, dtype=np.float32),
    )
