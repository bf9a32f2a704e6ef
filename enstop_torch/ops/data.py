"""Data layout for the EM kernels: zero-padded dense blocks (counterpart of
``enstop_tpu/ops/data.py``).

The count matrix is a zero-padded dense array whose dimensions are rounded up
(rows to 8, columns to 128, topics to 8); the padding is absorbing zeros
through every update. Sparse corpora are densified on the device
(``ops/driver.py``); dense input is padded on the host here.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = ["round_up", "pad_dense_counts", "pad_factors", "unpad_factors", "pad_vector"]

ROW_MULTIPLE = 8
COL_MULTIPLE = 128
K_MULTIPLE = 8


def round_up(x: int, multiple: int) -> int:
    return -(-int(x) // int(multiple)) * int(multiple)


def pad_dense_counts(X, row_multiple=ROW_MULTIPLE, col_multiple=COL_MULTIPLE,
                     dtype=np.float32):
    """Densify a (sparse or dense) count matrix into a zero-padded numpy array.

    Returns ``(dense, n, m)`` with ``dense.shape = (round_up(n), round_up(m))``.
    """
    n, m = X.shape
    out = np.zeros((round_up(max(n, 1), row_multiple), round_up(max(m, 1), col_multiple)),
                   dtype=dtype)
    if sp.issparse(X):
        coo = X.tocoo()
        np.add.at(out, (coo.row, coo.col), coo.data.astype(dtype))
    else:
        out[:n, :m] = np.asarray(X, dtype=dtype)
    return out, n, m


def pad_factors(p_z_given_d, p_w_given_z, n_pad, m_pad, k_multiple=K_MULTIPLE):
    """Zero-pad factors to padded dims; padded topics/docs/words stay exactly zero."""
    n, k = p_z_given_d.shape
    k2, m = p_w_given_z.shape
    if k != k2:
        raise ValueError(f"factor topic counts differ: {k} and {k2}")
    kp = round_up(k, k_multiple)
    zd = np.zeros((n_pad, kp), dtype=np.float32)
    zd[:n, :k] = p_z_given_d
    wz = np.zeros((kp, m_pad), dtype=np.float32)
    wz[:k, :m] = p_w_given_z
    return zd, wz


def unpad_factors(p_z_given_d, p_w_given_z, n, m, k):
    return np.asarray(p_z_given_d)[:n, :k], np.asarray(p_w_given_z)[:k, :m]


def pad_vector(v, n_pad, fill=0.0):
    out = np.full((n_pad,), fill, dtype=np.float32)
    out[: v.shape[0]] = v
    return out
