"""Data layout for the EM kernels: zero-padded dense blocks (counterpart of
``enstop_tpu/ops/data.py``), and the nonzeros shipped to the device.

The count matrix is a zero-padded dense array whose dimensions are rounded up
(rows to 8, columns to 128, topics to 8); the padding is absorbing zeros
through every update. A corpus ships to the device as its nonzeros
(:func:`ship_coo`, O(nnz) bytes); the dense staging scatters them into the
padded rectangle there (``ops/driver.py``), the sparse layouts sort them
(``ops/sell.py``).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..profiling import count, span

__all__ = ["round_up", "pad_dense_counts", "pad_factors", "unpad_factors", "pad_vector",
           "resolve_device", "ship_coo"]

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


def ship_coo(X, device):
    """The nonzeros of a (sparse or dense) matrix on ``device``: ``(rows,
    cols, vals)``, int64, int64 and float32, in row-major order, each
    (row, col) once (duplicates summed, explicit zeros dropped). The host's
    numpy work is in spans ``stage.coo``, each array's copy in a span
    ``stage.copy`` of its own."""
    with span("stage.coo"):
        Xc = sp.csr_matrix(X, copy=True) if sp.issparse(X) else sp.csr_matrix(np.asarray(X))
        Xc.sum_duplicates()
        Xc.eliminate_zeros()
        coo = Xc.tocoo()
    return tuple(_ship(a, dtype, device) for a, dtype in
                 ((coo.row, np.int64), (coo.col, np.int64), (coo.data, np.float32)))


def _ship(a, dtype, device):
    """``a`` cast on the host and copied to ``device``. Each cast array is
    freed as soon as it is copied: casting all three first holds them at
    once, which costs the host fresh pages on every fit (a dense fit at 20NG
    measured 17 ms slower on an H100's host)."""
    with span("stage.coo"):
        a = a.astype(dtype)
    with span("stage.copy", bytes=a.nbytes):
        count("host_syncs")  # a copy from pageable memory waits for it
        return torch.from_numpy(a).to(device)
