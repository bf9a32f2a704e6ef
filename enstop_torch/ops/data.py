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


def _weighted(sample_weight):
    return sample_weight is not None and bool(np.any(np.asarray(sample_weight) != 1.0))


def _on_device(a, dev):
    """``a`` as a float32 tensor on ``dev``; a copy from the host waits for it."""
    if not (isinstance(a, torch.Tensor) and a.device == dev):
        count("host_syncs")
    return torch.as_tensor(a, dtype=torch.float32, device=dev)


def _padded_on(a, shape, dev):
    """The 2-D host array ``a`` as float32 in the corner of a zero ``shape``
    tensor on ``dev``; the copy from the host waits for it."""
    out = torch.zeros(shape, dtype=torch.float32, device=dev)
    count("host_syncs")
    out[:a.shape[0], :a.shape[1]] = torch.from_numpy(np.asarray(a, dtype=np.float32))
    return out


class _Staged:
    """A corpus staged on a device once, dense (:class:`~.driver.PreparedCounts`)
    or sparse (:class:`~.sell.PreparedSell`). A fit asks either the same:
    ``device``, ``n``, ``m``, ``nnz``, ``backend`` (``info["backend"]``);
    ``_padded(k)``, the factors' shapes ``(n_pad, kp, m_pad)`` there, and
    ``_pad(zd, wz)``, host factors at those shapes; ``_weights(sample_weight)``
    as ``_fit`` takes them (the dense layout copies them to the device, the
    sparse one in its loop); ``_steps(precision, path)``, made once for any
    number of fits (the sparse layout has no bf16 mode and warns at ``"fast"``
    that the ``path`` runs at default precision); and ``_fit(zd, wz, w, n_iter,
    n_iter_per_test, tolerance, steps, e_step_thresh, refit=False)``, a
    :class:`~.fit.FitResult` on the device from factors on the host or the
    device (``refit``: ``wz`` frozen); ``_fit_runs(runs, n_runs, k, n_iter,
    n_iter_per_test, tolerance, steps)``, ``(i, FitResult)`` for each of
    ``n_runs`` runs of ``k`` topics that ``runs`` yields as ``(zd, wz, w)`` on
    the device, in the order they end (here one after another by ``_fit``; the
    dense layout fits them in groups on the batched step). Only the sparse
    layout applies a material ``e_step_thresh``."""

    __slots__ = ()

    @property
    def shape(self):
        return (self.n, self.m)

    def _place(self, zd, wz):
        return _on_device(zd, self.device), _on_device(wz, self.device)

    def _fit_runs(self, runs, n_runs, k, n_iter, n_iter_per_test, tolerance, steps):
        for i, (zd, wz, w) in enumerate(runs):
            yield i, self._fit(zd, wz, w, n_iter, n_iter_per_test, tolerance, steps)


def _is_staged(X):
    """Whether ``X`` is a staged corpus, which a fit takes as it stands."""
    return isinstance(X, _Staged)


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


# the value dtypes that torch takes from numpy and casts to float32 on any
# device as numpy's ``astype`` does (round to nearest); others, such as
# uint64, are cast on the host
_SHIPPABLE = frozenset(np.dtype(t) for t in (np.bool_, np.int8, np.uint8, np.int16, np.int32,
                                               np.int64, np.float32, np.float64))


def ship_coo(X, device):
    """The nonzeros of a (sparse or dense) matrix on ``device``: ``(rows,
    cols, vals)``, int64, int64 and float32, in row-major order, each
    (row, col) once (duplicates summed, explicit zeros dropped), sharing no
    memory with ``X``.

    A CSR's own ``indptr``, ``indices`` and ``data`` are copied to ``device``
    as they stand (a span ``stage.copy`` each) and expanded there; a check
    there that each row's columns strictly increase and no value is zero
    comes back as one flag (counter ``coo_as_is``). A CSR that fails it, or
    whose values torch does not hold, is canonicalised on the host in a copy
    and shipped again (counter ``coo_canonicalized``); ``X`` is never
    changed. Other input is made a CSR on the host first. The expansion, the
    check and any host work are in spans ``stage.coo``."""
    if not (sp.issparse(X) and X.format == "csr"):
        with span("stage.coo"):
            X = sp.csr_matrix(X) if sp.issparse(X) else sp.csr_matrix(np.asarray(X))
    if X.dtype in _SHIPPABLE:
        coo = _expand(*_ship_csr(X, device), check=True)
        if coo is not None:
            count("coo_as_is")
            return coo
    count("coo_canonicalized")
    with span("stage.coo"):
        X = sp.csr_matrix(X, copy=True)
        X.sum_duplicates()
        X.eliminate_zeros()
        if X.dtype not in _SHIPPABLE:
            X.data = X.data.astype(np.float32)
    return _expand(*_ship_csr(X, device), check=False)


def _ship_csr(X, device):
    """A CSR's ``indptr`` and its first ``nnz`` indices and values, each
    copied to ``device`` in its own dtype."""
    nnz = int(X.indptr[-1])
    return tuple(_ship(a, device) for a in (X.indptr, X.indices[:nnz], X.data[:nnz]))


def _ship(a, device):
    """``a`` copied to ``device`` (on the CPU, a view of ``a``)."""
    with span("stage.copy", bytes=a.nbytes):
        count("host_syncs")  # a copy from pageable memory waits for it
        return torch.from_numpy(a).to(device)


def _expand(indptr, indices, data, check):
    """The COO of a CSR's arrays, on their device; None where ``check``
    finds a row whose columns do not strictly increase, or a zero value. On
    the CPU the arrays are the caller's, so the outputs are copies."""
    with span("stage.coo"):
        nnz = indices.numel()
        indptr = indptr.long()
        if check:
            ok = data != 0
            if nnz > 1:
                row_start = torch.zeros(nnz + 1, dtype=torch.bool, device=indptr.device)
                row_start.index_fill_(0, indptr, True)  # no wait (an index_put_ would wait)
                ok[1:] &= row_start[1:nnz] | (indices[1:] > indices[:-1])
            count("host_syncs")  # the flag read back
            if not bool(ok.all()):
                return None
        own = indices.device.type == "cpu"
        return (torch.repeat_interleave(indptr.diff(), output_size=nnz),
                indices.to(torch.int64, copy=own), data.to(torch.float32, copy=own))
