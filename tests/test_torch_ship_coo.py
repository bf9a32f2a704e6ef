"""``ops.data.ship_coo`` against the host path it replaced.

``ship_coo`` copies a CSR's own arrays to the device and expands them to COO
there, with a check that the CSR is canonical; a CSR that is not is
canonicalised on the host in a copy first. :func:`_host_ship_coo` is the
host path (copy, ``sum_duplicates``, ``eliminate_zeros``, ``tocoo`` and three
casts, then the copies), and every case must give its ``(rows, cols, vals)``
bit for bit, dtypes included: index and value dtypes, empty rows, no
nonzeros, duplicates, unsorted columns, explicit zeros, and COO, CSC, dense
and ``csr_array`` input. The caller's arrays stay as they were, no output
shares memory with them on the CPU, and a fit gives the host path's factors
bit for bit.

On the card (marked ``cuda``; ``python -m pytest tests/test_torch_ship_coo.py
-q --noconftest -m cuda``): the same bits at about 5 M nonzeros, and
``prepare_sell``'s peak device memory no higher than with the host path.
This file imports no JAX.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import enstop_torch
from enstop_torch import profiling
from enstop_torch.ops import data, driver, sell


def _host_ship_coo(X, device):
    """The host path: canonicalise a copy, expand it and cast on the host,
    then copy each array to ``device``."""
    Xc = sp.csr_matrix(X, copy=True) if sp.issparse(X) else sp.csr_matrix(np.asarray(X))
    Xc.sum_duplicates()
    Xc.eliminate_zeros()
    coo = Xc.tocoo()
    return tuple(torch.from_numpy(a.astype(dtype)).to(device) for a, dtype in
                 ((coo.row, np.int64), (coo.col, np.int64), (coo.data, np.float32)))


def _ship(X, device="cpu"):
    """``ship_coo(X, device)`` and the counters it left."""
    with profiling.request("ship") as req:
        out = data.ship_coo(X, device)
    return out, req.record["counters"]


def _assert_same(got, want):
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.device == w.device
        assert torch.equal(g, w)
    assert [g.dtype for g in got] == [torch.int64, torch.int64, torch.float32]


def _arrays(X):
    return [a.copy() for a in (X.indptr, X.indices, X.data)] if sp.issparse(X) else [X.copy()]


def _assert_unchanged(X, before):
    after = [X.indptr, X.indices, X.data] if sp.issparse(X) else [X]
    for a, b in zip(after, before):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _values(rng, shape, dtype):
    """Nonzero-heavy values of ``dtype`` that round when cast to float32."""
    if dtype == np.bool_:
        return rng.random(shape) < 0.5
    if np.issubdtype(dtype, np.integer):
        hi = 2**40 if np.dtype(dtype).itemsize == 8 else int(np.iinfo(dtype).max)
        lo = 0 if np.issubdtype(dtype, np.unsignedinteger) else -hi // 2
        return rng.integers(lo, hi, shape).astype(dtype)
    return (rng.standard_normal(shape) * 1e3).astype(dtype)


def _matrix(dtype=np.int64, index_dtype=np.int32, seed=0, n=40, m=70):
    """A canonical CSR with empty rows at the start, in the middle and at the end."""
    rng = np.random.default_rng(seed)
    dense = np.where(rng.random((n, m)) < 0.2, _values(rng, (n, m), dtype), 0).astype(dtype)
    dense[[0, 1, n // 2, n - 1]] = 0
    X = sp.csr_matrix(dense)
    X.indptr = X.indptr.astype(index_dtype)
    X.indices = X.indices.astype(index_dtype)
    assert X.has_canonical_format and np.all(X.data != 0)
    return X


@pytest.mark.parametrize("value_dtype", [np.int64, np.int32, np.float32, np.float64, np.bool_])
@pytest.mark.parametrize("index_dtype", [np.int32, np.int64])
def test_a_canonical_csr_ships_as_it_stands(value_dtype, index_dtype):
    X = _matrix(value_dtype, index_dtype)
    before = _arrays(X)
    got, counters = _ship(X)
    _assert_same(got, _host_ship_coo(X, "cpu"))
    assert counters == {"coo_as_is": 1, "host_syncs": 4}
    _assert_unchanged(X, before)


@pytest.mark.parametrize("value_dtype", [np.uint64, np.uint32, np.float64])
def test_values_torch_cannot_cast_are_cast_on_the_host(value_dtype):
    X = _matrix(value_dtype)
    if value_dtype == np.float64:  # values that float32 rounds to zero stay explicit zeros
        X.data[::5] = 1e-60
    before = _arrays(X)
    got, counters = _ship(X)
    _assert_same(got, _host_ship_coo(X, "cpu"))
    assert counters["coo_as_is" if value_dtype == np.float64 else "coo_canonicalized"] == 1
    _assert_unchanged(X, before)


@pytest.mark.parametrize("shape", [(5, 7), (1, 1), (0, 4)])
def test_a_matrix_with_no_nonzeros(shape):
    X = sp.csr_matrix(shape, dtype=np.int64)
    got, counters = _ship(X)
    _assert_same(got, _host_ship_coo(X, "cpu"))
    assert all(t.numel() == 0 for t in got) and counters["coo_as_is"] == 1


def _duplicates(X):
    """Each nonzero of ``X`` as two adjacent entries of one (row, col)."""
    half = X.data // 2
    return sp.csr_matrix((np.stack([half, X.data - half], 1).ravel(), np.repeat(X.indices, 2),
                          2 * X.indptr), shape=X.shape)


def _unsorted(X):
    """``X`` with each row's columns reversed."""
    Y = X.copy()
    for r in range(Y.shape[0]):
        lo, hi = Y.indptr[r], Y.indptr[r + 1]
        Y.indices[lo:hi] = Y.indices[lo:hi][::-1].copy()
        Y.data[lo:hi] = Y.data[lo:hi][::-1].copy()
    Y.has_sorted_indices = False
    return Y


def _explicit_zeros(X):
    """``X`` with every third value an explicit zero."""
    Y = X.copy()
    Y.data[::3] = 0
    return Y


@pytest.mark.parametrize("index_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("make", [_duplicates, _unsorted, _explicit_zeros])
def test_a_csr_that_is_not_canonical_falls_back(make, index_dtype):
    X = make(_matrix(np.int64, index_dtype))
    before = _arrays(X)
    got, counters = _ship(X)
    _assert_same(got, _host_ship_coo(X, "cpu"))
    # the check's three copies and flag, then the canonical copy's three copies
    assert counters == {"coo_canonicalized": 1, "host_syncs": 7}
    _assert_unchanged(X, before)


@pytest.mark.parametrize("convert", [
    lambda X: X.tocoo(), lambda X: X.tocsc(), lambda X: X.toarray(), lambda X: sp.csr_array(X),
    lambda X: _duplicates(X).tocoo()])
def test_other_formats(convert):
    X = convert(_matrix(np.int64))
    before = _arrays(X) if not sp.issparse(X) or X.format == "csr" else None
    got, _ = _ship(X)
    _assert_same(got, _host_ship_coo(X, "cpu"))
    if before is not None:
        _assert_unchanged(X, before)


@pytest.mark.parametrize("value_dtype", [np.int64, np.float32])
@pytest.mark.parametrize("index_dtype", [np.int32, np.int64])
def test_no_output_shares_memory_with_the_input(value_dtype, index_dtype):
    X = _matrix(value_dtype, index_dtype)
    got, _ = _ship(X)
    for t in got:
        for a in (X.indptr, X.indices, X.data):
            assert not np.shares_memory(t.numpy(), a)
    got[1].zero_()
    got[2].zero_()
    assert np.all(X.data != 0)


def _patched_fit(monkeypatch, ship, backend, X):
    monkeypatch.setattr(driver, "ship_coo", ship)
    monkeypatch.setattr(sell, "ship_coo", ship)
    return enstop_torch.PLSA(n_components=5, n_iter=30, n_iter_per_test=5, random_state=3,
                             backend=backend, device="cpu").fit(X)


@pytest.mark.parametrize("backend", ["auto", "sparse"])
@pytest.mark.parametrize("value_dtype", [np.int64, np.float64])
def test_a_fit_gives_the_host_paths_factors(monkeypatch, backend, value_dtype):
    X = _matrix(value_dtype, seed=1, n=60, m=90)
    X.data = np.abs(X.data)
    X = X[X.getnnz(axis=1) > 0]
    new = _patched_fit(monkeypatch, data.ship_coo, backend, X)
    old = _patched_fit(monkeypatch, _host_ship_coo, backend, X)
    np.testing.assert_array_equal(new.embedding_, old.embedding_)
    np.testing.assert_array_equal(new.components_, old.components_)
    assert new.fit_info_["trace"]["counters"]["coo_as_is"] == 1


# -- on the card ----------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _large(seed=0, n=50_000, m=20_000, per_row=100):
    """About ``n * per_row`` nonzeros, int64 counts up to 2**40 (which float32
    rounds), int32 indices, canonical."""
    rng = np.random.default_rng(seed)
    X = sp.random(n, m, density=per_row / m, format="csr", random_state=rng,
                  data_rvs=lambda k: rng.integers(1, 2**40, k))
    X.data = X.data.astype(np.int64)
    X.sum_duplicates()
    return X


@pytest.mark.cuda
def test_the_card_gives_the_host_paths_arrays(cuda):
    X = _large()
    assert X.nnz > 4_000_000
    for Y in (X, _explicit_zeros(X[:5_000])):
        got, _ = _ship(Y, cuda)
        _assert_same(got, _host_ship_coo(Y, cuda))


@pytest.mark.cuda
def test_prepare_sell_holds_no_more_than_the_host_path(cuda, monkeypatch):
    X = _large(seed=1)

    def peak():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        prep = sell.prepare_sell(X, device=cuda)
        torch.cuda.synchronize()
        used = torch.cuda.max_memory_allocated() - base
        del prep
        return used

    new = peak()
    monkeypatch.setattr(sell, "ship_coo", _host_ship_coo)
    old = peak()
    assert new <= old, (new, old)
