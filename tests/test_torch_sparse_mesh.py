"""The port's sparse docs mesh (``parallel/sparse_mesh.py``) against the JAX
package's on the CPU: the same corpus and ``random_state`` (so the same
initial factors), JAX on the conftest's 8 virtual devices, the port with its
shards on the one CPU device. Tolerances: ``n_steps`` equal, the LL trace
rtol 1e-5, factors rtol 5e-4 / atol 1e-5 (``FACTOR_TOL``, float32 sums in
another order); the shards' nonzeros exactly those of the corpus.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import enstop_torch
import enstop_tpu
from conftest import make_corpus
from enstop_torch.ops import cuda_sparse
from enstop_torch.parallel import sparse_mesh as port_sm
from enstop_tpu.parallel import sparse_mesh as jax_sm

torch.set_num_threads(1)

CPU = torch.device("cpu")
FACTOR_TOL = dict(rtol=5e-4, atol=1e-5)


def _corpus(seed, n_docs=101, n_words=130):
    return sp.csr_matrix(make_corpus(np.random.RandomState(0), seed=seed, n_docs=n_docs,
                                     n_words=n_words))


def _meshes(n_shards):
    return port_sm.make_docs_mesh(devices=[CPU] * n_shards), jax_sm.make_docs_mesh(n_shards)


def _assert_same(got, want):
    zd, wz, steps, trace = got
    assert steps == want[2]
    np.testing.assert_allclose(trace, np.asarray(want[3]), rtol=1e-5)
    np.testing.assert_allclose(wz, want[1], **FACTOR_TOL)
    np.testing.assert_allclose(zd, want[0], **FACTOR_TOL)
    np.testing.assert_allclose(wz.sum(1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("thresh", [None, 1e-16, 1e-3])
def test_sparse_mesh_fit_matches_jax(n_shards, thresh):
    X = _corpus(61)
    pm, jm = _meshes(n_shards)
    kw = dict(n_iter=25, n_iter_per_test=5, tolerance=0.01, random_state=3,
              e_step_thresh=thresh)
    _assert_same(port_sm.sparse_mesh_fit(X, 4, mesh=pm, **kw),
                 jax_sm.sparse_mesh_fit(X, 4, mesh=jm, **kw))


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sparse_mesh_weighted_matches_jax(n_shards):
    X = _corpus(67, n_docs=80, n_words=100)
    w = np.random.RandomState(9).uniform(0.3, 2.0, X.shape[0]).astype(np.float32)
    pm, jm = _meshes(n_shards)
    kw = dict(sample_weight=w, n_iter=12, random_state=5)
    _assert_same(port_sm.sparse_mesh_fit(X, 3, mesh=pm, **kw),
                 jax_sm.sparse_mesh_fit(X, 3, mesh=jm, **kw))


@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("thresh", [None, 1e-16, 1e-3])
def test_sparse_mesh_refit_matches_jax(n_shards, thresh):
    X = _corpus(89, n_docs=60, n_words=90)
    _, wz, _, _ = jax_sm.sparse_mesh_fit(X, 3, mesh=jax_sm.make_docs_mesh(2), n_iter=10,
                                         random_state=2)
    pm, jm = _meshes(n_shards)
    kw = dict(e_step_thresh=thresh, random_state=7)
    np.testing.assert_allclose(port_sm.sparse_mesh_refit(X[:25], wz, mesh=pm, **kw),
                               jax_sm.sparse_mesh_refit(X[:25], wz, mesh=jm, **kw),
                               **FACTOR_TOL)


def test_shard_sell_holds_each_nonzero_once():
    X = _corpus(71, n_docs=96, n_words=120)
    pm, _ = _meshes(8)
    calls = dict(cuda_sparse.CALLS)
    preps, bounds, n, m = port_sm.shard_sell(pm, X)
    assert (n, m) == X.shape and len(preps) == 8
    np.testing.assert_array_equal(bounds, np.linspace(0, n, 9).astype(np.int64))
    for s, prep in enumerate(preps):
        lo, hi = bounds[s], bounds[s + 1]
        assert prep.shape == (hi - lo, m)
        block = X[lo:hi].tocoo()
        # doc side: local document ids, global word ids, in row-major order
        np.testing.assert_array_equal(prep.doc.owners().numpy(), block.row)
        np.testing.assert_array_equal(prep.doc.idx.numpy(), block.col)
        np.testing.assert_array_equal(prep.doc.vals.numpy(), block.data)
        assert prep.word.n_owner == m and prep.word.n_index == hi - lo
    assert sum(p.nnz for p in preps) == X.nnz
    assert cuda_sparse.CALLS == calls


def test_distributed_sparse_layout_matches_jax():
    class Port(enstop_torch.DistributedPLSA):
        def _devices(self):
            return [CPU] * 8

    X = sp.csr_matrix(make_corpus(np.random.RandomState(0), seed=79, n_docs=77,
                                  n_words=95).astype(np.int64))
    kw = dict(n_components=4, n_iter=15, random_state=0, layout="sparse")
    port = Port(device="cpu", **kw)
    emb = port.fit_transform(X)
    ref = enstop_tpu.DistributedPLSA(**kw).fit(X)
    assert port.n_iter_ == ref.n_iter_
    np.testing.assert_allclose(port.history_, ref.history_, rtol=1e-5)
    np.testing.assert_allclose(port.components_, ref.components_, **FACTOR_TOL)
    np.testing.assert_allclose(emb, ref.embedding_, **FACTOR_TOL)
    assert port.fit_info_["log_likelihood"] == port.history_[-1]
    np.testing.assert_allclose(port.transform(X[:20]), ref.transform(X[:20]), **FACTOR_TOL)
