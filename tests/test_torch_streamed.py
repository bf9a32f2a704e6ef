"""The port's StreamedPLSA against the JAX package's on the CPU, and against
the port's own resident sparse fit.

The same numpy corpus (``conftest.make_corpus``) and seeds go to
``enstop_tpu.StreamedPLSA`` and to ``enstop_torch.StreamedPLSA(device="cpu")``,
whose blocks run the plain versions of the sparse passes. Tolerances, those of
the port's sparse path (``tests/test_torch_sparse.py``): the same ``n_iter_``,
the log-likelihood trace at rtol 1e-5, the factors at ``TRAJECTORY_TOL``
(rtol 5e-4, atol 1e-6). A change of block size changes only the order in
which A's block sums are added, so it is held to the same tolerances.
"""

import numpy as np
import pytest
import scipy.sparse as sp

import enstop_torch
import enstop_tpu
from conftest import make_corpus
from enstop_torch.models import streamed_core as port_core
from enstop_torch.models.base import TopicModelBase
from enstop_torch.ops.init import plsa_init
from enstop_tpu.models import streamed_core as jax_core

TRAJECTORY_TOL = dict(rtol=5e-4, atol=1e-6)
LL_RTOL = 1e-5


def _corpus(seed, n_docs=90, n_words=80):
    return sp.csr_matrix(make_corpus(np.random.RandomState(0), seed=seed, n_docs=n_docs,
                                     n_words=n_words).astype(np.int64))


def _assert_same_fit(port, ref):
    assert port.n_iter_ == ref.n_iter_
    np.testing.assert_allclose(port.history_, np.asarray(ref.history_), rtol=LL_RTOL)
    np.testing.assert_allclose(port.components_, ref.components_, **TRAJECTORY_TOL)
    np.testing.assert_allclose(port.embedding_, ref.embedding_, **TRAJECTORY_TOL)


def _injected_init(X, k, seed=3):
    return plsa_init(X, k, rng=np.random.RandomState(seed))


@pytest.mark.parametrize("case", ["injected_init", "weighted", "estimator", "thresh",
                                  "test_on_n_iter"])
def test_fit_matches_jax(case):
    """The ``tests/test_streamed.py`` cases of the JAX package: an injected
    init, sample weights, the estimator with early stopping, a firing
    threshold, and a test point that lands on ``n_iter`` (one more LL
    stream)."""
    X = _corpus(seed={"weighted": 5, "thresh": 91}.get(case, 11))
    kw = dict(n_components=4, block_size=32, n_iter=20, n_iter_per_test=5)
    fit_kw = {}
    if case in ("injected_init", "thresh"):
        kw["init"] = _injected_init(X, 4)
    if case == "weighted":
        fit_kw["sample_weight"] = np.random.RandomState(5).uniform(
            0.3, 2.5, X.shape[0]).astype(np.float32)
        kw.update(block_size=24, random_state=3)
    if case == "estimator":
        kw.update(block_size=16, tolerance=0.05, random_state=7)
    if case == "thresh":
        kw["e_step_thresh"] = 2e-3
    if case == "test_on_n_iter":
        kw.update(n_iter=21, random_state=1)
    port = enstop_torch.StreamedPLSA(device="cpu", **kw)
    ref = enstop_tpu.StreamedPLSA(**kw)
    port.fit(X, **fit_kw)
    ref.fit(X, **fit_kw)
    _assert_same_fit(port, ref)
    if case == "estimator":
        assert port.n_iter_ < 20  # it stopped early, at a test point
    if case == "test_on_n_iter":
        assert len(port.history_) == 6
    np.testing.assert_allclose(port.transform(X[:25]), ref.transform(X[:25]),
                               **TRAJECTORY_TOL)


@pytest.mark.parametrize("n_iter,thresh", [(20, 1e-32), (21, 1e-32), (20, 2e-3)])
def test_fit_matches_the_resident_sparse_fit(n_iter, thresh):
    """From one init, the streamed fit is the port's resident
    ``PLSA(backend="sparse")`` fit, with and without a firing threshold."""
    X = _corpus(seed=41)
    w = np.random.RandomState(2).uniform(0.5, 1.5, X.shape[0]).astype(np.float32)
    kw = dict(n_components=4, init=_injected_init(X, 4, seed=7), n_iter=n_iter,
              n_iter_per_test=5, tolerance=0.0, e_step_thresh=thresh)
    resident = enstop_torch.PLSA(backend="sparse", device="cpu", **kw).fit(X, sample_weight=w)
    streamed = enstop_torch.StreamedPLSA(block_size=25, device="cpu", **kw).fit(
        X, sample_weight=w)
    _assert_same_fit(streamed, resident)


def test_block_size_changes_only_the_order_of_As_sums():
    """One block, three blocks, and blocks one document short of a full last
    block give the same trajectory."""
    X = _corpus(seed=23, n_docs=92)
    kw = dict(n_components=5, n_iter=25, n_iter_per_test=5, tolerance=0.0, random_state=4,
              device="cpu")
    one = enstop_torch.StreamedPLSA(block_size=1000, **kw).fit(X)
    assert one.fit_info_["n_blocks"] == 1
    for block_size, n_blocks in ((40, 3), (31, 3)):  # 40 + 40 + 12, 31 + 31 + 30
        other = enstop_torch.StreamedPLSA(block_size=block_size, **kw).fit(X)
        assert other.fit_info_["n_blocks"] == n_blocks
        _assert_same_fit(other, one)


@pytest.mark.parametrize("tol,npt,thresh", [(0.001, 5, None), (0.05, 10, None),
                                            (0.0, 5, 0.05)])
def test_refit_matches_jax(tol, npt, thresh):
    """The chunked frozen-topics refit: the same schedule, stopping step and
    embedding as the JAX package's, with and without a firing threshold."""
    X = _corpus(seed=31)
    topics = enstop_torch.PLSA(n_components=4, n_iter=15, random_state=0,
                               device="cpu").fit(X).components_
    kw = dict(block_docs=32, n_iter=50, n_iter_per_test=npt, tolerance=tol,
              e_step_thresh=thresh)
    got = port_core.streamed_refit_core(X, topics, random_state=np.random.RandomState(7),
                                        device="cpu", **kw)
    want = jax_core.streamed_refit_core(X, topics, random_state=np.random.RandomState(7), **kw)
    np.testing.assert_allclose(got, want, **TRAJECTORY_TOL)


def test_refit_sample_weight_weights_only_the_ll():
    """As in the reference's streamed refit: with no early stop the weights
    change nothing, and a uniform weight changes nothing even with one."""
    X = _corpus(seed=23, n_docs=70, n_words=60)
    topics = enstop_torch.PLSA(n_components=4, n_iter=12, random_state=0,
                               device="cpu").fit(X).components_
    w = np.random.RandomState(42).uniform(0.2, 5.0, size=X.shape[0]).astype(np.float32)

    def refit(sample_weight, n_iter, tol):
        return port_core.streamed_refit_core(
            X, topics, sample_weight=sample_weight, block_docs=24, n_iter=n_iter,
            n_iter_per_test=5, tolerance=tol, random_state=np.random.RandomState(3),
            device="cpu")

    np.testing.assert_array_equal(refit(None, 15, 0.0), refit(w, 15, 0.0))
    np.testing.assert_allclose(refit(np.full(X.shape[0], 7.0, np.float32), 50, 0.01),
                               refit(None, 50, 0.01), rtol=1e-5, atol=1e-7)
    # and the LL it weights is the JAX package's
    np.testing.assert_allclose(
        refit(w, 50, 0.01),
        jax_core.streamed_refit_core(X, topics, sample_weight=w, block_docs=24, n_iter=50,
                                     n_iter_per_test=5, tolerance=0.01,
                                     random_state=np.random.RandomState(3)),
        **TRAJECTORY_TOL)


def test_host_memory_is_o_nnz():
    """The block store costs O(nnz) host bytes, not O(n * m)
    (``tests/test_streamed_out_of_core.py``)."""
    rng = np.random.RandomState(0)
    n, m = 20000, 30000
    nnz = int(n * m * 2e-4)
    X = sp.coo_matrix((np.ones(nnz, np.float32),
                       (rng.randint(0, n, nnz), rng.randint(0, m, nnz))), shape=(n, m)).tocsr()
    X.sum_duplicates()
    X.data[:] = 1.0
    store = port_core._BlockStore(X, block_docs=4096)
    stored = store.host_bytes()
    assert store.n_blocks == 5
    assert stored < n * m * 4 / 50
    assert stored < 100 * X.nnz
    # each nonzero twice at 8 B (index and count), and the segment tables
    assert stored >= 16 * X.nnz
    assert sum(int(blk["doc"].nnz) for blk in store.blocks) == X.nnz


def test_estimator_api_zero_rows_and_transform():
    X = _corpus(seed=21, n_docs=70).tolil()
    X[6] = 0
    X = X.tocsr()
    model = enstop_torch.StreamedPLSA(n_components=3, block_size=16, n_iter=15,
                                      random_state=0, device="cpu")
    emb = model.fit_transform(X)
    assert emb.shape == (70, 3) and np.all(emb[6] == 0)
    np.testing.assert_allclose(np.delete(emb, 6, axis=0).sum(axis=1), 1.0, atol=1e-4)
    assert model.training_data_ is X or model.training_data_.shape == X.shape
    assert model.fit_info_["backend"] == "streamed" and model.fit_info_["n_sweeps"] >= 15
    t = model.transform(X[10:19].toarray(), sample_weight=np.ones(9))
    assert t.shape == (9, 3)
    np.testing.assert_allclose(t.sum(axis=1), 1.0, atol=1e-4)
    assert model.get_params()["device"] == "cpu" and model.get_params()["backend"] == "auto"
    with pytest.raises(ValueError, match="features"):
        model.transform(X[:3, :10])


def test_jax_checkpoint_loads():
    """A JAX ``StreamedPLSA`` checkpoint loads through ``TopicModelBase.load``
    as the port's ``StreamedPLSA`` and embeds as the JAX model does."""
    import tempfile
    from pathlib import Path

    X = _corpus(seed=9, n_docs=40, n_words=30)
    ref = enstop_tpu.StreamedPLSA(n_components=3, n_iter=10, block_size=16,
                                  random_state=0).fit(X)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "streamed.npz"
        ref.save(path)
        loaded = TopicModelBase.load(path, device="cpu")
        again = enstop_torch.StreamedPLSA.load(path, device="cpu")
    for model in (loaded, again):
        assert type(model) is enstop_torch.StreamedPLSA and model.block_size == 16
        np.testing.assert_array_equal(model.components_, ref.components_)
        np.testing.assert_allclose(model.history_, np.asarray(ref.history_), rtol=0)
        np.testing.assert_allclose(model.transform(X[:12]), ref.transform(X[:12]),
                                   **TRAJECTORY_TOL)


def test_default_device_raises_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only host")
    X = _corpus(seed=1, n_docs=20, n_words=30)
    model = enstop_torch.StreamedPLSA(n_components=3)
    assert model.device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        model.fit(X)
