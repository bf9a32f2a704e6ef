"""The port's PLSA slice end to end against the JAX package on the CPU.

``enstop_torch.PLSA(device="cpu")`` runs the plain PyTorch ops;
``enstop_tpu.PLSA(backend="xla", precision="highest")`` is the reference. Both
draw their initial factors from the same numpy RandomState, so the EM
trajectories agree to float32 summation order: ``n_iter_`` equal, ``history_``
rtol 1e-5, factors rtol 5e-4 / atol 1e-5.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import enstop_torch
import enstop_tpu
from conftest import make_corpus
from enstop_torch import convert
from enstop_torch import synthetic as port_synthetic
from enstop_torch.ops import driver as port_driver
from enstop_torch.ops.init import plsa_init as port_init
from enstop_torch.utils import _check_sample_weight as port_check_weight
from enstop_torch.utils import check_random_state
from enstop_tpu import synthetic as jax_synthetic
from enstop_tpu.ops.init import plsa_init as jax_init

torch.set_num_threads(1)

FACTOR_TOL = dict(rtol=5e-4, atol=1e-5)


def _corpus():
    X = make_corpus(np.random.RandomState(0), n_docs=70, n_words=130, seed=7)
    X[5] = 0.0  # a zero row: split off before the fit, put back after it
    w = np.random.RandomState(3).uniform(0.5, 1.5, X.shape[0]).astype(np.float32)
    return X, w


def _counts():
    X = sp.csr_matrix(make_corpus(np.random.RandomState(1), n_docs=60, n_words=150,
                                  seed=9).astype(np.int64))
    return X


def _pair(**kw):
    port = enstop_torch.PLSA(n_components=4, random_state=0, device="cpu", **kw)
    ref = enstop_tpu.PLSA(n_components=4, random_state=0, backend="xla",
                          precision="highest", **kw)
    return port, ref


def _assert_same_fit(port, ref):
    assert port.n_iter_ == ref.n_iter_
    np.testing.assert_allclose(port.history_, ref.history_, rtol=1e-5)
    np.testing.assert_allclose(port.components_, ref.components_, **FACTOR_TOL)
    np.testing.assert_allclose(port.embedding_, ref.embedding_, **FACTOR_TOL)


def test_plsa_fit_transform_matches_jax_with_zero_row_and_weights():
    X, w = _corpus()
    port, ref = _pair()
    port.fit(X, sample_weight=w)
    ref.fit(X, sample_weight=w)
    _assert_same_fit(port, ref)
    assert np.all(port.embedding_[5] == 0)
    assert port.fit_info_["backend"] == "torch"
    np.testing.assert_allclose(port.transform(X[:30]), ref.transform(X[:30]), **FACTOR_TOL)


def test_plsa_on_integer_counts_matches_jax():
    """Integer counts stage as bfloat16 (lossless) on both sides."""
    X = _counts()
    assert port_driver._resolve_x_dtype(X, "auto") == torch.bfloat16
    for forced, want in (("bfloat16", torch.bfloat16), (torch.bfloat16, torch.bfloat16),
                         (np.float32, torch.float32), ("float64", torch.float32),
                         (torch.float32, torch.float32)):
        assert port_driver._resolve_x_dtype(X, forced) == want
    port, ref = _pair(n_iter=30, n_iter_per_test=5, tolerance=0.0)
    port.fit(X)
    ref.fit(X)
    _assert_same_fit(port, ref)
    assert port.n_iter_ == 30 and len(port.history_) == 7
    np.testing.assert_allclose(port.transform(X), ref.transform(X), **FACTOR_TOL)


def test_prepared_counts_fit_matches_raw_fit():
    X = _counts()
    prep = enstop_torch.prepare_counts(X, device="cpu")
    assert isinstance(prep, enstop_torch.PreparedCounts)
    assert prep.device_array.shape == (64, 256) and prep.shape == X.shape
    assert prep.device_array.dtype == torch.bfloat16
    np.testing.assert_array_equal(prep.device_array[:60, :150].float().numpy(), X.toarray())
    a = enstop_torch.PLSA(n_components=3, random_state=2, device="cpu").fit(prep)
    b = enstop_torch.PLSA(n_components=3, random_state=2, device="cpu").fit(X)
    assert a.training_data_ is None
    np.testing.assert_allclose(a.components_, b.components_, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(a.embedding_, b.embedding_, rtol=1e-6, atol=1e-7)


def test_plsa_refit_driver_matches_jax():
    from enstop_tpu.ops.driver import plsa_refit as jax_refit

    X = _counts()
    topics = np.random.RandomState(4).rand(3, X.shape[1]).astype(np.float32)
    topics /= topics.sum(1, keepdims=True)
    got = port_driver.plsa_refit(X, topics, random_state=5, device="cpu")
    want = jax_refit(X, topics, random_state=5, backend="xla", precision="highest")
    np.testing.assert_allclose(got, want, **FACTOR_TOL)


def test_synthetic_corpus_is_identical():
    for kw in (dict(n_docs=300, n_words=800, n_topics=6, seed=3),
               dict(n_docs=120, n_words=400, background_weight=0.2, seed=1)):
        Xp, yp = port_synthetic.synthetic_corpus(**kw)
        Xj, yj = jax_synthetic.synthetic_corpus(**kw)
        for attr in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(Xp, attr), getattr(Xj, attr))
        assert Xp.dtype == Xj.dtype and Xp.shape == Xj.shape
        np.testing.assert_array_equal(yp, yj)


@pytest.mark.parametrize("init", ["random", "tuple"])
def test_plsa_init_is_identical(init):
    X = _counts()
    if init == "tuple":
        r = np.random.RandomState(8)
        init = (r.rand(X.shape[0], 5), r.rand(5, X.shape[1]))
    for got, want in zip(port_init(X, 5, init=init, rng=np.random.RandomState(6)),
                         jax_init(X, 5, init=init, rng=np.random.RandomState(6))):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_jax_checkpoint_loads_and_transforms_the_same(tmp_path):
    X, _ = _corpus()
    ref = enstop_tpu.PLSA(n_components=4, random_state=0, backend="xla",
                          precision="highest", n_iter=20).fit(X)
    path = tmp_path / "jax_plsa.npz"
    ref.save(path)
    want = ref.transform(X[:25])

    loaded = enstop_torch.PLSA.load(path, device="cpu")
    assert loaded.backend == "auto" and loaded.n_iter == 20 and loaded.device == "cpu"
    np.testing.assert_array_equal(loaded.components_, ref.components_)
    np.testing.assert_array_equal(loaded.history_, ref.history_)
    np.testing.assert_allclose(loaded.transform(X[:25]), want, **FACTOR_TOL)

    carried = convert.from_jax_state(ref.components_, ref.embedding_, ref.history_,
                                     ref.get_params())
    carried.device = "cpu"
    np.testing.assert_array_equal(carried.embedding_, ref.embedding_)
    np.testing.assert_allclose(carried.transform(X[:25]), want, **FACTOR_TOL)

    # the port writes the same format back
    carried.save(tmp_path / "port.npz")
    again = enstop_tpu.PLSA.load(tmp_path / "port.npz")
    np.testing.assert_array_equal(again.components_, ref.components_)


def test_pad_state_and_warm_start():
    zd = np.random.RandomState(0).rand(10, 5).astype(np.float32)
    wz = np.random.RandomState(1).rand(5, 30).astype(np.float32)
    zd_p, wz_p = convert.pad_state(zd, wz, 16, 128, "cpu")
    assert zd_p.shape == (16, 8) and wz_p.shape == (8, 128)
    assert zd_p.dtype == wz_p.dtype == torch.float32
    np.testing.assert_array_equal(zd_p[:10, :5].numpy(), zd)
    assert float(zd_p[10:].abs().sum()) == 0.0 and float(wz_p[5:].abs().sum()) == 0.0

    X = _counts()
    m = enstop_torch.PLSA(n_components=3, n_iter=5, random_state=0, device="cpu").fit(X)
    resumed = enstop_torch.PLSA(n_components=3, n_iter=5, init=m.warm_start_factors(),
                                device="cpu").fit(X)
    assert resumed.history_[0] >= m.history_[-1] - 1e-3 * abs(m.history_[-1])


@pytest.mark.parametrize("kwargs", [
    dict(precision="fast"),
    dict(backend="sparse"),
    dict(init="nndsvd"),
    dict(init="nmf"),
    dict(e_step_thresh=1e-16),
], ids=["fast", "sparse", "nndsvd", "nmf", "e_step_thresh"])
def test_unported_options_raise(kwargs):
    """The options still to port raise; ``precision="fast"``, the sparse
    backend and a firing ``e_step_thresh``, ported since, fit and transform
    (held against JAX in ``test_torch_fast.py`` and below)."""
    model = enstop_torch.PLSA(n_components=3, device="cpu", **kwargs)
    if "init" not in kwargs:
        X = _counts()
        emb = model.fit_transform(X)
        assert emb.shape == (X.shape[0], 3) and np.all(np.isfinite(emb))
        np.testing.assert_allclose(model.components_.sum(1), 1.0, rtol=1e-5)
        assert np.all(np.isfinite(model.transform(X[:10])))
        sparse = kwargs != dict(precision="fast")
        assert (model.fit_info_["backend"] == "sparse") == sparse
        return
    with pytest.raises(NotImplementedError):
        model.fit(_counts())


def _sparse_init(X, k, seed=8):
    r = np.random.RandomState(seed)
    return r.rand(X.shape[0], k), r.rand(k, X.shape[1])


@pytest.mark.parametrize("route", ["backend", "auto_thresh", "prepared"])
def test_plsa_fit_sparse_matches_jax(route):
    """``backend="sparse"``, the auto-route of a firing threshold and a
    PreparedSell all run the sparse path and agree with JAX's (rtol 1e-5 on
    the LL trace, factors as FACTOR_TOL) from one explicit init."""
    from enstop_tpu.ops.driver import plsa_fit as jax_fit

    X, w = _counts(), np.random.RandomState(3).uniform(0.5, 1.5, 60).astype(np.float32)
    kw = dict(sample_weight=w, init=_sparse_init(X, 4), n_iter=25, n_iter_per_test=5,
              tolerance=0.0, return_info=True)
    port_kw = dict(backend="sparse", e_step_thresh=1e-32)
    if route == "auto_thresh":
        port_kw = dict(e_step_thresh=1e-16)
    X_in = X
    if route == "prepared":
        X_in = enstop_torch.prepare_sell(X, standardize=False, device="cpu")
        port_kw = dict(e_step_thresh=1e-16)
    zd, wz, info = port_driver.plsa_fit(X_in, 4, device="cpu", **kw, **port_kw)
    jzd, jwz, jinfo = jax_fit(X, 4, e_step_thresh=port_kw["e_step_thresh"],
                              backend="sparse", **kw)
    assert info["backend"] == "sparse" and info["n_steps"] == jinfo["n_steps"] == 25
    np.testing.assert_allclose(info["ll_trace"], jinfo["ll_trace"], rtol=1e-5)
    np.testing.assert_allclose(zd, jzd, **FACTOR_TOL)
    np.testing.assert_allclose(wz, jwz, **FACTOR_TOL)
    assert info["nnz_k_updates_per_s"] > 0


def _auto_pair(**kw):
    """Both estimators at the backend ``kw`` names, else ``"auto"``."""
    return (enstop_torch.PLSA(n_components=4, random_state=0, device="cpu", **kw),
            enstop_tpu.PLSA(n_components=4, random_state=0, precision="highest", **kw))


def test_sparse_plsa_estimator_matches_jax():
    X, w = _corpus()
    port, ref = _auto_pair(backend="sparse")
    port.fit(X, sample_weight=w)
    ref.fit(X, sample_weight=w)
    _assert_same_fit(port, ref)
    assert port.fit_info_["backend"] == "sparse" and np.all(port.embedding_[5] == 0)
    np.testing.assert_allclose(port.transform(X[:30]), ref.transform(X[:30]), **FACTOR_TOL)

    # a firing threshold routes the fit to the sparse path; transform passes none
    port, ref = _auto_pair(e_step_thresh=1e-3, n_iter=30)
    port.fit(X)
    ref.fit(X)
    _assert_same_fit(port, ref)
    assert port.fit_info_["backend"] == "sparse"
    np.testing.assert_allclose(port.transform(X[:30]), ref.transform(X[:30]), **FACTOR_TOL)


def test_prepared_sell_reuse():
    X = _counts()
    prep = enstop_torch.prepare_sell(X, standardize=False, device="cpu")
    assert isinstance(prep, enstop_torch.PreparedSell) and prep.shape == X.shape
    for k, seed in ((3, 2), (5, 4)):
        a = enstop_torch.PLSA(n_components=k, random_state=seed, device="cpu").fit(prep)
        b = enstop_torch.PLSA(n_components=k, random_state=seed, backend="sparse",
                              device="cpu").fit(X)
        assert a.training_data_ is None and a.n_iter_ == b.n_iter_
        np.testing.assert_allclose(a.components_, b.components_, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(a.embedding_, b.embedding_, rtol=1e-6, atol=1e-7)
    topics = a.components_
    got = port_driver.plsa_refit(prep, topics, random_state=5, device="cpu")
    np.testing.assert_allclose(
        got, port_driver.plsa_refit(X, topics, random_state=5, backend="sparse", device="cpu"),
        rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="PreparedSell"):
        enstop_torch.PLSA(n_components=3, init="nndsvd", device="cpu").fit(prep)
    with pytest.raises(ValueError, match="prepare_sell"):
        enstop_torch.prepare_counts(X, backend="sparse", device="cpu")


def test_prepared_counts_stay_dense_whatever_the_threshold():
    """As in the JAX package, a PreparedCounts runs the dense path even with a
    firing threshold (the ensemble's refit depends on it)."""
    X = _counts()
    prep = enstop_torch.prepare_counts(X, device="cpu")
    calls = dict(port_driver.em_ops.CALLS)
    _, _, info = port_driver.plsa_fit(prep, 3, e_step_thresh=1e-16, n_iter=5,
                                      return_info=True, device="cpu")
    assert info["backend"] == "torch"
    assert port_driver.em_ops.CALLS["em"] > calls["em"]


def test_fast_on_sparse_warns_and_runs_fp32():
    X = _counts()
    kw = dict(n_components=3, random_state=0, n_iter=10, backend="sparse", device="cpu")
    with pytest.warns(UserWarning, match="fast"):
        fast = enstop_torch.PLSA(precision="fast", **kw).fit(X)
    exact = enstop_torch.PLSA(**kw).fit(X)
    np.testing.assert_array_equal(fast.components_, exact.components_)
    with pytest.warns(UserWarning, match="fast"):
        fast.transform(X[:10])


def test_jax_sparse_checkpoint_loads_and_transforms_the_same(tmp_path):
    X, _ = _corpus()
    ref = enstop_tpu.PLSA(n_components=4, random_state=0, backend="sparse", n_iter=20).fit(X)
    path = tmp_path / "jax_sparse_plsa.npz"
    ref.save(path)
    loaded = enstop_torch.PLSA.load(path, device="cpu")
    assert loaded.backend == "sparse"
    np.testing.assert_array_equal(loaded.components_, ref.components_)
    np.testing.assert_allclose(loaded.transform(X[:25]), ref.transform(X[:25]), **FACTOR_TOL)


def test_backend_must_match_device():
    with pytest.raises(ValueError):
        enstop_torch.PLSA(n_components=3, device="cpu", backend="cuda").fit(_counts())
    with pytest.raises(ValueError):
        enstop_torch.PLSA(n_components=3, device="cpu", backend="xla").fit(_counts())


def test_utils_match_the_jax_package():
    from enstop_tpu import utils as jax_utils

    X, _ = _corpus()
    for inp in (X, sp.csr_matrix(X), X.astype(np.float64), sp.csr_matrix(X.astype(np.float64))):
        got, want = enstop_torch.standardize_input(inp), jax_utils.standardize_input(inp)
        assert sp.issparse(got) == sp.issparse(want) and got.dtype == want.dtype
        dense = lambda a: a.toarray() if sp.issparse(a) else a  # noqa: E731
        np.testing.assert_array_equal(dense(got), dense(want))
    counts = _counts()
    assert enstop_torch.standardize_input(counts) is counts

    a = np.array([[1.0, 3.0], [0.0, 0.0]])
    np.testing.assert_array_equal(enstop_torch.normalize(a.copy(), axis=1),
                                  jax_utils.normalize(a.copy(), axis=1))
    for sw in (None, 2.0, np.arange(70, dtype=np.float64) + 1):
        np.testing.assert_array_equal(port_check_weight(sw, X, dtype=np.float32),
                                      jax_utils._check_sample_weight(sw, X, dtype=np.float32))
    with pytest.raises(ValueError):
        port_check_weight(np.ones(3), X)
    rs = np.random.RandomState(0)
    assert check_random_state(rs) is rs
    assert check_random_state(5).rand() == np.random.RandomState(5).rand()


def test_estimator_params_and_validation():
    m = enstop_torch.PLSA(n_components=3, device="cpu")
    params = m.get_params()
    assert params["device"] == "cpu" and params["n_components"] == 3
    assert set(params) == set(enstop_tpu.PLSA().get_params()) | {"device"}
    m.set_params(n_iter=7)
    assert m.n_iter == 7
    with pytest.raises(ValueError):
        m.set_params(bogus=1)
    with pytest.raises(AttributeError):
        m.transform(_counts())
    with pytest.raises(ValueError, match="non-negative"):
        m.fit(-_counts().toarray())
    with pytest.raises(ValueError):
        m.fit(np.ones(5))
    m.fit(_counts())
    with pytest.raises(ValueError, match="features"):
        m.transform(np.ones((3, 7)))


def test_host_densify_matches_jax_and_device_scatter():
    from enstop_torch.ops.data import pad_dense_counts as port_pad
    from enstop_tpu.ops.data import pad_dense_counts as jax_pad

    X = _counts()
    for inp in (X, X.toarray()):
        got, n, m = port_pad(inp)
        want, n0, m0 = jax_pad(inp)
        assert (n, m) == (n0, m0) and got.shape == want.shape == (64, 256)
        np.testing.assert_array_equal(got, want)
    # dense input is padded on the host, sparse input scattered on the device
    dense = port_driver._stage_dense(X.toarray(), torch.device("cpu"), torch.bfloat16)[0]
    scattered = port_driver._stage_dense(X, torch.device("cpu"), torch.bfloat16)[0]
    assert dense.dtype == scattered.dtype == torch.bfloat16
    assert torch.equal(dense, scattered)
