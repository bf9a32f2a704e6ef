"""The port's NMF, its data-dependent pLSA inits and ``model="nmf"`` against
the JAX package (and scikit-learn, which the JAX package calls) on the CPU.

Tolerances:

* ``randomized_svd`` and ``nndsvd_init``: rtol 1e-10 (the same draws and the
  same LAPACK calls in float64; observed bit for bit).
* the coordinate-descent NMF against scikit-learn's: the same iteration
  count; factors within 1e-9 of the largest entry for float64 input and 2e-4
  for float32 input (the Cython sweep sums each gradient in row order, the
  port as a matrix-vector product; over 100-200 sweeps float32 moves that
  far).
* ``nmf_fit_mu`` against JAX's, 200 multiplicative updates in float32: 1e-4
  of the largest entry (float32 products summed in another order).
* ``PLSA(init="nndsvd"/"nmf")``: the PLSA tolerances of
  ``test_torch_plsa.py`` (``n_iter_`` equal, history rtol 1e-5, factors
  rtol 5e-4 / atol 1e-5); the inits themselves rtol 1e-5 (float64 init
  rounded to float32 on both sides).
* ``EnsembleTopics(model="nmf")``: topic stacks within 1e-4 of the largest
  entry; with ``topic_combination="hellinger"`` the same ``n_components_``,
  stable topics within 1e-4 and the embedding within 1e-3 of the largest
  entry. ``parallelism`` is pinned to ``"resample"`` on both sides (what
  ``"auto"`` resolves to for NMF in both packages).
"""

import warnings

import numpy as np
import pytest
import scipy.sparse as sp
from sklearn.decomposition import NMF, non_negative_factorization
from sklearn.utils.extmath import randomized_svd as sk_randomized_svd

import enstop_torch
import enstop_tpu
from conftest import make_corpus
from enstop_torch.models import ensemble as port_ens
from enstop_torch.ops import init as port_init
from enstop_torch.ops import nmf as port_nmf
from enstop_torch.synthetic import synthetic_corpus
from enstop_tpu.models import ensemble as jax_ens
from enstop_tpu.ops import init as jax_init
from enstop_tpu.ops import nmf as jax_nmf

SVD_RTOL = 1e-10
CD_TOL = {np.float64: 1e-9, np.float32: 2e-4}
MU_TOL = 1e-4
FACTOR_TOL = dict(rtol=5e-4, atol=1e-5)


def _maxrel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max())


def _inputs(shape, seed=0):
    D = np.random.RandomState(seed).poisson(0.8, shape)
    return {"dense int": D, "csr int": sp.csr_matrix(D), "dense float64": D.astype(np.float64),
            "csr float32": sp.csr_matrix(D.astype(np.float32))}


def _separated():
    X, _ = synthetic_corpus(n_docs=240, n_words=320, n_topics=4, tokens_per_doc=150,
                            doc_topic_alpha=0.02, seed=3)
    return sp.csr_matrix(X).astype(np.float32)


@pytest.mark.parametrize("shape", [(80, 120), (120, 80)], ids=["wide", "tall"])
@pytest.mark.parametrize("k", [3, 10])
def test_randomized_svd_matches_scikit_learn(shape, k):
    for name, X in _inputs(shape).items():
        got = port_init.randomized_svd(X, k, np.random.RandomState(3))
        want = sk_randomized_svd(X, k, random_state=np.random.RandomState(3))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype, name
            np.testing.assert_allclose(g, w, rtol=SVD_RTOL, atol=0, err_msg=name)


@pytest.mark.parametrize("shape", [(60, 90), (90, 60)], ids=["wide", "tall"])
def test_nndsvd_init_matches_jax(shape):
    for name, X in _inputs(shape, seed=1).items():
        got = port_init.nndsvd_init(X, 5, np.random.RandomState(4))
        want = jax_init.nndsvd_init(X, 5, np.random.RandomState(4))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=SVD_RTOL, atol=0, err_msg=name)
        assert np.all(got[0] >= 0) and np.all(got[1] >= 0)


@pytest.mark.parametrize("shape", [(60, 90), (90, 60)], ids=["wide", "tall"])
@pytest.mark.parametrize("k", [3, 5])
def test_nmf_frobenius_init_matches_scikit_learn(shape, k):
    for name, X in _inputs(shape, seed=2).items():
        W, H, n_iter = non_negative_factorization(
            X, n_components=k, init="nndsvd", solver="cd", beta_loss=2, tol=1e-2,
            max_iter=100, random_state=np.random.RandomState(2))
        W2, H2, n_iter2 = port_nmf.nmf_cd(X, k, init="nndsvd", tol=1e-2, max_iter=100,
                                          random_state=np.random.RandomState(2))
        assert n_iter2 == n_iter and W2.dtype == W.dtype, name
        tol = CD_TOL[W.dtype.type]
        assert _maxrel(W2, W) <= tol and _maxrel(H2, H) <= tol, name
        W3, H3 = port_nmf.nmf_frobenius_init(X, k, np.random.RandomState(2))
        np.testing.assert_array_equal(W3, W2)
        np.testing.assert_array_equal(H3, H2)


@pytest.mark.parametrize("init", ["nndsvd", "random"])
@pytest.mark.parametrize("alpha", [0.0, 0.5])
def test_cd_solver_matches_scikit_learn_nmf(init, alpha):
    """The ensemble's ``solver="cd"``: scikit-learn's ``NMF`` with
    ``alpha_W = alpha / n_features`` and ``alpha_H = alpha / n_samples``
    puts ``alpha`` on both factors' L2 terms, 200 sweeps at tol 1e-4."""
    for name, X in _inputs((70, 50), seed=5).items():
        if name.startswith("dense int"):
            continue
        model = NMF(n_components=4, init=init, beta_loss=2, solver="cd",
                    alpha_W=alpha / X.shape[1], alpha_H=alpha / X.shape[0], l1_ratio=0.0,
                    random_state=7)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            W = model.fit_transform(X)
        W2, H2, n_iter = port_nmf.nmf_cd(X, 4, init=init, l2_reg=alpha, random_state=7)
        assert n_iter == model.n_iter_, name
        tol = CD_TOL[W.dtype.type]
        assert _maxrel(H2, model.components_) <= tol and _maxrel(W2, W) <= tol, name


def test_cd_solver_rejects_what_scikit_learn_rejects():
    with pytest.raises(ValueError, match="Negative"):
        port_nmf.nmf_cd(-np.ones((5, 6)), 2)
    with pytest.raises(ValueError, match="n_components"):
        port_nmf.nmf_cd(np.ones((5, 6)), 6, init="nndsvd")
    with pytest.raises(ValueError, match="nndsvd"):
        port_nmf.nmf_cd(np.ones((5, 6)), 2, init="nndsvda")


@pytest.mark.parametrize("beta_loss", [1, 2])
@pytest.mark.parametrize("init", ["nndsvd", "random"])
@pytest.mark.parametrize("alpha,l1_ratio", [(0.0, 0.0), (0.5, 0.3)])
def test_nmf_fit_mu_matches_jax(beta_loss, init, alpha, l1_ratio):
    X = _separated()
    kw = dict(beta_loss=beta_loss, init=init, alpha=alpha, l1_ratio=l1_ratio, random_state=3)
    W, H = port_nmf.nmf_fit_mu(X, 4, device="cpu", **kw)
    Wj, Hj = jax_nmf.nmf_fit_mu(X, 4, **kw)
    assert W.shape == (240, 4) and H.shape == (4, 320) and W.dtype == np.float32
    assert _maxrel(W, Wj) <= MU_TOL and _maxrel(H, Hj) <= MU_TOL


@pytest.mark.parametrize("beta_loss", [1, 2])
def test_nmf_fit_mu_with_frozen_topics_matches_jax(beta_loss):
    X = _separated()
    H0 = np.random.RandomState(0).rand(4, X.shape[1]).astype(np.float32)
    H0 /= H0.sum(1, keepdims=True)
    kw = dict(beta_loss=beta_loss, H_init=H0, update_H=False, random_state=5)
    W, H = port_nmf.nmf_fit_mu(X, 4, device="cpu", **kw)
    Wj, _ = jax_nmf.nmf_fit_mu(X, 4, **kw)
    np.testing.assert_array_equal(H, H0)
    assert _maxrel(W, Wj) <= MU_TOL
    # an explicit (W, H) start
    W2, H2 = port_nmf.nmf_fit_mu(X, 4, init=(Wj, H0), n_iter=20, device="cpu")
    W2j, H2j = jax_nmf.nmf_fit_mu(X, 4, init=(Wj, H0), n_iter=20)
    assert _maxrel(W2, W2j) <= MU_TOL and _maxrel(H2, H2j) <= MU_TOL


@pytest.mark.parametrize("init", ["nndsvd", "nmf"])
@pytest.mark.parametrize("backend", ["auto", "sparse"])
def test_plsa_data_dependent_inits_match_jax(init, backend):
    X = sp.csr_matrix(make_corpus(np.random.RandomState(1), n_docs=60, n_words=150,
                                  seed=9).astype(np.int64))
    for a, b in zip(port_init.plsa_init(X, 4, init=init, rng=np.random.RandomState(0)),
                    jax_init.plsa_init(X, 4, init=init, rng=np.random.RandomState(0))):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-8)
    kw = dict(n_components=4, init=init, n_iter=30, n_iter_per_test=5, tolerance=0.0,
              random_state=0, backend=backend)
    port = enstop_torch.PLSA(device="cpu", **kw).fit(X)
    ref = enstop_tpu.PLSA(precision="highest", **{**kw, "backend": (
        "xla" if backend == "auto" else backend)}).fit(X)
    assert port.n_iter_ == ref.n_iter_
    np.testing.assert_allclose(port.history_, ref.history_, rtol=1e-5)
    np.testing.assert_allclose(port.components_, ref.components_, **FACTOR_TOL)
    np.testing.assert_allclose(port.embedding_, ref.embedding_, **FACTOR_TOL)


@pytest.mark.parametrize("solver", ["mu", "cd"])
def test_nmf_stack_matches_jax(solver):
    X = _separated()
    kw = dict(model="nmf", n_runs=4, parallelism="resample", random_state=0, solver=solver)
    got = port_ens.ensemble_of_topics(X, 4, device="cpu", **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jax_ens.ensemble_of_topics(X, 4, **kw)
    assert got.shape == want.shape == (16, X.shape[1])
    np.testing.assert_allclose(got.sum(1), 1.0, rtol=1e-5)
    assert _maxrel(got, want) <= MU_TOL


def test_nmf_cd_runs_in_a_thread_pool_as_sequentially():
    """``solver="cd"`` under ``"joblib"`` fans the host solver over threads,
    with each run's seed drawn up front: the same stack as one after
    another."""
    X = _separated()
    kw = dict(model="nmf", n_runs=4, random_state=0, solver="cd", device="cpu")
    pooled = port_ens.ensemble_of_topics(X, 4, parallelism="joblib", n_jobs=4, **kw)
    serial = port_ens.ensemble_of_topics(X, 4, parallelism="resample", **kw)
    np.testing.assert_array_equal(pooled, serial)


@pytest.mark.parametrize("solver", ["mu", "cd"])
def test_nmf_ensemble_matches_jax(solver):
    X = _separated()
    kw = dict(n_components=4, model="nmf", n_starts=4, parallelism="resample",
              topic_combination="hellinger", min_samples=2, min_cluster_size=3,
              random_state=0, solver=solver)
    port = enstop_torch.EnsembleTopics(device="cpu", **kw)
    ref = enstop_tpu.EnsembleTopics(**kw)
    emb = port.fit_transform(X)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = ref.fit_transform(X)
    assert port.n_components_ == ref.n_components_ >= 2
    assert _maxrel(port.components_, ref.components_) <= MU_TOL
    assert _maxrel(emb, want) <= 1e-3
    np.testing.assert_allclose(port.components_.sum(1), 1.0, rtol=1e-5)
    assert set(port_ens.ensemble_fit.last_timings) == {"staging_s", "runs_s", "combine_s",
                                                       "refit_s"}
    # the quality band: every planted topic is some stable topic's nearest
    truth = synthetic_corpus(n_docs=240, n_words=320, n_topics=4, tokens_per_doc=150,
                             doc_topic_alpha=0.02, seed=3)[1]
    labels = emb.argmax(1)
    agree = np.mean([np.bincount(labels[truth == t]).max() / (truth == t).sum()
                     for t in np.unique(truth)])
    assert agree > 0.8


def test_nmf_ensemble_default_combiner_and_prepared_input():
    X = _separated()
    model = enstop_torch.EnsembleTopics(n_components=4, model="nmf", n_starts=4,
                                        random_state=0, device="cpu").fit(X)
    assert model.n_components_ >= 2 and np.all(np.isfinite(model.embedding_))
    assert np.all(np.isfinite(model.transform(X[:10])))
    prepared = enstop_torch.prepare_counts(X, device="cpu")
    with pytest.raises(ValueError, match="model='plsa'"):
        enstop_torch.ensemble_fit(prepared, 4, model="nmf", device="cpu")
    with pytest.raises(ValueError, match="Model must be"):
        enstop_torch.EnsembleTopics(model="lda", device="cpu").fit(X)
