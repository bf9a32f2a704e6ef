"""The port's topic metrics and the rest of its estimator surface against
the JAX package on the CPU: ``coherence`` / ``log_lift`` (functions and
estimator methods), ``GPUPLSA`` / ``TPUPLSA``, JAX checkpoints of both
through ``TopicModelBase.load``, ``profiling`` and ``datasets``.

Tolerances: the metric functions are the same host NumPy code on the same
inputs, rtol 1e-12; on fitted models each side's own topics, which agree to
the PLSA tolerances (rtol 5e-4 / atol 1e-5), so the metrics to rtol 1e-3.
"""

import json

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import enstop_torch
import enstop_tpu
from conftest import make_corpus
from enstop_torch import datasets as port_datasets
from enstop_torch import profiling as port_profiling
from enstop_torch.models.base import TopicModelBase
from enstop_torch.ops import metrics as port_metrics
from enstop_tpu.ops import metrics as jax_metrics

METRIC_RTOL = 1e-12
FITTED_RTOL = 1e-3


def _topics(rng, k, m):
    return rng.dirichlet(np.full(m, 0.3), size=k)


@pytest.mark.parametrize("dense", [False, True])
def test_metric_functions_match_jax(dense):
    """The ``tests/test_metrics_parity.py`` cases: every topic, top-n and
    all words, and the means; dense and sparse corpora."""
    rng = np.random.RandomState(42)
    X = make_corpus(rng, n_docs=40, n_words=60, seed=2)
    X = X if dense else sp.csr_matrix(X)
    topics = _topics(rng, 4, 60)
    for z in range(4):
        for n_words in (10, -1):
            assert np.isclose(port_metrics.log_lift(topics, z, X, n_words),
                              jax_metrics.log_lift(topics, z, X, n_words), rtol=METRIC_RTOL)
        assert np.isclose(port_metrics.coherence(topics, z, X, 8),
                          jax_metrics.coherence(topics, z, X, 8), rtol=METRIC_RTOL)
    assert np.isclose(port_metrics.mean_log_lift(topics, X, 10),
                      jax_metrics.mean_log_lift(topics, X, 10), rtol=METRIC_RTOL)
    assert np.isclose(port_metrics.mean_coherence(topics, X, 8),
                      jax_metrics.mean_coherence(topics, X, 8), rtol=METRIC_RTOL)
    for name in ("coherence", "log_lift", "mean_coherence", "mean_log_lift"):
        assert getattr(enstop_torch, name) is getattr(port_metrics, name)


def test_a_word_in_no_document_is_skipped():
    X = sp.csr_matrix(np.array([[1, 0, 2, 0], [0, 0, 1, 3], [2, 0, 0, 1]]))
    topics = np.array([[0.1, 0.6, 0.2, 0.1], [0.25, 0.25, 0.25, 0.25]])
    for z in range(2):
        assert np.isclose(port_metrics.coherence(topics, z, X, 3),
                          jax_metrics.coherence(topics, z, X, 3), rtol=METRIC_RTOL)
        assert np.isclose(port_metrics.log_lift(topics, z, X, 3),
                          jax_metrics.log_lift(topics, z, X, 3), rtol=METRIC_RTOL)


@pytest.mark.parametrize("estimator", ["PLSA", "StreamedPLSA", "GPUPLSA", "EnsembleTopics"])
def test_estimator_metrics_match_jax(estimator):
    X = sp.csr_matrix(make_corpus(np.random.RandomState(0), n_docs=50, n_words=60))
    kw = dict(n_components=3, n_iter=8, random_state=0)
    if estimator == "EnsembleTopics":
        # an explicit init: the two packages' device inits draw other streams
        r = np.random.RandomState(8)
        kw.update(n_starts=4, min_samples=2, min_cluster_size=3, init=(r.rand(50, 3), r.rand(3, 60)),
                  topic_combination="hellinger", parallelism="weights")
    if estimator == "GPUPLSA":
        port = enstop_torch.PLSA(device="cpu", **kw).fit(X)
        ref = enstop_tpu.PLSA(backend="xla", precision="highest", **kw).fit(X)
    else:
        port = getattr(enstop_torch, estimator)(device="cpu", **kw).fit(X)
        ref = getattr(enstop_tpu, estimator)(**kw).fit(X)
    if estimator == "EnsembleTopics":
        assert port.n_components_ == ref.n_components_
    for n_words in (5, 20):
        for method in ("coherence", "log_lift"):
            assert np.isclose(getattr(port, method)(n_words=n_words),
                              getattr(ref, method)(n_words=n_words), rtol=FITTED_RTOL)
            assert np.isclose(getattr(port, method)(1, n_words=n_words),
                              getattr(ref, method)(1, n_words=n_words), rtol=FITTED_RTOL)
    assert np.isclose(port.coherence(data=X[:20]), ref.coherence(data=X[:20]),
                      rtol=FITTED_RTOL)


def test_metric_errors():
    X = sp.csr_matrix(make_corpus(np.random.RandomState(0), n_docs=30, n_words=40))
    model = enstop_torch.PLSA(n_components=3, n_iter=5, random_state=0, device="cpu").fit(X)
    for method in (model.coherence, model.log_lift):
        with pytest.raises(ValueError, match="integer"):
            method(1.5)
        with pytest.raises(ValueError, match="range 0 to 3"):
            method(3)
        with pytest.raises(ValueError, match="range"):
            method(-1)
    prepared = enstop_torch.prepare_counts(X, device="cpu")
    fitted = enstop_torch.PLSA(n_components=3, n_iter=5, random_state=0, device="cpu").fit(
        prepared)
    with pytest.raises(ValueError, match="data=X"):
        fitted.coherence()
    assert np.isfinite(fitted.coherence(data=X)) and np.isfinite(fitted.log_lift(0, data=X))


def test_gpuplsa_positional_order_and_params():
    """The reference's positional order: the block counts third and fourth,
    accepted and round-tripped by ``get_params``, changing nothing."""
    model = enstop_torch.GPUPLSA(5, "random", 4, 2, 30)
    assert enstop_torch.TPUPLSA is enstop_torch.GPUPLSA
    assert isinstance(model, enstop_torch.PLSA)
    params = model.get_params()
    assert (params["n_row_blocks"], params["n_col_blocks"], params["n_iter"]) == (4, 2, 30)
    assert params["backend"] == "cuda" and params["device"] == "cuda"
    assert list(params)[:5] == ["n_components", "init", "n_row_blocks", "n_col_blocks", "n_iter"]
    ref_params = enstop_tpu.TPUPLSA(5, "random", 4, 2, 30).get_params()
    assert set(ref_params) | {"device"} == set(params)
    again = enstop_torch.GPUPLSA(**params)
    assert again.get_params() == params
    model.set_params(n_row_blocks=16)
    assert model.get_params()["n_row_blocks"] == 16
    with pytest.raises(ValueError, match="Invalid parameter"):
        model.set_params(n_tiles=3)


def test_gpuplsa_runs_only_on_the_card():
    X = sp.csr_matrix(make_corpus(np.random.RandomState(0), n_docs=30, n_words=40))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            enstop_torch.GPUPLSA(n_components=3).fit(X)
    with pytest.raises(ValueError, match="does not run"):
        enstop_torch.GPUPLSA(n_components=3, device="cpu").fit(X)
    # the blocks change nothing: the same fit as PLSA(backend="torch") on the CPU
    a = enstop_torch.GPUPLSA(3, "random", 2, 2, 10, backend="torch", device="cpu",
                             random_state=0).fit(X)
    b = enstop_torch.PLSA(3, n_iter=10, random_state=0, device="cpu").fit(X)
    np.testing.assert_array_equal(a.components_, b.components_)


@pytest.mark.parametrize("jax_class", ["TPUPLSA", "GPUPLSA"])
def test_jax_gpuplsa_checkpoint_loads(tmp_path, jax_class):
    """The JAX package records ``"TPUPLSA"`` for either name; it loads as the
    port's ``GPUPLSA`` (its ``backend="pallas"`` becoming ``"cuda"``)."""
    X = sp.csr_matrix(make_corpus(np.random.RandomState(0), n_docs=40, n_words=50))
    ref = enstop_tpu.PLSA(n_components=3, n_iter=10, random_state=0, backend="xla").fit(X)
    jax_model = getattr(enstop_tpu, jax_class)(n_components=3, n_row_blocks=4)
    jax_model.components_, jax_model.embedding_ = ref.components_, ref.embedding_
    jax_model.history_ = ref.history_
    path = tmp_path / "gpu.npz"
    jax_model.save(path)
    for loaded in (TopicModelBase.load(path, device="cpu"),
                   enstop_torch.GPUPLSA.load(path, device="cpu"),
                   enstop_torch.TPUPLSA.load(path, device="cpu")):
        assert type(loaded) is enstop_torch.GPUPLSA
        assert loaded.backend == "cuda" and loaded.n_row_blocks == 4
        np.testing.assert_array_equal(loaded.components_, ref.components_)
        np.testing.assert_array_equal(loaded.history_, np.asarray(ref.history_))
    with pytest.raises(ValueError, match="TPUPLSA"):
        enstop_torch.StreamedPLSA.load(path)
    json.loads(bytes(np.load(path)["params_json"]).decode())  # the JAX format


def test_profiling_trace_and_step_timer(tmp_path):
    X = sp.csr_matrix(make_corpus(np.random.RandomState(0), n_docs=30, n_words=40))
    with port_profiling.trace(tmp_path / "prof") as prof:
        model = enstop_torch.PLSA(n_components=3, n_iter=5, random_state=0,
                                  device="cpu").fit(X)
    traces = list((tmp_path / "prof").glob("*.pt.trace.json"))
    assert len(traces) == 1 and json.loads(traces[0].read_text())["traceEvents"]
    assert prof.key_averages() is not None
    assert "EM steps" in port_profiling.fit_stats(model)
    assert "no fit info" in port_profiling.fit_stats(enstop_torch.PLSA())

    timer = port_profiling.StepTimer()
    t = torch.ones(4)
    for _ in range(3):
        with timer.section("em", sync_on=t):
            t = t * 2
    with timer.section("ll", sync_on=[t, t]):
        pass
    with timer.section("host"):
        pass
    report = timer.report()
    assert list(report) == ["em", "host", "ll"]
    assert report["em"]["calls"] == 3 and report["em"]["total_s"] >= 0
    assert report["em"]["mean_ms"] == pytest.approx(1e3 * report["em"]["total_s"] / 3)


def test_datasets_npz_round_trip_and_error(tmp_path, monkeypatch):
    X = sp.csr_matrix(make_corpus(np.random.RandomState(0), n_docs=20, n_words=30))
    labels = np.arange(20) % 3
    vocab = np.array([f"w{i}" for i in range(30)])
    path = tmp_path / "20ng.npz"
    port_datasets.save_20newsgroups_npz(path, X, labels, vocabulary=vocab)
    for got in (port_datasets.load_20newsgroups_counts(local_npz=str(path)),
                __import__("enstop_tpu.datasets").datasets.load_20newsgroups_counts(
                    local_npz=str(path))):
        assert (got[0] != X).nnz == 0
        np.testing.assert_array_equal(got[1], labels)
        np.testing.assert_array_equal(got[2], vocab)
    monkeypatch.setenv(port_datasets.NPZ_ENV_VAR, str(path))
    assert port_datasets.NPZ_ENV_VAR == "ENSTOP_TPU_20NG_NPZ"
    assert port_datasets.load_20newsgroups_counts()[0].shape == (20, 30)
    monkeypatch.setenv(port_datasets.NPZ_ENV_VAR, str(tmp_path / "missing.npz"))
    # scikit-learn's default cache directory, empty, in place of the home directory's
    monkeypatch.setenv("SCIKIT_LEARN_DATA", str(tmp_path / "scikit_learn_data"))
    with pytest.raises(RuntimeError, match="ENSTOP_TPU_20NG_NPZ"):
        port_datasets.load_20newsgroups_counts()
    port_datasets.save_20newsgroups_npz(tmp_path / "bare.npz", X, labels)
    assert port_datasets.load_20newsgroups_counts(str(tmp_path / "bare.npz"))[2] is None


def _newsgroups_bunch(n_docs=40, seed=0):
    """A small fixed stand-in for scikit-learn's 20-Newsgroups bunch: words
    drawn from a 12-word vocabulary and three English stop words."""
    from sklearn.utils import Bunch

    rng = np.random.RandomState(seed)
    words = np.array([f"topic{i}" for i in range(12)] + ["the", "and", "of"])
    data = [" ".join(rng.choice(words, size=rng.randint(3, 15))) for _ in range(n_docs)]
    return Bunch(data=data, target=rng.randint(0, 20, n_docs))


@pytest.mark.parametrize("vectorizer", [{}, {"min_df": 1, "stop_words": None}],
                         ids=["notebook", "all_words"])
def test_datasets_sklearn_cache_matches_jax(tmp_path, monkeypatch, vectorizer):
    """With no ``.npz``, both loaders read scikit-learn's cache in
    ``data_home`` (``fetch_20newsgroups``, monkeypatched here to a fixed
    bunch) without downloading, and vectorise it to the same CSR arrays,
    labels and vocabulary; with neither source both raise ``RuntimeError``."""
    import sklearn.datasets

    from enstop_tpu import datasets as jax_datasets

    calls = []

    def fetch(subset, data_home, download_if_missing):
        calls.append((subset, data_home, download_if_missing))
        if data_home == str(tmp_path / "empty"):
            raise OSError("20Newsgroups dataset not found and download_if_missing is False")
        return _newsgroups_bunch()

    monkeypatch.delenv(port_datasets.NPZ_ENV_VAR, raising=False)
    monkeypatch.setattr(sklearn.datasets, "fetch_20newsgroups", fetch)
    home = str(tmp_path / "cache")
    port = port_datasets.load_20newsgroups_counts(data_home=home, **vectorizer)
    ref = jax_datasets.load_20newsgroups_counts(data_home=home, **vectorizer)
    assert calls == [("all", home, False)] * 2
    assert sp.isspmatrix_csr(port[0]) and port[0].shape == ref[0].shape
    assert port[0].shape[1] == (15 if vectorizer else 12)
    for attr in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(getattr(port[0], attr), getattr(ref[0], attr))
    np.testing.assert_array_equal(port[1], ref[1])
    np.testing.assert_array_equal(port[2], ref[2])
    missing = port_datasets.load_20newsgroups_counts(local_npz=str(tmp_path / "none.npz"),
                                                     data_home=home, **vectorizer)
    assert (missing[0] != port[0]).nnz == 0
    for loader in (port_datasets.load_20newsgroups_counts,
                   jax_datasets.load_20newsgroups_counts):
        with pytest.raises(RuntimeError, match="data_home="):
            loader(data_home=str(tmp_path / "empty"), **vectorizer)
