"""The port's EnsembleTopics slice against the JAX package on the CPU.

Both sides get the same numpy corpus, the same explicit factor-tuple init and
the same ``random_state``, so they draw the same bootstrap weights (checked
exactly). Tolerances:

* ``ensemble_of_topics`` stacks: at ``"default"`` (JAX ``backend="xla"``) a
  max-norm relative error of 1e-5 (float32 summation order); at ``"fast"``
  (JAX ``backend="pallas"``, the ``jo_res_bf16r`` kernel in interpret mode)
  5e-3, since bf16 roundings differ between the two sides
  (``test_torch_fast.py``).
* Combiners given the same stack: ``kl_divergence`` and ``hellinger`` give
  identical labels and stable topics to 1e-5. So does ``hellinger_umap``
  when both sides get the same Hellinger matrix. With each side's own matrix
  it gives the same partition, but the clusters may be numbered in another
  order and the membership weights move, so stable topics agree to 2e-3
  cluster for cluster: its spectral init is ill-conditioned when the stack
  has near-disconnected groups, and the two packages' Hellinger matrices
  differ in the last float32 bits (held to 1e-6 in test_torch_cluster.py).
* The dense fan-out's runs, fitted in groups on the batched step, against
  the same runs one after another on the CPU: bit for bit the stack, each
  run's steps, final state and log-likelihood trace
  (``test_batched_runs_are_the_per_run_loops``); the counter
  ``batched_run_steps`` is each run's steps less its folded test steps
  there, and 0 on the routes that fit one run after another.
* ``EnsembleTopics.fit_transform`` on a well-separated corpus: the same
  ``n_components_``; with ``topic_combination="hellinger"`` stable topics
  within 1e-6 and embeddings within 1e-5; with the default
  ``"hellinger_umap"`` stable topics within 2e-3 and embeddings within 5e-2,
  matched topic for topic (the membership weights come out of the UMAP
  layout, see above).
"""

import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.optimize import linear_sum_assignment

import enstop_torch
import enstop_tpu
from enstop_torch.cluster.hdbscan import HDBSCAN as PortHDBSCAN
from enstop_torch.cluster.umap import umap_embed as port_umap_embed
from enstop_torch.models import ensemble as port_ens
from enstop_torch.ops import cuda_em, cuda_sparse
from enstop_torch.ops import em as port_em
from enstop_torch.ops.data import _Staged
from enstop_torch.ops.driver import _staged
from enstop_torch.synthetic import synthetic_corpus
from enstop_tpu.cluster.distances import all_pairs_hellinger_distance as jax_hellinger
from enstop_tpu.cluster.hdbscan import HDBSCAN as JaxHDBSCAN
from enstop_tpu.models import ensemble as jax_ens

torch.set_num_threads(1)

K = 4
UMAP_TOPIC_ATOL = 2e-3
RUN_KW = dict(n_runs=4, n_iter=20, random_state=0, e_step_thresh=1e-32)


def _corpus():
    X, _ = synthetic_corpus(n_docs=240, n_words=320, n_topics=K, tokens_per_doc=150,
                            doc_topic_alpha=0.02, seed=3)
    r = np.random.RandomState(8)
    return X, (r.rand(X.shape[0], K), r.rand(K, X.shape[1]))


def _maxrel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def corpus():
    return _corpus()


def _jax_stack_and_weights(X, init, precision, backend):
    """The JAX package's weights-path stack, and the document weights of each
    run as its fit program received them."""
    seen = []
    real = jax_ens._build_fit_fn

    def spy(*args, **kwargs):
        run = real(*args, **kwargs)

        def recorded(Xd, zd, wz, w, tol):
            seen.append(np.asarray(w))
            return run(Xd, zd, wz, w, tol)

        return recorded

    jax_ens._build_fit_fn = spy
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            stack = jax_ens.ensemble_of_topics(X.astype(np.float32), K, init=init,
                                               parallelism="weights", backend=backend,
                                               precision=precision, **RUN_KW)
    finally:
        jax_ens._build_fit_fn = real
    return stack, seen


@pytest.fixture(scope="module")
def jax_stacks(corpus):
    X, init = corpus
    return {prec: _jax_stack_and_weights(X, init, prec, backend)
            for prec, backend in (("default", "xla"), ("fast", "pallas"))}


@pytest.mark.parametrize("precision,tol", [("default", 1e-5), ("fast", 5e-3)])
def test_stack_and_bootstrap_weights_match_jax(corpus, jax_stacks, precision, tol):
    X, init = corpus
    want, jax_weights = jax_stacks[precision]
    calls = dict(port_em.CALLS)
    got = enstop_torch.ensemble_of_topics(X.astype(np.float32), K, init=init, device="cpu",
                                          precision=precision, **RUN_KW)
    assert isinstance(got, np.ndarray) and got.flags.writeable
    assert got.shape == want.shape == (4 * K, X.shape[1])
    assert _maxrel(got, want) <= tol
    np.testing.assert_allclose(got.sum(1), 1.0, rtol=1e-5)
    prepared = enstop_torch.prepare_counts(X.astype(np.float32), standardize=False,
                                           device="cpu")
    # "fast" ran the bf16r plain steps, one run after another; "default" the
    # float32 ones, each run's folded steps (1, 2 and 12 of its 20) alone and
    # the other 17 in its group's batched steps
    if precision == "fast":
        assert port_em.CALLS["em_bf16r"] - calls["em_bf16r"] == 4 * 20
    else:
        assert port_em.CALLS["em"] - calls["em"] == 4 * 3
        assert port_em.CALLS["batch"] - calls["batch"] == 17 * len(prepared._run_groups(K, 4))
    port_weights = [w.numpy() for _, _, w in port_ens.bootstrap_inputs(
        prepared, K, 4, np.random.RandomState(0), init=init, X=X)]
    assert len(port_weights) == len(jax_weights) == 4
    for a, b in zip(port_weights, jax_weights):
        np.testing.assert_array_equal(a, b.ravel())


def test_random_init_draws_the_jax_order(corpus):
    """With init="random" one randint seeds the device inits, then one
    multinomial per run: the weights equal JAX's for the same seed."""
    X, _ = corpus
    _, jax_weights = _jax_stack_and_weights(X, "random", "default", "xla")
    prepared = enstop_torch.prepare_counts(X.astype(np.float32), standardize=False,
                                           device="cpu")
    runs = list(port_ens.bootstrap_inputs(prepared, K, 4, np.random.RandomState(0)))
    for (zd, wz, w), want in zip(runs, jax_weights):
        np.testing.assert_array_equal(w.numpy(), want.ravel())
        n, m = X.shape
        assert float(zd[n:].abs().sum()) == 0 and float(zd[:, K:].abs().sum()) == 0
        assert float(wz[K:].abs().sum()) == 0 and float(wz[:, m:].abs().sum()) == 0
        torch.testing.assert_close(zd[:n].sum(1), torch.ones(n))
        torch.testing.assert_close(wz[:K].sum(1), torch.ones(K))
    assert not torch.equal(runs[0][1], runs[1][1])
    again = next(port_ens.bootstrap_inputs(prepared, K, 1, np.random.RandomState(0)))
    assert torch.equal(again[0], runs[0][0]) and torch.equal(again[1], runs[0][1])


def _capture_merge(module, monkeypatch):
    seen = []
    real = module._merge_topics_by_label

    def spy(all_topics, labels, weights=None):
        seen.append((np.asarray(labels).copy(), None if weights is None else np.array(weights)))
        return real(all_topics, labels, weights)

    monkeypatch.setattr(module, "_merge_topics_by_label", spy)
    return seen


def _combine_both(name, stack, as_tensor, monkeypatch):
    """Run the port's and JAX's combiner on one stack; returns each side's
    stable topics, merge labels and merge weights."""
    kw = dict(random_state=0) if name == "hellinger_umap" else {}
    port_seen = _capture_merge(port_ens, monkeypatch)
    jax_seen = _capture_merge(jax_ens, monkeypatch)
    # a numpy stack goes to the card unless the call names the CPU
    got = port_ens._combine[name](torch.from_numpy(stack) if as_tensor else stack,
                                  3, 4, **kw, **({} if as_tensor else {"device": "cpu"})
                                  ).stable_topics
    want = jax_ens._topic_combiner[name](stack, 3, 4, **kw)
    assert got.shape == want.shape and got.shape[0] >= 2
    return (got, *port_seen[0]), (want, *jax_seen[0])


@pytest.mark.parametrize("name", ["kl_divergence", "hellinger", "hellinger_umap"])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_combiners_match_jax_on_the_same_stack(jax_stacks, monkeypatch, name, as_tensor):
    stack = jax_stacks["default"][0]
    if name == "hellinger_umap":
        # the same distance matrix on both sides (the matrices themselves are
        # held together in test_torch_cluster.py)
        monkeypatch.setattr(jax_ens, "all_pairs_hellinger_distance",
                            lambda d: port_ens.all_pairs_hellinger_distance(d, device="cpu"))
    (got, pl, pw), (want, jl, jw) = _combine_both(name, stack, as_tensor, monkeypatch)
    np.testing.assert_array_equal(pl, jl)
    if pw is not None or jw is not None:
        np.testing.assert_allclose(pw, jw, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_umap_combiner_partition_matches_jax_on_the_same_stack(jax_stacks, monkeypatch):
    """Each side with its own distance matrix: the same partition, the
    clusters numbered in another order, and stable topics close."""
    (got, pl, _), (want, jl, _) = _combine_both("hellinger_umap", jax_stacks["default"][0],
                                                True, monkeypatch)
    perm = {}
    for a, b in zip(pl, jl):
        assert perm.setdefault(a, b) == b
    assert len(set(perm.values())) == len(perm)
    order = [perm[c] for c in range(got.shape[0])]
    np.testing.assert_allclose(got, want[order], rtol=0, atol=UMAP_TOPIC_ATOL)


def test_umap_combiner_labels_identical_given_the_same_dmat(jax_stacks):
    dmat = jax_hellinger(jax_stacks["default"][0])
    emb = port_umap_embed(dmat=dmat, n_components=5, n_neighbors=15, random_state=0,
                          device="cpu")
    kw = dict(min_samples=3, min_cluster_size=4, cluster_selection_method="leaf",
              allow_single_cluster=True)
    ours, ref = PortHDBSCAN(**kw).fit(emb), JaxHDBSCAN(**kw).fit(emb)
    np.testing.assert_array_equal(ours.labels_, ref.labels_)
    np.testing.assert_array_equal(ours.probabilities_, ref.probabilities_)


def test_merge_on_device_matches_numpy():
    rng = np.random.RandomState(0)
    T = rng.dirichlet(np.full(50, 0.3), size=12).astype(np.float32)
    labels = np.array([0, 0, 1, 1, 1, 2, 2, 0, 1, 2, 2, 0])
    weights = rng.rand(12)
    for w in (None, weights):
        got = port_ens._merge_topics_by_label(torch.from_numpy(T), labels, w)
        np.testing.assert_allclose(got, port_ens._merge_topics_by_label(T, labels, w),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(got, jax_ens._merge_topics_by_label(T, labels, w),
                                   rtol=0, atol=1e-6)


def _matched(port_topics, jax_topics):
    cost = np.abs(port_topics[:, None, :] - jax_topics[None, :, :]).max(-1)
    rows, cols = linear_sum_assignment(cost)
    return rows, cols, cost[rows, cols].max()


@pytest.mark.parametrize("combination,topic_tol,emb_tol", [
    ("hellinger", 1e-6, 1e-5),
    ("hellinger_umap", 2e-3, 5e-2),
])
def test_estimator_matches_jax(corpus, combination, topic_tol, emb_tol):
    X, init = corpus
    kw = dict(n_components=K, n_starts=8, n_iter=40, random_state=0, init=init,
              topic_combination=combination)
    port = enstop_torch.EnsembleTopics(device="cpu", **kw)
    emb = port.fit_transform(X)
    ref = enstop_tpu.EnsembleTopics(backend="xla", parallelism="weights", **kw).fit(X)
    assert port.n_components_ == ref.n_components_ == K
    rows, cols, topic_gap = _matched(port.components_, ref.components_)
    assert topic_gap <= topic_tol
    np.testing.assert_allclose(emb[:, rows], ref.embedding_[:, cols], rtol=0, atol=emb_tol)
    assert port.training_data_.shape == X.shape
    assert set(port_ens.ensemble_fit.last_timings) == {"staging_s", "runs_s", "combine_s",
                                                       "refit_s"}
    np.testing.assert_allclose(port.transform(X[:25])[:, rows],
                               ref.transform(X[:25])[:, cols], rtol=0, atol=emb_tol)


def test_fast_estimator_runs_the_bf16r_steps(corpus):
    X, init = corpus
    calls = dict(port_em.CALLS)
    launches = dict(cuda_em.LAUNCHES)
    model = enstop_torch.EnsembleTopics(n_components=K, n_starts=4, n_iter=20, random_state=0,
                                        precision="fast", device="cpu").fit(X)
    assert port_em.CALLS["em_bf16r"] - calls["em_bf16r"] == 4 * 20
    assert port_em.CALLS["refit_bf16r"] > calls["refit_bf16r"]
    assert port_em.CALLS["em"] == calls["em"] and port_em.CALLS["refit"] == calls["refit"]
    assert cuda_em.LAUNCHES == launches
    assert model.n_components_ >= 2
    assert np.all(np.isfinite(model.components_)) and np.all(np.isfinite(model.embedding_))
    np.testing.assert_allclose(model.components_.sum(1), 1.0, rtol=1e-5)


def test_resample_and_thread_pool_match_jax(corpus):
    X, init = corpus
    kw = dict(n_runs=3, n_iter=10, random_state=1, e_step_thresh=1e-32)
    seq = enstop_torch.ensemble_of_topics(X, K, parallelism="resample", device="cpu", **kw)
    pooled = enstop_torch.ensemble_of_topics(X, K, parallelism="joblib", n_jobs=3,
                                             device="cpu", **kw)
    np.testing.assert_array_equal(seq, pooled)
    want = jax_ens.ensemble_of_topics(X, K, parallelism="resample", backend="xla",
                                      precision="highest", **kw)
    assert _maxrel(seq, want) <= 1e-5


def test_prepared_counts_and_checkpoints(corpus, tmp_path):
    X, init = corpus
    kw = dict(n_components=K, n_starts=4, n_iter=20, random_state=0, init=init,
              topic_combination="hellinger")
    raw = enstop_torch.EnsembleTopics(device="cpu", **kw).fit(X)
    prep = enstop_torch.prepare_counts(X.astype(np.float32), standardize=False, device="cpu")
    from_prep = enstop_torch.EnsembleTopics(device="cpu", **kw).fit(prep)
    assert from_prep.training_data_ is None
    np.testing.assert_allclose(from_prep.components_, raw.components_, rtol=0, atol=1e-6)

    # a JAX ensemble carried across: checkpoint and arrays
    ref = enstop_tpu.EnsembleTopics(backend="xla", **kw).fit(X)
    path = tmp_path / "jax_ensemble.npz"
    ref.save(path)
    want = ref.transform(X[:30])
    loaded = enstop_torch.EnsembleTopics.load(path, device="cpu")
    carried = enstop_torch.EnsembleTopics.from_state(ref.components_, ref.embedding_,
                                                     params=ref.get_params())
    carried.device = "cpu"
    for model in (loaded, carried):
        assert model.n_components_ == ref.n_components_ and model.backend == "auto"
        np.testing.assert_array_equal(model.components_, ref.components_)
        np.testing.assert_allclose(model.transform(X[:30]), want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="EnsembleTopics"):
        enstop_torch.PLSA.load(path)


@pytest.mark.parametrize("call", [
    lambda X: enstop_torch.EnsembleTopics(model="nmf", device="cpu").fit(X),
    lambda X: enstop_torch.EnsembleTopics(backend="sparse", device="cpu").fit(X),
    lambda X: enstop_torch.EnsembleTopics(parallelism="sharded", device="cpu").fit(X),
    lambda X: enstop_torch.ensemble_fit(X, 3, device="cpu"),  # e_step_thresh=1e-16
    lambda X: enstop_torch.ensemble_of_topics(X, 3, n_runs=2, parallelism="resample",
                                              device="cpu"),  # likewise
], ids=["nmf", "sparse", "sharded", "ensemble_fit_thresh", "resample_thresh"])
def test_routes_ported_since_run(request, corpus, call):
    """NMF, the sparse routes and the runs-sharded fan-out, each once
    unported, run (held against JAX below, in ``test_torch_nmf.py`` and in
    ``test_torch_mesh.py``). ``"sharded"`` on the one CPU device warns, as
    JAX's does on one device."""
    if request.node.callspec.id == "sharded":
        with pytest.warns(UserWarning, match="single device"):
            out = call(corpus[0])
    else:
        out = call(corpus[0])
    for a in out if isinstance(out, tuple) else (getattr(out, "components_", out),):
        assert np.all(np.isfinite(a))


def _jax_sparse_stack_and_weights(X, init, monkeypatch):
    from enstop_tpu.ops import sell as jax_sell

    seen = []
    real = jax_sell.sell_fit

    def spy(prep, zd, wz, sample_weight=None, **kw):
        seen.append(np.asarray(sample_weight))
        return real(prep, zd, wz, sample_weight=sample_weight, **kw)

    monkeypatch.setattr(jax_sell, "sell_fit", spy)
    stack = jax_ens.ensemble_of_topics(X.astype(np.float32), K, init=init,
                                       parallelism="weights", backend="sparse", **RUN_KW)
    return stack, seen


def test_sparse_stack_and_bootstrap_weights_match_jax(corpus, monkeypatch):
    """The sparse fan-out from one explicit init: the same bootstrap weights
    (exactly) and stacks within 1e-5 max-norm relative (float32 sums in
    another order)."""
    X, init = corpus
    want, jax_weights = _jax_sparse_stack_and_weights(X, init, monkeypatch)
    calls = dict(cuda_sparse.CALLS)
    got = enstop_torch.ensemble_of_topics(X.astype(np.float32), K, init=init, device="cpu",
                                          backend="sparse", **RUN_KW)
    assert got.shape == want.shape == (4 * K, X.shape[1])
    assert _maxrel(got, want) <= 1e-5
    assert cuda_sparse.CALLS["word_pass"] - calls["word_pass"] == 4 * 20
    prepared = enstop_torch.prepare_sell(X.astype(np.float32), standardize=False, device="cpu")
    runs = list(port_ens.bootstrap_inputs(prepared, K, 4, np.random.RandomState(0), init=init,
                                          X=X))
    assert len(runs) == len(jax_weights) == 4
    for (zd, wz, w), want_w in zip(runs, jax_weights):
        assert zd.shape == (X.shape[0], K) and wz.shape == (K, X.shape[1])
        np.testing.assert_array_equal(w.numpy(), want_w)
    # init="random": made on the device at the layout's own (unpadded) shapes
    zd, wz, w = next(port_ens.bootstrap_inputs(prepared, K, 1, np.random.RandomState(0)))
    assert zd.shape == (X.shape[0], K) and wz.shape == (K, X.shape[1])
    torch.testing.assert_close(wz.sum(1), torch.ones(K))


@pytest.mark.parametrize("prepared", [False, True])
def test_sparse_estimator_matches_jax(corpus, prepared):
    """``EnsembleTopics(backend="sparse")`` (or a PreparedSell) against JAX's,
    one explicit init: the same stable topics within 1e-5 and embeddings
    within 1e-4; with a random init on each side (other random streams) the
    quality band: the same number of stable topics, each within 0.1 of a JAX
    topic (max abs), which the corpus's topics are 100 times apart."""
    X, init = corpus
    kw = dict(n_components=K, n_starts=8, n_iter=20, random_state=0,
              topic_combination="hellinger")
    ref = enstop_tpu.EnsembleTopics(backend="sparse", parallelism="weights", init=init,
                                    **kw).fit(X)
    data = (enstop_torch.prepare_sell(X.astype(np.float32), standardize=False, device="cpu")
            if prepared else X)
    port = enstop_torch.EnsembleTopics(backend="sparse", init=init, device="cpu", **kw)
    emb = port.fit_transform(data)
    assert port.n_components_ == ref.n_components_ == K
    rows, cols, gap = _matched(port.components_, ref.components_)
    assert gap <= 1e-5
    np.testing.assert_allclose(emb[:, rows], ref.embedding_[:, cols], rtol=0, atol=1e-4)
    assert (port.training_data_ is None) == prepared
    np.testing.assert_allclose(port.transform(X[:25])[:, rows], ref.transform(X[:25])[:, cols],
                               rtol=0, atol=1e-4)

    port_r = enstop_torch.EnsembleTopics(backend="sparse", device="cpu", **kw).fit(data)
    ref_r = enstop_tpu.EnsembleTopics(backend="sparse", parallelism="weights", **kw).fit(X)
    assert port_r.n_components_ == ref_r.n_components_ == K
    assert _matched(port_r.components_, ref_r.components_)[2] <= 0.1


def test_ensemble_fit_at_its_default_threshold_matches_jax(corpus):
    """``ensemble_fit``'s own ``e_step_thresh=1e-16`` with a PreparedCounts
    refits dense, as JAX does (it raised before the sparse path was ported)."""
    X, init = corpus
    kw = dict(init=init, n_starts=4, n_iter=20, random_state=0, parallelism="weights",
              topic_combination="hellinger")
    emb, topics = enstop_torch.ensemble_fit(X, K, device="cpu", **kw)
    jemb, jtopics = jax_ens.ensemble_fit(X, K, backend="xla", **kw)
    rows, cols, gap = _matched(topics, np.asarray(jtopics))
    assert gap <= 1e-6
    np.testing.assert_allclose(emb[:, rows], np.asarray(jemb)[:, cols], rtol=0, atol=1e-5)
    # with the sparse layout the refit applies the threshold exactly, as JAX's does
    emb_s, topics_s = enstop_torch.ensemble_fit(X, K, device="cpu", backend="sparse", **kw)
    jemb_s, jtopics_s = jax_ens.ensemble_fit(X, K, backend="sparse", **kw)
    rows, cols, gap = _matched(topics_s, np.asarray(jtopics_s))
    assert gap <= 1e-5
    np.testing.assert_allclose(emb_s[:, rows], np.asarray(jemb_s)[:, cols], rtol=0, atol=1e-4)


def test_resample_routes_the_threshold_to_the_sparse_path(corpus):
    X, _ = corpus
    kw = dict(n_runs=2, n_iter=10, random_state=1)
    calls = dict(cuda_sparse.CALLS)
    got = enstop_torch.ensemble_of_topics(X, K, parallelism="resample", device="cpu", **kw)
    assert cuda_sparse.CALLS["word_pass"] - calls["word_pass"] == 2 * 10
    want = jax_ens.ensemble_of_topics(X, K, parallelism="resample", **kw)
    assert _maxrel(got, want) <= 1e-5


def test_sparse_fan_out_warns_at_fast_and_rejects_sharded(corpus):
    X, _ = corpus
    with pytest.warns(UserWarning, match="fast"):
        enstop_torch.ensemble_of_topics(X, K, n_runs=1, n_iter=3, backend="sparse",
                                        precision="fast", device="cpu")
    with pytest.raises(ValueError, match="sparse"):
        enstop_torch.EnsembleTopics(backend="sparse", parallelism="sharded",
                                    device="cpu").fit(X)
    prep = enstop_torch.prepare_sell(X, standardize=False, device="cpu")
    with pytest.raises(ValueError, match="sparse"):
        port_ens.resolve_parallelism("sharded", prepared=prep)
    assert port_ens.resolve_parallelism("auto", backend="sparse") == "weights"
    with pytest.raises(ValueError, match="Prepared"):
        enstop_torch.ensemble_fit(prep, K, parallelism="resample", device="cpu")


def test_estimator_validation(corpus):
    X, _ = corpus
    m = enstop_torch.EnsembleTopics(n_components=3, n_starts=2, n_iter=5, device="cpu")
    with pytest.raises(TypeError, match="sample_weight"):
        m.fit(X, sample_weight=np.ones(X.shape[0]))
    with pytest.raises(ValueError, match="non-negative"):
        m.fit(-X.toarray())
    with pytest.raises(ValueError):
        enstop_torch.ensemble_of_topics(X, 3, parallelism="bogus", device="cpu")
    with pytest.raises(ValueError):
        enstop_torch.ensemble_fit(X, 3, e_step_thresh=1e-32, topic_combination="bogus",
                                  device="cpu")
    with pytest.raises(AttributeError):
        m.transform(X)
    params = m.get_params()
    assert params["device"] == "cpu"
    assert set(params) == set(enstop_tpu.EnsembleTopics().get_params()) | {"device"}
    assert port_ens.resolve_parallelism("auto") == "weights"
    assert port_ens.resolve_parallelism("dask") == "dask"
    dense = enstop_torch.ensemble_of_topics(sp.csr_matrix(X).toarray(), 3, n_runs=2, n_iter=5,
                                            random_state=0, device="cpu")
    sparse = enstop_torch.ensemble_of_topics(X, 3, n_runs=2, n_iter=5, random_state=0,
                                             device="cpu")
    np.testing.assert_array_equal(dense, sparse)


# the batched runs: a corpus whose group rule (PreparedCounts._run_groups)
# gives groups of 4 and 3 for 7 runs of 5 topics, and 3 groups of 3 for 9
BATCH_K = 5
BATCH_CASES = {
    "stops_apart": dict(n_runs=7, n_iter=40, n_iter_per_test=5, tolerance=1e-3),
    "no_bootstrap": dict(n_runs=7, n_iter=40, n_iter_per_test=5, tolerance=1e-3,
                         bootstrap=False),
    "host_init": dict(n_runs=7, n_iter=40, n_iter_per_test=5, tolerance=1e-3, init="nndsvd"),
    "tolerance_0_ragged": dict(n_runs=7, n_iter=13, n_iter_per_test=5, tolerance=0.0),
    "all_stop_at_1": dict(n_runs=7, n_iter=30, n_iter_per_test=3, tolerance=0.05),
    "three_groups": dict(n_runs=9, n_iter=17, n_iter_per_test=4, tolerance=1e-2),
    "one_group": dict(n_runs=2, n_iter=25, n_iter_per_test=10, tolerance=1e-3),
    "n_iter_0": dict(n_runs=7, n_iter=0, n_iter_per_test=10, tolerance=1e-3),
    "n_iter_1": dict(n_runs=7, n_iter=1, n_iter_per_test=10, tolerance=1e-3),
}


@pytest.fixture(scope="module")
def batch_corpus():
    X = sp.csr_matrix(np.random.RandomState(0).poisson(0.3, (83, 301)).astype(np.float32))
    return X, _staged(X, "auto", device="cpu", counts=True)


@pytest.mark.parametrize("case", list(BATCH_CASES))
def test_batched_runs_are_the_per_run_loops(batch_corpus, case):
    """The dense fan-out's runs in groups on the batched step against the same
    runs one after another (``_Staged._fit_runs``): the stack, each run's
    steps, final state, final LL and LL trace bit for bit."""
    X, prep = batch_corpus
    kw = dict(BATCH_CASES[case])
    n_runs, bootstrap, init = kw.pop("n_runs"), kw.pop("bootstrap", True), kw.pop("init", "random")
    schedule = (kw["n_iter"], kw["n_iter_per_test"], kw["tolerance"])
    steps = prep._steps("default", "")
    assert "em_batch" in steps
    groups = prep._run_groups(BATCH_K, n_runs)
    assert sum(groups) == n_runs and max(groups) - min(groups) <= 1
    if n_runs == 7:
        assert n_runs % groups[0] != 0  # the runs do not fill whole groups

    def runs():
        return port_ens.bootstrap_inputs(prep, BATCH_K, n_runs, np.random.RandomState(5),
                                         bootstrap, init, X)

    got = {i: (res.state[0].clone(), res.state[1].clone(), *res[1:])
           for i, res in prep._fit_runs(runs(), n_runs, BATCH_K, *schedule, steps)}
    want = dict(_Staged._fit_runs(prep, runs(), n_runs, BATCH_K, *schedule, steps))
    assert sorted(got) == list(range(n_runs))
    for i, res in want.items():
        zd, wz, n_steps, final_ll, trace, n_tests = got[i]
        assert torch.equal(zd, res.state[0]) and torch.equal(wz, res.state[1]), i
        assert (n_steps, final_ll, n_tests) == (res.n_steps, res.final_ll, res.n_tests), i
        np.testing.assert_array_equal(trace, res.ll_trace)
    run_steps = [want[i].n_steps for i in range(n_runs)]
    if case == "stops_apart":
        assert len(set(run_steps)) > 1  # runs retire at different tests
    stack, steps_of = port_ens._device_resident_plsa_runs(
        X, BATCH_K, n_runs, np.random.RandomState(5), bootstrap, init, *schedule,
        prepared=prep, device="cpu")
    assert steps_of == run_steps
    assert torch.equal(stack, torch.cat([want[i].state[1][:BATCH_K, :X.shape[1]]
                                         for i in range(n_runs)]))


@pytest.mark.parametrize("route", ["dense", "sparse", "fast", "sharded"])
def test_batched_run_steps_count_the_batched_route(batch_corpus, route):
    """``batched_run_steps`` is each run's steps less its folded test steps
    (step 1 and each step after a test point it went past) on the dense
    fp32 route, and 0 on the sparse layout, at ``"fast"`` and on the
    runs-sharded fan-out, which fit one run after another."""
    X, _ = batch_corpus
    npt = 4
    kw = {"sparse": dict(backend="sparse"), "fast": dict(precision="fast"),
          "sharded": dict(parallelism="sharded")}.get(route, {})
    model = enstop_torch.EnsembleTopics(n_components=3, n_starts=5, n_iter=30,
                                        n_iter_per_test=npt, random_state=0, device="cpu",
                                        **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "sharded" on one device warns
        model.fit(X)
    counters = model.fit_info_["trace"]["counters"]
    steps = model.fit_info_["run_steps"]
    assert counters["em_steps"] == sum(steps)
    folded = sum(1 + len(range(1, n, npt)) for n in steps)
    want = sum(steps) - folded if route == "dense" else 0
    assert counters.get("batched_run_steps", 0) == want
    if route == "dense":
        assert want > 0
