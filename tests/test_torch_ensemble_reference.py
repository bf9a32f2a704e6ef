"""``EnsembleTopics`` against the plain reference, stage by stage, on the CPU.

``plain_ensemble.py`` is a byte-identical copy of the benchmark's
``benchmark/reference/ensemble.py`` (plain PyTorch and NumPy; it imports no
JAX and nothing of either package). At a small seeded size (400 x 700,
k = 5, 16 starts), dense (``backend="auto"``) and sparse, each stage of one
fit is held to it, on the program's own inputs to that stage:

* runs: run ``i``'s topics (``topic_stack_`` rows ``i*k..(i+1)*k``) against
  the reference's float64 run from the same weights and init, and its steps;
* distances: the port's Hellinger matrix of the stack against float64;
* labels: the reference's HDBSCAN on the port's layout gives the port's
  labels, topic for topic;
* merge and ``n_components_``: the reference's merge of the stack by its own
  labels against ``components_``;
* refit: the reference's refit against ``components_`` against
  ``embedding_``.

Each planted fault (a shuffled layout, labels off by one merge, a plain
mean, a refit against the stack's first topics) is judged not correct. The
tolerances are float32 against float64 at this size: the sound fits read
1e-7 to 1e-6 (runs, merge, refit) and exactly 0 (steps, labels, counts).
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import plain_ensemble as ref
from enstop_torch import EnsembleTopics, plsa_refit
from enstop_torch.cluster.distances import all_pairs_hellinger_distance
from enstop_torch.synthetic import synthetic_corpus

ROOT = Path(__file__).resolve().parents[1]
K, SEED = 5, 11
SCHEDULE = (80, 10, 1e-3)  # the estimator's n_iter, n_iter_per_test, tolerance
PAD = {"auto": ref.DENSE_PAD, "sparse": ref.NO_PAD}
BACKENDS = ("auto", "sparse")
RUN_L1 = 1e-4        # widest row of a run's topics; sound runs read < 2e-6
HELLINGER_SQ = 1e-5  # squared distance; float32 Gram products of normalised rows
TRUST = 0.85         # the layout's trustworthiness (k = 10); sound layouts read > 0.9
MERGE_L1 = 1e-5      # widest stable topic; sound merges read ~1e-7
REFIT_L1 = 1e-4      # widest document; sound refits read < 1e-6


def _row_l1_max(a, b):
    a, b = (torch.as_tensor(np.asarray(x, dtype=np.float64)) for x in (a, b))
    return float((a - b).abs().sum(1).max()) if a.shape == b.shape else float("inf")


@pytest.fixture(scope="module")
def corpus():
    X, _ = synthetic_corpus(n_docs=400, n_words=700, n_topics=K, tokens_per_doc=60,
                            doc_topic_alpha=0.1, seed=4)
    return X


@pytest.fixture(scope="module")
def fitted(corpus):
    return {b: EnsembleTopics(n_components=K, random_state=SEED, backend=b,
                              device="cpu").fit(corpus) for b in BACKENDS}


def _reference_clusters(model):
    return ref.clusters_of(model.topic_layout_, model.min_samples, model.min_cluster_size)


def _gaps(X, model, backend, runs=(0, 9, 15)):
    """The judged numbers of one fit."""
    gaps = {"run_l1": 0.0, "steps_gap": 0}
    for i in runs:
        cands = ref.run(X, K, SEED, i, *SCHEDULE, "cpu", PAD[backend])
        steps = model.fit_info_["run_steps"][i]
        same = [c for c in cands if c.n_steps == steps] or cands[-1:]
        wz = model.topic_stack_[i * K:(i + 1) * K]
        gaps["run_l1"] = max(gaps["run_l1"], min(_row_l1_max(wz, c.wz) for c in same))
        gaps["steps_gap"] = max(gaps["steps_gap"], min(abs(c.n_steps - steps) for c in cands))
    dmat = ref.hellinger(model.topic_stack_)
    gaps["trust"] = ref.trustworthiness(dmat, model.topic_layout_)
    labels, strengths = _reference_clusters(model)
    gaps["mismatch"], pairs = ref.match(model.topic_labels_, labels)
    merged = ref.merge(model.topic_stack_, labels, strengths)
    gaps["n_gap"] = abs(model.n_components_ - merged.shape[0])
    order = [r for p in range(model.n_components_) for r, q in pairs.items() if q == p]
    gaps["merge_l1"] = (_row_l1_max(model.components_, merged[order])
                        if len(order) == merged.shape[0] else float("inf"))
    cands = ref.refit(X, model.components_, SEED, "cpu")
    gaps["refit_l1"] = min(_row_l1_max(model.embedding_, c.zd) for c in cands)
    return gaps


def _correct(g):
    return (g["run_l1"] <= RUN_L1 and g["steps_gap"] == 0 and g["trust"] >= TRUST
            and g["mismatch"] == 0 and g["n_gap"] == 0 and g["merge_l1"] <= MERGE_L1
            and g["refit_l1"] <= REFIT_L1)


@pytest.fixture(scope="module")
def sound(corpus, fitted):
    return {b: _gaps(corpus, fitted[b], b) for b in BACKENDS}


@pytest.mark.parametrize("backend", BACKENDS)
def test_runs_match_the_reference(sound, fitted, backend):
    assert sound[backend]["steps_gap"] == 0
    assert sound[backend]["run_l1"] <= RUN_L1
    steps = fitted[backend].fit_info_["run_steps"]
    assert len(steps) == 16 and fitted[backend].topic_stack_.shape == (16 * K, 700)


@pytest.mark.parametrize("backend", BACKENDS)
def test_distances_match_the_reference(fitted, backend):
    stack = fitted[backend].topic_stack_
    got = all_pairs_hellinger_distance(stack, device="cpu")
    want = ref.hellinger(stack)
    assert float(np.abs(got ** 2 - want ** 2).max()) <= HELLINGER_SQ


@pytest.mark.parametrize("backend", BACKENDS)
def test_the_reference_hdbscan_gives_the_ports_labels(sound, fitted, backend):
    labels, _ = _reference_clusters(fitted[backend])
    np.testing.assert_array_equal(labels, fitted[backend].topic_labels_)
    assert sound[backend]["mismatch"] == 0
    assert sound[backend]["trust"] >= TRUST


@pytest.mark.parametrize("backend", BACKENDS)
def test_the_merge_matches_the_reference(sound, backend):
    assert sound[backend]["merge_l1"] <= MERGE_L1


@pytest.mark.parametrize("backend", BACKENDS)
def test_n_components_matches_the_reference(sound, fitted, backend):
    assert sound[backend]["n_gap"] == 0
    assert fitted[backend].n_components_ == int(fitted[backend].topic_labels_.max()) + 1


@pytest.mark.parametrize("backend", BACKENDS)
def test_the_refit_matches_the_reference(sound, backend):
    assert sound[backend]["refit_l1"] <= REFIT_L1


def _shuffled_layout(X, model, backend):
    model.topic_layout_ = model.topic_layout_[np.random.RandomState(0).permutation(
        model.topic_layout_.shape[0])]


def _labels_off_by_one_merge(X, model, backend):
    model.topic_labels_ = np.where(model.topic_labels_ >= 1, model.topic_labels_ - 1,
                                   model.topic_labels_)


def _plain_mean(X, model, backend):
    labels, strengths = _reference_clusters(model)
    T = np.asarray(model.topic_stack_, dtype=np.float64)
    plain = np.stack([np.average(T[labels == c], axis=0, weights=strengths[labels == c])
                      for c in range(int(labels.max()) + 1)])
    model.components_ = (plain / plain.sum(1, keepdims=True)).astype(np.float32)


def _refit_on_first_topics(X, model, backend):
    first = model.topic_stack_[:model.n_components_].numpy()
    model.embedding_ = plsa_refit(X.astype(np.float32), first, random_state=SEED,
                                  backend="sparse" if backend == "sparse" else "auto",
                                  device="cpu")


@pytest.mark.parametrize("fault", [_shuffled_layout, _labels_off_by_one_merge, _plain_mean,
                                   _refit_on_first_topics])
@pytest.mark.parametrize("backend", BACKENDS)
def test_a_planted_fault_is_not_correct(corpus, fitted, sound, backend, fault):
    assert _correct(sound[backend])
    model = EnsembleTopics(n_components=K)
    model.__dict__.update(fitted[backend].__dict__)
    fault(corpus, model, backend)
    assert not _correct(_gaps(corpus, model, backend, runs=(0,)))


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    return names


def test_the_reference_is_the_benchmarks_and_stands_alone():
    here = Path(__file__).resolve().parent / "plain_ensemble.py"
    bench = ROOT / "benchmark" / "reference" / "ensemble.py"
    assert here.read_bytes() == bench.read_bytes()
    for path in (here, bench):
        assert not _imports(path) & {"jax", "jaxlib", "enstop_tpu", "enstop_torch", "enstop"}
        assert _imports(path) <= {"__future__", "typing", "numpy", "torch"}
