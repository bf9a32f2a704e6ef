"""``EnsembleTopics(model="nmf")`` against the benchmark's plain NMF reference
(``benchmark/reference/ensemble_nmf.py``: float64 KL multiplicative updates
in plain PyTorch, importing no JAX and nothing of either package), and the
reference against scikit-learn's, on the CPU.

At a small seeded corpus (200 x 300, k = 4, 8 starts, every other default)
one fit of the port is held to the reference, stage by stage on the
program's own inputs:

* runs: run ``i``'s topics (``topic_stack_`` rows ``i*k..(i+1)*k``) against
  the reference's float64 run from the same resample and start, 200
  updates; the widest topic's l1 gap (sound: below 1e-7);
* combine: the reference's HDBSCAN on the port's layout gives its labels,
  and the reference's merge its ``components_`` and ``n_components_``;
* embedding: ``embedding_`` against the reference's 200 updates of W
  against ``components_`` from the call's own start, each document's l1
  gap over the l1 norm of the reference's row (sound: widest below 3e-6,
  mean below 2e-7).

The reference's own updates are held to scikit-learn's
``_fit_multiplicative_update`` (KL, ``tol=0``, the same start; an anchor
that shares nothing with the port) within 1e-9 of the largest entry. Its
control, the same updates in float32 with the ratio and the products'
operands rounded to bfloat16, fails each tolerance (it reads about 1e-3 on
the runs, 2e-2 on the widest document and 2e-3 on the mean).
"""

import ast
import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from enstop_torch import EnsembleTopics
from enstop_torch.synthetic import synthetic_corpus

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
K, SEED, N_STARTS = 4, 13, 8
RUNS = (0, 3, 7)
RUN_L1 = 2e-5        # widest topic row (l1); sound runs read < 1e-7, the control > 4e-4
EMBED_MAX = 1e-4     # widest document's relative l1 gap; sound < 3e-6, the control > 5e-3
EMBED_MEAN = 1e-5    # mean document's; sound < 2e-7, the control > 5e-4
MERGE_L1 = 1e-5      # widest stable topic; float32 merge ~1e-7
SKLEARN_TOL = 1e-9   # of the largest entry: float64 against float64, 50 updates


@pytest.fixture(scope="module")
def ref():
    sys.path.insert(0, str(BENCH))
    try:
        return importlib.import_module("reference.ensemble_nmf")
    finally:
        sys.path.remove(str(BENCH))


@pytest.fixture(scope="module")
def corpus():
    X, _ = synthetic_corpus(n_docs=200, n_words=300, n_topics=K, tokens_per_doc=40,
                            doc_topic_alpha=0.1, seed=4)
    return X


@pytest.fixture(scope="module")
def fitted(corpus):
    return EnsembleTopics(n_components=K, model="nmf", n_starts=N_STARTS, random_state=SEED,
                          device="cpu").fit(corpus)


def _run_gap(ref, answer, H):
    return float((torch.as_tensor(np.asarray(answer)).double() - ref.topics(H)).abs().sum(1).max())


@pytest.fixture(scope="module")
def readings(ref, corpus, fitted):
    """The judged numbers of the port's fit and of the control in its place."""
    stack = np.asarray(fitted.topic_stack_)
    out = {}
    for mode in ("exact", "bf16r"):
        runs = {i: ref.run(corpus, K, SEED, i, "cpu", N_STARTS, mode=mode)[1] for i in RUNS}
        W = ref.embedding(corpus, fitted.components_, SEED, "cpu", mode=mode)
        out[mode] = {"runs": runs, "W": W}
    exact = out["exact"]
    port = {"run_l1": max(_run_gap(ref, stack[i * K:(i + 1) * K], exact["runs"][i])
                          for i in RUNS)}
    gaps = ref.relative_row_l1(fitted.embedding_, exact["W"])
    port.update(embed_max=float(gaps.max()), embed_mean=float(gaps.mean()))
    control = {"run_l1": max(_run_gap(ref, ref.topics(out["bf16r"]["runs"][i]),
                                      exact["runs"][i]) for i in RUNS)}
    gaps = ref.relative_row_l1(out["bf16r"]["W"], exact["W"])
    control.update(embed_max=float(gaps.max()), embed_mean=float(gaps.mean()))
    return {"port": port, "control": control}


LIMITS = {"run_l1": RUN_L1, "embed_max": EMBED_MAX, "embed_mean": EMBED_MEAN}


@pytest.mark.parametrize("name", LIMITS)
def test_the_port_matches_the_reference(readings, name):
    assert readings["port"][name] <= LIMITS[name], readings["port"]


@pytest.mark.parametrize("name", LIMITS)
def test_the_control_fails_the_tolerance(readings, name):
    assert readings["control"][name] > LIMITS[name], readings["control"]


@pytest.mark.parametrize("i", RUNS)
def test_each_run_starts_where_the_port_starts(ref, corpus, i):
    """The reference's resample and start are the port's ``nmf_topics``
    draws: one update from them gives the port's run after one update."""
    from enstop_torch.ops.nmf import nmf_fit_mu

    run_seed = ref.run_seeds(SEED, N_STARTS)[i]
    B = ref.resample(corpus.astype(np.float32), run_seed)
    rows = np.random.RandomState(run_seed).randint(0, corpus.shape[0], size=corpus.shape[0])
    assert (B != corpus[rows]).nnz == 0
    W0, H0 = ref.start(*B.shape, K, run_seed)
    W, H = ref.mu(ref.corpus_of(B, K, "cpu"), W0, H0, n_iter=1)
    Wp, Hp = nmf_fit_mu(B, K, n_iter=1, init="random", random_state=run_seed, device="cpu")
    np.testing.assert_allclose(Wp, W.numpy(), rtol=1e-5)
    np.testing.assert_allclose(Hp, H.numpy(), rtol=1e-5)


def test_the_combine_matches_the_reference(ref, fitted):
    labels, strengths = ref.clusters_of(fitted.topic_layout_, fitted.min_samples,
                                        fitted.min_cluster_size)
    np.testing.assert_array_equal(labels, fitted.topic_labels_)
    merged = ref.merge(fitted.topic_stack_, labels, strengths)
    assert merged.shape[0] == fitted.n_components_
    gaps = np.abs(np.asarray(fitted.components_, dtype=np.float64) - merged).sum(1)
    assert float(gaps.max()) <= MERGE_L1


@pytest.mark.parametrize("update_H", [True, False], ids=["both factors", "frozen topics"])
@pytest.mark.parametrize("dense", [False, True], ids=["csr", "dense"])
def test_the_reference_matches_scikit_learn(ref, corpus, update_H, dense):
    nmf = pytest.importorskip("sklearn.decomposition._nmf")
    X = corpus.astype(np.float64)
    W0, H0 = (a.astype(np.float64) for a in ref.start(*X.shape, K, 21))
    if not update_H:  # frozen topics: normalised, as the stable topics are
        H0 = H0 / H0.sum(1, keepdims=True)
    W_sk, H_sk, n_iter = nmf._fit_multiplicative_update(
        X.toarray() if dense else X, W0.copy(), H0.copy(), beta_loss="kullback-leibler",
        max_iter=50, tol=0.0, update_H=update_H)
    assert n_iter == 50
    W, H = ref.mu(ref.corpus_of(sp.csr_matrix(X), K, "cpu"), W0, H0, n_iter=50,
                  update_H=update_H)
    for got, want in ((W.numpy(), W_sk), (H.numpy(), H_sk)):
        assert float(np.abs(got - want).max()) <= SKLEARN_TOL * float(np.abs(want).max())


def test_the_nmf_call_is_traced(fitted):
    """The five NMF spans, one set a run, and the counters: runs, every run's
    200 updates, the embedding's 200."""
    trace = fitted.fit_info_["trace"]
    names = [s["name"] for s in trace["spans"]]
    for name in ("runs.resample", "runs.stage", "runs.mu"):
        assert names.count(name) == N_STARTS
    assert names.count("refit.stage") == names.count("refit.mu") == 1
    assert trace["counters"]["runs"] == N_STARTS
    assert trace["counters"]["mu_steps"] == 200 * N_STARTS
    assert trace["counters"]["refit_mu_steps"] == 200


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("." if node.level else (node.module or "").split(".")[0])
    return names


def test_the_reference_stands_alone_in_float64(ref):
    path = BENCH / "reference" / "ensemble_nmf.py"
    assert _imports(path) <= {"__future__", "numpy", "torch", "."}
    for name in ("ensemble.py", "plsa_wide.py", "plsa.py"):
        assert not _imports(BENCH / "reference" / name) & {
            "jax", "jaxlib", "enstop_tpu", "enstop_torch", "enstop"}
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    W, H = ref.mu(ref.corpus_of(sp.csr_matrix(np.eye(3)), 2, "cpu"), np.ones((3, 2)),
                  np.ones((2, 3)), n_iter=1)
    assert W.dtype == H.dtype == torch.float64
