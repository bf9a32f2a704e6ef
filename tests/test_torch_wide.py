"""Topic counts past 256 on the sparse path, on the CPU: ``PLSA(backend="sparse")``
at k = 300 against the benchmark's plain reference for wide topic counts,
``benchmark/reference/plsa_wide.py`` (float64 sparse products; plain
PyTorch, no JAX and nothing of the port), from the same init.

At k = 300 the passes run past ``cuda_sparse.MAX_NARROW_KP``, where the card
takes the wide walk (``csrc/em_sparse_wide.cu``); here they run its plain
version, and count ``wide_passes`` as the card would. Tolerances, float32
against float64 over a 300 x 400 corpus: after 30 steps the sound fit reads
row l1 gaps of 1.3e-5 (``P(z|d)``) and 2.3e-5 (``P(w|z)``) at the widest row
and 8e-7 and 1.1e-6 in the mean, so the limits (2e-4 and 2e-5) leave about
ten times of room and lie far below the reference in bfloat16 (the cell's
control: 1e-2 in the mean); a transform reads 1.4e-7 (limit 1e-5). The
steps are exact.
"""

import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import enstop_torch
from enstop_torch.ops import cuda_em, cuda_sparse

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
K, SEED = 300, 5
SCHEDULE = (30, 10, 0.0)  # n_iter, n_iter_per_test, tolerance: every fit runs 30 steps
ROW_MAX, ROW_MEAN, TRANSFORM_MAX = 2e-4, 2e-5, 1e-5


@pytest.fixture(scope="module")
def wide_ref():
    sys.path.insert(0, str(BENCH))
    try:
        return importlib.import_module("reference.plsa_wide")
    finally:
        sys.path.remove(str(BENCH))


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.RandomState(1)
    X = (rng.rand(300, 400) < 0.08) * rng.randint(1, 5, (300, 400))
    X[7] = 0  # a zero row, set aside by both
    return sp.csr_matrix(X.astype(np.int64))


def _gaps(answer, reference):
    gaps = (torch.as_tensor(np.asarray(answer)).double() - reference.double()).abs().sum(1)
    return float(gaps.max()), float(gaps.mean())


def _fit(X, **kw):
    n_iter, npt, tol = SCHEDULE
    return enstop_torch.PLSA(n_components=K, backend="sparse", device="cpu", n_iter=n_iter,
                             n_iter_per_test=npt, tolerance=tol, random_state=SEED, **kw).fit(X)


@pytest.fixture(scope="module")
def fitted(corpus):
    return _fit(corpus)


def test_wide_fit_matches_the_reference(corpus, fitted, wide_ref):
    cands = wide_ref.fit(corpus, K, SEED, *SCHEDULE, "cpu")
    ref = cands[-1]
    assert fitted.n_iter_ == ref.n_steps == SCHEDULE[0]
    for answer, want in ((fitted.embedding_, ref.zd), (fitted.components_, ref.wz)):
        widest, mean = _gaps(answer, want)
        assert widest <= ROW_MAX and mean <= ROW_MEAN, (widest, mean)
    assert not fitted.embedding_[7].any()
    control = wide_ref.fit(corpus, K, SEED, *SCHEDULE, "cpu", mode="bf16r")[-1]
    assert _gaps(control.zd, ref.zd)[1] > 10 * ROW_MEAN  # the limits tell the control apart


def test_wide_transform_matches_the_reference(corpus, fitted, wide_ref):
    docs = corpus[:60]
    got = fitted.transform(docs)
    cands = wide_ref.refit(docs, fitted.components_, "cpu")
    assert min(_gaps(got, c.zd)[0] for c in cands) <= TRANSFORM_MAX


def test_weighted_wide_fit_matches_the_reference(corpus, wide_ref):
    """Sample weights enter the word pass and the log-likelihood alone."""
    sub = corpus[np.diff(corpus.indptr) > 0]
    w = np.random.RandomState(3).uniform(0.5, 1.5, sub.shape[0])
    n_iter, npt, tol = SCHEDULE
    zd, wz, info = enstop_torch.plsa_fit(sub, K, sample_weight=w, n_iter=n_iter,
                                         n_iter_per_test=npt, tolerance=tol, random_state=SEED,
                                         backend="sparse", device="cpu", return_info=True)
    zd0, wz0 = wide_ref.random_init(sub.shape[0], sub.shape[1], K, SEED)
    ref = wide_ref.em(wide_ref.corpus_of(sub, K, "cpu"), zd0, wz0, *SCHEDULE, weight=w)[-1]
    assert info["n_steps"] == ref.n_steps
    for answer, want in ((zd, ref.zd), (wz, ref.wz)):
        widest, mean = _gaps(answer, want)
        assert widest <= ROW_MAX and mean <= ROW_MEAN, (widest, mean)


def test_wide_passes_are_counted_past_256_topics(corpus, fitted):
    """Each pass past 256 topics counts once: two a step, the first LL and
    one LL a test point (steps 1, 11 and 21); none at 256 topics."""
    n_iter = SCHEDULE[0]
    assert fitted.fit_info_["trace"]["counters"]["wide_passes"] == 2 * n_iter + 4
    narrow = enstop_torch.PLSA(n_components=256, backend="sparse", device="cpu", n_iter=2,
                               random_state=SEED).fit(corpus)
    assert "wide_passes" not in narrow.fit_info_["trace"]["counters"]


def test_the_plain_passes_hold_past_256_topics():
    """The plain passes at wide kp, each mode, against the dense accumulators
    of the same step: no topic bound below ``MAX_KP`` on the CPU."""
    rng = np.random.default_rng(0)
    n, m, kp = 50, 70, 301
    X = (rng.random((n, m)) < 0.2) * rng.integers(1, 4, (n, m)).astype(np.float32)
    prep = enstop_torch.prepare_sell(sp.csr_matrix(X), standardize=False, device="cpu")
    zd = torch.from_numpy(rng.dirichlet(np.ones(kp), n).astype(np.float32))
    wz = torch.from_numpy(rng.dirichlet(np.ones(m), kp).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32))
    A, B, ll = enstop_torch.ops.em.em_accumulators_dense(torch.from_numpy(X), zd, wz, w)
    AT, ll_w = cuda_sparse.word_pass(prep.word, zd, wz.t().contiguous(), w)
    B_s, ll_d = cuda_sparse.doc_pass(prep.doc, zd, wz.t().contiguous(), w)
    torch.testing.assert_close(AT.t(), A, rtol=1e-5, atol=1e-5 * float(A.abs().max()))
    torch.testing.assert_close(B_s, B, rtol=1e-5, atol=1e-5 * float(B.abs().max()))
    torch.testing.assert_close(ll_w, ll, rtol=1e-5, atol=0)
    torch.testing.assert_close(ll_d, ll, rtol=1e-5, atol=0)


@pytest.mark.parametrize("kp", [257, 300, 1000, 2048])
def test_dense_and_batched_bounds_name_the_sparse_route(kp):
    """The row walk and the batched kernel stop at 256 topics and name
    ``backend="sparse"``, which takes every topic count up to 2,048."""
    with pytest.raises(ValueError, match="backend='sparse' fits up to 2048"):
        cuda_em._check_narrow(kp)
    with pytest.raises(ValueError, match="backend='sparse'"):
        cuda_em.walk_args(kp, None, cuda_em.ROW_STREAM)
    assert cuda_sparse.walk_shape(kp)[0] == 32
    cuda_em._check_narrow(256)
    with pytest.raises(ValueError, match="1..2048"):
        cuda_sparse.walk_shape(cuda_sparse.MAX_KP + 1)
