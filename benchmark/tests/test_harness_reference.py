"""The plain reference: one EM step against a hand computation, the
schedule's decisions, and the init and the fit against the port's CPU path."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from reference import compare, plsa as ref

X = np.array([[2, 0, 1], [0, 3, 1]], dtype=np.int64)
ZD = np.array([[0.6, 0.4], [0.3, 0.7]])
WZ = np.array([[0.5, 0.3, 0.2], [0.1, 0.6, 0.3]])


def test_one_em_step_by_hand():
    coo = ref.coo_of(sp.csr_matrix(X), "cpu")
    (zd, wz), ll = ref.em_pass(coo, torch.tensor(ZD), torch.tensor(WZ))
    S = ZD @ WZ
    A = np.zeros_like(WZ)
    B = np.zeros_like(ZD)
    want_ll = 0.0
    for d in range(2):
        for w in range(3):
            if X[d, w]:
                p = ZD[d] * WZ[:, w] / S[d, w]  # P(z|w,d)
                A[:, w] += X[d, w] * p
                B[d] += X[d, w] * p
                want_ll += X[d, w] * np.log(S[d, w])
    np.testing.assert_allclose(wz.numpy(), A / A.sum(1, keepdims=True), rtol=1e-12)
    np.testing.assert_allclose(zd.numpy(), B / B.sum(1, keepdims=True), rtol=1e-12)
    assert float(ll) == pytest.approx(want_ll, rel=1e-12)


def test_weights_enter_the_topics_and_the_likelihood_only():
    coo = ref.coo_of(sp.csr_matrix(X), "cpu")
    w = torch.tensor([2.0, 1.0], dtype=torch.float64)
    (zd_w, wz_w), ll_w = ref.em_pass(coo, torch.tensor(ZD), torch.tensor(WZ), weight=w)
    (zd, wz), ll = ref.em_pass(coo, torch.tensor(ZD), torch.tensor(WZ))
    torch.testing.assert_close(zd_w, zd)
    assert not torch.allclose(wz_w, wz)
    assert float(ll_w) != pytest.approx(float(ll))


def test_blocks_give_the_same_step(monkeypatch):
    rng = np.random.RandomState(0)
    M = sp.random(40, 30, density=0.3, random_state=rng, format="csr")
    M.data = np.ceil(M.data * 5)
    coo = ref.coo_of(M, "cpu")
    zd0, wz0 = ref.random_init(40, 30, 4, 3)
    state = (torch.tensor(zd0, dtype=torch.float64), torch.tensor(wz0, dtype=torch.float64))
    whole = ref.em_pass(coo, *state)
    monkeypatch.setattr(ref, "BLOCK", 7)
    blocked = ref.em_pass(coo, *state)
    torch.testing.assert_close(whole[0], blocked[0])
    torch.testing.assert_close(whole[1], blocked[1])


@pytest.mark.parametrize("prev,cur,tol,want", [
    (-100.0, -99.0, 1e-3, "go"),        # change 1 % of |cur|
    (-100.0, -99.99999, 1e-3, "stop"),  # 1e-7 relative
    (-100.0, -99.9, 1e-3, "either"),    # 1.001e-3: within the margin of 1e-3
    (-100.0, -100.0, 0.0, "either"),    # tolerance 0 stops only on an exact tie
    (-100.0, -99.0, 0.0, "go"),
])
def test_decisions(prev, cur, tol, want):
    assert ref._decide(prev, cur, tol) == want


def test_schedule_steps_and_candidates():
    M = sp.csr_matrix(np.random.RandomState(1).poisson(1.0, (30, 20)).astype(np.int64) + 1)
    cands = ref.fit(M, 3, 5, n_iter=23, n_iter_per_test=10, tolerance=0.0, device="cpu")
    assert cands[-1].n_steps == 23
    assert ref.fit(M, 3, 5, 0, 10, 0.0, "cpu")[-1].n_steps == 0
    early = ref.fit(M, 3, 5, n_iter=100, n_iter_per_test=10, tolerance=0.5, device="cpu")
    assert early[-1].n_steps == 1  # the first test meets a tolerance of 50 %


def test_init_and_fit_match_the_port_on_the_cpu():
    """The reference's init is the port's (the same draws), and the port's
    CPU fit lies within float32 rounding of the reference."""
    from enstop_torch import PLSA
    from enstop_torch.ops.init import plsa_init

    M = sp.csr_matrix(np.random.RandomState(2).poisson(0.7, (60, 45)).astype(np.int64))
    M = M[np.diff(M.indptr) > 0]
    zd0, wz0 = plsa_init(M, 4, rng=np.random.RandomState(9))
    rzd0, rwz0 = ref.random_init(*M.shape, 4, 9)
    np.testing.assert_array_equal(zd0, rzd0)
    np.testing.assert_array_equal(wz0, rwz0)
    model = PLSA(n_components=4, n_iter=30, tolerance=0.0, random_state=9, device="cpu").fit(M)
    gaps = compare.fit_gaps(model.embedding_, model.components_, model.n_iter_,
                            ref.fit(M, 4, 9, 30, 10, 0.0, "cpu"))
    assert gaps["steps_gap"] == 0
    assert gaps["zd_l1_max"] < 1e-4 and gaps["wz_l1_max"] < 1e-4


def test_zero_rows_come_back_as_zero_rows():
    M = sp.csr_matrix(np.array([[1, 2, 0], [0, 0, 0], [3, 0, 1]], dtype=np.int64))
    c = ref.fit(M, 2, 1, 5, 10, 0.0, "cpu")[-1]
    assert c.zd.shape == (3, 2) and float(c.zd[1].abs().sum()) == 0.0


def test_gaps():
    a = np.array([[0.5, 0.5], [1.0, 0.0]])
    b = torch.tensor([[0.5, 0.5], [0.75, 0.25]], dtype=torch.float64)
    stats = compare.row_l1_stats("x", a, b)
    assert stats["x_l1_max"] == pytest.approx(0.5) and stats["x_l1_mean"] == pytest.approx(0.25)
    assert compare.row_l1_max(a[:1], b) == float("inf")
