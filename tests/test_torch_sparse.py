"""The port's sparse O(nnz) path against the JAX package on the CPU.

The same numpy corpus and factors go through the port's plain passes
(``enstop_torch.ops.sell`` over ``cuda_sparse``'s plain versions, and the
``coo`` oracle) and through the JAX package's ``coo`` oracle, its XLA SELL
path and its Pallas chunk kernels in interpret mode. Tolerances:

* one step, refit or LL: the JAX package's own (``tests/test_sell.py``):
  factors rtol 2e-5 / atol 1e-7, the log-likelihood rtol 1e-5 (float32 sums
  in another order);
* a multi-step ``sell_fit``: the same ``n_steps`` and number of tests, the LL
  trace rtol 1e-5, factors rtol 5e-4 / atol 1e-6 (the JAX package's
  multi-step tolerance, ``tests/test_sell.py``);
* the dense EM step's A from the word pass against the matmul form: rtol
  1e-5 in fp32; in the bf16r mode 1e-3 of the largest entry (S summed in
  another order can flip the bf16 rounding of a ratio, which moves one term by
  2^-8).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from enstop_torch.ops import coo as port_coo
from enstop_torch.ops import cuda_em, cuda_sparse
from enstop_torch.ops import em as port_em
from enstop_torch.ops import sell as port_sell
from enstop_tpu.ops import coo as jax_coo
from enstop_tpu.ops import pallas_sell as jax_ps
from enstop_tpu.ops import sell as jax_sell

torch.set_num_threads(1)

STEP_TOL = dict(rtol=2e-5, atol=1e-7)
TRAJECTORY_TOL = dict(rtol=5e-4, atol=1e-6)
THRESHOLDS = [None, 1e-16, 1e-3, 3e-2]


def _setup(seed=0, n=37, m=53, k=5, density=0.15, weighted=False):
    """As the JAX package's ``tests/test_sell.py`` makes its inputs."""
    rng = np.random.RandomState(seed)
    X = sp.random(n, m, density=density, random_state=rng, format="csr")
    X.data = np.ceil(X.data * 5).astype(np.float32)
    for i in np.flatnonzero(np.diff(X.indptr) == 0):
        X[i, rng.randint(m)] = 1.0
    X = sp.csr_matrix(X)
    zd = rng.rand(n, k).astype(np.float32)
    zd /= zd.sum(1, keepdims=True)
    wz = rng.rand(k, m).astype(np.float32)
    wz /= wz.sum(1, keepdims=True)
    w = (rng.rand(n).astype(np.float32) * 2 + 0.1) if weighted else None
    return X, zd, wz, w


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _coo(X):
    c = X.tocoo()
    return c.row.astype(np.int64), c.col.astype(np.int64), c.data.astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def _chunks(X):
    ch = jax_ps.pack_chunks(X, bd=32, bw=64, chunk=128)
    return jax_ps.device_chunks(ch), dict(bd=32, bw=64, n_pad=ch.n_pad, m_pad=ch.m_pad)


@pytest.mark.parametrize("thresh", THRESHOLDS, ids=["off", "1e-16", "1e-3", "3e-2"])
@pytest.mark.parametrize("weighted", [False, True])
def test_em_step_matches_jax(thresh, weighted):
    X, zd, wz, w = _setup(seed=3, weighted=weighted)
    prep = port_sell.prepare_sell(X, standardize=False, device="cpu")
    calls = dict(cuda_sparse.CALLS)
    got = port_sell.em_step_sell(prep, _t(zd), _t(wz), w=_t(w), thresh=thresh)
    assert cuda_sparse.CALLS["word_pass"] == calls["word_pass"] + 1
    assert cuda_sparse.CALLS["doc_pass"] == calls["doc_pass"] + 1

    rows, cols, vals = _coo(X)
    p_thresh = 1e-32 if thresh is None else thresh
    wants = {
        "coo": jax_coo.em_step_coo(_j(rows), _j(cols), _j(vals), _j(zd), _j(wz), *X.shape,
                                   sample_weight=_j(w), probability_threshold=p_thresh),
        "sell": jax_sell.em_step_sell(jax_sell.prepare_sell(X, standardize=False).dev,
                                      _j(zd), _j(wz), w=_j(w), thresh=thresh),
        "port coo": port_coo.em_step_coo(_t(rows), _t(cols), _t(vals), _t(zd), _t(wz),
                                         *X.shape, sample_weight=_t(w),
                                         probability_threshold=p_thresh),
    }
    dev, kw = _chunks(X)
    wants["chunks"] = jax_ps.em_step_chunks(dev, _j(zd), _j(wz), w=_j(w), thresh=thresh, **kw)
    for name, (zd1, wz1, ll1) in wants.items():
        _close(got[0], zd1, err_msg=name, **STEP_TOL)
        _close(got[1], wz1, err_msg=name, **STEP_TOL)
        _close(float(got[2]), float(ll1), rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("thresh", THRESHOLDS, ids=["off", "1e-16", "1e-3", "3e-2"])
def test_refit_and_ll_match_jax(thresh):
    X, zd, wz, w = _setup(seed=11, weighted=True)
    prep = port_sell.prepare_sell(X, standardize=False, device="cpu")
    zd2, ll2 = port_sell.refit_step_sell(prep, _t(zd), _t(wz), w=_t(w), thresh=thresh)
    jdev = jax_sell.prepare_sell(X, standardize=False).dev
    zd1, ll1 = jax_sell.refit_step_sell(jdev, _j(zd), _j(wz), w=_j(w), thresh=thresh)
    dev, kw = _chunks(X)
    zd3, ll3 = jax_ps.refit_step_chunks(dev, _j(zd), _j(wz), w=_j(w), thresh=thresh, **kw)
    for want_zd, want_ll in ((zd1, ll1), (zd3, ll3)):
        _close(zd2, want_zd, **STEP_TOL)
        _close(float(ll2), float(want_ll), rtol=1e-5)
    _, ll_off = port_sell.refit_step_sell(prep, _t(zd), _t(wz), w=_t(w), thresh=thresh,
                                          compute_ll=False)
    assert float(ll_off) == 0.0
    # the LL is never thresholded
    ll = port_sell.log_likelihood_sell(prep, _t(zd), _t(wz), w=_t(w))
    rows, cols, vals = _coo(X)
    _close(float(ll), float(jax_coo.log_likelihood_coo(_j(rows), _j(cols), _j(vals), _j(zd),
                                                       _j(wz), _j(w))), rtol=1e-5)
    _close(float(ll), float(jax_ps.log_likelihood_chunks(dev, _j(zd), _j(wz), w=_j(w), **kw)),
           rtol=1e-5)


def test_threshold_fires_and_changes_the_step():
    X, zd, wz, w = _setup(seed=5, weighted=True)
    prep = port_sell.prepare_sell(X, standardize=False, device="cpu")
    off = port_sell.em_step_sell(prep, _t(zd), _t(wz), w=_t(w))
    tiny = port_sell.em_step_sell(prep, _t(zd), _t(wz), w=_t(w), thresh=1e-16)
    big = port_sell.em_step_sell(prep, _t(zd), _t(wz), w=_t(w), thresh=3e-2)
    _close(tiny[1], off[1], **STEP_TOL)  # 1e-16 drops nothing at these values
    assert float((big[1] - off[1]).abs().max()) > 1e-3
    assert float(big[2]) == pytest.approx(float(off[2]), rel=1e-6)  # the LL is unmasked


def test_layout_with_empty_rows_columns_and_a_long_column():
    rng = np.random.RandomState(2)
    n, m = 300, 20
    dense = (rng.rand(n, m) < 0.1) * rng.randint(1, 5, (n, m))
    dense[:, 0] = rng.randint(1, 4, n)  # one word in every document: 3 segments
    dense[7] = 0                        # an empty document
    dense[:, 11] = 0                    # an empty word
    X = sp.csr_matrix(dense.astype(np.float32))
    prep = port_sell.prepare_sell(X, standardize=False, device="cpu")
    assert prep.shape == (n, m) and prep.nnz == X.nnz and prep.backend == "sparse"
    L = cuda_sparse.SEG_LEN
    for side, want in ((prep.doc, dense), (prep.word, dense.T)):
        lengths = side.seg_ptr.diff().numpy()
        assert np.all((lengths > 0) & (lengths <= L))
        assert np.all(np.diff(side.seg_owner.numpy()) >= 0)
        per_owner = side.owner_seg_ptr.diff().numpy()
        np.testing.assert_array_equal(per_owner, -(-np.count_nonzero(want, axis=1) // L))
        recon = np.zeros_like(want, dtype=np.float32)
        recon[side.owners().numpy(), side.idx.numpy()] = side.vals.numpy()
        np.testing.assert_array_equal(recon, want)
    assert int(prep.word.owner_seg_ptr[1] - prep.word.owner_seg_ptr[0]) == -(-n // L) == 3

    zd = rng.rand(n, 4).astype(np.float32)
    wz = rng.rand(4, m).astype(np.float32)
    zd /= zd.sum(1, keepdims=True)
    wz /= wz.sum(1, keepdims=True)
    rows, cols, vals = _coo(X)
    for thresh in (None, 1e-3):
        got = port_sell.em_step_sell(prep, _t(zd), _t(wz), thresh=thresh)
        want = jax_coo.em_step_coo(_j(rows), _j(cols), _j(vals), _j(zd), _j(wz), n, m,
                                   probability_threshold=thresh or 1e-32)
        for g, w_ in zip(got, want):
            _close(g, w_, **STEP_TOL)
        assert float(got[0][7].abs().sum()) == 0 and float(got[1][:, 11].abs().sum()) == 0


@pytest.mark.parametrize("thresh,tolerance", [(1e-32, 0.0), (1e-16, 0.0), (1e-3, 1e-3)])
def test_sell_fit_trajectory_matches_jax(thresh, tolerance):
    X, zd, wz, w = _setup(seed=17, n=80, m=120, k=4, density=0.1, weighted=True)
    kw = dict(sample_weight=w, n_iter=30, n_iter_per_test=5, tolerance=tolerance,
              e_step_thresh=thresh)
    prep = port_sell.prepare_sell(X, standardize=False, device="cpu")
    got = port_sell.sell_fit(prep, zd, wz, **kw)
    want = jax_sell.sell_fit(jax_sell.prepare_sell(X, standardize=False), zd, wz, **kw)
    assert got[2] == int(want[2]) and got[5] == int(want[5])
    if tolerance:
        assert got[2] < 30  # converged before n_iter
    _close(got[4][:got[5]], np.asarray(want[4])[:got[5]], rtol=1e-5)
    _close(got[3], float(want[3]), rtol=1e-5)
    _close(got[0], want[0], **TRAJECTORY_TOL)
    _close(got[1], want[1], **TRAJECTORY_TOL)

    refit = port_sell.sell_refit(prep, zd, got[1], **kw)
    want_refit = jax_sell.sell_refit(jax_sell.prepare_sell(X, standardize=False), zd,
                                     np.asarray(got[1]), **kw)
    assert refit[2] == int(want_refit[2])
    _close(refit[0], want_refit[0], **TRAJECTORY_TOL)
    np.testing.assert_array_equal(refit[1].numpy(), got[1].numpy())


def test_prepare_sell_standardizes_and_checks_kind():
    X, _, _, _ = _setup(seed=1)
    Xf = X.astype(np.float64)
    prep = port_sell.prepare_sell(Xf, device="cpu")  # float input is l1-normalised
    np.testing.assert_allclose(
        np.bincount(prep.doc.owners().numpy(), weights=prep.doc.vals.numpy()), 1.0,
        rtol=1e-6)
    for kind in port_sell.KINDS:
        p = port_sell.prepare_sell(X, standardize=False, kind=kind, device="cpu")
        assert torch.equal(p.word.idx, prep.word.idx)
    with pytest.raises(ValueError, match="kind"):
        port_sell.prepare_sell(X, kind="tiles", device="cpu")
    with pytest.raises(ValueError):
        port_sell.sell_fit(prep, np.ones((3, 2)), np.ones((2, X.shape[1])))


@pytest.mark.parametrize("bf16r", [False, True])
def test_word_pass_gives_the_dense_steps_A(bf16r):
    """The dense EM step on the card sums A with the word pass over the
    word-major nonzeros of the padded X; its plain version agrees with the
    matmul form of A (fp32, and the bf16r rounding of precision="fast")."""
    rng = np.random.default_rng(4)
    X = np.zeros((208, 768), np.float32)
    X[:203, :650] = (rng.random((203, 650)) < 0.03) * rng.integers(1, 6, (203, 650))
    zd = np.zeros((208, 24), np.float32)
    zd[:203, :20] = rng.random((203, 20)) + 0.01
    zd /= np.maximum(zd.sum(1, keepdims=True), 1e-30)
    wz = np.zeros((24, 768), np.float32)
    wz[:20, :650] = rng.random((20, 650)) + 0.01
    wz /= np.maximum(wz.sum(1, keepdims=True), 1e-30)
    w = rng.uniform(0.5, 1.5, 208).astype(np.float32)
    Xt = torch.from_numpy(X).to(torch.bfloat16)
    word = cuda_em.word_side_of(Xt)
    assert word.n_owner == 768 and word.n_index == 208 and word.nnz == np.count_nonzero(X)
    AT, _ = cuda_sparse.word_pass(word, _t(zd), _t(wz).t().contiguous(), _t(w), bf16r=bf16r)
    plain = port_em.em_accumulators_bf16r if bf16r else port_em.em_accumulators_dense
    A = plain(Xt, _t(zd), _t(wz), _t(w))[0]
    err = float((AT.t() - A).abs().max() / A.abs().max())
    assert err <= (1e-3 if bf16r else 1e-5), err
