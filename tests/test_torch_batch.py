"""The port's batched multi-run EM (``enstop_torch.ops.cuda_batch``) against
the JAX package's ``pallas_batch`` on the CPU.

The same numpy corpus, initial factors and multinomial document weights, made
as the JAX package's ``tests/test_ensemble.py`` makes them, go through JAX's
batch kernel in Pallas interpret mode and through the port's plain path
(``device="cpu"``). JAX's interpret mode takes one row block only, so the
padded corpus keeps n <= 1024. Tolerances: the raw accumulators A and B to
1e-5 of their largest entry (float32 sums in another order); a fit of a few
steps to rtol 1e-4 / atol 1e-6, the JAX test's own.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from conftest import make_corpus
from enstop_torch.ops import cuda_batch
from enstop_torch.ops import em as port_em
from enstop_tpu.ops import pallas_batch as jax_pb
from enstop_tpu.ops.data import pad_dense_counts, pad_factors, pad_vector
from enstop_tpu.ops.init import plsa_init

torch.set_num_threads(1)

ACC_RTOL = 1e-5
FIT_TOL = dict(rtol=1e-4, atol=1e-6)
N_STEPS = 6
PRECISIONS = ["default", "highest", "fast"]


def _inputs(R, k, weighted, seed=0):
    """``(Xd, zds, wzs, ws, n, m, bd, bw)`` as numpy arrays: the padded corpus,
    R initial factor pairs and R multinomial weight vectors (None when not
    ``weighted``)."""
    X = sp.csr_matrix(make_corpus(np.random.RandomState(7 + seed), n_docs=150, n_words=260,
                                  avg_doc_len=50, n_topics_true=4).astype(np.int64))
    bd, bw = jax_pb.pick_batch_block_shape(*X.shape)
    Xd, n, m = pad_dense_counts(X, row_multiple=bd, col_multiple=bw)
    rng = np.random.RandomState(seed)
    zds, wzs, ws = [], [], []
    for _ in range(R):
        zd, wz = pad_factors(*plsa_init(X, k, rng=rng), *Xd.shape)
        zds.append(zd)
        wzs.append(wz)
        ws.append(pad_vector(rng.multinomial(n, np.full(n, 1.0 / n)).astype(np.float32),
                             Xd.shape[0]))
    return (Xd, np.stack(zds), np.stack(wzs), np.stack(ws) if weighted else None, n, m, bd,
            bw)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("k", [4, 20])
@pytest.mark.parametrize("R", [1, 3])
def test_accumulators_match_jax(R, k, weighted, precision):
    Xd, zds, wzs, ws, n, _, bd, bw = _inputs(R, k, weighted)
    assert Xd.shape[0] == bd  # one row block: JAX's interpret mode takes no more
    wcol = np.ones((R, Xd.shape[0], 1), np.float32) if ws is None else ws[:, :, None]
    A_j, B_j = jax_pb._batched_accumulators(Xd, zds, wzs, wcol, bd, bw, precision_key=precision)
    calls = port_em.CALLS["batch"]
    A, B = cuda_batch.batched_accumulators(_t(Xd), _t(zds), _t(wzs), _t(ws), precision=precision)
    assert port_em.CALLS["batch"] == calls + 1
    assert A.shape == (R, zds.shape[2], Xd.shape[1]) and B.shape == zds.shape
    assert _max_rel(A, A_j) <= ACC_RTOL
    assert _max_rel(B, B_j) <= ACC_RTOL


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("k", [4, 20])
@pytest.mark.parametrize("R", [1, 3])
def test_fit_matches_jax(R, k, weighted, precision):
    Xd, zds, wzs, ws, n, m, _, _ = _inputs(R, k, weighted, seed=1)
    zf_j, wf_j = jax_pb.batched_em_fit(Xd, zds, wzs, ws, N_STEPS, precision=precision)
    zf, wf = cuda_batch.batched_em_fit(Xd, zds, wzs, ws, N_STEPS, precision=precision,
                                       device="cpu")
    np.testing.assert_allclose(zf.numpy(), np.asarray(zf_j), **FIT_TOL)
    np.testing.assert_allclose(wf.numpy(), np.asarray(wf_j), **FIT_TOL)
    # the padding stays absorbing: padded documents, words and topics stay 0
    assert not zf[:, n:].any() and not zf[:, :, k:].any()
    assert not wf[:, k:].any() and not wf[:, :, m:].any()
    np.testing.assert_allclose(wf[:, :k].sum(2).numpy(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("weighted", [False, True])
def test_plain_batched_step_is_separate_steps(weighted):
    """The plain batched step loops over the runs, so each run's factors are
    bit for bit those of the port's single-run step."""
    Xd, zds, wzs, ws, *_ = _inputs(3, 20, weighted, seed=2)
    X, zds, wzs, ws = _t(Xd), _t(zds), _t(wzs), _t(ws)
    next_zd, next_wz = cuda_batch.batched_em_step(X, zds, wzs, ws)
    for r in range(3):
        zd_r, wz_r, _ = port_em.em_step_dense(X, zds[r], wzs[r], None if ws is None else ws[r])
        assert torch.equal(next_zd[r], zd_r) and torch.equal(next_wz[r], wz_r)


def test_fit_defaults_to_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only host")
    Xd, zds, wzs, ws, *_ = _inputs(2, 4, True)
    with pytest.raises(RuntimeError, match="cuda"):
        cuda_batch.batched_em_fit(Xd, zds, wzs, ws, 2)


def test_inputs_are_checked():
    Xd, zds, wzs, ws, *_ = _inputs(2, 4, True)
    with pytest.raises(ValueError, match="precision"):
        cuda_batch.batched_accumulators(_t(Xd), _t(zds), _t(wzs), _t(ws), precision="bogus")
    with pytest.raises(ValueError, match="precision"):
        cuda_batch.batched_em_fit(Xd, zds, wzs, ws, 1, precision="bogus", device="cpu")
    # the kernel passes take CUDA tensors only, and check them before any launch
    wzT = _t(wzs).transpose(1, 2).contiguous()
    with pytest.raises(ValueError, match="runs on cpu"):
        cuda_batch.batch_rows(_t(Xd), _t(zds), wzT)
    with pytest.raises(ValueError, match="shape"):
        cuda_batch.batch_rows(_t(Xd), _t(zds), wzT[:, :-1])
    with pytest.raises(TypeError):
        cuda_batch.batch_rows(_t(Xd).double(), _t(zds), wzT)
