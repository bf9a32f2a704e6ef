"""The CUDA EM kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU and nvcc; skipped without one. Run on the card with
``python -m pytest tests/test_torch_kernels.py -q --noconftest`` (the suite's
conftest sets up JAX, which these tests do not use). Small shapes, ragged
before padding and spanning several blocks of rows. Tolerances: rtol 1e-4
on A, B and the factors (the kernel reduces A with atomics, in another order
than the plain matmul), rtol 1e-5 on the log-likelihood. The bf16r modes of
``precision="fast"`` hold A to 1e-4 and B to 1e-3 of their largest entry (S
summed in another order can flip the bf16 rounding of a ratio, which moves one
term of B by 2^-8), and each lies at least 4 times nearer its bf16r plain
version than the fp32 plain accumulators, so a kernel that skips the
roundings fails.
"""

import numpy as np
import pytest
import torch

import enstop_torch
from enstop_torch.ops import cuda_em
from enstop_torch.ops import em as port_em

pytestmark = pytest.mark.cuda

BF16R_A_RTOL, BF16R_B_RTOL = 1e-4, 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _problem(device, dtype, weighted, n=203, m=650, k=20, seed=0):
    rng = np.random.default_rng(seed)
    n_pad, m_pad, kp = -(-n // 8) * 8, -(-m // 128) * 128, -(-k // 8) * 8
    X = np.zeros((n_pad, m_pad), np.float32)
    X[:n, :m] = (rng.random((n, m)) < 0.03) * rng.integers(1, 6, (n, m))
    zd = np.zeros((n_pad, kp), np.float32)
    zd[:n, :k] = rng.random((n, k)) + 0.01
    zd /= np.maximum(zd.sum(1, keepdims=True), 1e-30)
    wz = np.zeros((kp, m_pad), np.float32)
    wz[:k, :m] = rng.random((k, m)) + 0.01
    wz /= np.maximum(wz.sum(1, keepdims=True), 1e-30)
    w = rng.uniform(0.5, 1.5, n_pad).astype(np.float32) if weighted else None
    to = lambda a: None if a is None else torch.from_numpy(a).to(device)  # noqa: E731
    return to(X).to(dtype), to(zd), to(wz), to(w)


def _close(got, want, rtol):
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=rtol * float(want.abs().max()))


def _max_rel(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("compute_ll", [False, True])
def test_em_kernel_matches_plain(cuda, dtype, weighted, compute_ll):
    X, zd, wz, w = _problem(cuda, dtype, weighted)
    before = cuda_em.LAUNCHES["em"]
    A, B, ll = cuda_em.em_accumulators_fused(X, zd, wz, w, compute_ll=compute_ll)
    torch.cuda.synchronize()
    assert cuda_em.LAUNCHES["em"] == before + 1
    A0, B0, ll0 = port_em.em_accumulators_dense(X, zd, wz, w)
    _close(A, A0, 1e-4)
    _close(B, B0, 1e-4)
    if compute_ll:
        _close(ll, ll0, 1e-5)
    else:
        assert float(ll) == 0.0


@pytest.mark.parametrize("k", [3, 40, 130])
def test_kernel_topic_widths(cuda, k):
    X, zd, wz, w = _problem(cuda, torch.bfloat16, True, n=50, m=300, k=k, seed=k)
    for got, want in zip(cuda_em.em_accumulators_fused(X, zd, wz, w),
                         port_em.em_accumulators_dense(X, zd, wz, w)):
        _close(got, want, 1e-4)


@pytest.mark.parametrize("compute_ll", [False, True])
def test_refit_and_ll_kernels_match_plain(cuda, compute_ll):
    X, zd, wz, w = _problem(cuda, torch.bfloat16, True, seed=1)
    before = cuda_em.LAUNCHES["refit"]
    B, _ = cuda_em.refit_accumulators_fused(X, zd, wz, w, compute_ll=compute_ll)
    assert cuda_em.LAUNCHES["refit"] == before + 1
    _close(B, port_em.refit_accumulators_dense(X, zd, wz, w)[0], 1e-4)
    zr, llr = cuda_em.refit_step_fused(X, zd, wz, w, compute_ll=compute_ll)
    zr0, llr0 = port_em.refit_step_dense(X, zd, wz, w)
    _close(zr, zr0, 1e-4)
    if compute_ll:
        _close(llr, llr0, 1e-5)
    _close(cuda_em.log_likelihood_fused(X, zd, wz, w),
           port_em.log_likelihood_dense(X, zd, wz, w), 1e-5)
    torch.cuda.synchronize()


def test_kernel_rejects_bad_input(cuda):
    X, zd, wz, _ = _problem(cuda, torch.float32, False)
    with pytest.raises(TypeError):
        cuda_em.em_accumulators_fused(X.double(), zd, wz)
    with pytest.raises(ValueError):
        cuda_em.em_accumulators_fused(X[:, :-3], zd, wz[:, :-3])
    with pytest.raises(ValueError):
        cuda_em.em_accumulators_fused(X, zd.cpu(), wz)


def test_plsa_on_cuda_matches_cpu(cuda):
    from enstop_torch.synthetic import synthetic_corpus

    X, _ = synthetic_corpus(n_docs=300, n_words=700, n_topics=8, seed=2)
    before = dict(cuda_em.LAUNCHES)
    gpu = enstop_torch.PLSA(n_components=8, n_iter=30, tolerance=0, random_state=0).fit(X)
    cpu = enstop_torch.PLSA(n_components=8, n_iter=30, tolerance=0, random_state=0,
                            device="cpu").fit(X)
    assert cuda_em.LAUNCHES["em"] - before["em"] == 30  # the test LLs fold into steps
    assert gpu.n_iter_ == cpu.n_iter_ == 30
    np.testing.assert_allclose(gpu.history_, cpu.history_, rtol=1e-5)
    np.testing.assert_allclose(gpu.components_, cpu.components_, rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(gpu.transform(X[:50]), cpu.transform(X[:50]),
                               rtol=1e-3, atol=1e-5)
    assert cuda_em.LAUNCHES["refit"] > before["refit"]
    assert cuda_em.LAUNCHES["ll"] > before["ll"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("compute_ll", [False, True])
def test_bf16r_kernels_match_plain(cuda, dtype, weighted, compute_ll):
    X, zd, wz, w = _problem(cuda, dtype, weighted, seed=2)
    before = dict(cuda_em.LAUNCHES)
    A, B, ll = cuda_em.em_accumulators_fused(X, zd, wz, w, compute_ll=compute_ll,
                                             precision="fast")
    Br, llr = cuda_em.refit_accumulators_fused(X, zd, wz, w, compute_ll=compute_ll,
                                               precision="fast")
    torch.cuda.synchronize()
    assert cuda_em.LAUNCHES["em_bf16r"] == before["em_bf16r"] + 1
    assert cuda_em.LAUNCHES["refit_bf16r"] == before["refit_bf16r"] + 1
    assert cuda_em.LAUNCHES["em"] == before["em"]
    A0, B0, ll0 = port_em.em_accumulators_bf16r(X, zd, wz, w)
    B0r, ll0r = port_em.refit_accumulators_bf16r(X, zd, wz, w)
    _close(A, A0, BF16R_A_RTOL)
    _close(B, B0, BF16R_B_RTOL)
    _close(Br, B0r, BF16R_B_RTOL)
    A32, B32, _ = port_em.em_accumulators_dense(X, zd, wz, w)
    B32r, _ = port_em.refit_accumulators_dense(X, zd, wz, w)
    for got, bf16r, fp32 in ((A, A0, A32), (B, B0, B32), (Br, B0r, B32r)):
        near, far = _max_rel(got, bf16r), _max_rel(got, fp32)
        assert far > 0 and far >= 4 * near, (near, far)
    if compute_ll:
        _close(ll, ll0, 1e-5)
        _close(llr, ll0r, 1e-5)
    else:
        assert float(ll) == float(llr) == 0.0


@pytest.mark.parametrize("k", [3, 40, 130])
def test_bf16r_kernel_topic_widths(cuda, k):
    X, zd, wz, w = _problem(cuda, torch.bfloat16, True, n=50, m=300, k=k, seed=k + 1)
    for got, want, rtol in zip(cuda_em.em_accumulators_fused(X, zd, wz, w, precision="fast"),
                               port_em.em_accumulators_bf16r(X, zd, wz, w),
                               (BF16R_A_RTOL, BF16R_B_RTOL, 1e-5)):
        _close(got, want, rtol)


def test_fast_plsa_and_ensemble_on_cuda(cuda):
    from enstop_torch.synthetic import synthetic_corpus

    X, _ = synthetic_corpus(n_docs=300, n_words=700, n_topics=8, seed=2)
    before = dict(cuda_em.LAUNCHES)
    gpu = enstop_torch.PLSA(n_components=8, n_iter=30, tolerance=0, random_state=0,
                            precision="fast").fit(X)
    cpu = enstop_torch.PLSA(n_components=8, n_iter=30, tolerance=0, random_state=0,
                            precision="fast", device="cpu").fit(X)
    assert cuda_em.LAUNCHES["em_bf16r"] - before["em_bf16r"] == 30
    assert cuda_em.LAUNCHES["em"] == before["em"]
    np.testing.assert_allclose(gpu.history_, cpu.history_, rtol=1e-4)
    assert np.all(np.isfinite(gpu.transform(X[:50])))
    assert cuda_em.LAUNCHES["refit_bf16r"] > before["refit_bf16r"]

    model = enstop_torch.EnsembleTopics(n_components=8, n_starts=4, n_iter=20, random_state=0,
                                        precision="fast")
    emb = model.fit_transform(X)
    assert model.n_components_ >= 2 and np.all(np.isfinite(emb))
    np.testing.assert_allclose(model.components_.sum(1), 1.0, rtol=1e-4)
    assert cuda_em.LAUNCHES["em_bf16r"] - before["em_bf16r"] == 30 + 4 * 20
