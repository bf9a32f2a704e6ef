"""The CUDA EM kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU and nvcc; skipped without one. Run on the card with
``python -m pytest tests/test_torch_kernels.py -q --noconftest`` (the suite's
conftest sets up JAX, which these tests do not use). Small shapes, ragged
before padding and spanning several blocks of rows. Tolerances: rtol 1e-4
on A, B and the factors (the kernels sum in another order than the plain
matmul), rtol 1e-5 on the log-likelihood. The sparse passes (kernels #8 and
#9) hold their accumulators to 1e-5 of the largest entry and the LL to 1e-5
relative, with the threshold off, at 1e-16 and at 1e-3. Every kernel gives
the same bits from launch to launch (nothing is summed with atomics). The bf16r modes of
``precision="fast"`` hold A to 1e-4 and B to 1e-3 of their largest entry (S
summed in another order can flip the bf16 rounding of a ratio, which moves one
term of B by 2^-8), and each lies at least 4 times nearer its bf16r plain
version than the fp32 plain accumulators, so a kernel that skips the
roundings fails. The batched kernel (#10) holds A and B to 1e-4 of the
largest entry, as the dense fp32 modes do, repeats bit for bit, and gives
each run the bits of a single-run ``em_accumulators_fused`` (the same
operations in the same order: B by the row pass, A by the sparse word pass
over a grid of runs). ``StreamedPLSA`` on the card (kernels #8 and #9 over
blocks copied from pinned host memory) repeats bit for bit, stays bit for
bit the same when every copy is held back, and agrees with its CPU run and
the resident sparse fit (history rtol 1e-5, factors rtol 1e-3 / atol 1e-5).
The NMF multiplicative updates on the card lie within 1e-3 of the largest
entry of their CPU run after 50 steps (float32 products summed in another
order).
"""

import numpy as np
import pytest
import torch

import enstop_torch
from enstop_torch.ops import cuda_batch, cuda_em, cuda_sparse
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


def _sparse_problem(device, weighted, k=20, seed=0):
    """A corpus with a column in every document (several segments), an empty
    document and an empty word, its sparse layout and factors on ``device``."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    n, m = 700, 300
    dense = (rng.random((n, m)) < 0.03) * rng.integers(1, 6, (n, m))
    dense[:, 0] = rng.integers(1, 4, n)
    dense[5] = 0
    dense[:, 9] = 0
    prep = enstop_torch.prepare_sell(sp.csr_matrix(dense.astype(np.float32)),
                                     standardize=False, device=device)
    zd = rng.random((n, k)).astype(np.float32) + 0.01
    zd /= zd.sum(1, keepdims=True)
    wzT = rng.random((m, k)).astype(np.float32) + 0.01
    wzT /= wzT.sum(0, keepdims=True)
    w = rng.uniform(0.5, 1.5, n).astype(np.float32) if weighted else None
    to = lambda a: None if a is None else torch.from_numpy(a).to(device)  # noqa: E731
    return prep, to(zd), to(wzT), to(w)


@pytest.mark.parametrize("word", [True, False], ids=["word_pass", "doc_pass"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("thresh", [None, 1e-16, 1e-3], ids=["off", "1e-16", "1e-3"])
@pytest.mark.parametrize("compute_ll", [False, True])
def test_sparse_passes_match_plain(cuda, word, weighted, thresh, compute_ll):
    prep, zd, wzT, w = _sparse_problem(cuda, weighted)
    side = prep.word if word else prep.doc
    kernel, plain = ((cuda_sparse.word_pass, cuda_sparse.word_pass_plain) if word
                     else (cuda_sparse.doc_pass, cuda_sparse.doc_pass_plain))
    key = ("word_pass" if word else "doc_pass") + ("" if thresh is None else "_thresh")
    before = cuda_em.LAUNCHES[key]
    out, ll = kernel(side, zd, wzT, w, thresh=thresh, compute_ll=compute_ll)
    again, ll_again = kernel(side, zd, wzT, w, thresh=thresh, compute_ll=compute_ll)
    torch.cuda.synchronize()
    assert cuda_em.LAUNCHES[key] == before + 2
    assert torch.equal(out, again) and torch.equal(ll, ll_again)
    out0, ll0 = plain(side, zd, wzT, w, thresh=thresh, compute_ll=True)
    _close(out, out0, 1e-5)
    if compute_ll:
        _close(ll, ll0, 1e-5)
    else:
        assert float(ll) == 0.0


def _segment_problem(device, kp, seed):
    """A square layout whose owners hold 1, E - 1, E, E + 1, 127, 128, 129,
    S - 1, S, S + 1 (two segments), 0 and 2 S + 44 (three) entries, E the
    kernel's entries a warp at ``kp`` and S the segment length, and factor
    tables of ``kp`` topics shaped like a fitted model's: one
    :class:`~.cuda_sparse.Side` serves both passes (as many owners as
    indices)."""
    rng = np.random.default_rng(seed)
    E = 32 // cuda_sparse.walk_shape(kp)[0]
    S = cuda_sparse.SEG_LEN
    counts = [1, max(E - 1, 1), E, E + 1, 127, 128, 129, S - 1, S, S + 1, 0, 2 * S + 44]
    N = 2 * S + 64
    owner = np.repeat(np.arange(len(counts)), counts)
    idx = np.concatenate([np.sort(rng.choice(N, c, replace=False)) for c in counts])
    vals = rng.integers(1, 6, owner.size).astype(np.float32)
    side = cuda_sparse.build_side(torch.from_numpy(owner).to(device),
                                  torch.from_numpy(idx).to(device),
                                  torch.from_numpy(vals).to(device), N, N)
    zd = rng.dirichlet(np.full(kp, 0.3), N).astype(np.float32)
    wzT = rng.random((N, kp)).astype(np.float32) ** 4 + 1e-4
    wzT /= wzT.sum(0, keepdims=True)
    w = rng.uniform(0.5, 1.5, N).astype(np.float32)
    return side, *(torch.from_numpy(a).to(device) for a in (zd, wzT, w))


# (word pass, threshold, bf16r): each mode the kernel has
SPARSE_MODES = {"word": (True, None, False), "word_thresh_1e-16": (True, 1e-16, False),
                "word_thresh_1e-3": (True, 1e-3, False), "word_bf16r": (True, None, True),
                "doc": (False, None, False), "doc_thresh_1e-16": (False, 1e-16, False),
                "doc_thresh_1e-3": (False, 1e-3, False)}


@pytest.mark.parametrize("k", [1, 3, 20, 24, 32, 33, 40, 104, 130, 256])
@pytest.mark.parametrize("mode", list(SPARSE_MODES))
def test_sparse_pass_topic_widths(cuda, k, mode):
    """Every mode at every lane-group shape, with segments of 1, E - 1, E,
    E + 1, 127, 128, 129 and up to SEG_LEN entries and an empty owner: held to
    the plain version at 1e-5, and bit for bit on repeat, LL on and off,
    weighted or not."""
    word, thresh, bf16r = SPARSE_MODES[mode]
    side, zd, wzT, w_all = _segment_problem(cuda, k, seed=k)
    kernel = cuda_sparse.word_pass if word else cuda_sparse.doc_pass
    plain = cuda_sparse.word_pass_plain if word else cuda_sparse.doc_pass_plain
    extra = {"bf16r": True} if bf16r else {}
    for weighted in (False, True):
        w = w_all if weighted else None
        out0, ll0 = plain(side, zd, wzT, w, thresh=thresh, **extra)
        for compute_ll in (False, True):
            out, ll = kernel(side, zd, wzT, w, thresh=thresh, compute_ll=compute_ll, **extra)
            again, ll_again = kernel(side, zd, wzT, w, thresh=thresh, compute_ll=compute_ll,
                                     **extra)
            torch.cuda.synchronize()
            assert torch.equal(out, again) and torch.equal(ll, ll_again)
            assert float(out[10].abs().sum()) == 0  # the owner with no entries
            _close(out, out0, 1e-5)
            if compute_ll:
                _close(ll, ll0, 1e-5)
            else:
                assert float(ll) == 0.0


@pytest.mark.parametrize("precision", ["default", "fast"])
def test_dense_step_is_the_same_from_launch_to_launch(cuda, precision):
    X, zd, wz, w = _problem(cuda, torch.bfloat16, True, seed=3)
    word = cuda_em.word_side_of(X)
    first = cuda_em.em_accumulators_fused(X, zd, wz, w, precision=precision, word=word)
    for _ in range(3):
        again = cuda_em.em_accumulators_fused(X, zd, wz, w, precision=precision, word=word)
        assert all(torch.equal(a, b) for a, b in zip(first, again))
    key = "word_pass_bf16r" if precision == "fast" else "word_pass"
    before = cuda_em.LAUNCHES[key]
    cuda_em.em_accumulators_fused(X, zd, wz, w, precision=precision)  # word side made from X
    assert cuda_em.LAUNCHES[key] == before + 1


def test_sparse_plsa_on_cuda_matches_cpu_and_repeats(cuda):
    from enstop_torch.synthetic import synthetic_corpus

    X, _ = synthetic_corpus(n_docs=300, n_words=700, n_topics=8, seed=2)
    kw = dict(n_components=8, n_iter=30, tolerance=0, random_state=0)
    before = dict(cuda_em.LAUNCHES)
    gpu = enstop_torch.PLSA(e_step_thresh=1e-16, **kw).fit(X)
    again = enstop_torch.PLSA(e_step_thresh=1e-16, **kw).fit(X)
    cpu = enstop_torch.PLSA(e_step_thresh=1e-16, device="cpu", **kw).fit(X)
    assert cuda_em.LAUNCHES["word_pass_thresh"] - before["word_pass_thresh"] == 60
    assert gpu.fit_info_["backend"] == "sparse"
    np.testing.assert_array_equal(gpu.components_, again.components_)
    np.testing.assert_allclose(gpu.history_, cpu.history_, rtol=1e-5)
    np.testing.assert_allclose(gpu.components_, cpu.components_, rtol=1e-3, atol=1e-5)
    dense = enstop_torch.PLSA(**kw).fit(X)
    dense_again = enstop_torch.PLSA(**kw).fit(X)
    np.testing.assert_array_equal(dense.components_, dense_again.components_)
    ens = [enstop_torch.EnsembleTopics(n_components=8, n_starts=4, n_iter=20, random_state=0,
                                       backend=backend).fit(X) for backend in ("auto", "auto",
                                                                                "sparse")]
    np.testing.assert_array_equal(ens[0].components_, ens[1].components_)
    assert ens[2].n_components_ >= 2 and np.all(np.isfinite(ens[2].components_))


def _batch_problem(device, dtype, R, k, weighted, n=203, m=650, seed=0):
    """A ragged padded X and R runs' factors and weights on ``device``."""
    rng = np.random.default_rng(seed)
    X = _problem(device, dtype, False, n=n, m=m, k=k, seed=seed)[0]
    n_pad, m_pad = X.shape
    kp = -(-k // 8) * 8
    zds = np.zeros((R, n_pad, kp), np.float32)
    zds[:, :n, :k] = rng.random((R, n, k)) + 0.01
    zds /= np.maximum(zds.sum(2, keepdims=True), 1e-30)
    wzs = np.zeros((R, kp, m_pad), np.float32)
    wzs[:, :k, :m] = rng.random((R, k, m)) + 0.01
    wzs /= np.maximum(wzs.sum(2, keepdims=True), 1e-30)
    ws = rng.uniform(0.5, 1.5, (R, n_pad)).astype(np.float32) if weighted else None
    to = lambda a: None if a is None else torch.from_numpy(a).to(device)  # noqa: E731
    return X, to(zds), to(wzs), to(ws)


# R = 1; kp > 32; a group with spare slots (R = 3, G = 4); two groups (R = 5,
# kp = 104: G = 4); R = 9 at G = 16
@pytest.mark.parametrize("R, k", [(1, 20), (3, 40), (5, 100), (9, 20)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("weighted", [False, True])
def test_batch_kernel_matches_plain_and_repeats(cuda, R, k, dtype, weighted):
    X, zds, wzs, ws = _batch_problem(cuda, dtype, R, k, weighted, seed=R)
    word = cuda_em.word_side_of(X)
    before = dict(cuda_em.LAUNCHES)
    A, B = cuda_batch.batched_accumulators(X, zds, wzs, ws, word=word)
    again = cuda_batch.batched_accumulators(X, zds, wzs, ws, word=word)
    torch.cuda.synchronize()
    assert cuda_em.LAUNCHES["batch"] == before["batch"] + 2
    assert cuda_em.LAUNCHES["batch_word"] == before["batch_word"] + 2
    assert torch.equal(A, again[0]) and torch.equal(B, again[1])
    A0, B0 = port_em.batched_accumulators_dense(X, zds, wzs, ws)
    _close(A, A0, 1e-4)
    _close(B, B0, 1e-4)


@pytest.mark.parametrize("R, k", [(3, 20), (5, 100)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_batch_runs_equal_single_runs(cuda, R, k, dtype):
    X, zds, wzs, ws = _batch_problem(cuda, dtype, R, k, True, seed=10 + R)
    word = cuda_em.word_side_of(X)
    A, B = cuda_batch.batched_accumulators(X, zds, wzs, ws, word=word)
    for r in range(R):
        A1, B1, _ = cuda_em.em_accumulators_fused(X, zds[r], wzs[r], ws[r], compute_ll=False,
                                                  word=word)
        assert torch.equal(A[r], A1) and torch.equal(B[r], B1), r


def test_batched_fit_on_cuda_matches_cpu(cuda):
    X, zds, wzs, ws = _batch_problem(cuda, torch.bfloat16, 4, 8, True, seed=4)
    before = dict(cuda_em.LAUNCHES)
    zf, wf = cuda_batch.batched_em_fit(X, zds, wzs, ws, 10)
    assert zf.device.type == "cuda"
    assert cuda_em.LAUNCHES["batch"] - before["batch"] == 10
    assert cuda_em.LAUNCHES["batch_word"] - before["batch_word"] == 10
    zc, wc = cuda_batch.batched_em_fit(X.cpu(), zds.cpu(), wzs.cpu(), ws.cpu(), 10, device="cpu")
    _close(zf.cpu(), zc, 1e-4)
    _close(wf.cpu(), wc, 1e-4)


def _walk_problem(device, dtype, kp, R=1, seed=0):
    """X (40, 1600) whose rows hold the row walk's edge cases, and R runs'
    factors of ``kp`` topics (one run: no leading axis). Row 0 is empty; row 1
    fully nonzero (1,600 entries: it overflows every queue and is walked in
    pieces); row 2 holds one nonzero, in the last 16-byte chunk; row 3 holds
    the columns on each side of every 512-, 256- and 128-column boundary (the
    windows of 1 KB of bf16 and of fp32, and of 512 B); rows 4-7 hold 300
    nonzeros (more than a 256-entry queue, fewer than 512); the rest 3 %."""
    rng = np.random.default_rng(seed)
    n, m = 40, 1600
    X = (rng.random((n, m)) < 0.03) * rng.integers(1, 6, (n, m))
    X[0] = 0
    X[1] = rng.integers(1, 4, m)
    X[2] = 0
    X[2, m - 1] = 3
    X[3] = 0
    for edge in range(128, m, 128):
        X[3, edge - 1] = X[3, edge] = 2
    for row in range(4, 8):
        X[row] = 0
        X[row, rng.choice(m, 300, replace=False)] = rng.integers(1, 6, 300)
    zd = rng.dirichlet(np.full(kp, 0.5), (R, n)).astype(np.float32)
    wz = rng.random((R, kp, m)).astype(np.float32) + 0.01
    wz /= wz.sum(2, keepdims=True)
    w = rng.uniform(0.5, 1.5, (R, n)).astype(np.float32)
    to = lambda a: torch.from_numpy(a if R > 1 else a[0]).to(device)  # noqa: E731
    return torch.from_numpy(X.astype(np.float32)).to(device).to(dtype), to(zd), to(wz), to(w)


@pytest.mark.parametrize("kp", [1, 20, 24, 33, 104, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_row_walk_edges_match_plain(cuda, kp, dtype):
    """Every mode of the dense kernel on the row walk's edge cases (an empty
    row, a fully dense row, a nonzero in the last chunk, nonzeros on window
    boundaries, rows past the queue) at every walk shape: against the plain
    versions at the tolerances above, an empty row's B exactly 0, and two
    launches bit for bit the same."""
    X, zd, wz, w = _walk_problem(cuda, dtype, kp, seed=kp)
    modes = {
        "em": (lambda: cuda_em.em_accumulators_fused(X, zd, wz, w),
               port_em.em_accumulators_dense(X, zd, wz, w), (1e-4, 1e-4, 1e-5)),
        "em_bf16r": (lambda: cuda_em.em_accumulators_fused(X, zd, wz, w, precision="fast"),
                     port_em.em_accumulators_bf16r(X, zd, wz, w),
                     (BF16R_A_RTOL, BF16R_B_RTOL, 1e-5)),
        "refit": (lambda: cuda_em.refit_accumulators_fused(X, zd, wz, w),
                  port_em.refit_accumulators_dense(X, zd, wz, w), (1e-4, 1e-5)),
        "refit_bf16r": (lambda: cuda_em.refit_accumulators_fused(X, zd, wz, w, precision="fast"),
                        port_em.refit_accumulators_bf16r(X, zd, wz, w), (BF16R_B_RTOL, 1e-5)),
        "ll": (lambda: (cuda_em.log_likelihood_fused(X, zd, wz, w),),
               (port_em.log_likelihood_dense(X, zd, wz, w),), (1e-5,)),
    }
    for name, (kernel, plain, rtols) in modes.items():
        before = cuda_em.LAUNCHES[name]
        got, again = kernel(), kernel()
        torch.cuda.synchronize()
        assert cuda_em.LAUNCHES[name] == before + 2, name
        for g, a, want, rtol in zip(got, again, plain, rtols):
            assert torch.equal(g, a), name
            _close(g, want, rtol)
        if name != "ll":
            B = got[-2]
            assert float(B[0].abs().sum()) == 0.0, name  # the empty row
            assert float(B[2].abs().sum()) > 0.0, name   # the last chunk's nonzero


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kp", [24, 104])
def test_row_walk_is_the_same_whatever_the_stream(cuda, dtype, kp):
    """The order invariant of ``csrc/row_walk.cuh``: B does not depend on the
    window size, the stage count, the queue length or the warps a block, and
    the LL (summed per block over its warps) not on the first three."""
    X, zd, wz, w = _walk_problem(cuda, dtype, kp, seed=3)
    RS = cuda_em.RowStream
    B0, ll0 = cuda_em._launch("refit", X, zd, wz, w, True, True)[:2]
    for stream in (RS(window=512, stages=2), RS(window=512, stages=5),
                   RS(window=2048, stages=8, queue=1024), RS(window=1536, stages=3),
                   RS(queue=512), RS(warps=1), RS(warps=16, stages=3), RS(warps=8)):
        B, ll = cuda_em._launch("refit", X, zd, wz, w, True, True, stream=stream)[:2]
        torch.cuda.synchronize()
        assert torch.equal(B, B0), stream
        if stream.warps == cuda_em.ROW_STREAM.warps:
            assert torch.equal(ll, ll0), stream


@pytest.mark.parametrize("R", [1, 3, 9, 16])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_batch_rows_equal_single_runs_on_row_edges(cuda, R, dtype):
    """Each batched run's B is a single run's bit for bit on the row walk's
    edge cases, with the default queue (the fully dense row is streamed again
    for each run) and with one that holds it; and within 1e-4 of the plain
    batched accumulators."""
    X, zds, wzs, ws = _walk_problem(cuda, dtype, 24, R=R, seed=R)
    if R == 1:
        zds, wzs, ws = zds[None], wzs[None], ws[None]
    wzT = wzs.transpose(1, 2).contiguous()
    B = cuda_batch.batch_rows(X, zds, wzT)
    B_big = cuda_batch.batch_rows(X, zds, wzT, stream=cuda_em.RowStream(queue=2048))
    _close(B, port_em.batched_accumulators_dense(X, zds, wzs, ws)[1], 1e-4)
    for r in range(R):
        B1, _ = cuda_em.refit_accumulators_fused(X, zds[r], wzs[r], ws[r], compute_ll=False)
        assert torch.equal(B[r], B1) and torch.equal(B_big[r], B1), r


def _streamed_corpus():
    from enstop_torch.synthetic import synthetic_corpus

    return synthetic_corpus(n_docs=300, n_words=700, n_topics=8, seed=2)[0]


STREAMED_KW = dict(n_components=8, n_iter=30, n_iter_per_test=5, tolerance=0, random_state=0)


# one block (it stays on the card), two (each slot keeps its block) and five
# (every block shipped every sweep)
@pytest.mark.parametrize("block_size", [1000, 150, 64])
def test_streamed_fit_on_cuda_matches_cpu_and_repeats(cuda, block_size):
    X = _streamed_corpus()
    kw = dict(block_size=block_size, **STREAMED_KW)
    before = dict(cuda_em.LAUNCHES)
    gpu = enstop_torch.StreamedPLSA(**kw).fit(X)
    n_blocks = gpu.fit_info_["n_blocks"]
    assert cuda_em.LAUNCHES["word_pass"] - before["word_pass"] == 30 * n_blocks
    assert cuda_em.LAUNCHES["doc_pass"] - before["doc_pass"] == 30 * n_blocks
    again = enstop_torch.StreamedPLSA(**kw).fit(X)
    for name in ("components_", "embedding_", "history_"):
        np.testing.assert_array_equal(getattr(gpu, name), getattr(again, name))
    cpu = enstop_torch.StreamedPLSA(device="cpu", **kw).fit(X)
    np.testing.assert_allclose(gpu.history_, cpu.history_, rtol=1e-5)
    np.testing.assert_allclose(gpu.components_, cpu.components_, rtol=1e-3, atol=1e-5)
    resident = enstop_torch.PLSA(backend="sparse", **STREAMED_KW).fit(X)
    np.testing.assert_allclose(gpu.history_, resident.history_, rtol=1e-5)
    np.testing.assert_allclose(gpu.transform(X[:40]), cpu.transform(X[:40]), rtol=1e-3,
                               atol=1e-4)
    if n_blocks > 2:
        assert gpu.fit_info_["bytes_shipped"] >= 30 * gpu.fit_info_["bytes_per_sweep"]


def test_streamed_fit_waits_for_a_slow_copy(cuda, monkeypatch):
    """Each copy is held back on the copy stream by a spin of about 10 ms: a
    block read before its copy lands, or a slot written while its block is
    still read, would change the numbers; the fit and the refit stay bit for
    bit the same."""
    from enstop_torch.models import streamed_core

    X = _streamed_corpus()
    kw = dict(block_size=64, **STREAMED_KW)
    base = enstop_torch.StreamedPLSA(**kw).fit(X)
    base_embedding = base.transform(X[:130])
    real = streamed_core._Streamer._ship

    def slow(self, b, s, names):
        with torch.cuda.stream(self.copy_stream):
            torch.cuda._sleep(20_000_000)
        return real(self, b, s, names)

    monkeypatch.setattr(streamed_core._Streamer, "_ship", slow)
    slowed = enstop_torch.StreamedPLSA(**kw).fit(X)
    for name in ("components_", "embedding_", "history_"):
        np.testing.assert_array_equal(getattr(slowed, name), getattr(base, name))
    np.testing.assert_array_equal(slowed.transform(X[:130]), base_embedding)


def test_nmf_on_cuda_matches_cpu(cuda):
    from enstop_torch.ops.nmf import nmf_fit_mu

    X = _streamed_corpus()
    for beta_loss in (1, 2):
        W, H = nmf_fit_mu(X, 8, beta_loss=beta_loss, n_iter=50, random_state=0)
        W0, H0 = nmf_fit_mu(X, 8, beta_loss=beta_loss, n_iter=50, random_state=0, device="cpu")
        for got, want in ((W, W0), (H, H0)):
            assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()
    model = enstop_torch.EnsembleTopics(n_components=8, model="nmf", n_starts=4,
                                        random_state=0).fit(X)
    assert model.n_components_ >= 2 and np.all(np.isfinite(model.embedding_))
    np.testing.assert_allclose(model.components_.sum(1), 1.0, rtol=1e-5)


def test_mesh_tiles_on_one_card(cuda):
    """A 2 x 2 mesh of four tiles on one card (kernels #1, #8 and the refit's
    #2 on each tile) against the same steps on the CPU's plain ops (rtol 1e-4
    on the factors, 1e-5 on the LL); a 1 x 1 mesh fit is ``PLSA``'s bit for
    bit, and a ``BlockParallelPLSA`` of four tiles repeats bit for bit."""
    import scipy.sparse as sp

    from enstop_torch.ops.data import pad_factors
    from enstop_torch.parallel import mesh as mesh_lib

    rng = np.random.default_rng(3)
    n, m, k = 203, 650, 20
    X = sp.csr_matrix((rng.random((n, m)) < 0.03) * rng.integers(1, 6, (n, m)))
    zd0, wz0 = rng.random((n, k)) + 0.01, rng.random((k, m)) + 0.01
    zd0, wz0 = zd0 / zd0.sum(1, keepdims=True), wz0 / wz0.sum(1, keepdims=True)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        mesh = mesh_lib.make_mesh(2, 2, devices=[dev] * 4)
        tiles, _, _ = mesh_lib.stage_sharded_counts(mesh, X)
        n_pad, m_pad = 2 * tiles[0][0].n, 2 * tiles[0][0].m
        zd, wz = pad_factors(zd0, wz0, n_pad, m_pad)
        w = rng.uniform(0.5, 1.5, n_pad).astype(np.float32) if dev == cuda else out["w"]
        before = dict(cuda_em.LAUNCHES)
        zds, wzs, ws = mesh_lib.shard_factors(mesh, zd, wz, w)
        next_zd, next_wz, ll = mesh_lib.build_sharded_em_step(mesh)(tiles, zds, wzs, ws)
        refit_zd, refit_ll = mesh_lib.build_sharded_refit_step(mesh)(tiles, zds, wzs)
        out.update(w=w, **{str(dev.type): (
            mesh_lib.gather_rows(mesh, next_zd), mesh_lib.gather_cols(next_wz), float(ll),
            mesh_lib.gather_rows(mesh, refit_zd), float(refit_ll))})
        launched = {key: cuda_em.LAUNCHES[key] - before[key] for key in before}
        if dev == cuda:
            assert launched["em"] == launched["word_pass"] == launched["refit"] == 4
    for got, want in zip(out["cuda"], out["cpu"]):
        np.testing.assert_allclose(got, want, rtol=1e-4 if np.ndim(want) else 1e-5,
                                   atol=1e-4 * float(np.abs(want).max()) if np.ndim(want) else 0)

    one = enstop_torch.BlockParallelPLSA(n_components=k, init=(zd0, wz0), n_iter=30).fit(X)
    flat = enstop_torch.PLSA(n_components=k, init=(zd0, wz0), n_iter=30).fit(X)
    for name in ("components_", "embedding_", "history_"):
        np.testing.assert_array_equal(getattr(one, name), getattr(flat, name))

    class FourTiles(enstop_torch.BlockParallelPLSA):
        def _devices(self):
            return [cuda] * 4

    a, b = (FourTiles(n_components=k, init=(zd0, wz0), n_row_blocks=2, n_col_blocks=2,
                      n_iter=30).fit(X) for _ in range(2))
    np.testing.assert_array_equal(a.components_, b.components_)
    np.testing.assert_array_equal(a.history_, b.history_)
    np.testing.assert_allclose(a.history_, flat.history_, rtol=1e-5)


def test_reference_inner_loops_on_the_thresholded_passes(cuda, monkeypatch):
    """``plsa_fit_inner`` and ``plsa_refit_inner`` on the card run every step
    on the thresholded word and doc passes (the reference's 1e-32 fires on
    products of small probabilities) and agree with the same loops on the
    plain passes on the card: the tested log-likelihoods to 1e-5 relative, the
    factors to 1e-4."""
    import scipy.sparse as sp

    from enstop_torch import plsa as compat
    from enstop_torch.ops import sell

    rng = np.random.default_rng(5)
    n, m, k = 203, 650, 20
    X = sp.coo_matrix((rng.random((n, m)) < 0.03) * rng.integers(1, 6, (n, m)))
    coo = (X.row, X.col, X.data.astype(np.float32))
    zd0 = rng.random((n, k)).astype(np.float32) + 0.01
    wz0 = rng.random((k, m)).astype(np.float32) + 0.01
    wz0[:, X.col[0]] = 1e-33  # every product of this word's entries falls under 1e-32
    zd0, wz0 = zd0 / zd0.sum(1, keepdims=True), wz0 / wz0.sum(1, keepdims=True)
    w = rng.uniform(0.5, 1.5, n).astype(np.float32)
    kw = dict(n_iter=30, n_iter_per_test=10, tolerance=0.0)

    def both(plain):
        lls, real = [], compat.log_likelihood_sell

        def tested(*args):
            ll = real(*args)
            lls.append(float(ll))
            return ll

        monkeypatch.setattr(compat, "log_likelihood_sell", tested)
        if plain:
            monkeypatch.setattr(sell, "word_pass", cuda_sparse.word_pass_plain)
            monkeypatch.setattr(sell, "doc_pass", cuda_sparse.doc_pass_plain)
        before = dict(cuda_sparse.LAUNCHES)
        zd, wz = compat.plsa_fit_inner(*coo, wz0.copy(), zd0.copy(), w, use_sample_weights=True,
                                       **kw)
        refit = compat.plsa_refit_inner(*coo, wz, zd0.copy(), w, **kw)
        monkeypatch.undo()
        return zd, wz, refit, lls, {key: cuda_sparse.LAUNCHES[key] - before[key]
                                    for key in before}

    *got, got_ll, launched = both(plain=False)
    *want, want_ll, _ = both(plain=True)
    assert launched["word_pass_thresh"] == 30 and launched["doc_pass_thresh"] == 60
    assert launched["word_pass"] == 0 and launched["doc_pass"] == len(got_ll) == 8
    np.testing.assert_allclose(got_ll, want_ll, rtol=1e-5)
    for g, w_ in zip(got, want):
        _close(torch.from_numpy(g), torch.from_numpy(w_), 1e-4)
    assert np.all(got[1][:, X.col[0]] == 0)  # the threshold dropped the word
