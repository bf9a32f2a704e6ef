"""``precision="fast"`` (bf16 responsibilities) in the port, against the JAX
package on the same numpy inputs.

The plain bf16r accumulators of ``enstop_torch.ops.em`` are held bit for bit
(to float32 summation order, rtol 1e-6) against a NumPy statement of the
mode: ``R = bf16(bf16(X) / bf16(max(S, 1e-30)))``, ``A = bf16(w P(z|d))^T R``,
``B = R bf16(P(w|z))^T``, the LL float32. The ``cuda_em`` wrappers, which run
that plain version on a CPU tensor, are held against
``enstop_tpu.ops.pallas_em`` at ``precision="fast"`` in Pallas interpret mode,
which reaches the ``jo_res_bf16r`` kernel: ``B``, the refit's ``P(z|d)`` and
the LL at rtol 1e-5, ``A`` at a max-norm relative error of 5e-3. ``A`` is
looser because XLA on the CPU, allowed excess precision, skips the bf16
rounding of ``R`` on the way into ``A``'s product (the TPU and this port keep
it); one bf16 rounding moves a term by at most 2^-8.

Whole fits: ``PLSA(precision="fast", device="cpu")`` against JAX
``PLSA(backend="pallas", precision="fast")`` from the same seed: ``n_iter_``
equal, ``history_`` rtol 5e-5, ``components_`` atol 1e-3, ``embedding_`` and
``transform`` atol 5e-3 (the bf16 roundings that differ between the two
sides, as above, move the factors at that level). The fast fit also keeps the
quality band of ``tests/test_fast_precision.py`` (ARI and AMI above 0.30).
"""

import warnings

import ml_dtypes
import numpy as np
import pytest
import torch
from scipy.special import gammaln

import enstop_torch
import enstop_tpu
from enstop_torch.ops import cuda_em, driver
from enstop_torch.ops import em as port_em
from enstop_torch.synthetic import synthetic_corpus
from enstop_tpu.ops import pallas_em
from test_torch_em import CASES, _jax, _problem, _torch
from test_torch_plsa import _counts

torch.set_num_threads(1)

A_MAXREL = 5e-3
RTOL = 1e-5


def _bf(a):
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16).astype(np.float64)


def _maxrel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("dtypes,weighted", CASES)
def test_plain_bf16r_is_the_stated_rounding(dtypes, weighted):
    _, tdt = dtypes
    X, zd, wz, w = _problem(5, weighted)
    Xq = X.astype(ml_dtypes.bfloat16).astype(np.float32) if tdt == torch.bfloat16 else X
    # S as torch computes it, so that only the bf16 rounding is under test
    S = np.maximum((torch.from_numpy(zd) @ torch.from_numpy(wz)).numpy(), np.float32(1e-30))
    R = _bf(_bf(Xq).astype(np.float32) / _bf(S).astype(np.float32))
    wcol = np.ones((X.shape[0], 1), np.float32) if w is None else w[:, None]
    A0 = _bf(zd * wcol).T @ R
    B0 = R @ _bf(wz).T
    ll0 = np.sum(np.where(Xq > 0, Xq * np.log(S), 0.0) * wcol)

    A, B, ll = port_em.em_accumulators_bf16r(*_torch(X, zd, wz, w, tdt))
    np.testing.assert_allclose(A.numpy(), A0, rtol=1e-6, atol=1e-6 * np.abs(A0).max())
    np.testing.assert_allclose(B.numpy(), B0, rtol=1e-6, atol=1e-6 * np.abs(B0).max())
    np.testing.assert_allclose(float(ll), ll0, rtol=1e-6)
    Br, llr = port_em.refit_accumulators_bf16r(*_torch(X, zd, wz, w, tdt))
    np.testing.assert_array_equal(Br.numpy(), B.numpy())
    assert float(llr) == float(ll)


@pytest.mark.parametrize("compute_ll", [True, False])
@pytest.mark.parametrize("dtypes,weighted", CASES)
def test_fast_wrappers_on_cpu_match_pallas_interpret(dtypes, weighted, compute_ll):
    jdt, tdt = dtypes
    prob = _problem(6, weighted)
    jx, tx = _jax(*prob, jdt), _torch(*prob, tdt)
    launches, calls = dict(cuda_em.LAUNCHES), dict(port_em.CALLS)

    A, B, ll = cuda_em.em_accumulators_fused(*tx, compute_ll=compute_ll, precision="fast")
    A0, B0, ll0 = pallas_em.em_accumulators_fused(
        jx[0], jx[1], jx[2], sample_weight=jx[3], bd=16, bw=256,
        compute_ll=compute_ll, precision="fast")
    assert _maxrel(A, A0) <= A_MAXREL
    np.testing.assert_allclose(B.numpy(), np.asarray(B0), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(float(ll), float(ll0), rtol=RTOL)

    zr, llr = cuda_em.refit_step_fused(*tx, compute_ll=compute_ll, precision="fast")
    zr0, llr0 = pallas_em.refit_step_fused(
        jx[0], jx[1], jx[2], sample_weight=jx[3], bd=16, bw=256,
        compute_ll=compute_ll, precision="fast")
    np.testing.assert_allclose(zr.numpy(), np.asarray(zr0), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(float(llr), float(llr0), rtol=RTOL)

    # the fast LL sweep is the float32 one, on both sides
    np.testing.assert_allclose(
        float(cuda_em.log_likelihood_fused(*tx, precision="fast")),
        float(pallas_em.log_likelihood_fused(jx[0], jx[1], jx[2], sample_weight=jx[3],
                                             bd=16, bw=256, precision="fast")),
        rtol=RTOL)
    # the CPU route is the plain bf16r version and launches nothing
    assert cuda_em.LAUNCHES == launches
    assert port_em.CALLS["em_bf16r"] == calls["em_bf16r"] + 1
    assert port_em.CALLS["refit_bf16r"] == calls["refit_bf16r"] + 1
    assert port_em.CALLS["em"] == calls["em"] and port_em.CALLS["refit"] == calls["refit"]


@pytest.mark.parametrize("precision", ["default", "highest", "fast"])
def test_kernel_and_plain_steps_agree_on_cpu(precision):
    """The driver's two step tables compute the same function on a CPU tensor;
    the plain one at "fast" is the bf16r version."""
    X, zd, wz, w = _torch(*_problem(7, True), torch.bfloat16)
    kernel, plain = driver.kernel_steps(precision), driver.plain_steps(precision)
    fast = precision == "fast"
    assert plain["em"] is (port_em.em_step_bf16r if fast else port_em.em_step_dense)
    assert plain["refit"] is (port_em.refit_step_bf16r if fast else port_em.refit_step_dense)
    assert plain["ll"] is port_em.log_likelihood_dense
    for name in ("em", "em_ll", "refit"):
        got, want = kernel[name](X, zd, wz, w), plain[name](X, zd, wz, w)
        for g, h in zip(got[:-1], want[:-1]):
            torch.testing.assert_close(g, h, rtol=0, atol=0)
    torch.testing.assert_close(kernel["em_ll"](X, zd, wz, w)[2], plain["em_ll"](X, zd, wz, w)[2])
    torch.testing.assert_close(kernel["ll"](X, zd, wz, w), plain["ll"](X, zd, wz, w))
    with pytest.raises(ValueError):
        driver.plain_steps("bogus")


def test_fast_plsa_matches_jax():
    X = _counts()
    kw = dict(n_components=4, random_state=0, n_iter=30, n_iter_per_test=5, tolerance=0.0)
    calls = dict(port_em.CALLS)
    port = enstop_torch.PLSA(device="cpu", precision="fast", **kw).fit(X)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = enstop_tpu.PLSA(backend="pallas", precision="fast", **kw).fit(X)
    assert port_em.CALLS["em_bf16r"] - calls["em_bf16r"] == 30
    assert port_em.CALLS["em"] == calls["em"]
    assert port.n_iter_ == ref.n_iter_ == 30
    np.testing.assert_allclose(port.history_, ref.history_, rtol=5e-5)
    np.testing.assert_allclose(port.components_, ref.components_, rtol=0, atol=1e-3)
    np.testing.assert_allclose(port.embedding_, ref.embedding_, rtol=0, atol=5e-3)
    before = port_em.CALLS["refit_bf16r"]
    np.testing.assert_allclose(port.transform(X[:20]), ref.transform(X[:20]), rtol=0, atol=5e-3)
    assert port_em.CALLS["refit_bf16r"] > before


def _comb2(n):
    return n * (n - 1) / 2.0


def _contingency(a, b):
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    table = np.zeros((ai.max() + 1, bi.max() + 1), np.int64)
    np.add.at(table, (ai, bi), 1)
    return table


def adjusted_rand(a, b):
    """Adjusted Rand index, written out in NumPy."""
    c = _contingency(a, b)
    n = c.sum()
    sum_ij = _comb2(c).sum()
    sum_a, sum_b = _comb2(c.sum(1)).sum(), _comb2(c.sum(0)).sum()
    expected = sum_a * sum_b / _comb2(n)
    return (sum_ij - expected) / ((sum_a + sum_b) / 2.0 - expected)


def adjusted_mutual_info(a, b):
    """Adjusted mutual information (arithmetic mean of the entropies, natural
    log), with the exact expected mutual information, written out in NumPy."""
    c = _contingency(a, b).astype(np.float64)
    n = c.sum()
    ra, rb = c.sum(1), c.sum(0)
    nz = c > 0
    mi = np.sum(c[nz] / n * np.log(n * c[nz] / np.outer(ra, rb)[nz]))
    emi = 0.0
    for x in ra:
        for y in rb:
            nij = np.arange(max(1.0, x + y - n), min(x, y) + 1)
            if nij.size == 0:
                continue
            logp = (gammaln(x + 1) + gammaln(y + 1) + gammaln(n - x + 1) + gammaln(n - y + 1)
                    - gammaln(n + 1) - gammaln(nij + 1) - gammaln(x - nij + 1)
                    - gammaln(y - nij + 1) - gammaln(n - x - y + nij + 1))
            emi += np.sum(nij / n * np.log(n * nij / (x * y)) * np.exp(logp))

    def entropy(counts):
        p = counts / n
        return -np.sum(p * np.log(p))

    mean_h = (entropy(ra) + entropy(rb)) / 2.0
    return (mi - emi) / (mean_h - emi)


def test_fast_fit_quality_band():
    from sklearn.metrics import adjusted_mutual_info_score, adjusted_rand_score

    X, labels = synthetic_corpus(
        n_docs=500, n_words=1200, n_topics=6, tokens_per_doc=90,
        doc_topic_alpha=0.35, background_weight=0.6, seed=777,
    )
    emb = enstop_torch.PLSA(n_components=6, n_iter=60, random_state=0, device="cpu",
                            precision="fast").fit_transform(X)
    pred = np.argmax(emb, axis=1)
    ari, ami = adjusted_rand(labels, pred), adjusted_mutual_info(labels, pred)
    # the NumPy scores are scikit-learn's
    np.testing.assert_allclose(ari, adjusted_rand_score(labels, pred), rtol=1e-10)
    np.testing.assert_allclose(ami, adjusted_mutual_info_score(labels, pred), rtol=1e-8)
    assert ari > 0.30, f"fast-mode ARI {ari:.4f} below band"
    assert ami > 0.30, f"fast-mode AMI {ami:.4f} below band"
