"""The port's EM ops against the JAX package's, on the same numpy inputs.

``enstop_torch.ops.em`` (plain PyTorch) is held against ``enstop_tpu.ops.em``;
the ``enstop_torch.ops.cuda_em`` wrappers, which run their plain version on a
CPU tensor, are held against ``enstop_tpu.ops.pallas_em`` in Pallas interpret
mode (``precision="highest"``, small tiles for a multi-block grid). X is
ragged before padding (45 x 500 padded to 48 x 512), weighted and not, in
float32 and bfloat16. Tolerance: rtol 1e-5 / atol 1e-6 on the float32
accumulators and factors, rtol 1e-5 on the log-likelihood; the two sides sum
in different orders.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from enstop_torch.ops import _build, cuda_em
from enstop_torch.ops import em as port_em
from enstop_tpu.ops import em as jax_em
from enstop_tpu.ops import pallas_em

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
N_RAW, M_RAW, N, M, K, KP = 45, 500, 48, 512, 5, 8


def _problem(seed, weighted):
    rng = np.random.default_rng(seed)
    X = np.zeros((N, M), np.float32)
    X[:N_RAW, :M_RAW] = (rng.random((N_RAW, M_RAW)) < 0.08) * rng.integers(1, 5, (N_RAW, M_RAW))
    zd = np.zeros((N, KP), np.float32)
    zd[:N_RAW, :K] = rng.random((N_RAW, K)) + 0.05
    zd[:N_RAW, :K] /= zd[:N_RAW, :K].sum(1, keepdims=True)
    wz = np.zeros((KP, M), np.float32)
    wz[:K, :M_RAW] = rng.random((K, M_RAW)) + 0.05
    wz[:K] /= wz[:K].sum(1, keepdims=True)
    w = (rng.random(N) + 0.5).astype(np.float32) if weighted else None
    return X, zd, wz, w


def _jax(X, zd, wz, w, dtype):
    return (jnp.asarray(X, dtype), jnp.asarray(zd), jnp.asarray(wz),
            None if w is None else jnp.asarray(w))


def _torch(X, zd, wz, w, dtype):
    return (torch.from_numpy(X).to(dtype), torch.from_numpy(zd), torch.from_numpy(wz),
            None if w is None else torch.from_numpy(w))


DTYPES = [(np.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]
CASES = [pytest.param(dt, weighted, id=f"{dt[1]}-{'weighted' if weighted else 'unweighted'}")
         for dt in DTYPES for weighted in (False, True)]


def _close(port, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtypes,weighted", CASES)
def test_plain_ops_match_jax_dense(dtypes, weighted):
    jdt, tdt = dtypes
    prob = _problem(0, weighted)
    jx, tx = _jax(*prob, jdt), _torch(*prob, tdt)

    for port, ref in zip(port_em.em_accumulators_dense(*tx), jax_em.em_accumulators_dense(*jx)):
        _close(port, ref)
    for port, ref in zip(port_em.em_step_dense(*tx), jax_em.em_step_dense(*jx)):
        _close(port, ref)
    for port, ref in zip(port_em.refit_step_dense(*tx), jax_em.refit_step_dense(*jx)):
        _close(port, ref)
    _close(port_em.log_likelihood_dense(*tx), jax_em.log_likelihood_dense(*jx))


def test_plain_weight_asymmetry():
    """w scales A and the LL, never B; the refit's B ignores w as well."""
    X, zd, wz, w = _torch(*_problem(1, True), torch.float32)
    A1, B1, ll1 = port_em.em_accumulators_dense(X, zd, wz)
    A2, B2, ll2 = port_em.em_accumulators_dense(X, zd, wz, 2 * torch.ones_like(w))
    torch.testing.assert_close(A2, 2 * A1)
    torch.testing.assert_close(B2, B1)
    torch.testing.assert_close(ll2, 2 * ll1)
    zr1, _ = port_em.refit_step_dense(X, zd, wz)
    zr2, _ = port_em.refit_step_dense(X, zd, wz, w)
    torch.testing.assert_close(zr1, zr2)
    # padding is absorbing: padded rows / topics stay exactly zero
    zd2, wz2, _ = port_em.em_step_dense(X, zd, wz, w)
    assert torch.all(zd2[N_RAW:] == 0) and torch.all(zd2[:, K:] == 0)
    assert torch.all(wz2[K:] == 0) and torch.all(wz2[:, M_RAW:] == 0)


@pytest.mark.parametrize("compute_ll", [True, False])
@pytest.mark.parametrize("dtypes,weighted", CASES)
def test_wrappers_on_cpu_match_pallas_interpret(dtypes, weighted, compute_ll):
    jdt, tdt = dtypes
    prob = _problem(2, weighted)
    jx, tx = _jax(*prob, jdt), _torch(*prob, tdt)
    launches = dict(cuda_em.LAUNCHES)

    A, B, ll = cuda_em.em_accumulators_fused(*tx, compute_ll=compute_ll, precision="highest")
    A0, B0, ll0 = pallas_em.em_accumulators_fused(
        jx[0], jx[1], jx[2], sample_weight=jx[3], bd=16, bw=256,
        compute_ll=compute_ll, precision="highest")
    _close(A, A0)
    _close(B, B0)
    if compute_ll:
        _close(ll, ll0, atol=0)
    else:
        assert float(ll) == 0.0 == float(ll0)

    zr, llr = cuda_em.refit_step_fused(*tx, compute_ll=compute_ll, precision="highest")
    zr0, llr0 = pallas_em.refit_step_fused(
        jx[0], jx[1], jx[2], sample_weight=jx[3], bd=16, bw=256,
        compute_ll=compute_ll, precision="highest")
    _close(zr, zr0)
    _close(llr, llr0, atol=0)

    # CPU tensors never launch a kernel
    assert cuda_em.LAUNCHES == launches


@pytest.mark.parametrize("dtypes,weighted", CASES)
def test_fused_step_and_ll_on_cpu_match_pallas_interpret(dtypes, weighted):
    jdt, tdt = dtypes
    prob = _problem(3, weighted)
    jx, tx = _jax(*prob, jdt), _torch(*prob, tdt)
    calls = dict(port_em.CALLS)

    zd, wz, ll = cuda_em.em_step_fused(*tx, compute_ll=True, precision="default")
    zd0, wz0, ll0 = pallas_em.em_step_fused(
        jx[0], jx[1], jx[2], sample_weight=jx[3], bd=16, bw=256,
        compute_ll=True, precision="highest")
    _close(zd, zd0)
    _close(wz, wz0)
    _close(ll, ll0, atol=0)
    _close(cuda_em.log_likelihood_fused(*tx, precision="highest"),
           pallas_em.log_likelihood_fused(jx[0], jx[1], jx[2], sample_weight=jx[3],
                                          bd=16, bw=256, precision="highest"), atol=0)
    # the CPU route is the plain version
    assert port_em.CALLS["em"] == calls["em"] + 1
    assert port_em.CALLS["ll"] == calls["ll"] + 1


def test_wrappers_refuse_fast_and_unknown_devices():
    X, zd, wz, w = _torch(*_problem(4, False), torch.float32)
    with pytest.raises(NotImplementedError):
        cuda_em.em_step_fused(X, zd, wz, precision="fast")
    with pytest.raises(NotImplementedError):
        cuda_em.refit_step_fused(X, zd, wz, precision="fast")
    with pytest.raises(ValueError):
        cuda_em.log_likelihood_fused(X, zd, wz, precision="bogus")
    # a tensor that is neither on the CPU nor on a CUDA device raises; it never
    # quietly takes the plain path
    with pytest.raises(ValueError):
        cuda_em.em_accumulators_fused(X.to("meta"), zd.to("meta"), wz.to("meta"))


def test_build_without_nvcc_raises(monkeypatch):
    """Building needs nvcc; its absence is an error, never a fallback."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda path: False)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
