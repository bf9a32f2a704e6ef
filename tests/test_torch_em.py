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

from pathlib import Path

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
    """``precision="fast"`` is served now (on a CPU tensor by the plain bf16r
    ops, held against JAX in ``test_torch_fast.py``); an unknown precision and
    an unknown device still raise."""
    X, zd, wz, w = _torch(*_problem(4, False), torch.float32)
    calls = dict(port_em.CALLS)
    zd_f, wz_f, _ = cuda_em.em_step_fused(X, zd, wz, precision="fast")
    zr_f, _ = cuda_em.refit_step_fused(X, zd, wz, precision="fast")
    assert port_em.CALLS["em_bf16r"] == calls["em_bf16r"] + 1
    assert port_em.CALLS["refit_bf16r"] == calls["refit_bf16r"] + 1
    for got, ref in ((zd_f, port_em.em_step_bf16r(X, zd, wz)[0]),
                     (wz_f, port_em.em_step_bf16r(X, zd, wz)[1]),
                     (zr_f, port_em.refit_step_bf16r(X, zd, wz)[0])):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
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


def test_library_digest_follows_included_headers(tmp_path):
    """A library's name hashes its source and every header it includes from
    ``csrc`` (through other headers too), so a library built from a stale
    header is never loaded; a source that does not include it keeps its name."""
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(Path(_build.__file__).parent / "csrc", csrc)
    names = ("em_dense", "em_batch", "em_sparse")
    before = {name: _build.digest(name, csrc) for name in names}
    assert before == {name: _build.digest(name) for name in names}
    for name in ("em_dense", "em_batch"):
        assert '#include "row_walk.cuh"' in (csrc / f"{name}.cu").read_text()

    header = csrc / "row_walk.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    edited = {name: _build.digest(name, csrc) for name in names}
    assert edited["em_dense"] != before["em_dense"]
    assert edited["em_batch"] != before["em_batch"]
    assert edited["em_sparse"] == before["em_sparse"]

    shared = csrc / "lane_walk.cuh"  # included by em_sparse.cu and, through row_walk.cuh, both
    shared.write_text(shared.read_text() + "\n// edited\n")
    assert all(_build.digest(name, csrc) != edited[name] for name in names)
    sparse = _build.digest("em_sparse", csrc)

    (csrc / "inner.cuh").write_text("#pragma once\n")
    header.write_text('#include "inner.cuh"\n' + header.read_text())
    nested = _build.digest("em_dense", csrc)
    (csrc / "inner.cuh").write_text("#pragma once\n// edited\n")
    assert _build.digest("em_dense", csrc) != nested
    assert _build.digest("em_sparse", csrc) == sparse


@pytest.mark.parametrize("stream, ok", [
    (cuda_em.ROW_STREAM, True),
    (cuda_em.RowStream(queue=512), True),
    (cuda_em.RowStream(warps=16, stages=8, window=1024, queue=512), True),
    (cuda_em.RowStream(warps=0), False),
    (cuda_em.RowStream(warps=17), False),
    (cuda_em.RowStream(stages=1), False),
    (cuda_em.RowStream(stages=9), False),
    (cuda_em.RowStream(window=768), False),
    (cuda_em.RowStream(queue=128), False),
    (cuda_em.RowStream(queue=300), False),
    (cuda_em.RowStream(warps=2, stages=4, window=3072, queue=288), True),
    (cuda_em.RowStream(warps=16, stages=8, window=2048), False),  # 327,680 B of shared memory
])
def test_row_stream_shapes(stream, ok):
    """The row walk's stream takes 1-16 warps, 2-8 stages, windows of a multiple
    of 512 bytes, a queue of a multiple of 32 of at least 256 entries, within
    an H100 block's shared memory; anything else raises
    before a launch."""
    bars = -(-stream.warps * stream.stages * 8 // 128) * 128
    assert stream.smem_bytes() == bars + stream.warps * (stream.stages * stream.window
                                                         + 8 * stream.queue)
    if ok:
        assert cuda_em.walk_args(24, None, stream) == (4, 8, *stream)
    else:
        with pytest.raises(ValueError):
            cuda_em.walk_args(24, None, stream)


def test_walk_args_shapes():
    """The walk's shape is the sparse walk's for the topic count, or one given
    that holds the topics."""
    from enstop_torch.ops import cuda_sparse

    for kp in (1, 20, 24, 33, 104, 256):
        assert cuda_em.walk_args(kp, None, cuda_em.ROW_STREAM)[:2] == cuda_sparse.walk_shape(kp)
    assert cuda_em.walk_args(24, (2, 12), cuda_em.ROW_STREAM)[:2] == (2, 12)
    with pytest.raises(ValueError):
        cuda_em.walk_args(24, (2, 8), cuda_em.ROW_STREAM)
    with pytest.raises(ValueError):
        cuda_em.walk_args(257, None, cuda_em.ROW_STREAM)
