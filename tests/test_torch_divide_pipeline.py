"""The E-step's ratio modes in the port against the TPU experiments they port,
on the same numpy inputs.

``scripts/exp_divide_pipeline.py`` is loaded by path (its top level imports
only ``sys``, ``time`` and numpy) and its ``_make_tile_math(mode)``, the one
EM step (A and B, no LL) of its kernel in each of its seven ``MODES``, is run
on jnp arrays at ``precision="default"``. ``ops.em.em_accumulators_ratio``
and ``cuda_em._em_accumulators_ratio`` on a CPU tensor (its plain version)
are held to it at 64 x 128, k = 20 (kp = 24: the five modes other than
``f32div`` and ``bf16r`` are built at kp 17-32 only), bf16 X, weighted and
not: rtol 1e-5 / atol 1e-6 for the fp32-accurate modes (``f32div``,
``recip_mul``, ``lax_recip``, ``nr1``, ``nr2``; as ``test_torch_em.py``), a
max-norm relative error of 5e-3 for ``bf16recip_x32`` and ``bf16r`` (as
``test_torch_fast.py``: XLA on the CPU may round bf16 at other places). So
that a mode which quietly divides in fp32 fails, the port's gap from its own
``f32div`` must lie within 0.5-2 times JAX's, for ``nr1``, ``bf16recip_x32``
and ``bf16r``. The word pass's plain version in each mode gives the dense
plain A (rtol 1e-5 / atol 1e-6; it sums in float64).

``scripts/torch_kernel_variants.py``'s chunk functions (10 steps then an LL
sweep; 9 steps then a step with the LL folded in) are held to the same
chunks of ``enstop_tpu.ops.pallas_em`` in Pallas interpret mode: factors at
rtol 1e-5 / atol 1e-6, the LL at rtol 1e-5, and the folded LL is the sweep's
LL of the state after 9 steps.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from enstop_torch.ops import cuda_em, cuda_sparse
from enstop_torch.ops import em as port_em
from enstop_tpu.ops import pallas_em
from enstop_tpu.ops.pallas_em_variants import _resolve_precision

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL, LOSSY_MAXREL = 1e-5, 1e-6, 5e-3
LOSSY = ("bf16recip_x32", "bf16r")
N, M, K, KP = 64, 128, 20, 24


def _load(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


EXPERIMENT = _load("exp_divide_pipeline")
VARIANTS = _load("torch_kernel_variants")


def _problem(seed, kp=KP):
    rng = np.random.default_rng(seed)
    X = ((rng.random((N, M)) < 0.1) * rng.integers(1, 6, (N, M))).astype(np.float32)
    X[3] = 0  # an empty document
    zd = np.zeros((N, kp), np.float32)
    zd[:, :K] = rng.random((N, K)) + 0.01
    zd /= zd.sum(1, keepdims=True)
    wz = np.zeros((kp, M), np.float32)
    wz[:K] = rng.random((K, M)) + 0.01
    wz /= np.maximum(wz.sum(1, keepdims=True), 1e-30)
    w = rng.uniform(0.5, 1.5, N).astype(np.float32)
    return X, zd, wz, w


def _jax_step(mode, X, zd, wz, w):
    """The experiment's tile math over the whole problem: ``(A, B)``."""
    weights = np.ones(N, np.float32) if w is None else w
    a, b = EXPERIMENT._make_tile_math(mode)(
        jnp.asarray(X, jnp.bfloat16), jnp.asarray(zd), jnp.asarray(wz),
        jnp.asarray(weights)[:, None], _resolve_precision("default"))
    return np.asarray(a), np.asarray(b)


def _port(X, zd, wz, w):
    return (torch.from_numpy(X).to(torch.bfloat16), torch.from_numpy(zd), torch.from_numpy(wz),
            None if w is None else torch.from_numpy(w))


def _maxrel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _close(got, want, mode):
    if mode in LOSSY:
        assert _maxrel(got, want) <= LOSSY_MAXREL
    else:
        np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL, atol=ATOL)


def test_the_modes_are_the_experiments():
    assert cuda_em.RATIO_MODES == port_em.RATIO_MODES == EXPERIMENT.MODES


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("mode", EXPERIMENT.MODES)
def test_ratio_step_matches_the_tile_math(mode, weighted):
    X, zd, wz, w = _problem(0)
    w = w if weighted else None
    want = _jax_step(mode, X, zd, wz, w)
    calls = dict(port_em.CALLS)
    for got in (port_em.em_accumulators_ratio(*_port(X, zd, wz, w), mode=mode),
                cuda_em._em_accumulators_ratio(*_port(X, zd, wz, w), mode=mode)):
        for g, ref in zip(got, want):
            _close(g, ref, mode)
    assert port_em.CALLS["em_ratio"] == calls["em_ratio"] + 2


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("mode", ["nr1", "bf16recip_x32", "bf16r"])
def test_ratio_modes_do_not_quietly_divide(mode, weighted):
    """Each lossy mode's gap from ``f32div`` is JAX's to within a factor of 2."""
    X, zd, wz, w = _problem(1)
    w = w if weighted else None
    jax_gaps = [_maxrel(a, b) for a, b in zip(_jax_step(mode, X, zd, wz, w),
                                              _jax_step("f32div", X, zd, wz, w))]
    port = _port(X, zd, wz, w)
    port_gaps = [_maxrel(a, b) for a, b in zip(port_em.em_accumulators_ratio(*port, mode=mode),
                                               port_em.em_accumulators_ratio(*port))]
    for port_gap, jax_gap in zip(port_gaps, jax_gaps):
        assert jax_gap > 0 and 0.5 * jax_gap <= port_gap <= 2 * jax_gap, (port_gaps, jax_gaps)


@pytest.mark.parametrize("mode", EXPERIMENT.MODES)
def test_word_pass_plain_gives_the_dense_A(mode):
    X, zd, wz, w = _problem(2)
    Xt, zdt, wzt, wt = _port(X, zd, wz, w)
    word = cuda_em.word_side_of(Xt)
    calls = cuda_sparse.CALLS["word_pass"]
    AT, ll = cuda_sparse._plain_pass(word, zdt, wzt.t().contiguous(), wt, True, None, False,
                                     ratio=mode)
    assert cuda_sparse.CALLS["word_pass"] == calls + 1 and float(ll) == 0.0
    A = port_em.em_accumulators_ratio(Xt, zdt, wzt, wt, mode)[0]
    np.testing.assert_allclose(AT.t().numpy(), A.numpy(), rtol=RTOL, atol=ATOL)


def test_ratio_step_rejects_what_is_not_built():
    X, zd, wz, w = _port(*_problem(3))
    with pytest.raises(ValueError, match="unknown ratio mode"):
        cuda_em._em_accumulators_ratio(X, zd, wz, w, "fp32div")
    with pytest.raises(ValueError, match="unknown ratio mode"):
        port_em.em_accumulators_ratio(X, zd, wz, w, "nr3")
    with pytest.raises(ValueError, match="bfloat16 X at kp 17-32"):
        cuda_em._em_accumulators_ratio(X.float(), zd, wz, w, "nr1")
    X40, zd40, wz40, w40 = _port(*_problem(3, kp=40))
    for mode in EXPERIMENT.MODES[1:-1]:
        with pytest.raises(ValueError, match="bfloat16 X at kp 17-32"):
            cuda_em._em_accumulators_ratio(X40, zd40, wz40, w40, mode)
    for mode in ("f32div", "bf16r"):  # the shipped steps take any kp and X type
        A, B = cuda_em._em_accumulators_ratio(X40.float(), zd40, wz40, w40, mode)
        assert A.shape == (40, M) and B.shape == (N, 40)


def test_kernel_variants_chunks_match_jax():
    """The two test-chunk forms of ``torch_kernel_variants.py`` against the
    same chunks of JAX's fused step and LL sweep (interpret mode), on the
    experiment's ``make_inputs`` at a small size."""
    X, zd, wz, w = VARIANTS.make_inputs(n_docs=45, n_words=500, k=5, nnz=2000, seed=0)
    jx = (jnp.asarray(X, jnp.bfloat16), jnp.asarray(zd), jnp.asarray(wz), jnp.asarray(w))
    tx = (torch.from_numpy(X).to(torch.bfloat16), torch.from_numpy(zd), torch.from_numpy(wz),
          torch.from_numpy(w))
    kw = dict(bd=16, bw=256, precision="highest")

    def jax_steps(zd_, wz_, n):
        for _ in range(n):
            zd_, wz_, _ = pallas_em.em_step_fused(jx[0], zd_, wz_, sample_weight=jx[3],
                                                  compute_ll=False, **kw)
        return zd_, wz_

    zd9, wz9 = jax_steps(jx[1], jx[2], 9)
    zd10, wz10, ll9 = pallas_em.em_step_fused(jx[0], zd9, wz9, sample_weight=jx[3],
                                              compute_ll=True, **kw)
    ll10 = pallas_em.log_likelihood_fused(jx[0], zd10, wz10, sample_weight=jx[3], **kw)
    separate = VARIANTS.chunk_separate(*tx)
    folded = VARIANTS.chunk_folded(*tx)
    for got, want in ((separate, (zd10, wz10, ll10)), (folded, (zd10, wz10, ll9))):
        for g, ref in zip(got[:2], want[:2]):
            np.testing.assert_allclose(g.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=RTOL)
    # the folded step's LL is the LL sweep of its input state, the state after 9 steps
    state9 = tx[1], tx[2]
    for _ in range(9):
        state9 = cuda_em.em_step_fused(tx[0], *state9, tx[3], compute_ll=False)[:2]
    np.testing.assert_allclose(float(folded[2]),
                               float(cuda_em.log_likelihood_fused(tx[0], *state9, tx[3])),
                               rtol=RTOL)


def test_instance_names_carry_the_ratio_mode():
    """``chip_smoke.py`` names each kernel instance from its mangled name, the
    ratio mode (an ``int`` template argument) included."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    dense = ("_ZN12_GLOBAL__N_113em_accumulateI13__nv_bfloat16Li4ELi8ELi4ELb1ELb0ELi{}EEEv"
             "N8row_walk4ArgsEPf")
    sparse = ("_ZN12_GLOBAL__N_112segment_passILi4ELi8ELi4ELb1ELb{}ELi{}EEEvPKlPKiS4_PKfS6_S6_"
              "S6_fPfS7_liiiii")
    assert smoke.row_instance(dense.format(0)) == "em_accumulate_bf16_L4_TPL8_V4_B"
    assert smoke.row_instance(dense.format(6)) == "em_accumulate_bf16_L4_TPL8_V4_B_bf16r"
    assert smoke.row_instance(dense.format(3)) == "em_accumulate_bf16_L4_TPL8_V4_B_nr1"
    assert (smoke.row_instance("_ZN12_GLOBAL__N_110batch_rowsIfLi1ELi4ELi1EEEvN8row_walk4ArgsE")
            == "batch_rows_fp32_L1_TPL4_V1_B")
    assert smoke.sparse_instance(sparse.format(1, 0)) == "L4_TPL8_V4_word_thresh"
    assert smoke.sparse_instance(sparse.format(0, 6)) == "L4_TPL8_V4_word_bf16r"
    assert smoke.sparse_instance(sparse.format(0, 5)) == "L4_TPL8_V4_word_bf16recip_x32"
    assert set(smoke.EXPERIMENT_RATIOS) == set(port_em.RATIO_MODES[1:-1])
