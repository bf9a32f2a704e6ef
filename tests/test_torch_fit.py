"""The port's fit loops against ``enstop_tpu.ops.fit`` on schedule edges.

Both loops get the same data and initial factors and their own package's
dense EM step, so the schedules (step counts, test counts, which tests are
recorded) must agree exactly and the LL values to float32 summation order
(rtol 1e-5). Cases: convergence at a test point, a test landing on n_iter,
n_iter = 0, n_iter = 1, and a trace longer than the cap.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import make_corpus
from enstop_torch.ops import em as port_em
from enstop_torch.ops import fit as port_fit
from enstop_torch.ops.init import plsa_init
from enstop_tpu.ops import em as jax_em
from enstop_tpu.ops import fit as jax_fit

torch.set_num_threads(1)

X = make_corpus(np.random.RandomState(0), n_docs=40, n_words=60, seed=51)
PZD, PWZ = plsa_init(X, 4, rng=np.random.RandomState(1))

# (n_iter, n_iter_per_test, tolerance)
SCHEDULES = {
    "converges_at_test": (60, 5, 1e-3),
    "test_lands_on_n_iter": (21, 10, 0.0),
    "n_iter_0": (0, 10, 1e-3),
    "n_iter_1": (1, 10, 1e-3),
    "trace_past_cap": (140, 1, 0.0),
}


def _jax_loop(folded, n_iter, npt, tol):
    Xj = jnp.asarray(X)

    def step(state):
        zd, wz, ll = jax_em.em_step_dense(Xj, state[0], state[1])
        return (zd, wz), ll

    def ll_of(state):
        return jax_em.log_likelihood_dense(Xj, state[0], state[1])

    s0 = (jnp.asarray(PZD), jnp.asarray(PWZ))
    if folded:
        return jax_fit.em_fit_loop_folded(step, step, ll_of, s0, n_iter, npt, tol)
    return jax_fit.em_fit_loop(step, ll_of, s0, n_iter, npt, tol)


def _port_loop(folded, n_iter, npt, tol):
    Xt = torch.from_numpy(X)

    def step(state):
        zd, wz, ll = port_em.em_step_dense(Xt, state[0], state[1])
        return (zd, wz), ll

    def ll_of(state):
        return port_em.log_likelihood_dense(Xt, state[0], state[1])

    s0 = (torch.from_numpy(PZD), torch.from_numpy(PWZ))
    if folded:
        return port_fit.em_fit_loop_folded(step, step, ll_of, s0, n_iter, npt, tol)
    return port_fit.em_fit_loop(step, ll_of, s0, n_iter, npt, tol)


@pytest.mark.parametrize("folded", [False, True], ids=["em_fit_loop", "folded"])
@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_schedule_matches_jax(schedule, folded):
    n_iter, npt, tol = SCHEDULES[schedule]
    ref = _jax_loop(folded, n_iter, npt, tol)
    res = _port_loop(folded, n_iter, npt, tol)

    assert res.n_steps == int(ref.n_steps)
    assert res.n_tests == int(ref.n_tests)
    trace, ref_trace = res.ll_trace, np.asarray(ref.ll_trace)
    assert trace.shape == (port_fit.MAX_LL_TRACE,)
    np.testing.assert_array_equal(np.isnan(trace), np.isnan(ref_trace))
    np.testing.assert_allclose(trace, ref_trace, rtol=1e-5)
    np.testing.assert_allclose(res.final_ll, float(ref.final_ll), rtol=1e-5)
    for port, jax_state in zip(res.state, ref.state):
        np.testing.assert_allclose(port.numpy(), np.asarray(jax_state), rtol=5e-4, atol=1e-5)

    if schedule == "n_iter_0":
        np.testing.assert_array_equal(res.state[0].numpy(), PZD)
        assert res.n_steps == 0
    if schedule == "converges_at_test":
        assert res.n_steps < n_iter and (res.n_steps - 1) % npt == 0
    if schedule == "trace_past_cap":
        assert res.n_tests == port_fit.MAX_LL_TRACE and not np.isnan(trace).any()


def test_folded_loop_matches_unfolded_loop():
    """The folded loop returns the unfolded loop's state, steps and trace."""
    for n_iter, npt, tol in SCHEDULES.values():
        a = _port_loop(False, n_iter, npt, tol)
        b = _port_loop(True, n_iter, npt, tol)
        assert (a.n_steps, a.n_tests) == (b.n_steps, b.n_tests)
        np.testing.assert_allclose(a.ll_trace, b.ll_trace, rtol=1e-6)
        for x, y in zip(a.state, b.state):
            torch.testing.assert_close(x, y)


def test_folded_loop_sweeps_only_when_a_test_lands_on_n_iter():
    Xt = torch.from_numpy(X)
    sweeps = []

    def step(state):
        zd, wz, ll = port_em.em_step_dense(Xt, state[0], state[1])
        return (zd, wz), ll

    def ll_of(state):
        sweeps.append(1)
        return port_em.log_likelihood_dense(Xt, state[0], state[1])

    s0 = (torch.from_numpy(PZD), torch.from_numpy(PWZ))
    port_fit.em_fit_loop_folded(step, step, ll_of, s0, 20, 10, 0.0)
    assert sweeps == []
    port_fit.em_fit_loop_folded(step, step, ll_of, s0, 21, 10, 0.0)
    assert sweeps == [1]
