"""EM fit loops with the reference's convergence schedule (counterpart of
``enstop_tpu/ops/fit.py``).

The schedule tests the relative log-likelihood improvement after steps
1, 1 + npt, 1 + 2 npt, ... and stops when ``|cur - prev| == 0`` or
``|cur - prev| / |cur| < tolerance``. JAX runs the loop as one
``lax.while_loop``; PyTorch runs eagerly, so the loop is Python. The steps
between test points are queued on the device without a host sync; each test
point reads the LL back to the host. The test arithmetic is float32, as in
JAX, so both packages take the same decisions on the same values.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..profiling import count

# Size of the LL trajectory buffer: later test values are not recorded.
MAX_LL_TRACE = 128


class FitResult(NamedTuple):
    state: tuple
    n_steps: int            # EM steps executed (on convergence: up to the test point)
    final_ll: float         # last tested log-likelihood
    ll_trace: np.ndarray    # (MAX_LL_TRACE,) float32, NaN-padded
    n_tests: int            # valid entries in ll_trace


class _Trace:
    """The float32 test-point bookkeeping shared by both loops."""

    def __init__(self, ll0, tolerance):
        self.tolerance = np.float32(tolerance)
        self.prev = np.float32(ll0)
        self.trace = np.full((MAX_LL_TRACE,), np.nan, np.float32)
        self.trace[0] = self.prev
        self.t = 1

    def test(self, ll):
        """Record one tested value; True when it meets the convergence test."""
        cur = np.float32(ll)
        change = np.abs(cur - self.prev)
        with np.errstate(divide="ignore", invalid="ignore"):
            converged = bool(change == 0.0 or change / np.abs(cur) < self.tolerance)
        if self.t < MAX_LL_TRACE:
            self.trace[self.t] = cur
            self.t += 1
        self.prev = cur
        return converged


def _host(ll):
    count("host_syncs")
    return float(ll)  # device -> host sync for a 0-d tensor


def em_fit_loop(em_step, ll_fn, state0, n_iter, n_iter_per_test, tolerance):
    """Run EM with the reference's exact convergence schedule.

    ``em_step(state) -> (state, ll_of_inputs)``; ``ll_fn(state) -> scalar``.
    Returns a :class:`FitResult`.
    """
    n_iter = int(n_iter)
    npt = max(int(n_iter_per_test), 1)
    rec = _Trace(_host(ll_fn(state0)), tolerance)
    state, done, converged = state0, 0, False
    while done < n_iter and not converged:
        # next stopping point: step 1 first, then every npt steps; a final
        # partial chunk up to n_iter runs without a test
        test_point = 1 if done == 0 else done + npt
        next_stop = min(n_iter, test_point)
        for _ in range(next_stop - done):
            state, _ll = em_step(state)
        done = next_stop
        if next_stop == test_point:
            converged = rec.test(_host(ll_fn(state)))
    return FitResult(state, done, float(rec.prev), rec.trace, rec.t)


def em_fit_loop_traced(em_step, ll_fn, state0, n_iter, n_iter_per_test, tolerance):
    """:func:`em_fit_loop` returning ``(state, n_steps, ll_trace, n_tests)``."""
    res = em_fit_loop(em_step, ll_fn, state0, n_iter, n_iter_per_test, tolerance)
    return res.state, res.n_steps, res.ll_trace, res.n_tests


def em_fit_loop_folded(em_step_ll, em_step, ll_fn, state0, n_iter,
                       n_iter_per_test, tolerance):
    """:func:`em_fit_loop` with the test log-likelihood folded into the EM
    step: the test value LL(state_T) comes out of step T+1 run with the LL on
    (``em_step_ll``), so no separate LL sweep runs. On convergence state_T is
    returned and the folded step T+1 is discarded; ``ll_fn`` runs only when a
    test point lands on ``n_iter``. ``n_iter == 0`` returns ``state0``.

    ``em_step_ll(state) -> (state', ll_of_input)``,
    ``em_step(state) -> (state', ignored)``, ``ll_fn(state) -> scalar``.
    """
    n_iter = int(n_iter)
    npt = max(int(n_iter_per_test), 1)

    # the first step carries LL(state0) out for free
    state, ll0 = em_step_ll(state0)
    rec = _Trace(_host(ll0), tolerance)
    saved, done, steps_rep, next_tp, converged = state0, 1, 1, 1, False
    while not converged and (done < n_iter or next_tp <= n_iter):
        if next_tp <= n_iter:
            T = next_tp
            for _ in range(T - done):
                state, _ll = em_step(state)
            state_T = state
            if T < n_iter:
                state, llT = em_step_ll(state_T)
                done = T + 1
            else:
                llT = ll_fn(state_T)
                done = T
            converged = rec.test(_host(llT))
            saved = state_T
            # on convergence the reference stops AT the test point
            steps_rep = T if converged else done
            next_tp = T + npt
        else:
            for _ in range(n_iter - done):
                state, _ll = em_step(state)
            done = steps_rep = n_iter
    if n_iter == 0:
        final_state = state0
    else:
        final_state = saved if converged else state
    return FitResult(final_state, min(steps_rep, n_iter), float(rec.prev),
                     rec.trace, rec.t)
