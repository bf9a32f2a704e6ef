"""Profiling and tracing hooks (counterpart of ``enstop_tpu/profiling.py``).

* :func:`trace`: a ``torch.profiler`` capture of everything inside the block,
  with the CUDA activity (each kernel on the card) where a card is present,
  written as a Chrome trace that TensorBoard and Perfetto open.
* :func:`fit_stats`: a fitted estimator's ``fit_info_`` in one line.
* :class:`StepTimer`: wall-clock section timing that can wait for the card.
"""

from __future__ import annotations

import contextlib
import time

import torch

__all__ = ["trace", "fit_stats", "StepTimer"]


@contextlib.contextmanager
def trace(logdir):
    """Profile the block and write ``<logdir>/<host>_<pid>.<ms>.pt.trace.json``;
    yields the ``torch.profiler.profile`` object.

    >>> with trace("profiles/plsa"):
    ...     PLSA(n_components=20).fit(X)
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(str(logdir)))
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()


def fit_stats(model):
    """Human-readable throughput summary from a fitted model's ``fit_info_``."""
    info = getattr(model, "fit_info_", None)
    if not info:
        return "no fit info recorded (model not fitted via the instrumented path)"
    return (
        "{steps} EM steps in {wall:.3f}s device-side "
        "({rate:.2f}G nnz*k updates/s); final log-likelihood {ll:.1f}".format(
            steps=info["n_steps"],
            wall=info["wall_time_s"],
            rate=info["nnz_k_updates_per_s"] / 1e9,
            ll=info["log_likelihood"],
        )
    )


def _cuda_devices(sync_on):
    tensors = sync_on if isinstance(sync_on, (list, tuple)) else (sync_on,)
    return {t.device for t in tensors if isinstance(t, torch.Tensor) and t.is_cuda}


class StepTimer:
    """Wall-clock section timer; ``sync_on`` (a tensor, or a list or tuple
    of them) makes a section wait for their CUDA devices before it stops.

    >>> t = StepTimer()
    >>> with t.section("em", sync_on=state):
    ...     state = step(state)
    >>> t.report()
    """

    def __init__(self):
        self.totals = {}
        self.counts = {}

    @contextlib.contextmanager
    def section(self, name, sync_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            for device in _cuda_devices(sync_on):
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self):
        return {
            name: {"total_s": total, "calls": self.counts[name],
                   "mean_ms": 1e3 * total / self.counts[name]}
            for name, total in sorted(self.totals.items())
        }
