"""Profiling and tracing hooks (counterpart of ``enstop_tpu/profiling.py``).

* :func:`trace`: a ``torch.profiler`` capture of everything inside the block,
  with the CUDA activity (each kernel on the card) where a card is present,
  written as a Chrome trace that TensorBoard and Perfetto open.
* :func:`fit_stats`: a fitted estimator's ``fit_info_`` in one line.
* :class:`StepTimer`: wall-clock section timing that can wait for the card.
* :func:`request`, :func:`span`, :func:`count`: spans and counters inside the
  program. A request is a root span with a fresh integer ``id``; a span is a
  child of the innermost open span of the same thread and task (a
  ``contextvars`` stack); a counter adds to the innermost open span. Each
  span records its name, its parent's index in the request's list, its start
  and end in seconds of ``time.perf_counter()`` from the root's start, its
  attributes and its counters; the list is handed back when the root closes
  (:attr:`Request.record`). With no request open and no profiler running,
  :func:`span` and :func:`count` return at once. While a ``torch.profiler``
  runs, every span also enters ``record_function("enstop.<name>")``, so the
  spans land in its Chrome trace as ``user_annotation`` ranges on the
  device's clock, beside the kernels and copies.
* :func:`idle_by_span`: the device's idle seconds in such a trace, put down
  to the innermost ``enstop.*`` range.

The spans of the program, each under its parent, in order:

``fit``         ``PLSA.fit`` / ``fit_transform`` (attributes ``estimator``,
                ``backend``), or ``plsa_fit`` called with no request open
                (attribute ``backend``); the estimator keeps the record as
                ``fit_info_["trace"]``, ``plsa_fit(return_info=True)`` as
                ``info["trace"]``
  ``validate``  the estimator's input checks and zero-row split, or the
                sample-weight check of prepared input
  ``stage``     the corpus and the document weights to the device
    ``stage.copy``    the copy of the corpus's CSR arrays to the device as
                      they stand, one each for ``indptr``, ``indices`` and
                      ``data`` (attribute ``bytes``)
    ``stage.coo``     their expansion to COO there and the check that the
                      CSR is canonical (its flag read back); before the
                      copies, any conversion of other input to a CSR on the
                      host, and after the check, the host's canonical copy
                      of a CSR that failed it (then copied and expanded
                      again)
    ``stage.layout``  the layout built there: the dense scatter and the word
                      side, or the sparse path's two sides
  ``init``      the initial factors drawn and padded on the host
  ``loop``      the EM loop, from the factors' copy to the device to the
                factors read back: ``fit_info_["wall_time_s"]`` is its length
    ``readback``  the factors to the host
  ``finish``    the estimator's zero rows put back and its record kept
``transform``   ``PLSA.transform``, to the profiler only: ``validate``,
                ``stage``, ``init``, ``loop`` and ``readback`` as above
``ensemble``    ``EnsembleTopics.fit`` / ``fit_transform`` (attributes
                ``estimator``, ``model``, ``backend``, ``n_starts``; kept as
                ``fit_info_["trace"]``), or ``ensemble_fit`` called with no
                request open (attributes ``model``, ``n_starts``)
  ``validate``  the estimator's input checks
  ``staging``   the input cast and the corpus staged once for every run
                (with ``stage.copy``, ``stage.coo`` and ``stage.layout``)
  ``runs``      the bootstrap runs (counters ``runs`` and ``em_steps``, the
                sum of their EM steps, for the device fan-outs)
  ``combine``   the stable topics (counter ``stable_topics``):
    ``combine.distances``  the distance matrix of the runs' topics
    ``combine.layout``     the UMAP layout (``"hellinger_umap"`` only;
                           counter ``layout_launches``, the layout kernel's
                           launches, 1 on a card)
    ``combine.cluster``    HDBSCAN
    ``combine.merge``      each cluster merged into its stable topic
  ``refit``     the documents refitted against the stable topics (the
                spans of ``plsa_refit``); the lengths of ``staging``,
                ``runs``, ``combine`` and ``refit`` are also
                ``ensemble_fit.last_timings``

``plsa_fit``, ``plsa_refit`` and ``ensemble_fit`` called inside an open
request add their spans to it. The counter ``host_syncs`` counts the points at which a fit on
a card makes the host wait for the device: each copy between host and
device (pageable memory: the copy waits for the stream), each value read
back (a test point's log-likelihood, an index bound, a segment count) and
each ``bincount`` (it reads its input's bounds back). It counts the same on
any device, so a CPU fit reads what the same fit on a card would; where a
path runs only on the card (the UMAP layout's epochs on the device) it
counts there alone. No span or
counter runs per EM step. The counters ``coo_as_is`` and
``coo_canonicalized`` count the corpora shipped as they stood and those
canonicalised on the host first (``ops.data.ship_coo``).
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import time

import torch

__all__ = ["trace", "fit_stats", "StepTimer", "Request", "request", "span", "count",
           "is_open", "idle_by_span"]


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


# -- spans and counters ---------------------------------------------------------

# the innermost open span of this thread or task: (request, index), or None
_OPEN = contextvars.ContextVar("enstop_open_span", default=None)
_IDS = itertools.count(1)
_profiler_enabled = torch._C._autograd._profiler_enabled


class Request:
    """The spans of one request. ``spans`` is a list of dicts (``name``,
    ``parent``, ``start``, ``end``, ``attrs``, ``counters``), the root first
    with parent None; ``record`` is set when the root closes."""

    __slots__ = ("id", "t0", "spans", "record")

    def __init__(self):
        self.id = next(_IDS)
        self.t0 = None  # the root's start
        self.spans = []
        self.record = None

    def close(self):
        counters = {}
        for s in self.spans:
            for name, n in s["counters"].items():
                counters[name] = counters.get(name, 0) + n
        self.record = {"id": self.id, "spans": self.spans, "counters": counters}


class _Span:
    """An open span: the ``record_function`` range while a profiler runs,
    the request's entry while a request is open. ``seconds`` is its length
    once closed (None where no request recorded it)."""

    __slots__ = ("name", "attrs", "request", "parent", "entry", "token", "range", "seconds")

    def __init__(self, name, attrs, request, parent):
        self.name, self.attrs, self.request, self.parent = name, attrs, request, parent
        self.entry = self.token = self.range = self.seconds = None

    def __enter__(self):
        if _profiler_enabled():
            self.range = torch.profiler.record_function("enstop." + self.name)
            self.range.__enter__()
        req = self.request
        if req is not None:
            now = time.perf_counter()
            if req.t0 is None:
                req.t0 = now
            self.entry = {"name": self.name, "parent": self.parent,
                          "start": now - req.t0, "end": None,
                          "attrs": self.attrs, "counters": {}}
            self.token = _OPEN.set((req, len(req.spans)))
            req.spans.append(self.entry)
        return self

    def __exit__(self, *exc):
        entry = self.entry
        if entry is not None:
            entry["end"] = time.perf_counter() - self.request.t0
            self.seconds = entry["end"] - entry["start"]
            _OPEN.reset(self.token)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


class _Off:
    """The span of no request with no profiler running: nothing to do."""

    seconds = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


@contextlib.contextmanager
def request(name, **attrs):
    """Open a root span ``name`` with a fresh ``id``; yields the
    :class:`Request`, whose ``record`` (``{"id", "spans", "counters"}``, the
    counters summed over the spans) is set when the block ends."""
    req = Request()
    try:
        with _Span(name, attrs, req, None):  # a root: no parent, even inside another request
            yield req
    finally:
        req.close()


def span(name, **attrs):
    """A child span ``name`` of the innermost open span (a context manager)."""
    top = _OPEN.get()
    if top is None:
        return _Span(name, attrs, None, None) if _profiler_enabled() else _OFF
    return _Span(name, attrs, top[0], top[1])


def count(name, n=1):
    """Add ``n`` to the counter ``name`` of the innermost open span."""
    top = _OPEN.get()
    if top is not None:
        counters = top[0].spans[top[1]]["counters"]
        counters[name] = counters.get(name, 0) + n


def is_open():
    """True inside an open request."""
    return _OPEN.get() is not None


# -- the device's idle time by span -------------------------------------------

_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
_PREFIX = "enstop."


def _is_work(name):
    """A device event that does work (a synchronise shows on the device's
    timeline but does none)."""
    low = name.lower()
    return "synchroniz" not in low and "event sync" not in low and "stream wait" not in low


def idle_by_span(trace_path):
    """The device's idle seconds in a Chrome trace that :func:`trace` (or any
    ``torch.profiler`` export) wrote, put down to the program's spans.

    The device is idle where no kernel, copy or set runs; the window is the
    trace's first event to its last. Each idle stretch counts for the
    innermost ``enstop.*`` range that holds it (the latest started of those
    open), or for none. Returns ``{"window_s", "idle_s", "outside_s",
    "by_span": {span name: idle seconds}}``; ``outside_s`` is the idle time
    in no range.
    """
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    if not events:
        return {"window_s": 0.0, "idle_s": 0.0, "outside_s": 0.0, "by_span": {}}
    lo = min(float(e["ts"]) for e in events)
    hi = max(float(e["ts"]) + float(e.get("dur", 0.0)) for e in events)
    busy, ranges = [], []
    for e in events:
        start = float(e["ts"])
        end = start + float(e.get("dur", 0.0))
        if e.get("cat") in _DEVICE_CATEGORIES and _is_work(e["name"]):
            busy.append((start, end))
        elif (e.get("cat") == "user_annotation" and e["name"].startswith(_PREFIX)
              and end > start):
            ranges.append((start, end, e["name"][len(_PREFIX):]))
    # idle stretches of [lo, hi]
    idle, cur = [], lo
    for start, end in sorted(busy):
        if start > cur:
            idle.append((cur, start))
        cur = max(cur, end)
    if cur < hi:
        idle.append((cur, hi))
    # cut [lo, hi] at every boundary: each piece is idle or busy as a whole,
    # and held by the same ranges as a whole
    cuts = sorted({lo, hi, *(t for g in idle for t in g), *(t for r in ranges for t in r[:2])})
    starting, ending = {}, {}
    for i, (start, end, _) in enumerate(ranges):
        starting.setdefault(start, []).append(i)
        ending.setdefault(end, []).append(i)
    by_span, outside, held, k = {}, 0.0, set(), 0
    for a, b in zip(cuts, cuts[1:]):
        held.difference_update(ending.get(a, ()))
        held.update(starting.get(a, ()))
        while k < len(idle) and idle[k][1] <= a:
            k += 1
        if k == len(idle) or idle[k][0] > a:
            continue  # the device works here
        if held:
            name = ranges[max(held, key=lambda j: (ranges[j][0], -ranges[j][1]))][2]
            by_span[name] = by_span.get(name, 0.0) + (b - a) / 1e6
        else:
            outside += (b - a) / 1e6
    idle_total = sum(e - s for s, e in idle) / 1e6
    return {"window_s": (hi - lo) / 1e6, "idle_s": idle_total, "outside_s": outside,
            "by_span": by_span}


# -- section timing -----------------------------------------------------------------

def _cuda_devices(sync_on):
    tensors = sync_on if isinstance(sync_on, (list, tuple)) else (sync_on,)
    return {t.device for t in tensors if isinstance(t, torch.Tensor) and t.is_cuda}


class StepTimer:
    """Wall-clock section timer; ``sync_on`` (a tensor, or a list or tuple
    of them) makes a section wait for their CUDA devices before it stops.
    Each section is also a :func:`span` of its name.

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
        with span(name):
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
