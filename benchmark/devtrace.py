"""The traced run: ``torch.profiler`` over the measured window, reduced to
what the per-layer readers and the result line need. The profiler's trace
is exported and read as a Chrome trace, which costs far less than walking
the profiler's event objects.

The device is busy where any of its activities (kernels, copies, sets)
runs: the union of their intervals, clipped to the window, as
``scripts/torch_measure.py`` computes it. A synchronise shows on the
device's timeline but does no work, so it is left out. The window is the
profiler's own record of the harness's ``bench.window`` range, in the same
clock as the device's events.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile

WINDOW = "bench.window"
TOP = 10
NAME_CHARS = 160  # kernel names are long template instances
MAX_TRACED_SECONDS = 10.0  # a traced run's window: enough calls, a trace that reads fast


def union_s(intervals):
    """Seconds covered by the union of ``(start_us, end_us)`` intervals."""
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(intervals):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy / 1e6


def gaps(intervals, lo, hi):
    """The ``(start_us, end_us)`` stretches of ``[lo, hi]`` that no interval covers."""
    out, cur = [], lo
    for start, stop in sorted(intervals):
        if start > cur:
            out.append((cur, min(start, hi)))
        cur = max(cur, stop)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [g for g in out if g[1] > g[0]]


def _is_work(name):
    low = name.lower()
    return "synchroniz" not in low and "event sync" not in low and "stream wait" not in low


def summarise(device_events, host_events, window):
    """``device_events`` are ``(name, start_us, end_us, category)``,
    ``host_events`` ``(name, start_us, end_us)``; ``window`` is
    ``(start_us, end_us)``. Returns busy and window seconds, the seconds of
    kernels alone (``kernel_s``, copies and sets left out), and the
    breakdown: device operations by time, and the longest idle gaps named
    by the host operation that overlaps each most (the shortest of equals,
    so the innermost)."""
    lo, hi = window
    dev = [(n, max(s, lo), min(e, hi), c) for n, s, e, c in device_events
           if _is_work(n) and e > lo and s < hi]
    intervals = [(s, e) for _, s, e, _ in dev]
    by_name = {}
    for n, s, e, _ in dev:
        by_name[n[:NAME_CHARS]] = by_name.get(n[:NAME_CHARS], 0.0) + (e - s) / 1e6
    idle = sorted(gaps(intervals, lo, hi), key=lambda g: g[0] - g[1])[:TOP]
    named = []
    for g0, g1 in idle:
        best, key = "host, outside any torch operation", None
        for n, s, e in host_events:
            overlap = min(e, g1) - max(s, g0)
            if overlap > 0 and (key is None or (overlap, s - e) > key):
                best, key = n, (overlap, s - e)
        named.append([best[:NAME_CHARS], (g1 - g0) / 1e6])
    return {
        "busy_s": union_s(intervals),
        "window_s": (hi - lo) / 1e6,
        "kernel_s": sum(e - s for _, s, e, c in dev if c == KERNEL) / 1e6,
        "device_ops": sorted(([n, t] for n, t in by_name.items()), key=lambda x: -x[1])[:TOP],
        "idle_gaps": named,
    }


KERNEL = "kernel"
DEVICE_CATEGORIES = (KERNEL, "gpu_memcpy", "gpu_memset")


def read_chrome_trace(path):
    """``(device_events, host_events, window)`` of a trace that
    ``torch.profiler`` exported: device events are kernels, copies and sets,
    each with its category, host events the torch operations, and the window
    the host's ``bench.window`` range."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device, host, window = [], [], None
    for e in events:
        if e.get("ph") != "X":
            continue
        item = (e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
        cat = e.get("cat")
        if cat in DEVICE_CATEGORIES:
            device.append((*item, cat))
        elif cat == "cpu_op":
            host.append(item)
        elif cat == "user_annotation" and e["name"] == WINDOW:
            window = item[1:]
    return device, host, window


@contextlib.contextmanager
def profiled(enabled):
    """Yields a holder whose ``summary`` is set when the block ends: the
    block runs under ``torch.profiler`` (host and CUDA activity) with the
    window marked, or bare when not ``enabled`` (``summary`` stays None).
    The trace goes through a file in the temporary directory, deleted after."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    holder = type("Traced", (), {"summary": None})()
    if not enabled:
        yield holder
        return
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            yield holder
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        holder.summary = summarise(*read_chrome_trace(path))
    finally:
        os.remove(path)


def idle_percent(summary):
    """``100 * (1 - busy / window)`` of a :func:`summarise` result, or None."""
    if summary is None or summary["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
