"""The wide walk's kernels against their roofline, in %: the least time of an
EM iteration (``roofline.py``, at the cell's counts) times the steps the
traced fits ran, over the device seconds of the kernels of the sparse passes
past 256 topics (``csrc/em_sparse_wide.cu``: ``wide_walk_segments`` and
``wide_walk_reduce``), found by name in the trace's ``device_ops``. None
where the trace holds none of them (a program without the wide walk)."""

import roofline

KERNELS = ("wide_walk_segments", "wide_walk_reduce")


def read(rec):
    infos = [i for i in rec.infos if i]
    if rec.trace is None or not infos:
        return None
    seconds = sum(t for name, t in rec.trace["device_ops"] if any(k in name for k in KERNELS))
    if seconds <= 0:
        return None
    least = roofline.em_step_least_s(**rec.counts)
    return 100.0 * least * sum(i["n_steps"] for i in infos) / seconds
