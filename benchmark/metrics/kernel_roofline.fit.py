"""The fits' kernels against their roofline, in %: the least time of an EM
iteration (``roofline.py``) times the steps the traced fits ran, over the
seconds of the device's kernels in the traced window (``devtrace``'s
``kernel_s``: copies and sets, the front end's staging, left out)."""

import roofline


def read(rec):
    infos = [i for i in rec.infos if i]
    if rec.trace is None or not infos or rec.trace["kernel_s"] <= 0:
        return None
    least = roofline.em_step_least_s(**rec.counts)
    return 100.0 * least * sum(i["n_steps"] for i in infos) / rec.trace["kernel_s"]
