"""The device's idle share of the traced window, in %: 1 - the union of its
activity intervals over the window (``devtrace.py``)."""

import devtrace


def read(rec):
    return devtrace.idle_percent(rec.trace)
