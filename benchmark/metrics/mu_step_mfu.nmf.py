"""The NMF runs' updates' share of the chip's peak, in %: the algorithm's
least time for one KL multiplicative update at the cell's counts
(``roofline_nmf.py``) times the runs' updates (the counter ``mu_steps``), over
the seconds of the ``runs.mu`` spans (the updates up to the factors read
back), summed over the calls (``fit_info_["trace"]``). None where no call
kept a trace with the counter."""

import roofline_nmf


def read(rec):
    traces = [info["trace"] for info in rec.infos
              if info and "trace" in info and "mu_steps" in info["trace"]["counters"]]
    seconds = sum(s["end"] - s["start"] for t in traces for s in t["spans"]
                  if s["name"] == "runs.mu")
    if seconds <= 0:
        return None
    steps = sum(t["counters"]["mu_steps"] for t in traces)
    return 100.0 * roofline_nmf.mu_step_least_s(**rec.counts) * steps / seconds
