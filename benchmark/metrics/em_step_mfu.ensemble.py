"""The bootstrap runs' share of the chip's peak, in %: the algorithm's least
time for one EM iteration (``roofline.py``) times the runs' EM steps (the
counter ``em_steps``), over the seconds of the ``runs`` span (the weights'
draws and copies, the inits and the tests' reads back included), summed
over the calls (``fit_info_["trace"]``). A weighted step does the work of an
unweighted one. None where no call kept a trace with the counter."""

import roofline


def read(rec):
    traces = [info["trace"] for info in rec.infos
              if info and "trace" in info and "em_steps" in info["trace"]["counters"]]
    seconds = sum(s["end"] - s["start"] for t in traces for s in t["spans"]
                  if s["name"] == "runs")
    if seconds <= 0:
        return None
    steps = sum(t["counters"]["em_steps"] for t in traces)
    return 100.0 * roofline.em_step_least_s(**rec.counts) * steps / seconds
