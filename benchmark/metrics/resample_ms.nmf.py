"""Mean ms a call spends making its NMF runs' inputs: the seconds of every
run's ``runs.resample`` (the host's row resample) and ``runs.stage`` (the
run's start drawn on the host and copied up, and the resample staged on the
device), summed over the call's runs, on the program's clock
(``fit_info_["trace"]``). None where no call kept a trace with those spans."""

SPANS = ("runs.resample", "runs.stage")


def read(rec):
    traces = [info["trace"] for info in rec.infos if info and "trace" in info
              and any(s["name"] in SPANS for s in info["trace"]["spans"])]
    if not traces:
        return None
    return 1e3 * sum(s["end"] - s["start"] for t in traces for s in t["spans"]
                     if s["name"] in SPANS) / len(traces)
