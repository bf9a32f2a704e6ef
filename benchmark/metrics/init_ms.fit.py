"""Mean ms of a fit's ``init`` span: the initial factors drawn and padded on
the host, on the program's clock (``fit_info_["trace"]``). None where no fit
kept a trace."""


def read(rec):
    traces = [info["trace"] for info in rec.infos if info and "trace" in info]
    if not traces:
        return None
    return 1e3 * sum(s["end"] - s["start"] for t in traces for s in t["spans"]
                     if s["name"] == "init") / len(traces)
