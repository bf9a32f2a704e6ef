"""Mean ms of an ensemble call's ``refit`` span: every document's ``P(z|d)``
fitted against the stable topics, on the program's clock
(``fit_info_["trace"]``). None where no call kept a trace."""


def read(rec):
    traces = [info["trace"] for info in rec.infos if info and "trace" in info]
    if not traces:
        return None
    return 1e3 * sum(s["end"] - s["start"] for t in traces for s in t["spans"]
                     if s["name"] == "refit") / len(traces)
