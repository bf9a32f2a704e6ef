"""Mean ms of an ensemble call's ``staging`` span: the input cast, the
corpus's layout staged on the device once for every run, on the program's
clock (``fit_info_["trace"]``). None where no call kept a trace."""


def read(rec):
    traces = [info["trace"] for info in rec.infos if info and "trace" in info]
    if not traces:
        return None
    return 1e3 * sum(s["end"] - s["start"] for t in traces for s in t["spans"]
                     if s["name"] == "staging") / len(traces)
