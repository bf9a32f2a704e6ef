"""Mean ms of an ensemble call's ``combine`` span: the Hellinger distances,
the UMAP layout, HDBSCAN and the merge of the runs' topics, on the program's
clock (``fit_info_["trace"]``). None where no call kept a trace."""


def read(rec):
    traces = [info["trace"] for info in rec.infos if info and "trace" in info]
    if not traces:
        return None
    return 1e3 * sum(s["end"] - s["start"] for t in traces for s in t["spans"]
                     if s["name"] == "combine") / len(traces)
