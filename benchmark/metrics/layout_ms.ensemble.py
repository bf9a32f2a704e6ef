"""Mean ms of an ensemble call's ``combine.layout`` span: the UMAP layout of
the runs' topics (its graph, its spectral start and the SGD epochs), on the
program's clock (``fit_info_["trace"]``). None where no call kept a trace."""


def read(rec):
    traces = [info["trace"] for info in rec.infos if info and "trace" in info]
    if not traces:
        return None
    return 1e3 * sum(s["end"] - s["start"] for t in traces for s in t["spans"]
                     if s["name"] == "combine.layout") / len(traces)
