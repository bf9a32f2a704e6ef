"""Mean number of times an ensemble call makes the host wait for the
device: the ``host_syncs`` counter of its trace (``fit_info_["trace"]``),
each copy between host and device and each value read back. None where no
call kept a trace."""


def read(rec):
    traces = [info["trace"] for info in rec.infos if info and "trace" in info]
    if not traces:
        return None
    return sum(t["counters"].get("host_syncs", 0) for t in traces) / len(traces)
