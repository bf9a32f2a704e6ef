"""The rate of the corpus's copy to the device, in GB/s (1e9 bytes): the
``bytes`` of every ``stage.copy`` span of the fits (``fit_info_["trace"]``)
over the sum of their seconds, the host's wait for the pageable copies
included. None where no fit kept a trace with a copy."""


def read(rec):
    copies = [s for info in rec.infos if info and "trace" in info
              for s in info["trace"]["spans"] if s["name"] == "stage.copy"]
    seconds = sum(s["end"] - s["start"] for s in copies)
    if seconds <= 0:
        return None
    return sum(s["attrs"]["bytes"] for s in copies) / seconds / 1e9
