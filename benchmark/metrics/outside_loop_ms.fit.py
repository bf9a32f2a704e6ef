"""Mean ms of a fit spent outside its EM loop (input checks, staging, init,
unpadding): the harness's clock around ``fit`` minus the program's
``fit_info_["wall_time_s"]``."""


def read(rec):
    pairs = [(t1 - t0, info["wall_time_s"]) for (_, t0, t1), info in zip(rec.calls, rec.infos)
             if info]
    return 1e3 * sum(a - b for a, b in pairs) / len(pairs) if pairs else None
