"""The whole EM step's share of the chip's peak, in %: the algorithm's least
time for one iteration (``roofline.py``) over the program's mean time a step
(``fit_info_`` ``wall_time_s / n_steps``, the loop to its readback)."""

import roofline


def read(rec):
    infos = [i for i in rec.infos if i]
    if not infos:
        return None
    least = roofline.em_step_least_s(**rec.counts)
    return 100.0 * least * sum(i["n_steps"] for i in infos) / sum(i["wall_time_s"] for i in infos)
