"""Seconds a fit call: from the window's start to the end of the
last call, over the calls (the call under way at the close counts)."""


def read(rec):
    if not rec.calls:
        return None
    loops = [i["wall_time_s"] for i in rec.infos if i]
    if loops:
        rec.log(f"fits: {len(rec.calls)}; EM loop mean {sum(loops) / len(loops):.5f} s")
    return (rec.calls[-1][2] - rec.window_start) / len(rec.calls)
