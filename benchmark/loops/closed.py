"""A closed loop of one client: each call is offered when the one before it
has returned, until ``end`` (the call under way then completes and counts)
or, where ``max_calls`` is given, for that many calls. A call that raises
ends the loop and counts as failed, with its traceback on standard error."""

import time
import traceback


def drive(entry, spec, seed, end, max_calls, log):
    """Returns ``(calls, failed)``: each call's ``(arrival, start, end)``
    host-clock seconds (here arrival is start) and the failed count."""
    calls = []
    while (len(calls) < max_calls if max_calls is not None
           else not calls or time.perf_counter() < end):
        i = len(calls)
        args = entry.prepare(i)
        try:
            t0 = time.perf_counter()
            out = entry.call(args)
            t1 = time.perf_counter()
        except Exception:
            log(traceback.format_exc())
            return calls, 1
        calls.append((t0, t0, t1))
        entry.keep(i, args, out)
    return calls, 0
