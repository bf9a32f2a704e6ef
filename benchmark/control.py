"""Readings for the limits of ``correct``, on the chip at a cell's own size.

    python benchmark/control.py --workload <cell> --seeds <a> <b> ... [--calls N]
        [--control-calls M] [--out FILE]

For each seed: a run of the program (``--calls`` calls, then the check) and
a run of the cell's control in the program's place (the traffic's
``control``: the program's own lower-precision path, or the reference in
bfloat16), each judged against the float64 reference exactly as a run of
``run.py`` is. Prints one JSON line a run and appends it to ``--out``. The
benchmark's own runs never run the control.
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


def main():
    parser = argparse.ArgumentParser(description="Readings of the program and its control.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--calls", type=int, default=None)
    parser.add_argument("--control-calls", type=int, default=None)
    parser.add_argument("--out", required=True)
    args = parser.parse_args()

    import torch

    from harness import find_cell, run

    if not torch.cuda.is_available():
        raise SystemExit("control.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = find_cell(args.workload)
    calls = args.calls or int(cell.traffic["check"]["sample"])
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    for seed in args.seeds:
        for variant, n in ((None, calls), ("control", args.control_calls or calls)):
            t0 = time.perf_counter()
            result = run(cell, seed, 0.0, variant=variant, max_calls=n, all_checks=True)
            line = {"workload": cell.name, "seed": seed, "variant": variant or "program",
                    "calls": n, "correct": result["correct"], "seconds": time.perf_counter() - t0,
                    "checks": {k: v["value"] for k, v in result["checks"].items()}}
            print(json.dumps(line), flush=True)
            with out.open("a") as f:
                f.write(json.dumps(line) + "\n")


if __name__ == "__main__":
    main()
