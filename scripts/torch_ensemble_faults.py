"""The ensemble cells' check under each planted fault, on the card at the
cells' own size: the upper ends of the limits that the precision control
does not reach.

    python3 scripts/torch_ensemble_faults.py --workload <cell> --seeds a b ... [--out FILE]

For each seed: the cell's corpus and one warm call (the entry's set-up),
then for each fault of ``benchmark/tests/test_harness_ensemble.py`` (the
layout's rows shuffled, two clusters' labels merged, the merge a plain mean,
the refit against the stack's first topics) one call of the program with
the fault planted underneath the entry, and the entry's check of it, every
number it computes. The faults leave the runs as they are, so the check
judges no run here (``check.runs`` 0). One JSON line a fault, printed and
appended to ``--out``; needs a CUDA device.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT), str(ROOT / "benchmark" / "tests")]

from harness import find_cell, load  # noqa: E402
from inputs import Reservoir  # noqa: E402
from test_harness_ensemble import (_labels_off_by_one_merge, _plain_mean,  # noqa: E402
                                   _refit_on_first_topics, _shuffled_layout)

FAULTS = (_shuffled_layout, _labels_off_by_one_merge, _plain_mean, _refit_on_first_topics)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--out", required=True)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_ensemble_faults.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = find_cell(args.workload)
    cell.traffic["check"]["runs"] = 0
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    for seed in args.seeds:
        entry = load(cell.root, "entries", cell.traffic["entry"]).Entry(cell, seed, "cuda")
        entry.setup()
        for i, fault in enumerate(FAULTS):
            entry.infos, entry.kept = [], Reservoir(1, seed)
            with pytest.MonkeyPatch.context() as mp:
                judged = fault(mp)
                rs = entry.prepare(i)
                entry.keep(i, rs, entry.call(rs))
            t0 = time.perf_counter()
            checks = entry.check()
            line = {"workload": cell.name, "seed": seed, "fault": fault.__name__.strip("_"),
                    "judged": judged, "seconds": time.perf_counter() - t0, "checks": checks}
            print(json.dumps(line), flush=True)
            with out.open("a") as f:
                f.write(json.dumps(line) + "\n")


if __name__ == "__main__":
    main()
