"""The host phases of ``PLSA.fit`` in one checkout, by timers wrapped around
its functions, so that two checkouts (a parent and a change) can be held
against each other phase by phase on the card.

    python3 scripts/torch_fit_phases.py <checkout> [--cell 20ng-k20.fit] [--fits 25]

Imports ``enstop_torch`` and the benchmark's corpus generator from
``<checkout>``, makes the cell's corpus from a fixed seed, warms one fit,
then times ``--fits`` fits (the host's clock, the device synchronised before
each) and the median of each wrapped function a fit. Wraps those of its
functions that the checkout has (the staging function is ``_staged`` in one
checkout, ``_stage_or_reuse`` and ``_weights`` in an older one), so that it
needs no spans. Prints one JSON line; needs a CUDA device. Run it for each
checkout in turns.
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

WRAPPED = {"models.plsa": ("validate_corpus", "split_zero_rows", "plsa_fit"),
           "ops.driver": ("ship_coo", "word_side", "plsa_init", "_weights", "fit_padded",
                          "_stage_or_reuse", "_staged", "pad_factors")}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("checkout")
    parser.add_argument("--cell", default="20ng-k20.fit")
    parser.add_argument("--fits", type=int, default=25)
    parser.add_argument("--seed", type=int, default=2400000301)
    args = parser.parse_args()
    root = Path(args.checkout).resolve()
    sys.path[:0] = [str(root / "benchmark"), str(root)]

    import importlib

    import torch

    import enstop_torch
    from harness import find_cell
    from inputs import make_corpus, random_state

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    times = {}

    def timed(fn, name):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                times.setdefault(name, []).append(time.perf_counter() - t0)
        return wrapper

    for module, names in WRAPPED.items():
        mod = importlib.import_module(f"enstop_torch.{module}")
        for name in names:
            if hasattr(mod, name):
                setattr(mod, name, timed(getattr(mod, name), name))
    cell = find_cell(args.cell, root)
    X = make_corpus(cell, args.seed, "cuda")["train"]
    kw = dict(cell.traffic["estimator"], n_components=int(cell.config["n_components"]),
              device="cuda")
    getattr(enstop_torch, cell.traffic["estimator_class"])(**kw, random_state=1).fit(X)
    times.clear()
    walls = []
    for i in range(args.fits):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        getattr(enstop_torch, cell.traffic["estimator_class"])(
            **kw, random_state=random_state(5, i)).fit(X)
        walls.append(time.perf_counter() - t0)
    print(json.dumps({"checkout": root.name, "card": torch.cuda.get_device_name(0),
                      "fit_ms": 1e3 * statistics.median(walls),
                      **{k: 1e3 * statistics.median(v) for k, v in times.items()}}), flush=True)


if __name__ == "__main__":
    main()
