"""Where a fit's time goes, by the program's spans, on the card.

    PYTHONPATH=. python3 scripts/torch_trace_spans.py [--seed N] [--cells a,b] [--fits U T]

For each benchmark cell named (``BENCHMARK.json``; by default
``20ng-k20.fit`` and ``nytimes-k20.fit-sparse``), on the cell's corpus made
from the seed by the benchmark's generator:

1. the synchronisations ``torch.cuda.set_sync_debug_mode("warn")`` reports
   over one fit, by the package's source line that reached each, beside the
   fit's ``host_syncs`` counter;
2. untraced fits: the host's clock around each ``fit``, ``wall_time_s`` and
   the mean of each span of ``fit_info_["trace"]``; the share of the time
   outside the loop that ``validate``, ``stage``, ``init`` and ``finish``
   cover, and the ``stage.copy`` rate;
3. traced windows (``torch.profiler``, CPU and CUDA activity) in turns with
   and without the spans' ``record_function`` ranges (``TURNS``): the mean
   fit in each, the cost of the ranges (the ratio of the medians); from the
   first, the device's idle time by innermost span
   (``profiling.idle_by_span``) and the longest idle gaps, each named by the
   torch operation that overlaps it most (the benchmark's label) and split
   by the innermost ``enstop.*`` range;
4. the host cost of the spans alone: a request of 10 spans and 25 counts.

Writes ``chiprun_out/torch_trace_spans.json``; needs a CUDA device.
"""

import argparse
import json
import statistics
import sys
import tempfile
import time
import traceback
import warnings
from collections import Counter
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT)]

import enstop_torch  # noqa: E402
from enstop_torch import profiling  # noqa: E402
from harness import find_cell  # noqa: E402
from inputs import make_corpus, random_state  # noqa: E402

OUTSIDE = ("validate", "stage", "init", "finish")
TOP = 10
TURNS = (True, False, False, True, True, False, False, True)  # ranges on or off


def _model(cell, rs):
    return getattr(enstop_torch, cell.traffic["estimator_class"])(
        **cell.traffic["estimator"], n_components=int(cell.config["n_components"]),
        device="cuda", random_state=rs)


def _fit(cell, X, rs):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = _model(cell, rs).fit(X)
    return time.perf_counter() - t0, model.fit_info_


def _site(stack):
    """Where a synchronisation came from: the innermost frame of the package,
    and the frame that made it where that lies outside the package."""
    while stack and stack[-1].filename.endswith("warnings.py"):
        stack = stack[:-1]
    ours = [f for f in stack if "enstop_torch" in f.filename]
    site = f"{ours[-1].filename.split('enstop_torch/')[-1]}:{ours[-1].lineno}" if ours else "?"
    last = stack[-1]
    if ours and last is ours[-1]:
        return site
    return f"{site} via {last.filename.rsplit('/', 1)[-1]}:{last.lineno} ({last.name})"


def sync_sites(cell, X, seed):
    """Debug-mode synchronisations of one fit by the package's source line
    that reached each, and the counter."""
    model = _model(cell, random_state(seed, 100))
    torch.cuda.synchronize()
    sites = Counter()

    def show(message, *args, **kwargs):
        if "called a synchronizing" in str(message):
            sites[_site(traceback.extract_stack()[:-1])] += 1

    shown = warnings.showwarning
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            model.fit(X)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            warnings.showwarning = shown
    return {"debug_mode": sum(sites.values()), "sites": dict(sorted(sites.items())),
            "host_syncs": model.fit_info_["trace"]["counters"]["host_syncs"]}


def span_means(infos):
    """Mean seconds a fit of each span name."""
    total = Counter()
    for info in infos:
        for s in info["trace"]["spans"]:
            total[s["name"]] += s["end"] - s["start"]
    return {name: t / len(infos) for name, t in total.items()}


def untraced(cell, X, seed, n):
    walls, infos = [], []
    for i in range(n):
        wall, info = _fit(cell, X, random_state(seed, i))
        walls.append(wall)
        infos.append(info)
    means = span_means(infos)
    outside = statistics.mean(w - i["wall_time_s"] for w, i in zip(walls, infos))
    copies = [s for i in infos for s in i["trace"]["spans"] if s["name"] == "stage.copy"]
    return {
        "fits": n, "fit_s": statistics.mean(walls), "fit_s_all": walls,
        "wall_time_s": statistics.mean(i["wall_time_s"] for i in infos),
        "outside_loop_ms": 1e3 * outside,
        "spans_ms": {k: 1e3 * v for k, v in means.items()},
        "covered": sum(means.get(k, 0.0) for k in OUTSIDE) / outside,
        "h2d_gbps": sum(s["attrs"]["bytes"] for s in copies)
        / sum(s["end"] - s["start"] for s in copies) / 1e9,
        "host_syncs": statistics.mean(i["trace"]["counters"]["host_syncs"] for i in infos),
    }


def _events(path):
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def _overlap_name(events, g0, g1):
    """The name of the event that overlaps ``[g0, g1]`` most (the shortest of equals)."""
    best, key = None, None
    for name, s, e in events:
        overlap = min(e, g1) - max(s, g0)
        if overlap > 0 and (key is None or (overlap, s - e) > key):
            best, key = name, (overlap, s - e)
    return best


def longest_gaps(path):
    """The ``TOP`` longest idle gaps of the device, each with the torch
    operation that overlaps it most (the benchmark's label) and its split by
    innermost ``enstop.*`` range."""
    events = _events(path)
    busy = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))) for e in events
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    lo = min(float(e["ts"]) for e in events)
    hi = max(float(e["ts"]) + float(e.get("dur", 0)) for e in events)
    gaps, cur = [], lo
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    gaps.append((cur, hi))
    ops = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
           for e in events if e.get("cat") == "cpu_op"]
    ranges = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
              for e in events if e.get("cat") == "user_annotation"
              and e["name"].startswith("enstop.")]
    out = []
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]:
        out.append({"ms": (g1 - g0) / 1e3, "torch_op": _overlap_name(ops, g0, g1),
                    "spans_ms": _innermost_split(ranges, g0, g1)})
    return out


def _innermost_split(ranges, g0, g1):
    """``[g0, g1]``'s milliseconds by the innermost range that holds each part
    (the latest started), ``"none"`` outside every range."""
    cuts = sorted({g0, g1, *(t for _, s, e in ranges for t in (s, e) if g0 < t < g1)})
    split = Counter()
    for a, b in zip(cuts, cuts[1:]):
        held = [(s, n) for n, s, e in ranges if s <= a and e >= b]
        split[max(held)[1][len("enstop."):] if held else "none"] += (b - a) / 1e3
    return dict(split.most_common())


def traced_window(cell, X, seed, n, ranges, keep):
    """Mean fit in a window under ``torch.profiler``, with or without the
    spans' ranges; with ``keep``, the idle split and the longest gaps."""
    profiled = profiling._profiler_enabled
    if not ranges:
        profiling._profiler_enabled = lambda: False
    walls = []
    try:
        with tempfile.TemporaryDirectory() as tmp:
            with profiling.trace(tmp):
                for i in range(n):
                    walls.append(_fit(cell, X, random_state(seed, 1000 + i))[0])
                torch.cuda.synchronize()
            out = {"ranges": ranges, "fits": n, "fit_s": statistics.mean(walls)}
            if keep:
                (path,) = Path(tmp).glob("*.pt.trace.json")
                out["idle_by_span"] = profiling.idle_by_span(path)
                out["longest_gaps"] = longest_gaps(path)
    finally:
        profiling._profiler_enabled = profiled
    return out


def span_cost(n=2000):
    """Seconds of a request of 10 spans and 25 counts, with no profiler."""
    t0 = time.perf_counter()
    for _ in range(n):
        with profiling.request("fit"):
            for name in ("validate", "stage", "stage.coo", "stage.copy", "stage.layout",
                         "init", "loop", "readback", "finish"):
                with profiling.span(name):
                    profiling.count("host_syncs")
            for _ in range(16):
                profiling.count("host_syncs")
    return (time.perf_counter() - t0) / n


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=2300000041)
    parser.add_argument("--cells", default="20ng-k20.fit,nytimes-k20.fit-sparse")
    parser.add_argument("--fits", type=int, nargs=2, default=None,
                        metavar=("UNTRACED", "TRACED"),
                        help="fits untraced and in each traced window (default: 20 and 15 "
                             "on the dense path, 5 and 2 on the sparse)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    report = {"device": torch.cuda.get_device_name(0), "torch": torch.__version__,
              "seed": args.seed, "span_cost_s": span_cost(), "cells": {}}
    for name in args.cells.split(","):
        cell = find_cell(name, ROOT)
        X = make_corpus(cell, args.seed, "cuda")["train"]
        dense = cell.traffic["estimator"].get("backend") != "sparse"
        n_untraced, n_traced = args.fits or ((20, 15) if dense else (5, 2))
        _fit(cell, X, random_state(args.seed, -1))  # warm: builds the kernels
        out = {"nnz": int(X.nnz), "sync": sync_sites(cell, X, args.seed),
               "untraced": untraced(cell, X, args.seed, n_untraced)}
        out["traced"] = [traced_window(cell, X, args.seed, n_traced, ranges, keep=i == 0)
                         for i, ranges in enumerate(TURNS)]
        on = [w["fit_s"] for w in out["traced"] if w["ranges"]]
        off = [w["fit_s"] for w in out["traced"] if not w["ranges"]]
        out["ranges_cost"] = statistics.median(on) / statistics.median(off) - 1
        report["cells"][name] = out
        print(name, json.dumps({k: v for k, v in out.items() if k != "traced"}), flush=True)
        print(name, "traced", json.dumps(out["traced"]), flush=True)
    Path("chiprun_out").mkdir(exist_ok=True)
    Path("chiprun_out/torch_trace_spans.json").write_text(json.dumps(report, indent=1))
    print("span_cost_s", report["span_cost_s"])


if __name__ == "__main__":
    main()
