"""Where an ensemble call's time goes, by the program's spans, on the card.

    PYTHONPATH=. python3 scripts/torch_ensemble_spans.py [--seed N] [--cells a,b] [--calls N]

For each ensemble cell of ``BENCHMARK.json`` named (by default
``20ng-k20.ensemble`` and ``nytimes-enstop-k20.ensemble-sparse``), on the
cell's corpus made from the seed by the benchmark's generator:

1. the synchronisations ``torch.cuda.set_sync_debug_mode("warn")`` reports
   over one call, by the package's source line that reached each, beside the
   call's ``host_syncs`` counter (``torch_trace_spans.sync_sites``);
2. untraced calls, each after the one before has been let go: the host's
   clock around each ``fit``, the mean of each span of ``fit_info_["trace"]``,
   the share of the call its top-level spans cover, the counters, the run
   steps, the peak device memory of a call, and the topic stack's bytes and
   the time of its copy to the host;
3. one traced call (``torch.profiler``, CPU and CUDA activity): the device's
   busy share and its idle time by innermost span
   (``profiling.idle_by_span``);
4. one call whose top-level spans (``validate``, ``staging``, ``runs``,
   ``combine``, ``refit``) each read the device's high-water of
   ``torch.cuda.max_memory_allocated`` while they ran, and what was allocated
   as each began, above what the call started from, with the counters
   ``em_steps`` and ``batched_run_steps`` (absent where the program has no
   such counter).

Writes ``chiprun_out/torch_ensemble_spans.json``; needs a CUDA device.
"""

import argparse
import json
import statistics
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT), str(ROOT / "scripts")]

from enstop_torch import profiling  # noqa: E402
from harness import find_cell  # noqa: E402
from inputs import make_corpus, random_state  # noqa: E402
from torch_trace_spans import _model, span_means, sync_sites  # noqa: E402

CELLS = ("20ng-k20.ensemble", "nytimes-enstop-k20.ensemble-sparse")


def untraced(cell, X, seed, n):
    walls, infos, peaks, copies, counters = [], [], [], [], Counter()
    for i in range(n):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        model = _model(cell, random_state(seed, i)).fit(X)
        walls.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated() - base)
        t0 = time.perf_counter()
        stack = model.topic_stack_.cpu()
        copies.append(time.perf_counter() - t0)
        info = model.fit_info_
        infos.append(info)
        counters.update(info["trace"]["counters"])
        stack_bytes = stack.numel() * stack.element_size()
        steps, n_stable = info["run_steps"], model.n_components_
        del model, stack
    top = [sum(s["end"] - s["start"] for s in i["trace"]["spans"] if s["parent"] == 0)
           / (i["trace"]["spans"][0]["end"] - i["trace"]["spans"][0]["start"]) for i in infos]
    return {
        "calls": n, "fit_s": statistics.mean(walls), "fit_s_all": walls,
        "spans_ms": {k: 1e3 * v for k, v in span_means(infos).items()},
        "covered": min(top), "counters": {k: v / n for k, v in counters.items()},
        "run_steps_last": steps, "n_components_last": n_stable,
        "peak_gib": max(peaks) / 2**30, "stack_bytes": stack_bytes,
        "stack_copy_ms": [1e3 * c for c in copies],
    }


def traced(cell, X, seed):
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp):
            torch.cuda.synchronize()
            _model(cell, random_state(seed, 500)).fit(X)
            torch.cuda.synchronize()
        (path,) = Path(tmp).glob("*.pt.trace.json")
        idle = profiling.idle_by_span(path)
    idle["busy_share"] = 1.0 - idle["idle_s"] / idle["window_s"]
    return idle


def span_peaks(cell, X, seed):
    """Each top-level span's device high-water over the call's start, in
    bytes: the peak statistics are reset as each such span begins and read as
    it ends (the card waits at both)."""
    cls = profiling._Span
    enter, exit_ = cls.__enter__, cls.__exit__
    base, peaks = None, {}

    def top(span):
        return span.request is not None and span.parent == 0

    def entered(span):
        if top(span):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            peaks[span.name] = {"at_start": torch.cuda.memory_allocated() - base}
        return enter(span)

    def exited(span, *exc):
        out = exit_(span, *exc)
        if top(span):
            torch.cuda.synchronize()
            peaks[span.name]["peak"] = torch.cuda.max_memory_allocated() - base
        return out

    model = _model(cell, random_state(seed, 300))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    cls.__enter__, cls.__exit__ = entered, exited
    try:
        model.fit(X)
    finally:
        cls.__enter__, cls.__exit__ = enter, exit_
    counters = model.fit_info_["trace"]["counters"]
    return {"bytes": peaks, "counters": {k: counters.get(k) for k in
                                         ("em_steps", "batched_run_steps", "runs")}}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=2400171100)
    parser.add_argument("--cells", default=",".join(CELLS))
    parser.add_argument("--calls", type=int, default=3)
    parser.add_argument("--out", default="chiprun_out/torch_ensemble_spans.json")
    args = parser.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"card": torch.cuda.get_device_name(0), "torch": torch.__version__}
    for name in args.cells.split(","):
        cell = find_cell(name)
        X = make_corpus(cell, args.seed, "cuda")["train"]
        t0 = time.perf_counter()
        _model(cell, random_state(args.seed, -1)).fit(X)  # the kernels built and warm
        rec = {"first_call_s": time.perf_counter() - t0, "nnz": X.nnz}
        rec["syncs"] = sync_sites(cell, X, args.seed)
        print(name, "syncs:", json.dumps(rec["syncs"]), flush=True)
        rec["untraced"] = untraced(cell, X, args.seed, args.calls)
        print(name, "untraced:", json.dumps(rec["untraced"]), flush=True)
        rec["traced"] = traced(cell, X, args.seed)
        print(name, "traced:", json.dumps(rec["traced"]), flush=True)
        rec["span_peaks"] = span_peaks(cell, X, args.seed)
        print(name, "span peaks:", json.dumps(rec["span_peaks"]), flush=True)
        out[name] = rec
        del X
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
