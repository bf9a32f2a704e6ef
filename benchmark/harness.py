"""Run one cell of ``BENCHMARK.json`` once.

A cell names a configuration (``benchmark/configs/<config>.json``: the
corpus and the topic count) and a traffic mix
(``benchmark/traffic/<traffic>.json``: the entry of the program the window
drives, the estimator class and its parameters, the loop that offers the
calls, the reference and the limits of the check). Each piece is a file the
harness finds by its name: the entry ``benchmark/entries/<entry>.py``, the
loop ``benchmark/loops/<kind>.py``, each metric's reader
``benchmark/metrics/<metric>.py``, each corpus generator
``benchmark/corpora/<generator>.py``, each reference
``benchmark/reference/<reference>.py``; under the ``benchmark`` folder of
the root first and then under this one. A cell, a mix, an entry, a loop or
a metric is added by adding files.

A run: set-up (the entry makes its inputs from the seed and warms its
call), the harness's device memory freed, the peak reset and the objects
set-up made frozen out of the garbage collector's walks; then the loop
offers calls for ``seconds`` (a traced run's window lasts
``devtrace.MAX_TRACED_SECONDS`` at most), traced or not; then the check
against the plain reference on a sample of the answers drawn from the seed.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CLOSED_LOOP = {"kind": "closed"}


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


def find_file(root, kind, name, suffix):
    """``<kind>/<name><suffix>`` under ``root/benchmark`` or this folder."""
    for base in (Path(root) / "benchmark", BENCH):
        path = base / kind / f"{name}{suffix}"
        if path.is_file():
            return path
    raise FileNotFoundError(f"no {kind} file named {name}{suffix}")


def load_module(path):
    spec = importlib.util.spec_from_file_location(f"bench_{path.parent.name}_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load(root, kind, name):
    """The module ``<kind>/<name>.py`` (:func:`find_file`)."""
    return load_module(find_file(root, kind, name, ".py"))


def find_cell(name, root=ROOT):
    """The cell ``name`` of ``root/BENCHMARK.json``: its entry, configuration,
    traffic mix and the metrics it reports."""
    spec = json.loads((Path(root) / "BENCHMARK.json").read_text())
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"BENCHMARK.json has no workload {name!r}")
    conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
    end_to_end = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return SimpleNamespace(
        name=name, root=Path(root), chips=entry["chips"],
        config=json.loads((Path(root) / conf["file"]).read_text()),
        traffic=json.loads(find_file(root, "traffic", entry["traffic"], ".json").read_text()),
        end_to_end=end_to_end, per_layer=per_layer)


def read_metrics(cell, entries, rec):
    """``{name: {"value", "unit"}}`` of each entry whose reader finds something."""
    out = {}
    for m in entries:
        value = load(cell.root, "metrics", m["name"]).read(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def _free_device_memory(device, freeze=False):
    gc.collect()
    if freeze:  # what set-up made lives on: no collection in the window walks it
        gc.freeze()
    if device == "cuda":
        import torch

        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def run(cell, seed, seconds, trace=False, device="cuda", variant=None, max_calls=None,
        started=None, all_checks=False):
    """One run; returns the result dict (the last line a run prints).
    ``variant="control"`` puts the traffic's ``control`` in the program's
    place; ``max_calls`` fixes the number of calls instead of the time;
    ``all_checks`` reports every number the check computes, judged or not
    (limit None)."""
    from devtrace import MAX_TRACED_SECONDS, profiled

    started = time.perf_counter() if started is None else started
    entry = load(cell.root, "entries", cell.traffic["entry"]).Entry(cell, seed, device, variant)
    loop_spec = cell.traffic.get("loop", CLOSED_LOOP)
    loop = load(cell.root, "loops", loop_spec["kind"])
    t0 = time.perf_counter()
    entry.setup()
    log(f"set-up: {t0 - started:.2f} s to the entry's set-up, "
        f"{time.perf_counter() - t0:.2f} s in it")
    _free_device_memory(device, freeze=True)
    from enstop_torch.ops._build import BUILD_LOG, LAUNCHES

    log("nvcc:", {k: round(v["seconds"], 1) for k, v in BUILD_LOG.items()} or "every library "
        "was built before this run")
    launches0 = dict(LAUNCHES)
    if trace:
        seconds = min(seconds, MAX_TRACED_SECONDS)
    with profiled(trace) as traced:
        window_start = time.perf_counter()
        calls, failed = loop.drive(entry, loop_spec, seed, window_start + seconds, max_calls, log)
    peak = 0
    if device == "cuda":
        import torch

        peak = torch.cuda.max_memory_allocated()
    rec = SimpleNamespace(
        calls=calls, window_start=window_start, setup_s=window_start - started,
        infos=entry.infos, peak_bytes=peak, counts=entry.counts, trace=traced.summary,
        launches={k: LAUNCHES[k] - launches0.get(k, 0) for k in LAUNCHES}, log=log)
    if calls:
        ms = sorted(1e3 * (end - arrival) for arrival, _, end in calls)
        log(f"calls: {len(ms)}; ms p10 {ms[len(ms) // 10]:.3f}, p50 {ms[len(ms) // 2]:.3f}, "
            f"p90 {ms[9 * len(ms) // 10]:.3f}, max {ms[-1]:.3f}; launches "
            f"{ {k: v for k, v in rec.launches.items() if v} }")
    metrics = read_metrics(cell, cell.per_layer if trace else cell.end_to_end, rec)
    entry.release()
    gc.unfreeze()
    _free_device_memory(device)
    t0 = time.perf_counter()
    checks = entry.check() if calls else {}
    log(f"check: {time.perf_counter() - t0:.1f} s")
    limits = cell.traffic["limits"]
    result = {
        "correct": failed == 0 and bool(checks) and all(
            checks.get(k, float("inf")) <= limits[k] for k in limits),
        "attempted": len(calls) + failed, "failed": failed, "metrics": metrics,
        "device": {"platform": "gpu" if device == "cuda" else device,
                   "kind": _device_kind(device), "count": cell.chips,
                   "memory_peak_bytes": peak},
    }
    if traced.summary is not None:
        result["device"].update(busy_s=traced.summary["busy_s"],
                                window_s=traced.summary["window_s"])
        result["breakdown"] = {k: traced.summary[k] for k in ("device_ops", "idle_gaps")}
    result["checks"] = {k: {"value": checks.get(k), "limit": limits[k]}
                        for k in limits}
    if all_checks:
        result["checks"].update({k: {"value": v, "limit": None} for k, v in checks.items()
                                 if k not in limits})
    return result


def _device_kind(device):
    if device != "cuda":
        return device
    import torch

    return torch.cuda.get_device_name(0)
