"""The ensemble's runs on the batched kernel, step by step, on the card.

    PYTHONPATH=. python3 scripts/torch_ensemble_batch.py [--seed N] [--cell NAME]

On the corpus of an ensemble cell of ``BENCHMARK.json`` (by default
``20ng-k20.ensemble``), made from the seed by the benchmark's generator and
staged as ``EnsembleTopics`` stages it (``ops/driver.py`` ``_staged``):

1. the staging's device high-water over the layout it leaves, and the
   groups ``PreparedCounts._run_groups`` cuts the cell's runs into;
2. CUDA-event times of one run's EM step, with its LL (``em_ll``, the step
   after a test point) and without (``em``), and of the batched step in
   place (``cuda_batch.batched_em_step_``) at R = 1-16 runs, with its
   parts: the word pass, the row pass and the rest (the normalisation and
   the transpose), each alone;
3. the device high-water of a batched step at each R over what its tables
   hold, and of a test point (the R runs' ``em_ll`` steps, their next
   factors held until the test), a run's share of each from R = 1 to 16;
4. the host's draw of one run's inputs (``bootstrap_inputs``), its wall.

Writes ``chiprun_out/torch_ensemble_batch.json``; needs a CUDA device.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT)]

from enstop_torch.models import ensemble as ens  # noqa: E402
from enstop_torch.ops import cuda_batch  # noqa: E402
from enstop_torch.ops.driver import _staged  # noqa: E402
from harness import find_cell  # noqa: E402
from inputs import make_corpus  # noqa: E402

SIZES = (1, 2, 4, 5, 6, 8, 12, 16)
REPS = 20


def cuda_ms(fn, reps=REPS):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def high_water(fn):
    """Device bytes ``fn`` holds at most above what was allocated before it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=2400171100)
    parser.add_argument("--cell", default="20ng-k20.ensemble")
    parser.add_argument("--out", default="chiprun_out/torch_ensemble_batch.json")
    args = parser.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = find_cell(args.cell)
    k, n_runs = int(cell.config["n_components"]), int(cell.traffic["estimator"]["n_starts"])
    X = make_corpus(cell, args.seed, "cuda")["train"].astype(np.float32)
    out = {"card": torch.cuda.get_device_name(0), "torch": torch.__version__,
           "cell": args.cell, "nnz": int(X.nnz)}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    prep = _staged(X, device="cuda", counts=True)
    torch.cuda.synchronize()
    layout = torch.cuda.memory_allocated() - base
    out["layout_bytes"] = layout
    out["staging_over_layout_bytes"] = torch.cuda.max_memory_allocated() - base - layout
    out["groups"] = prep._run_groups(k, n_runs)
    n_pad, kp, m_pad = prep._padded(k)
    out["shapes"] = {"n_pad": n_pad, "kp": kp, "m_pad": m_pad, "n_seg": prep.word.n_seg}
    print(json.dumps(out), flush=True)

    t0 = time.perf_counter()
    runs = list(ens.bootstrap_inputs(prep, k, max(SIZES), np.random.RandomState(0)))
    torch.cuda.synchronize()
    out["draw_ms_per_run"] = 1e3 * (time.perf_counter() - t0) / max(SIZES)
    steps = prep._steps("default", "")
    Xd, word = prep.device_array, prep.word
    zd, wz, w = runs[0]
    out["single_ms"] = {name: cuda_ms(lambda: steps[name](Xd, zd, wz, w))
                        for name in ("em", "em_ll")}
    out["single_bytes"] = {name: high_water(lambda: steps[name](Xd, zd, wz, w))
                           for name in ("em", "em_ll")}
    batched = {}
    for R in SIZES:
        zds = torch.stack([r[0] for r in runs[:R]])
        wzs = torch.stack([r[1] for r in runs[:R]])
        ws = torch.stack([r[2] for r in runs[:R]])
        wzT = wzs.transpose(1, 2).contiguous()
        # the step in place: the tables' values drift from step to step, which
        # moves no time
        step_ms = cuda_ms(lambda: cuda_batch.batched_em_step_(Xd, zds, wzs, wzT, ws, word))
        words_ms = cuda_ms(lambda: cuda_batch.batch_words(word, zds, wzT, ws))
        rows_ms = cuda_ms(lambda: cuda_batch.batch_rows(Xd, zds, wzT))
        step_bytes = high_water(lambda: cuda_batch.batched_em_step_(Xd, zds, wzs, wzT, ws, word))
        test_bytes = high_water(lambda: [steps["em_ll"](Xd, zds[j], wzs[j], ws[j])
                                         for j in range(R)])
        tables = sum(t.numel() * t.element_size() for t in (zds, wzs, wzT, ws))
        batched[R] = {"step_ms": step_ms, "per_run_step_ms": step_ms / R,
                      "word_pass_ms": words_ms, "row_pass_ms": rows_ms,
                      "rest_ms": step_ms - words_ms - rows_ms, "tables_bytes": tables,
                      "step_bytes": step_bytes, "test_point_bytes": test_bytes}
        print(R, json.dumps(batched[R]), flush=True)
        del zds, wzs, ws, wzT
    out["batched"] = batched
    lo, hi = batched[min(SIZES)], batched[max(SIZES)]
    span = max(SIZES) - min(SIZES)
    out["per_run_bytes"] = {
        part: ((hi["tables_bytes"] + hi[part]) - (lo["tables_bytes"] + lo[part])) / span
        for part in ("step_bytes", "test_point_bytes")}
    print(json.dumps({key: out[key] for key in ("draw_ms_per_run", "single_ms", "single_bytes",
                                                "per_run_bytes")}), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
