"""Where the sparse passes' time goes past 256 topics: the wide walk of
``csrc/em_sparse_wide.cu`` on one NVIDIA GPU, at the corpus of the benchmark
cell ``nytimes-k1000.fit-wide`` (UCI NYTimes's shape, 69.7 M nonzeros, made
on the card from ``--seed`` by the benchmark's generator).

    PYTHONPATH=. python3 scripts/torch_wide_walk.py [--seed N] [--out chiprun_out/torch_wide_walk.json]

With the corpus staged by ``prepare_sell`` and factors drawn on the card
(rows normalised, kp topics):

* ``passes``: for kp = 256 (the lane-group walk's widest, for comparison),
  264, 512, 1000, 1024 and 2048 at the chosen shape (``walk_shape``), and at
  kp = 1000 also at TPL = 64, the CUDA-event mean of ``--reps`` warm
  launches of the word pass and the doc pass as the EM step launches them
  (no threshold, LL off), the doc pass with the LL (the test's sweep) and,
  at kp = 1000, both passes thresholded at 1e-16; each with the gathered
  rows' bytes (nnz x kp x 4) over its time and its split between the segment
  kernel and the owner reduction (``torch.profiler``);
* ``step``: ``sell.em_step_sell`` at kp = 1000 (both passes and the rows'
  normalisation), CUDA events, and the device memory it holds at its peak
  over the staged layout and factors;
* ``reference``: one pass of ``benchmark/reference/plsa_wide.py``'s
  ``em_pass`` at k = 1000, float64 and its bf16r control, to a synchronise;
* ``bound_ms``: ``benchmark/roofline.py``'s least time of a step;
* ``ptxas``: registers and spill stores of each ``wide_walk_segments`` and
  ``wide_walk_reduce`` instance.

Prints the card's name and power limit, then one JSON line, which it also
writes to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT)]

import enstop_torch  # noqa: E402
from enstop_torch.ops import _build, cuda_sparse, sell  # noqa: E402

KPS = (256, 264, 512, 1000, 1024, 2048)
CELL = "nytimes-k1000.fit-wide"


def cuda_ms(fn, reps):
    """CUDA-event mean ms of ``reps`` calls of ``fn`` after a warm one."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def split_ms(fn, reps):
    """Device ms a call in the segment kernels and the owner reductions."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for event in prof.key_averages():
        total = getattr(event, "device_time_total", None) or getattr(event, "cuda_time_total", 0)
        for kernel in ("wide_walk_segments", "wide_walk_reduce", "segment_pass",
                       "reduce_segments"):
            if kernel in event.key:
                split[kernel + "_ms"] = split.get(kernel + "_ms", 0.0) + total / 1e3 / reps
    return split or "not measured"


def factors(n, m, kp, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    zd = torch.rand((n, kp), generator=g, device="cuda") + 0.01
    wzT = torch.rand((m, kp), generator=g, device="cuda") ** 4 + 1e-4
    return zd / zd.sum(1, keepdim=True), (wzT / wzT.sum(0, keepdim=True)).contiguous()


def at_shape(shape, fn):
    """``fn()`` with the walk shape forced to ``shape`` (None: the chosen one)."""
    picked = cuda_sparse.walk_shape
    if shape is not None:
        cuda_sparse.walk_shape = lambda kp: shape
    try:
        return fn()
    finally:
        cuda_sparse.walk_shape = picked


def time_passes(prep, kp, reps, shape=None, thresh=False):
    zd, wzT = factors(prep.n, prep.m, kp, seed=kp)
    w = torch.ones(prep.n, device="cuda")
    gathered = prep.nnz * kp * 4
    t = 1e-16 if thresh else None
    calls = {
        "word": lambda: cuda_sparse.word_pass(prep.word, zd, wzT, w, t, compute_ll=False),
        "doc": lambda: cuda_sparse.doc_pass(prep.doc, zd, wzT, w, t, compute_ll=False),
    }
    if not thresh:
        calls["doc_ll"] = lambda: cuda_sparse.doc_pass(prep.doc, zd, wzT, w, compute_ll=True)
    row = {"shape": list(shape or cuda_sparse.walk_shape(kp))}
    for name, fn in calls.items():
        ms = at_shape(shape, lambda: cuda_ms(fn, reps))
        row[name + "_ms"] = ms
        row[name + "_gathered_GB_per_s"] = gathered / ms / 1e6
        row[name + "_split"] = at_shape(shape, lambda: split_ms(fn, 2))
    return row


def ptxas():
    from chip_smoke import ptxas_instances, wide_instance

    report = _build.BUILD_LOG.get("em_sparse_wide", {}).get("report", "")
    found = {wide_instance(name): {"registers": regs, "spill_store_bytes": spill}
             for name, (regs, spill) in ptxas_instances(report).items() if wide_instance(name)}
    return found or "library built before this run"


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=2_400_210_001)
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--out", default="chiprun_out/torch_wide_walk.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    import roofline
    from harness import find_cell
    from inputs import make_corpus

    t0 = time.perf_counter()
    _build.library("em_sparse_wide")
    out = {"card": smi, "torch": torch.__version__, "nvcc_s": time.perf_counter() - t0,
           "ptxas": ptxas()}
    cell = find_cell(CELL)
    X = make_corpus(cell, args.seed, "cuda")["train"]
    prep = enstop_torch.prepare_sell(X, standardize=False, device="cuda")
    out["corpus"] = {"n": prep.n, "m": prep.m, "nnz": prep.nnz,
                     "word_segments": prep.word.n_seg, "doc_segments": prep.doc.n_seg}
    out["bound_ms"] = {kp: 1e3 * roofline.em_step_least_s(prep.nnz, prep.n, prep.m, kp)
                       for kp in KPS}
    out["passes"] = {}
    for kp in KPS:
        out["passes"][f"kp{kp}"] = time_passes(prep, kp, args.reps)
        print(json.dumps({f"kp{kp}": out["passes"][f"kp{kp}"]}), flush=True)
    out["passes"]["kp1000_TPL64"] = time_passes(prep, 1000, args.reps, shape=(32, 64))
    out["passes"]["kp1000_thresh"] = time_passes(prep, 1000, args.reps, thresh=True)

    zd, wzT = factors(prep.n, prep.m, 1000, seed=1)
    wz = wzT.t().contiguous()
    del wzT
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(lambda: sell.em_step_sell(prep, zd, wz, compute_ll=False), args.reps)
    out["step"] = {"kp": 1000, "ms": step_ms,
                   "peak_over_inputs_GiB": (torch.cuda.max_memory_allocated() - base) / 2**30,
                   "layout_and_factors_GiB": base / 2**30}
    del zd, wz
    print(json.dumps({"step": out["step"]}), flush=True)

    from reference import plsa_wide

    corpus = plsa_wide.corpus_of(X, 1000, "cuda")
    zd0, wz0 = plsa_wide.random_init(prep.n, prep.m, 1000, 7)
    out["reference"] = {"doc_blocks": len(corpus.doc_blocks),
                        "word_blocks": len(corpus.word_blocks)}
    for mode, dtype in (("exact", torch.float64), ("bf16r", torch.float32)):
        zd, wz = (torch.as_tensor(a).to("cuda", dtype) for a in (zd0, wz0))
        for rep in ("first", "second"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plsa_wide.em_pass(corpus, zd, wz, mode=mode)
            torch.cuda.synchronize()
            out["reference"][f"{mode}_{rep}_pass_s"] = time.perf_counter() - t0
        del zd, wz
    print(json.dumps({"reference": out["reference"]}), flush=True)
    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
