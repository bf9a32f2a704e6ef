"""The UMAP layout kernel (``enstop_torch/ops/csrc/umap_layout.cu``) on the card.

    PYTHONPATH=. python3 scripts/torch_umap_layout.py [--reps N]

1. Builds the kernel and prints the compiler's report (registers, spills).
2. The kernel against the CPU loop (the same epochs as a torch loop) after 1,
   5 and 20 epochs, at 50 and 320 points in 5 dimensions (one block, its
   positions in shared memory) and at 1,500 points in 20 (many blocks, in
   device memory): the largest gap of a
   coordinate over the largest coordinate, and whether the two give the same
   bits with b = 1 (where powf is exact).
3. Repeat launches bit for bit, and another seed moves the layout.
   How the kernel runs: at the ensemble's graph (320 points in 5 dimensions),
   at 1,500 in 20 and at the facade's sizes (``torch_umap_scale.py``'s graphs
   of 2,000, 5,000 and 10,000 points in 2 dimensions), the launch alone (CUDA
   events, a fresh start each launch) on one block with its positions and
   tables in shared memory (where they fit), on one block in device memory,
   on the blocks ``cuda_umap.blocks_for`` picks and on as many as the card
   holds at once; all of them the same bits.
4. At an ensemble-sized graph (320 topics: 20 groups of 16 noisy copies, 15
   neighbours, 500 epochs): the kernel alone (``torch.profiler``'s device time
   of the launch), a whole ``_optimize_layout_device`` call and ``umap_embed``
   by part on the host's clock, and the trustworthiness (k = 10) of the
   kernel's layout and of the host layout.
5. HDBSCAN's time (the combine's next stage, on the host) on that layout,
   started 0-400 ms after the spectral start's ``eigh``: how long the host
   stays slow after it.

Writes ``chiprun_out/torch_umap_layout.json``; needs a CUDA device.
"""

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests"), str(ROOT / "scripts")]

from enstop_torch.cluster import umap  # noqa: E402
from enstop_torch.cluster.hdbscan import HDBSCAN  # noqa: E402
from enstop_torch.ops import _build, cuda_umap  # noqa: E402
from plain_ensemble import trustworthiness  # noqa: E402
from test_torch_umap_layout import problem  # noqa: E402


def gap(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def launch_ms(packed, n, dim, epochs, a, b, seed, reps, **how):
    """The launch alone, on a fresh copy of ``packed`` each time (CUDA events)."""
    copies = [packed.clone() for _ in range(reps + 1)]
    cuda_umap.launch_layout(copies[0], n, dim, epochs, a, b, seed, **how)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for copy in copies[1:]:
        cuda_umap.launch_layout(copy, n, dim, epochs, a, b, seed, **how)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, cuda_umap.layout_of(copies[0], n, dim).cpu().numpy()


def variants(dev, reps):
    """Step 3's times of each way the kernel runs, by graph."""
    from torch_umap_scale import problem as scale_problem

    graphs = {"n320_d5": problem(2, 20, 16, 5)[1:3], "n1500_d20": problem(1, 60, 25, 20)[1:3]}
    with tempfile.TemporaryDirectory() as cache:
        for n in (2000, 5000, 10000):
            W, start = scale_problem(n, cache, umap)
            graphs[f"n{n}_d2"] = (start, W)
    a, b = umap.find_ab_params(1.0, 0.1)
    found = {}
    for label, (emb, W) in graphs.items():
        x, heads, tails, eps, a32, b32 = umap._layout_inputs(emb, W, a, b)
        n, dim = x.shape
        epochs = 500 if n < 10000 else 200
        packed = torch.from_numpy(cuda_umap.pack(x, heads, tails, eps)).to(dev)
        row = {"edges": int(heads.size), "epochs": epochs,
               "auto_blocks": cuda_umap.blocks_for(n, heads.size)}
        outs = []
        for name, how in (("one_block_shared", {"blocks": 1}),
                          ("one_block_device", {"blocks": 1, "shared": False}),
                          ("auto", {}), ("all_blocks", {"blocks": 1024})):
            row[name], layout = launch_ms(packed, n, dim, epochs, a32, b32, 7,
                                          reps if n < 5000 else 3, **how)
            outs.append(layout)
        row["same_bits"] = all(np.array_equal(o, outs[0]) for o in outs[1:])
        found[label] = row
        print("variants", label, json.dumps(row), flush=True)
    return found


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args()
    dev = torch.device("cuda")
    out = {"device": torch.cuda.get_device_name(0), "torch": torch.__version__,
           "power_limit": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
               capture_output=True, text=True).stdout.strip()}
    print(out, flush=True)

    t0 = time.perf_counter()
    _build.library("umap_layout")
    out["build_s"] = time.perf_counter() - t0
    report = _build.BUILD_LOG.get("umap_layout", {}).get("report", "")
    print(f"built in {out['build_s']:.1f} s\n" + "\n".join(
        line for line in report.splitlines() if "registers" in line or "spill" in line
        or "Compiling entry" in line), flush=True)

    gaps, exact = {}, {}
    for label, (n_groups, copies, dim) in {"n50_d5": (5, 10, 5), "n320_d5": (20, 16, 5),
                                           "n1500_d20": (60, 25, 20)}.items():
        _, emb, W, a, b, seed = problem(1, n_groups, copies, dim)
        for epochs in (1, 5, 20):
            cpu = umap._optimize_layout_device(emb, W, epochs, a, b, seed, device="cpu")
            card = umap._optimize_layout_device(emb, W, epochs, a, b, seed, device=dev)
            gaps[f"{label}_e{epochs}"] = gap(card, cpu)
            exact[f"{label}_e{epochs}"] = bool(np.array_equal(
                umap._optimize_layout_device(emb, W, epochs, a, 1.0, seed, device="cpu"),
                umap._optimize_layout_device(emb, W, epochs, a, 1.0, seed, device=dev)))
        print(label, "edges", int(np.count_nonzero(W)), "8 n dim",
              8 * emb.shape[0] * dim, {k: f"{v:.3e}" for k, v in gaps.items() if k.startswith(label)},
              flush=True)
    out["gap_over_max"] = gaps
    out["same_bits_at_b_1"] = exact
    print("same bits at b = 1:", exact, flush=True)

    dmat, emb, W, a, b, seed = problem(2, 20, 16, 5)
    first = umap._optimize_layout_device(emb, W, 500, a, b, seed, device=dev)
    again = umap._optimize_layout_device(emb, W, 500, a, b, seed, device=dev)
    other = umap._optimize_layout_device(emb, W, 500, a, b, seed + 1, device=dev)
    out["repeat_equal"] = bool(np.array_equal(first, again))
    out["other_seed_differs"] = not np.array_equal(first, other)
    print({k: out[k] for k in ("repeat_equal", "other_seed_differs")}, flush=True)
    out["variants"] = variants(dev, args.reps)

    out["edges"] = int(np.count_nonzero(W))
    out["max_degree"] = int((W > 0).sum(1).max())
    torch.cuda.synchronize()
    walls = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        umap._optimize_layout_device(emb, W, 500, a, b, seed, device=dev)
        walls.append(1e3 * (time.perf_counter() - t0))
    out["call_ms"] = sorted(walls)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(args.reps):
            umap._optimize_layout_device(emb, W, 500, a, b, seed, device=dev)
    kernels = {e.key: e.device_time_total / e.count / 1e3 for e in prof.key_averages()
               if "layout" in e.key and e.device_time_total > 0}
    out["kernel_ms"] = kernels
    print(f"E = {out['edges']}, max degree {out['max_degree']}; call ms (min, median) "
          f"{min(walls):.3f}, {sorted(walls)[len(walls) // 2]:.3f}; kernel ms {kernels}",
          flush=True)

    parts = {"graph": [], "spectral": [], "layout": [], "embed": []}
    for rep in range(5):
        t0 = time.perf_counter()
        W2 = umap.fuzzy_simplicial_set(dmat, 15)
        t1 = time.perf_counter()
        emb2 = umap._spectral_init(W2, 5, np.random.RandomState(rep))
        t2 = time.perf_counter()
        umap._optimize_layout_device(emb2, W2, 500, a, b, seed, device=dev)
        t3 = time.perf_counter()
        layout = umap.umap_embed(dmat=dmat, n_components=5, n_neighbors=15, random_state=rep,
                                 device=dev)
        t4 = time.perf_counter()
        for key, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            parts[key].append(1e3 * dt)
    out["embed_parts_ms"] = parts
    print("umap_embed parts, ms:", {k: [round(v, 2) for v in vs] for k, vs in parts.items()},
          flush=True)
    host = umap.umap_embed(dmat=dmat, n_components=5, n_neighbors=15, random_state=4,
                           layout="host", device=dev)
    out["trust_kernel"] = trustworthiness(dmat, layout)
    out["trust_host"] = trustworthiness(dmat, host)
    print(f"trustworthiness (k = 10): kernel {out['trust_kernel']:.4f}, host "
          f"{out['trust_host']:.4f}", flush=True)
    hdbscan_ms = {}
    for pause in (0.0, 0.015, 0.05, 0.1, 0.2, 0.4):
        for _ in range(5):
            umap._spectral_init(W, 5, np.random.RandomState(0))
            time.sleep(pause)
            t0 = time.perf_counter()
            HDBSCAN(min_samples=5, min_cluster_size=5, cluster_selection_method="leaf",
                    allow_single_cluster=True).fit(layout)
            hdbscan_ms.setdefault(f"{1e3 * pause:.0f}", []).append(1e3 * (time.perf_counter() - t0))
    out["hdbscan_ms_by_pause_after_eigh"] = hdbscan_ms
    print("HDBSCAN ms by the pause (ms) after eigh:",
          {k: [round(v, 1) for v in vs] for k, vs in hdbscan_ms.items()}, flush=True)
    out["launches"] = _build.LAUNCHES["umap_layout"]
    Path("chiprun_out").mkdir(exist_ok=True)
    Path("chiprun_out/torch_umap_layout.json").write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
