"""The UMAP layout's SGD at the sizes the ``UMAP`` facade meets, timed on the card.

    python3 scripts/torch_umap_scale.py --root <checkout> --cache <dir> [--n 2000 10000] [--reps 3]

For each N: N points drawn around 20 centres in 10 dimensions, their euclidean
distances, the fuzzy graph of 15 neighbours (``fuzzy_simplicial_set``), a start
uniform in [-10, 10] in 2 dimensions (the facade's ``n_components``; the
spectral start's n x n ``eigh`` takes minutes at these sizes and does not touch
the SGD) and the epochs ``umap_embed`` picks (500 below 10,000 points, 200 from
there). The first run at an N writes the graph and start to ``--cache``, and a
later run (another checkout) reads them, so both time the same problem. Times
``_optimize_layout_device(..., device="cuda")`` of the checkout at ``--root``
(one warm call, then ``--reps`` calls, each to its readback) and the edge
listing it starts with (``np.nonzero`` of the dense graph, the same on every
side), and prints one JSON line an N.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


def problem(n, cache, umap):
    path = Path(cache) / f"umap_scale_{n}.npz"
    if path.exists():
        f = np.load(path)
        W = np.zeros((n, n))
        W[f["heads"], f["tails"]] = f["weights"]
        return W, f["start"]
    rng = np.random.RandomState(n)
    pts = rng.randn(20, 10)[rng.randint(20, size=n)] * 4 + rng.randn(n, 10)
    sq = (pts * pts).sum(1)
    dmat = np.sqrt(np.maximum(sq[:, None] + sq[None, :] - 2 * pts @ pts.T, 0.0))
    np.fill_diagonal(dmat, 0.0)
    W = umap.fuzzy_simplicial_set(dmat, 15)
    start = rng.uniform(-10, 10, (n, 2))
    heads, tails = np.nonzero(W)
    Path(cache).mkdir(parents=True, exist_ok=True)
    np.savez(path, heads=heads, tails=tails, weights=W[heads, tails], start=start)
    return W, start


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", required=True)
    parser.add_argument("--cache", required=True)
    parser.add_argument("--n", type=int, nargs="+", default=[2000, 10000])
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    from enstop_torch.cluster import umap

    a, b = umap.find_ab_params(1.0, 0.1)
    for n in args.n:
        W, start = problem(n, args.cache, umap)
        epochs = 500 if n < 10000 else 200
        t0 = time.perf_counter()
        heads, _ = np.nonzero(W)
        nonzero_ms = 1e3 * (time.perf_counter() - t0)
        umap._optimize_layout_device(start, W, epochs, a, b, 7, device="cuda")
        walls = []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = umap._optimize_layout_device(start, W, epochs, a, b, 7, device="cuda")
            walls.append(1e3 * (time.perf_counter() - t0))
        print(json.dumps({"root": args.root, "n": n, "edges": int(heads.size), "epochs": epochs,
                          "call_ms": sorted(walls), "nonzero_ms": nonzero_ms,
                          "finite": bool(np.isfinite(out).all()),
                          "spread": float(np.abs(out).max())}), flush=True)


if __name__ == "__main__":
    main()
