"""Where the random init drawn on the card (``csrc/mt_uniform.cu``) pays off
against the host's draw, on one NVIDIA GPU.

    PYTHONPATH=. python3 scripts/torch_mt_init.py [--reps 7] [--out chiprun_out/torch_mt_init.json]

For a fit's random init of (n + m) k values at k = 20 and k = 1,000, n = m,
from 2^10 to 2^24 values (and the cell ``nytimes-k1000.fit-wide``'s 402.7 M
with ``--full``), the median wall of ``--reps`` draws, each from a fresh
``RandomState`` to the factors on the card with the host waiting for them:

* ``host``: ``ops/init.py`` ``plsa_init`` on the host, ``pad_factors`` at the
  sparse layout's shapes and both factors copied up (the host path of
  ``ops/driver.py`` ``_initial_factors``);
* ``card``: zeroed factors and ``_uniform_rows`` (the state's read back waits
  for the draw).

Both give the same bits (checked at each size). ``crossover`` is the
smallest size from which the card is faster at every larger size, against
``init.DEVICE_DRAW_MIN``. Prints the card's name and power limit, then one
JSON line, which it also writes to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import scipy.sparse as sp
import torch

from enstop_torch.ops import init as init_ops
from enstop_torch.ops.data import pad_factors


def _host(n, m, k, seed, dev):
    zd, wz = pad_factors(*init_ops.plsa_init(sp.csr_matrix((n, m)), k, rng=seed), n, m, 1)
    zd, wz = torch.from_numpy(zd).to(dev), torch.from_numpy(wz).to(dev)
    torch.cuda.synchronize()
    return zd, wz


def _card(n, m, k, seed, dev):
    zd = torch.zeros((n, k), device=dev)
    wz = torch.zeros((k, m), device=dev)
    init_ops._uniform_rows(np.random.RandomState(seed), [wz, zd])
    return zd, wz


def _median_ms(fn, reps):
    times = []
    for i in range(reps):
        t0 = time.perf_counter()
        fn(i)
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=7)
    parser.add_argument("--full", action="store_true")
    parser.add_argument("--out", default="chiprun_out/torch_mt_init.json")
    args = parser.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    dev = torch.device("cuda")
    _card(64, 64, 20, 0, dev)  # builds and loads the library
    init_ops._row_sum_piece()
    rows = []
    shapes = [(k, values) for k in (20, 1_000) for values in (2 ** e for e in range(10, 25, 2))]
    if args.full:
        shapes.append((1_000, (300_000 + 102_660) * 1_000))
    for k, values in shapes:
        half = max(1, values // (2 * k))
        n, m = (300_000, 102_660) if values > 2 ** 24 else (half, half)
        zd_h, wz_h = _host(n, m, k, 1, dev)
        zd_c, wz_c = _card(n, m, k, 1, dev)
        same = bool(torch.equal(zd_h.view(torch.int32), zd_c.view(torch.int32))
                    and torch.equal(wz_h.view(torch.int32), wz_c.view(torch.int32)))
        del zd_h, wz_h, zd_c, wz_c
        reps = args.reps if values <= 2 ** 24 else 3
        host = _median_ms(lambda i: _host(n, m, k, 2 + i, dev), reps)
        card = _median_ms(lambda i: _card(n, m, k, 2 + i, dev), reps)
        rows.append({"k": k, "n": n, "m": m, "values": (n + m) * k, "host_ms": host,
                     "card_ms": card, "same_bits": same})
        print(json.dumps(rows[-1]), flush=True)
    crossover = {}
    for k in (20, 1_000):
        sizes = [r for r in rows if r["k"] == k]
        faster = [r["values"] for i, r in enumerate(sizes)
                  if all(s["card_ms"] < s["host_ms"] for s in sizes[i:])]
        crossover[k] = min(faster) if faster else None
    result = {"device": smi, "torch": torch.__version__, "numpy": np.__version__,
              "row_sum_piece": init_ops._row_sum_piece(), "rows": rows,
              "crossover": crossover, "device_draw_min": init_ops.DEVICE_DRAW_MIN}
    line = json.dumps(result)
    print(line)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(line + "\n")
    if not all(r["same_bits"] for r in rows):
        raise SystemExit("the card's init differs from the host's")


if __name__ == "__main__":
    main()
