"""The rate of a corpus's copy to the card from pageable host memory, by
where its host pages came from.

    PYTHONPATH=. python3 scripts/torch_copy_rate.py [--cell nytimes-k20.fit-sparse] [--seed N]

On the cell's training CSR, made by the benchmark's generator (its arrays
allocated by torch and handed to numpy), times ``torch.from_numpy(a).to("cuda")``
of ``indices`` and ``data``, as ``ops.data.ship_coo`` copies them: (a) the
generator's arrays, (b) fresh numpy copies of them, (c) each array copied
into pinned memory on the host first, then up (the two timed together).
Each way ``REPEATS`` times in turns, the host's clock around each copy;
prints one JSON line of the median GB/s (1e9 bytes) of each way and array,
beside the host's transparent huge page setting and the process's huge
pages. Needs a CUDA device.
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT)]

from harness import find_cell  # noqa: E402
from inputs import make_corpus  # noqa: E402

REPEATS = 5


def _read(path):
    try:
        return Path(path).read_text().strip()
    except OSError:
        return "not read"


def _huge_kib():
    for line in _read("/proc/self/smaps_rollup").splitlines():
        if line.startswith("AnonHugePages:"):
            return int(line.split()[1])
    return None


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cell", default="nytimes-k20.fit-sparse")
    parser.add_argument("--seed", type=int, default=2400001601)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    cell = find_cell(args.cell)
    X = make_corpus(cell, args.seed, "cuda")["train"]
    arrays = {"indices": X.indices, "data": X.data}
    fresh = {name: np.array(a) for name, a in arrays.items()}
    pinned = {name: torch.empty(a.shape, dtype=torch.from_numpy(a[:1]).dtype, pin_memory=True)
              for name, a in arrays.items()}

    def staged(name):
        pinned[name].copy_(torch.from_numpy(arrays[name]))
        return pinned[name].to("cuda", non_blocking=True)

    ways = {"as_made": lambda n: torch.from_numpy(arrays[n]).to("cuda"),
            "numpy_copy": lambda n: torch.from_numpy(fresh[n]).to("cuda"),
            "pinned_first": staged}
    seconds = {(w, n): [] for w in ways for n in arrays}
    for _ in range(REPEATS):
        for w, fn in ways.items():
            for n in arrays:
                s, out = _timed(lambda: fn(n))
                seconds[w, n].append(s)
                del out
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "torch": torch.__version__,
        "cell": args.cell, "seed": args.seed, "nnz": int(X.nnz),
        "thp_enabled": _read("/sys/kernel/mm/transparent_hugepage/enabled"),
        "anon_huge_kib": _huge_kib(), "torch_threads": torch.get_num_threads(),
        "gbps": {f"{w}.{n}": arrays[n].nbytes / statistics.median(s) / 1e9
                 for (w, n), s in seconds.items()},
        "seconds": {f"{w}.{n}": s for (w, n), s in seconds.items()}}), flush=True)


if __name__ == "__main__":
    main()
