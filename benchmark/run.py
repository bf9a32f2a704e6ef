"""Run one cell of the benchmark of ``enstop_torch`` once, on this machine.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, this folder and
the ``enstop_torch`` package. Prints diagnostics on standard error, each
number the check compared beside its limit as the last lines there, and the
result as the last line of standard output (one JSON object). Exits with a
code other than 0, and prints no result, without as many CUDA devices as
the cell asks for, or when JAX or the JAX package was loaded.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

# top-level module names that may not be loaded: JAX, and the JAX package and
# the CPU reference library that the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "enstop_tpu", "enstop")


def loaded_forbidden():
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def card():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not read"


def main():
    parser = argparse.ArgumentParser(description="Run one benchmark cell once.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args()

    import torch

    from harness import find_cell, log, run

    cell = find_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA device(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = run(cell, args.seed, args.seconds, trace=bool(args.trace), started=STARTED)
    # read after the window and the check, so that set-up holds no subprocess
    log(f"card: {card()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    found = loaded_forbidden()
    if found:
        log(f"refused: the run loaded {', '.join(found)}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
