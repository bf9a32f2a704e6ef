"""The dense EM step and the ensemble's stages of ``enstop_torch`` at the
20-Newsgroups shape on one NVIDIA GPU, for holding two checkouts of the port
against each other in one call.

    PYTHONPATH=<checkout> python3 scripts/torch_step_time.py --label NAME [--out FILE]

Imports the ``enstop_torch`` that ``PYTHONPATH`` names, so that one call can
time the parent commit and this one in turns (parent, change, change,
parent), each in a process of its own. At each precision (``"default"``,
``"fast"``), on the 20NG-shaped corpus (18,846 docs x 25,000 words, k = 20):

* the CUDA-event mean of 50 launches of ``cuda_em.em_accumulators_fused``
  with the LL off, warm, in two turns. A checkout whose wrapper takes the
  word-major nonzeros (``word``, from ``PreparedCounts.word``) is given them,
  as its fits give them;
* the EM-loop wall (``fit_info_["wall_time_s"]``) of a 100-iteration
  ``PLSA.fit`` with a test every 10 and tolerance 0, after one warm-up fit;
* ``EnsembleTopics(n_components=20, n_starts=16, n_iter=80, random_state=0)
  .fit_transform``, twice: each fit's wall, ``last_timings`` and
  ``n_components_``.

Prints the card's name and power limit, then one JSON line, which it also
appends to ``--out``.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

import enstop_torch
from enstop_torch.models.ensemble import ensemble_fit
from enstop_torch.ops import cuda_em
from enstop_torch.synthetic import twenty_newsgroups_shape

K = 20
PRECISIONS = ("default", "fast")


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def factors(X, seed=2):
    rng = np.random.RandomState(seed)
    n_pad, m_pad = X.shape
    kp = -(-K // 8) * 8
    zd = torch.zeros((n_pad, kp), device=X.device)
    zd[:, :K] = torch.from_numpy(rng.rand(n_pad, K).astype(np.float32) + 0.01).to(X.device)
    wz = torch.zeros((kp, m_pad), device=X.device)
    wz[:K] = torch.from_numpy(rng.rand(K, m_pad).astype(np.float32) + 0.01).to(X.device)
    zd /= zd.sum(1, keepdim=True)
    wz /= wz.sum(1, keepdim=True)
    return zd, wz, torch.ones(n_pad, device=X.device)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--label", required=True)
    parser.add_argument("--out", default="chiprun_out/torch_step_time.jsonl")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_step_time.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)

    X, _ = twenty_newsgroups_shape(seed=0)
    prep = enstop_torch.prepare_counts(X, device="cuda")
    takes_word = "word" in inspect.signature(cuda_em.em_accumulators_fused).parameters
    extra = {"word": prep.word} if takes_word else {}
    Xd = prep.device_array
    zd, wz, w = factors(Xd)
    rec = {"label": args.label, "card": card, "package": str(Path(enstop_torch.__file__).parent),
           "step_ms": {p: [] for p in PRECISIONS}, "loop_s": {}}
    for _ in range(2):
        for precision in PRECISIONS:
            rec["step_ms"][precision].append(cuda_ms(
                lambda p=precision: cuda_em.em_accumulators_fused(
                    Xd, zd, wz, w, compute_ll=False, precision=p, **extra), 50))
    for precision in PRECISIONS:
        def fit():
            return enstop_torch.PLSA(n_components=K, n_iter=100, n_iter_per_test=10,
                                     tolerance=0, random_state=0, precision=precision,
                                     device="cuda").fit(X)

        fit()
        rec["loop_s"][precision] = fit().fit_info_["wall_time_s"]
    rec["ensembles"] = []
    for precision in PRECISIONS:
        for _ in range(2):
            model = enstop_torch.EnsembleTopics(n_components=K, n_starts=16, n_iter=80,
                                                random_state=0, precision=precision,
                                                device="cuda")
            t0 = time.perf_counter()
            model.fit_transform(X)
            rec["ensembles"].append({"precision": precision,
                                     "fit_transform_s": time.perf_counter() - t0,
                                     "n_components_": model.n_components_,
                                     **ensemble_fit.last_timings})
    print(json.dumps(rec))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a") as f:
        f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
