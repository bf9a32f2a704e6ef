"""Where the batched EM kernel's time goes: its two passes at the 20-Newsgroups
shape on one NVIDIA GPU, over the number of runs and the group size.

    PYTHONPATH=. python3 scripts/torch_batch_sweep.py [--out chiprun_out/torch_batch_sweep.json]

On the 20NG-shaped corpus (18,846 docs x 25,000 words, bf16, k = 20, kp =
24) with the ensemble's own bootstrap inits and weights, the CUDA-event mean
of 20 warm launches of each pass of ``cuda_batch.batched_accumulators`` (the
row pass for B, the word pass for A):

* ``natural``: R = 1, 2, 4, 8, 16 runs in one launch, at the group size
  ``group_size`` picks (G = R here);
* ``forced_group``: R = 16 in one launch at G = 1, 2, 4, 8, 16 (the launch
  walks X, and each segment, 16 / G times);
* ``split``: R = 16 as 16 / G launches of G runs each, so that each launch's
  factor tables are G runs' (G = 1, 2, 4, 8): the same work per warp as
  ``forced_group`` at that G, a smaller working set (the group size is the
  row pass's: the word pass is the sparse word pass with the runs on its
  grid, one walk a run, so G does not reach it);
* ``single``: one run's B pass (``refit_accumulators_fused``), word pass and
  whole ``em_accumulators_fused``, for the sequential baseline;
* ``sass``: the instructions of the main path's kernel instances (kp <= 32)
  as ``cuobjdump -sass`` lists them, all and by opcode family (SHFL, MUFU,
  LDG). The row pass at G = 16 and G = 1 differs by 15 copies of one run's
  unrolled work, so ``per_run`` is the difference over 15 (the
  divergent-path copies of the shuffles, which a converged warp never runs,
  included). The listings themselves go to ``--out`` with ``.sass`` for
  ``.json``; the G = 2 row pass is the shortest to read.

Prints the card's name and power limit, then one JSON line, which it also
writes to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
from collections import Counter
from pathlib import Path

import numpy as np
import torch

import enstop_torch
from enstop_torch.models.ensemble import bootstrap_inputs
from enstop_torch.ops import _build, cuda_batch, cuda_em, cuda_sparse
from enstop_torch.synthetic import twenty_newsgroups_shape

K, R_MAX, REPS = 20, 16, 20


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


def passes_ms(Xd, word, zds, wzT, ws, launches=1):
    """``(row pass ms, word pass ms)`` of the runs, as ``launches`` launches
    of consecutive runs each."""
    parts = [slice(i, i + zds.shape[0] // launches)
             for i in range(0, zds.shape[0], zds.shape[0] // launches)]
    rows = cuda_ms(lambda: [cuda_batch.batch_rows(Xd, zds[p], wzT[p]) for p in parts])
    words = cuda_ms(lambda: [cuda_batch.batch_words(word, zds[p], wzT[p], ws[p]) for p in parts])
    return rows, words


# mangled-name fragments of the kernel instances at kp <= 32 (KT = 1)
SASS_INSTANCES = {
    "batch_rows_g16": "batch_rowsI13__nv_bfloat16Li1ELi16EE",
    "batch_rows_g2": "batch_rowsI13__nv_bfloat16Li1ELi2EE",
    "batch_rows_g1": "batch_rowsI13__nv_bfloat16Li1ELi1EE",
    "dense_b_pass": "em_accumulateI13__nv_bfloat16Li1ELb1ELb0ELb0EE",
    "word_pass": "segment_passILi4ELi8ELi4ELb1ELb0ELb0EE",  # the walk at kp = 24
}


def sass_counts(listing):
    """Opcode counts of the ``SASS_INSTANCES`` from ``cuobjdump -sass``; their
    listings are written to ``listing``."""
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    counts, blocks = {}, []
    for name in ("em_batch", "em_dense", "em_sparse"):
        sass = subprocess.run([str(cuobjdump), "-sass", _build.library(name)._name],
                              capture_output=True, text=True, check=True).stdout
        for block in sass.split("Function : ")[1:]:
            fn = block.split()[0]
            for key, fragment in SASS_INSTANCES.items():
                if fragment in fn:
                    blocks.append(f"Function : {block}")
                    ops = Counter(m.group(1).split(".")[0] for m in re.finditer(
                        r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)", block))
                    counts[key] = {"all": sum(ops.values()),
                                   **{op: ops[op] for op in ("SHFL", "MUFU", "LDG")}}
    for pass_name in ("batch_rows",):
        g16, g1 = counts[pass_name + "_g16"], counts[pass_name + "_g1"]
        counts[pass_name + "_per_run"] = {op: (g16[op] - g1[op]) / 15 for op in g16}
    listing.write_text("".join(blocks))
    return counts


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="chiprun_out/torch_batch_sweep.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    X, _ = twenty_newsgroups_shape(seed=0)
    prep = enstop_torch.prepare_counts(X, device="cuda")
    Xd, word = prep.device_array, prep.word
    runs = list(bootstrap_inputs(prep, K, R_MAX, np.random.RandomState(0)))
    zds, wzs, ws = (torch.stack([run[i] for run in runs]) for i in range(3))
    wzT = wzs.transpose(1, 2).contiguous()
    kp = zds.shape[2]
    out = {"card": smi, "shape": list(Xd.shape), "nnz": int(word.nnz), "k": K, "kp": kp}

    out["natural"] = {R: dict(zip(("rows_ms", "words_ms", "group"),
                                  (*passes_ms(Xd, word, zds[:R], wzT[:R], ws[:R]),
                                   cuda_batch.group_size(R, kp))))
                      for R in (1, 2, 4, 8, 16)}
    picked = cuda_batch.group_size
    out["forced_group"], out["split"] = {}, {}
    try:
        for g in (1, 2, 4, 8, 16):
            cuda_batch.group_size = lambda R, kp, g=g: g
            out["forced_group"][g] = dict(zip(("rows_ms", "words_ms"),
                                              passes_ms(Xd, word, zds, wzT, ws)))
            if g < R_MAX:
                out["split"][g] = dict(zip(("rows_ms", "words_ms"),
                                           passes_ms(Xd, word, zds, wzT, ws, R_MAX // g)))
    finally:
        cuda_batch.group_size = picked
    out["single"] = {
        "rows_ms": cuda_ms(lambda: cuda_em.refit_accumulators_fused(
            Xd, zds[0], wzs[0], ws[0], compute_ll=False)),
        "words_ms": cuda_ms(lambda: cuda_sparse.word_pass(word, zds[0], wzT[0], ws[0],
                                                          compute_ll=False)),
        "accumulators_ms": cuda_ms(lambda: cuda_em.em_accumulators_fused(
            Xd, zds[0], wzs[0], ws[0], compute_ll=False, word=word)),
    }
    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out["sass"] = sass_counts(out_path.with_suffix(".sass"))
    line = json.dumps(out)
    print(line)
    out_path.write_text(line + "\n")


if __name__ == "__main__":
    main()
