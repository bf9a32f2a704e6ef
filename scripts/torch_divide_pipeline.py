"""The E-step's ratio modes on one NVIDIA GPU: the port of the TPU experiment
``scripts/exp_divide_pipeline.py``, which asked whether the E-step's fp32
division can be made cheaper without giving up fp32-accurate
responsibilities.

    PYTHONPATH=. python3 scripts/torch_divide_pipeline.py [k ...] [--out chiprun_out/torch_divide_pipeline.json]

The step is ``cuda_em._em_accumulators_ratio``: the EM step's ``(A, B)``
without the LL, the dense B pass of ``csrc/em_dense.cu`` then the word pass
of ``csrc/em_sparse.cu`` for A, the ratio ``x / max(S, 1e-30)`` in each of
the seven modes of ``cuda_em.RATIO_MODES`` (``csrc/lane_walk.cuh``;
``f32div`` is the shipped fp32 step, ``bf16r`` the ``precision="fast"`` one;
the five others are built for bf16 X at kp 17-32 only). On the 20-Newsgroups
shape (``twenty_newsgroups_shape(seed=0)``, staged by ``prepare_counts``,
bf16) with ``plsa_init`` factors (``RandomState(1)``) for each k (default
20), as the experiment's ``main()``:

* ``accuracy``: each mode's largest gap in A and in B from ``f32div``, over
  the largest entry of ``f32div``'s;
* ``loop_ms``: a 20-step EM loop of the mode's accumulators and the row
  normalisations, to a host readback, best of 3 after a warm one, and
  ``speedup_vs_f32div``;

and what this card needs to answer the question:

* ``kernels_ms``: each mode's dense B pass alone and word pass alone, the
  CUDA-event mean of 50 warm launches, at 20NG and, for the word pass, at
  config C (``sparse_corpus(250_000, 141_000, 19_000_000, seed=0)``, k = 20,
  factors as ``chip_smoke.sparse_problem`` makes them), beside their bounds;
* ``instances``: the registers and spill stores of each mode's instance of
  both kernels at (L, TPL) = (4, 8), bf16 X, B only, and of the plain word
  pass, with 16-byte chunks (V4) and without (V1), and the hot loop's
  instructions (the innermost loop that holds ``MUFU.RCP``:
  ``scripts/torch_sparse_sweep.py:hot_loop``), all and by opcode family,
  and over the loop's entries. The listings go to ``--out`` with ``.sass``
  for ``.json``.

Prints the card's name and power limit, the experiment's lines, then one JSON
line, which it also writes to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

import enstop_torch
from chip_smoke import (CONFIG_C, cuda_ms, dense_bound_ms, ptxas_instances, row_instance,
                        sparse_bound_ms, sparse_instance, sparse_problem)
from enstop_torch.convert import pad_state
from enstop_torch.ops import _build, cuda_em, cuda_sparse
from enstop_torch.ops.init import plsa_init
from enstop_torch.synthetic import sparse_corpus, twenty_newsgroups_shape
from scripts.torch_dense_sweep import ptxas_report
from scripts.torch_sparse_sweep import hot_loop

MODES = cuda_em.RATIO_MODES
N_STEPS, REPS, TINY = 20, 50, 1e-30


def built_at(mode, kp):
    """Whether the kernels are built for ``mode`` at ``kp`` topics (bf16 X)."""
    return mode in ("f32div", "bf16r") or cuda_sparse.walk_shape(kp) == (4, 8)


def make_loop(Xd, w, word, mode):
    """``run(zd, wz, n_steps) -> (zd, wz)``: the experiment's EM loop."""
    def run(zd, wz, n_steps):
        for _ in range(n_steps):
            a, b = cuda_em._em_accumulators_ratio(Xd, zd, wz, w, mode, word=word)
            num = wz * a
            wz = num / num.sum(1, keepdim=True).clamp_min(TINY)
            num = zd * b
            zd = num / num.sum(1, keepdim=True).clamp_min(TINY)
        return zd, wz
    return run


def loop_ms(run, zd, wz):
    """Best of 3 walls of ``N_STEPS`` steps to a host readback, after a warm
    run, in ms a step."""
    float(run(zd, wz, N_STEPS)[0][0, 0])
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        float(run(zd, wz, N_STEPS)[0][0, 0])
        walls.append(time.perf_counter() - t0)
    return min(walls) / N_STEPS * 1e3, walls


def instance_counts(listing):
    """Registers, spills and hot-loop SASS of each mode's instances at (4, 8):
    the dense kernel's (bf16 X, B only) and the plain word pass's."""
    regs = {}
    for lib, namer in (("em_dense", row_instance), ("em_sparse", sparse_instance)):
        for mangled, (r, spill) in ptxas_instances(ptxas_report(lib)).items():
            name = namer(mangled)
            if name:
                regs[name] = (r, spill)
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    counts, blocks = {}, []
    for lib, namer in (("em_dense", row_instance), ("em_sparse", sparse_instance)):
        sass = subprocess.run([str(cuobjdump), "-sass", _build.library(lib)._name],
                              capture_output=True, text=True, check=True).stdout
        for block in sass.split("Function : ")[1:]:
            name = namer(block.split()[0])
            match = name and re.fullmatch(
                r"(?:em_accumulate_bf16_)?L4_TPL8_V[14]_(?:B|word)(?:_(\w+))?", name)
            mode = match and (match.group(1) or "f32div")
            if mode not in MODES:
                continue
            loop = hot_loop(block)
            ops = Counter(re.match(r"(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)", t).group(1)
                          for t in loop)
            entries = 8 * max(sum(t.startswith("MUFU.RCP") for t in loop), 1)
            counts[name] = {
                "mode": mode, "registers": regs[name][0],
                "spill_bytes": regs[name][1], "loop": len(loop),
                "per_entry": len(loop) / entries, "calls": block.count(" CALL"),
                **{op: ops[op] for op in ("MUFU", "FFMA", "FMUL", "FADD", "F2F", "SHFL", "LDG",
                                          "LDS", "BRA")}}
            blocks.append(f"Function : {block}")
    listing.write_text("".join(blocks))
    return counts


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("ks", nargs="*", type=int, default=[20])
    parser.add_argument("--out", default="chiprun_out/torch_divide_pipeline.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out = {"card": smi, "modes": list(MODES), "steps": N_STEPS}
    dev = torch.device("cuda")
    X = twenty_newsgroups_shape(seed=0)[0]
    prep = enstop_torch.prepare_counts(X, device=dev)
    Xd, word = prep.device_array, prep.word
    n_pad, m_pad = Xd.shape
    w = torch.ones(n_pad, device=dev)
    for k in args.ks:
        zd0, wz0 = plsa_init(X, k, rng=np.random.RandomState(1))
        zd, wz = pad_state(zd0, wz0, n_pad, m_pad, dev)
        kp = zd.shape[1]
        modes = [mode for mode in MODES if built_at(mode, kp)]
        row = out[f"k{k}"] = {"kp": kp, "not_built": [m for m in MODES if m not in modes],
                              "accuracy": {}, "loop_ms": {}, "kernels_ms": {}}
        a0, b0 = cuda_em._em_accumulators_ratio(Xd, zd, wz, w, "f32div", word=word)
        for mode in modes:
            a1, b1 = cuda_em._em_accumulators_ratio(Xd, zd, wz, w, mode, word=word)
            da = float((a1 - a0).abs().max() / a0.abs().max().clamp_min(TINY))
            db = float((b1 - b0).abs().max() / b0.abs().max().clamp_min(TINY))
            row["accuracy"][mode] = {"A": da, "B": db}
            print(f"k{k}/{mode}: rel maxdiff A={da:.3e} B={db:.3e}"
                  + ("  (bit-identical)" if da == 0 and db == 0 else ""), flush=True)
        for mode in modes:
            ms, walls = loop_ms(make_loop(Xd, w, word, mode), zd, wz)
            row["loop_ms"][mode] = {"ms": ms, "walls_s": walls}
        base = row["loop_ms"]["f32div"]["ms"]
        wzT = wz.t().contiguous()
        least = {"B": dense_bound_ms(Xd, kp, kp * n_pad),
                 "word": sparse_bound_ms(word, n_pad, m_pad, kp)}
        for mode in modes:
            ms = row["loop_ms"][mode]["ms"]
            row["loop_ms"][mode]["speedup_vs_f32div"] = base / ms
            row["kernels_ms"][mode] = {
                "B": cuda_ms(lambda: cuda_em._launch("em", Xd, zd, wz, w, True, False, mode),
                             REPS),
                "word": cuda_ms(lambda: cuda_sparse._pass(word, zd, wzT, w, True, None, False,
                                                          mode), REPS)}
            print(f"k{k}/{mode}: {ms:.3f} ms/iter  speedup_vs_f32div={base / ms:.3f}x; "
                  f"B pass {row['kernels_ms'][mode]['B']:.4f} ms, word pass "
                  f"{row['kernels_ms'][mode]['word']:.4f} ms", flush=True)
        row["bounds_ms"] = {key: value[0] for key, value in least.items()}
    del prep, Xd, word
    XC = sparse_corpus(*CONFIG_C, seed=0).astype(np.int64)
    cprep = enstop_torch.prepare_sell(XC, standardize=False, device=dev)
    zd_c, wzT_c, _ = sparse_problem(cprep, 20, False, seed=6)
    w_c = torch.ones(cprep.n, device=dev)
    out["config_C_word_ms"] = {
        mode: cuda_ms(lambda: cuda_sparse._pass(cprep.word, zd_c, wzT_c, w_c, True, None, False,
                                                mode), REPS)
        for mode in MODES}
    out["config_C_word_bound_ms"] = sparse_bound_ms(cprep.word, cprep.n, cprep.m, 20)[0]
    print(f"config C word pass by mode: {json.dumps(out['config_C_word_ms'])}", flush=True)
    out["instances"] = instance_counts(out_path.with_suffix(".sass"))
    line = json.dumps(out)
    print(line)
    out_path.write_text(line + "\n")


if __name__ == "__main__":
    main()
