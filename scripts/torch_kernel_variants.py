"""The drive of the TPU experiment ``scripts/exp_kernel_variants.py`` on one
NVIDIA GPU: a test chunk of the EM loop with a separate LL sweep against one
with the LL folded into its last step, and the parity of the mask-free step.

    PYTHONPATH=. python3 scripts/torch_kernel_variants.py [--out chiprun_out/torch_kernel_variants.json]

What the experiment held, and its counterpart here:

* Its "nomask" kernel (``_make_em_kernel_nomask``, l.52-74: ``r = x / max(s,
  1e-30)`` with no compare and select) is since the shipped
  ``_make_em_kernel`` (``enstop_tpu/ops/pallas_em.py:176``). In the port the
  two are one launch pair, the dense B pass of ``csrc/em_dense.cu`` and the
  word pass of ``csrc/em_sparse.cu`` (``cuda_em.em_step_fused``), which never
  masks: "shipped" and "nomask" are timed once, as ``step``.
* Its tile sweep over (bd, bw) sizes the TPU's grid. The port's kernel has
  no tile; the sweep over the row walk's stream and lane shape is
  ``scripts/torch_dense_sweep.py``.
* ``chunks`` (l.137-169): 10 steps of ``em_step_fused(compute_ll=False)``
  followed by ``log_likelihood_fused``, against 9 steps followed by one step
  with ``compute_ll=True`` (whose LL is that of the state after 9 steps), in
  ms a chunk over 8 chunks to a host readback, after one warm chunk.
* ``parity`` (l.171-176): one step on float32 X, the kernels' mask-free step
  against the plain step of ``ops/em.py``, which masks (``R = X / S`` where
  ``X > 0``, else 0): the largest absolute gaps in P(z|d) and P(w|z).

The inputs are the experiment's ``make_inputs`` (18,846 x 25,000, 2.2 M
uniform draws of 1 + Poisson(1.5), k = 20, bf16 X), padded as the port pads
(rows to 8, columns to 128, topics to 8). Prints the card's name and power
limit, then one JSON line, which it also writes to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from enstop_torch.ops import cuda_em, em
from enstop_torch.ops.data import round_up

N_DOCS, N_WORDS, K, NNZ = 18846, 25000, 20, 2200000  # the experiment's inputs
CHUNK_STEPS, CHUNKS, STEPS = 10, 8, 40


def make_inputs(n_docs=N_DOCS, n_words=N_WORDS, k=K, nnz=NNZ, seed=0):
    """The experiment's ``make_inputs`` as numpy ``(X, zd, wz, w)``: ``nnz``
    draws of 1 + Poisson(1.5) added at uniform cells, uniform factors
    normalised, the padding absorbing (zero factors, zero weights)."""
    rng = np.random.RandomState(seed)
    npad, mpad, kp = round_up(n_docs, 8), round_up(n_words, 128), round_up(k, 8)
    X = np.zeros((npad, mpad), np.float32)
    ridx = rng.randint(0, n_docs, nnz)
    cidx = rng.randint(0, n_words, nnz)
    np.add.at(X, (ridx, cidx), 1.0 + rng.poisson(1.5, nnz))
    zd = rng.rand(npad, kp).astype(np.float32)
    zd[n_docs:] = 0
    zd[:, k:] = 0
    zd /= np.maximum(zd.sum(1, keepdims=True), 1e-30)
    wz = rng.rand(kp, mpad).astype(np.float32)
    wz[k:] = 0
    wz[:, n_words:] = 0
    wz /= np.maximum(wz.sum(1, keepdims=True), 1e-30)
    w = np.ones(npad, np.float32)
    w[n_docs:] = 0
    return X, zd, wz, w


def chunk_separate(X, zd, wz, w, word=None):
    """10 steps without the LL, then an LL sweep of the state they reach:
    ``(zd, wz, ll)``."""
    for _ in range(CHUNK_STEPS):
        zd, wz, _ = cuda_em.em_step_fused(X, zd, wz, w, compute_ll=False, word=word)
    return zd, wz, cuda_em.log_likelihood_fused(X, zd, wz, w)


def chunk_folded(X, zd, wz, w, word=None):
    """9 steps without the LL, then one step that folds in the LL of its input
    state: ``(zd, wz, ll)``, ``ll`` that of the state after 9 steps."""
    for _ in range(CHUNK_STEPS - 1):
        zd, wz, _ = cuda_em.em_step_fused(X, zd, wz, w, compute_ll=False, word=word)
    return cuda_em.em_step_fused(X, zd, wz, w, compute_ll=True, word=word)


def per_call_ms(fn, calls, state):
    """Wall ms a call of ``fn(zd, wz) -> (zd, wz, ll)``, ``calls`` calls in a
    chain after one warm call, to a host readback."""
    zd, wz, _ = fn(*state)
    float(zd[0, 0])
    t0 = time.perf_counter()
    zd, wz = state
    for _ in range(calls):
        zd, wz, _ = fn(zd, wz)
    float(zd[0, 0])
    return (time.perf_counter() - t0) / calls * 1e3


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="chiprun_out/torch_kernel_variants.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    X, zd, wz, w = (torch.from_numpy(a).cuda() for a in make_inputs())
    Xd = X.to(torch.bfloat16)
    word = cuda_em.word_side_of(Xd)
    nnz = word.nnz
    out = {"card": smi, "shape": list(Xd.shape), "nonzeros": nnz, "draws": NNZ, "k": K}
    step_ms = per_call_ms(lambda z, v: cuda_em.em_step_fused(Xd, z, v, w, compute_ll=False,
                                                            word=word), STEPS, (zd, wz))
    out["step"] = {"ms": step_ms, "draws_k_updates_per_s": NNZ * K / step_ms * 1e3,
                   "nnz_k_updates_per_s": nnz * K / step_ms * 1e3,
                   "note": "shipped = nomask: one launch pair in the port"}
    out["chunks"] = {
        name: per_call_ms(lambda z, v, fn=fn: fn(Xd, z, v, w, word), CHUNKS, (zd, wz))
        for name, fn in (("10 steps + LL sweep", chunk_separate),
                         ("9 steps + LL-folded step", chunk_folded))}
    z1, v1, _ = cuda_em.em_step_fused(X, zd, wz, w, compute_ll=False)
    z0, v0, _ = em.em_step_dense(X, zd, wz, w)
    out["parity"] = {"max_abs_dzd": float((z1 - z0).abs().max()),
                     "max_abs_dwz": float((v1 - v0).abs().max())}
    line = json.dumps(out)
    print(line)
    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(line + "\n")


if __name__ == "__main__":
    main()
