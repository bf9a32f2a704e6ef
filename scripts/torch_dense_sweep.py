"""Where the dense row walk's time goes: the dense kernel of ``csrc/em_dense.cu``
and the batched row pass of ``csrc/em_batch.cu`` (both ``csrc/row_walk.cuh``)
on one NVIDIA GPU, over the stream's shape and the walk's.

    PYTHONPATH=. python3 scripts/torch_dense_sweep.py [--out chiprun_out/torch_dense_sweep.json]

On the 20-Newsgroups shape (``twenty_newsgroups_shape(seed=0)`` staged by
``prepare_counts``: bf16 X 18,848 x 25,088, 2.7 M nonzeros) with random
factors (``chip_smoke.problem``), CUDA-event means of 30 warm launches:

* ``stream``: the B-only pass (the refit's mode, kp = 24) over the stages
  (2, 3, 4), the window (1,024 to 8,192 bytes) and the warps a block (4, 8,
  16), where the block's shared memory fits; the queue at 256 and 512 entries
  at the default stream;
* ``modes``: each mode at the default stream (``cuda_em.ROW_STREAM``): B + LL,
  B only, their bf16r forms, the LL sweep, bf16 and fp32 X, the B-only pass
  over an all-zero X of the same shape (the stream and the scan without a
  walk), the EM step's accumulators (the B pass and the word pass), and the
  kernel's bound (``chip_smoke.dense_bound_ms``);
* ``shapes``: the B-only pass at kp = 20, 24 and 104 over every built walk
  shape (L, TPL) with L x TPL >= kp (``cuda_sparse.WALK_SHAPES`` and
  ``cuda_em.SWEEP_SHAPES``);
* ``batch``: the batched row pass with the ensemble's bootstrap runs at R = 1,
  2, 4, 8, 16 at ``cuda_batch.BATCH_STREAM``, and at R = 16 over the stages,
  the window, the warps a block and the queue, beside 16 single-run B-only
  passes;
* ``split``: ``torch.profiler``'s device time of the EM step's two kernels
  (the dense B pass and the word pass) and of the batched row pass;
* ``ptxas``: registers and spill stores of every ``em_accumulate`` and
  ``batch_rows`` instance (``chip_smoke.row_instance`` names);
* ``sass``: the walk's hot loop (the innermost loop that holds the division)
  of the B-only instances with 16-byte chunks, all and by opcode family, and
  its warp-instructions an entry. The listings go to ``--out`` with ``.sass``
  for ``.json``.

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
from chip_smoke import cuda_ms, dense_bound_ms, problem, ptxas_instances, row_instance
from enstop_torch.models.ensemble import bootstrap_inputs
from enstop_torch.ops import _build, cuda_batch, cuda_em, cuda_sparse
from enstop_torch.synthetic import twenty_newsgroups_shape
from scripts.torch_sparse_sweep import hot_loop

REPS, KPS, RUNS = 30, (20, 24, 104), (1, 2, 4, 8, 16)
STAGES, WINDOWS, WARPS = (2, 3, 4), (1024, 2048, 4096, 8192), (4, 8, 16)
RS = cuda_em.RowStream


def shapes_for(kp):
    built = cuda_sparse.WALK_SHAPES + (cuda_em.SWEEP_SHAPES if kp % 4 == 0 else ())
    return [(L, tpl) for L, tpl in built if L * tpl >= kp]


def fits(stream):
    try:
        stream.check()
        return True
    except ValueError:
        return False


def ptxas_report(name):
    """``-Xptxas -v`` of ``csrc/<name>.cu``: the build's own, or (the library
    came from the cache) that of a compile to a discarded cubin."""
    _build.library(name)
    build = _build.BUILD_LOG.get(name)
    if build is not None:
        return build["report"]
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    src = Path(_build.__file__).parent / "csrc" / f"{name}.cu"
    proc = subprocess.run([_build._nvcc(), *flags, "-cubin", "-o", "/dev/null", str(src)],
                          capture_output=True, text=True, check=True)
    return proc.stderr + proc.stdout


def sass_counts(listing):
    """Hot-loop instruction counts of the B-only instances with 16-byte chunks
    (bf16 X); the listings go to ``listing``."""
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    counts, blocks = {}, []
    for lib in ("em_dense", "em_batch"):
        sass = subprocess.run([str(cuobjdump), "-sass", _build.library(lib)._name],
                              capture_output=True, text=True, check=True).stdout
        for block in sass.split("Function : ")[1:]:
            name = row_instance(block.split()[0])
            if name is None or "_bf16_" not in name or not name.endswith("V4_B"):
                continue
            L = int(re.search(r"_L(\d+)_", name).group(1))
            loop = hot_loop(block)
            ops = Counter(re.match(r"(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)", t).group(1)
                          for t in loop)
            entries = 32 // L * max(sum(t.startswith("MUFU.RCP") for t in loop), 1)
            counts[name] = {"loop": len(loop), "per_entry": len(loop) / entries,
                            "calls": block.count(" CALL"), "local_stores": block.count("STL"),
                            **{op: ops[op] for op in ("SHFL", "MUFU", "LDG", "LDS", "FFMA")}}
            blocks.append(f"Function : {block}")
    listing.write_text("".join(blocks))
    return counts


def device_split(fn, reps=REPS):
    """Device ms a call of ``fn`` spends in each kernel, by name, from
    ``torch.profiler`` ("not measured" if it sees none)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for event in prof.key_averages():
        total = getattr(event, "device_time_total", None) or getattr(event, "cuda_time_total", 0)
        for kernel in ("em_accumulate", "batch_rows", "segment_pass", "reduce_segments"):
            if kernel in event.key:
                split[kernel + "_ms"] = split.get(kernel + "_ms", 0.0) + total / 1e3 / reps
    return split or "not measured"


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="chiprun_out/torch_dense_sweep.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out = {"card": smi, "default_stream": cuda_em.ROW_STREAM._asdict(),
           "batch_stream": cuda_batch.BATCH_STREAM._asdict()}
    out["ptxas"] = {row_instance(key): {"registers": regs, "spill_bytes": spill}
                    for lib in ("em_dense", "em_batch")
                    for key, (regs, spill) in ptxas_instances(ptxas_report(lib)).items()
                    if row_instance(key)}
    X, _ = twenty_newsgroups_shape(seed=0)
    prep = enstop_torch.prepare_counts(X, device="cuda")
    Xd, word = prep.device_array, prep.word
    zd, wz, _ = problem(Xd, 20, False, seed=2)
    kp = zd.shape[1]
    w = torch.ones(Xd.shape[0], device="cuda")

    def b_only(stream=cuda_em.ROW_STREAM, shape=None, z=zd, v=wz, x=Xd):
        return cuda_ms(lambda: cuda_em._launch("refit", x, z, v, w, True, False, shape=shape,
                                               stream=stream), REPS)

    n_pad = Xd.shape[0]
    out["bound_ms"] = {"B only": dense_bound_ms(Xd, kp, kp * n_pad)[0],
                       "LL": dense_bound_ms(Xd, kp, 1)[0]}
    out["stream"] = {}

    for stages in STAGES:
        for window in WINDOWS:
            for warps in WARPS:
                s = RS(warps=warps, stages=stages, window=window)
                if fits(s):
                    key = f"s{stages}_win{window}_w{warps}"
                    out["stream"][key] = b_only(s)
                    print(f"stream {key}: {out['stream'][key]:.4f} ms", flush=True)
    for queue in (256, 512):
        out["stream"][f"default_queue{queue}"] = b_only(cuda_em.ROW_STREAM._replace(queue=queue))

    X32 = Xd.float()
    out["modes"] = {
        "B, X all zero": b_only(x=torch.zeros_like(Xd)),
        "B+LL": cuda_ms(lambda: cuda_em._launch("em", Xd, zd, wz, w, True, True), REPS),
        "B": b_only(),
        "B+LL bf16r": cuda_ms(lambda: cuda_em._launch("em", Xd, zd, wz, w, True, True, "bf16r"),
                              REPS),
        "B bf16r": cuda_ms(lambda: cuda_em._launch("em", Xd, zd, wz, w, True, False, "bf16r"),
                           REPS),
        "LL": cuda_ms(lambda: cuda_em._launch("ll", Xd, zd, wz, w, False, True), REPS),
        "B fp32 X": b_only(x=X32),
        "EM step accumulators": cuda_ms(lambda: cuda_em.em_accumulators_fused(
            Xd, zd, wz, w, compute_ll=False, word=word), REPS),
        "EM step accumulators bf16r": cuda_ms(lambda: cuda_em.em_accumulators_fused(
            Xd, zd, wz, w, compute_ll=False, precision="fast", word=word), REPS),
    }
    del X32
    print(f"modes: {json.dumps(out['modes'])}", flush=True)

    out["shapes"] = {}
    for k in KPS:
        zk, wk, _ = problem(Xd, k, False, seed=2)
        kpk = zk.shape[1] if k != 20 else 20
        zk, wk = zk[:, :kpk].contiguous(), wk[:kpk].contiguous()
        for L, tpl in shapes_for(kpk):
            out["shapes"][f"kp{kpk}_L{L}_TPL{tpl}"] = b_only(shape=(L, tpl), z=zk, v=wk)
    print(f"shapes: {json.dumps(out['shapes'])}", flush=True)

    runs = list(bootstrap_inputs(prep, 20, max(RUNS), np.random.RandomState(0)))
    zds, wzs, _ = (torch.stack([run[i] for run in runs]) for i in range(3))
    wzT = wzs.transpose(1, 2).contiguous()
    out["batch"] = {f"R{R}": cuda_ms(lambda: cuda_batch.batch_rows(Xd, zds[:R], wzT[:R]), REPS)
                    for R in RUNS}
    out["batch"]["R16_single_B_passes"] = cuda_ms(lambda: [cuda_em._launch(
        "refit", Xd, zds[r], wzs[r], w, True, False) for r in range(16)], 5)
    for stages in (2, 3):
        for window in WINDOWS[:3]:
            for warps in (4, 8):
                s = cuda_batch.BATCH_STREAM._replace(stages=stages, window=window, warps=warps)
                if fits(s):
                    out["batch"][f"R16_s{stages}_win{window}_w{warps}"] = cuda_ms(
                        lambda: cuda_batch.batch_rows(Xd, zds, wzT, stream=s), 10)
    for queue in (256, 1024):
        s = cuda_batch.BATCH_STREAM._replace(queue=queue)
        out["batch"][f"R16_queue{queue}"] = cuda_ms(
            lambda: cuda_batch.batch_rows(Xd, zds, wzT, stream=s), 10)
    print(f"batch: {json.dumps(out['batch'])}", flush=True)

    out["split"] = {
        "EM step": device_split(lambda: cuda_em.em_accumulators_fused(
            Xd, zd, wz, w, compute_ll=False, word=word)),
        "batch R16": device_split(lambda: cuda_batch.batch_rows(Xd, zds, wzT), 10)}
    print(f"split: {json.dumps(out['split'])}", flush=True)
    out["sass"] = sass_counts(out_path.with_suffix(".sass"))
    line = json.dumps(out)
    print(line)
    out_path.write_text(line + "\n")


if __name__ == "__main__":
    main()
