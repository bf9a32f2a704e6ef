"""Where the sparse passes' time goes: the word and doc passes of
``csrc/em_sparse.cu`` over the walk's shape (L lanes an entry, TPL topics a
lane) on one NVIDIA GPU.

    PYTHONPATH=. python3 scripts/torch_sparse_sweep.py [--out chiprun_out/torch_sparse_sweep.json]

On the 20-Newsgroups shape (``twenty_newsgroups_shape(seed=0)``, 18,846 docs x
25,000 words), on config C (``sparse_corpus(250_000, 141_000, 19_000_000,
seed=0)``) and on config C' (``sparse_corpus(100_000, 141_000, 6_200_000,
seed=0)``, the sparse ensemble's), each staged by ``prepare_sell``, with
factors shaped like a fitted model's (``chip_smoke.sparse_problem``, k = kp
topics):

* ``shapes``: for kp = 20, 24 and 104 and every built shape with L x TPL >= kp
  and TPL <= 24 (``WALK_SHAPES``, and ``SWEEP_SHAPES`` where kp % 4 == 0), the
  CUDA-event mean of 50 warm launches of each pass as the EM step launches it
  (no threshold, LL off), its bound (``chip_smoke.sparse_bound_ms``), the
  gathered rows' bytes (nnz x kp x 4) over the time, and the share of entry
  slots left idle: over the segments, the slots of the last, ragged group of
  E = 32 / L entries that hold no entry, over all slots walked;
* ``split``: at the chosen shape (kp = 24 at 20NG, the dense EM step's; kp =
  20 at configs C and C'), the device time of each pass in its segment kernel and in
  its owner reduction, from ``torch.profiler``;
* ``seg_len``: both passes at kp = 20 at the chosen shape with segments of
  64, 128, 256, 512 and 1024 entries at most (``cuda_sparse.SEG_LEN``), CUDA
  events and the profiler's split;
* ``ptxas``: registers and spill stores of every ``segment_pass`` instance,
  named ``L<L>_TPL<TPL>_V<V>_<mode>``;
* ``sass``: for the word pass (no threshold) at each shape with 16-byte chunks,
  the instructions of its hot loop (the innermost loop that holds the
  division, in ``cuobjdump -sass``: one group of E entries, or at L = 1 the
  32 entries of a chunk with their loads; twice that where the compiler
  unrolled it), all and by opcode family, and the loop's instructions over
  its entries: the warp-instructions an entry (the LL's branch, skipped
  with LL off, included). The
  listings go to ``--out`` with ``.sass`` for ``.json``.

``chosen`` is ``cuda_sparse.walk_shape(kp)``. Prints the card's name and
power limit, then one JSON line, which it also writes to ``--out``.
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
from chip_smoke import (CONFIG_C, CONFIG_C2, cuda_ms, ptxas_instances, sparse_bound_ms,
                        sparse_instance, sparse_problem)
from enstop_torch.ops import _build, cuda_sparse
from enstop_torch.synthetic import sparse_corpus, twenty_newsgroups_shape

KPS, REPS, SEG_LENS = (20, 24, 104), 50, (64, 128, 256, 512, 1024)


def shapes_for(kp):
    built = cuda_sparse.WALK_SHAPES + (cuda_sparse.SWEEP_SHAPES if kp % 4 == 0 else ())
    return [(L, tpl) for L, tpl in built if L * tpl >= kp and tpl <= 24]


def idle_share(side, L):
    """Entry slots of the segments' ragged last groups that hold no entry, over
    all slots walked."""
    E = 32 // L
    cnt = side.seg_ptr.diff()
    slots = (cnt + E - 1) // E * E
    return float((slots - cnt).sum() / slots.sum())


def at_shape(shape, fn):
    """``fn()`` with the kernel's walk shape forced to ``shape``."""
    picked = cuda_sparse.walk_shape
    cuda_sparse.walk_shape = lambda kp: shape
    try:
        return fn()
    finally:
        cuda_sparse.walk_shape = picked


def passes_ms(prep, zd, wzT, w):
    return (cuda_ms(lambda: cuda_sparse.word_pass(prep.word, zd, wzT, w, compute_ll=False), REPS),
            cuda_ms(lambda: cuda_sparse.doc_pass(prep.doc, zd, wzT, w, compute_ll=False), REPS))


def ptxas_report():
    """``-Xptxas -v`` of ``em_sparse.cu``: the build's own, or (the library
    came from the cache) that of a compile to a discarded cubin."""
    _build.library("em_sparse")
    build = _build.BUILD_LOG.get("em_sparse")
    if build is not None:
        return build["report"]
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    src = Path(_build.__file__).parent / "csrc" / "em_sparse.cu"
    proc = subprocess.run([_build._nvcc(), *flags, "-cubin", "-o", "/dev/null", str(src)],
                          capture_output=True, text=True, check=True)
    return proc.stderr + proc.stdout


def hot_loop(block):
    """The instructions of the innermost loop of one ``cuobjdump -sass``
    function listing that holds the division (``MUFU.RCP``): from the target
    of a conditional backward branch to the branch. (The unconditional
    backward branches are the returns of the shuffles' divergent paths.)"""
    lines = [(int(a, 16), t) for a, t in re.findall(r"/\*([0-9a-f]{4,})\*/\s+(.*?);", block)]
    loops = []
    for addr, text in lines:
        branch = re.match(r"@!?U?P[T0-9]+\s+BRA\b.*?0x([0-9a-f]+)", text)
        if branch and int(branch.group(1), 16) <= addr:
            body = [t for a, t in lines if int(branch.group(1), 16) <= a <= addr]
            if any(t.startswith("MUFU.RCP") for t in body):
                loops.append(body)
    return min(loops, key=len, default=[])


def sass_counts(listing):
    """Hot-loop instruction counts of the plain word pass at each 16-byte-chunk
    shape; the listings go to ``listing``."""
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", _build.library("em_sparse")._name],
                          capture_output=True, text=True, check=True).stdout
    counts, blocks = {}, []
    for block in sass.split("Function : ")[1:]:
        name = sparse_instance(block.split()[0])
        if name is None or not name.endswith("V4_word"):
            continue
        L = int(name.split("_")[0][1:])
        loop = hot_loop(block)
        ops = Counter(re.match(r"(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)", t).group(1)
                      for t in loop)
        entries = 32 // L * max(sum(t.startswith("MUFU.RCP") for t in loop), 1)
        counts[name] = {"loop": len(loop), "per_entry": len(loop) / entries,
                        **{op: ops[op] for op in ("SHFL", "MUFU", "LDG", "FFMA", "FMUL", "FADD")}}
        blocks.append(f"Function : {block}")
    listing.write_text("".join(blocks))
    return counts


def kernel_split(fn):
    """Device ms a call of ``fn`` spends in each of the two kernels, from
    ``torch.profiler`` over REPS calls ("not measured" if it sees none)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    split = {}
    for event in prof.key_averages():
        total = getattr(event, "device_time_total", None) or getattr(event, "cuda_time_total", 0)
        for kernel in ("segment_pass", "reduce_segments"):
            if kernel in event.key:
                split[kernel + "_ms"] = split.get(kernel + "_ms", 0.0) + total / 1e3 / REPS
    return split or "not measured"


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="chiprun_out/torch_sparse_sweep.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out = {"card": smi, "chosen": {kp: cuda_sparse.walk_shape(kp) for kp in KPS}}
    out["ptxas"] = {sparse_instance(name): {"registers": regs, "spill_bytes": spill}
                    for name, (regs, spill) in ptxas_instances(ptxas_report()).items()
                    if sparse_instance(name)}
    corpora = (("20NG", twenty_newsgroups_shape(seed=0)[0]),
               ("config C", sparse_corpus(*CONFIG_C, seed=0).astype(np.int64)),
               ("config C'", sparse_corpus(*CONFIG_C2, seed=0).astype(np.int64)))
    out["shapes"], out["seg_len"] = {}, {}
    for label, X in corpora:
        prep = enstop_torch.prepare_sell(X, standardize=False, device="cuda")
        rows = out["shapes"][label] = {"nnz": prep.nnz, "word_segments": prep.word.n_seg,
                                       "doc_segments": prep.doc.n_seg}
        for kp in KPS:
            zd, wzT, _ = sparse_problem(prep, kp, False, seed=6)
            w = torch.ones(prep.n, device="cuda")
            gathered = prep.nnz * kp * 4
            for L, tpl in shapes_for(kp):
                word_ms, doc_ms = at_shape((L, tpl), lambda: passes_ms(prep, zd, wzT, w))
                rows[f"kp{kp}_L{L}_TPL{tpl}"] = {
                    "word_ms": word_ms, "doc_ms": doc_ms,
                    "word_bound_ms": sparse_bound_ms(prep.word, prep.n, prep.m, kp)[0],
                    "doc_bound_ms": sparse_bound_ms(prep.doc, prep.n, prep.m, kp)[0],
                    "word_gathered_GB_per_s": gathered / word_ms / 1e6,
                    "doc_gathered_GB_per_s": gathered / doc_ms / 1e6,
                    "word_idle_share": idle_share(prep.word, L),
                    "doc_idle_share": idle_share(prep.doc, L)}
                print(f"{label} kp {kp} L {L} TPL {tpl}: {json.dumps(rows[f'kp{kp}_L{L}_TPL{tpl}'])}",
                      flush=True)
        kp = 24 if label == "20NG" else 20  # the dense EM step's kp, the sparse path's k
        zd, wzT, _ = sparse_problem(prep, kp, False, seed=6)
        w = torch.ones(prep.n, device="cuda")
        rows["split"] = {
            "kp": kp,
            "word": kernel_split(lambda: cuda_sparse.word_pass(prep.word, zd, wzT, w,
                                                               compute_ll=False)),
            "doc": kernel_split(lambda: cuda_sparse.doc_pass(prep.doc, zd, wzT, w,
                                                             compute_ll=False))}
        print(f"{label} split: {json.dumps(rows['split'])}", flush=True)
        del prep
        seg_len = cuda_sparse.SEG_LEN
        try:
            for length in SEG_LENS:
                cuda_sparse.SEG_LEN = length
                prep = enstop_torch.prepare_sell(X, standardize=False, device="cuda")
                zd, wzT, _ = sparse_problem(prep, 20, False, seed=6)
                w = torch.ones(prep.n, device="cuda")
                word_ms, doc_ms = passes_ms(prep, zd, wzT, w)
                out["seg_len"][f"{label} {length}"] = {
                    "word_ms": word_ms, "doc_ms": doc_ms,
                    "word_split": kernel_split(lambda: cuda_sparse.word_pass(
                        prep.word, zd, wzT, w, compute_ll=False)),
                    "doc_split": kernel_split(lambda: cuda_sparse.doc_pass(
                        prep.doc, zd, wzT, w, compute_ll=False))}
                del prep
        finally:
            cuda_sparse.SEG_LEN = seg_len
        print(f"{label} seg_len: {json.dumps(out['seg_len'])}", flush=True)
    out["sass"] = sass_counts(out_path.with_suffix(".sass"))
    line = json.dumps(out)
    print(line)
    out_path.write_text(line + "\n")


if __name__ == "__main__":
    main()
