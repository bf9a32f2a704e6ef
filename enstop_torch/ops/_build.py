"""Build the CUDA kernels from ``ops/csrc`` at first use and bind them with ctypes.

``nvcc`` compiles each source into a shared library with a plain C interface
(no PyTorch headers, so a build takes seconds), under ``enstop_torch/_build/``
(git-ignored). The library's name carries a hash of the source, of every
header it includes from ``csrc`` (``#include "..."``, followed through the
headers) and of the flags, so an edited source or header is rebuilt and a
stale library is never loaded.
:func:`build_all` runs one ``nvcc`` per source, all started together.

``LAUNCHES`` counts kernel launches by kernel and mode; each wrapper raises
its count where it launches its kernel, and nowhere else (:func:`launch`
does both for a wrapper whose entry point takes the stream last).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from .em import RATIO_MODES

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# launches by kernel and mode: the dense EM kernel's B + LL launch of the EM
# step ("em"), of the refit ("refit"), its LL sweep ("ll"), their bf16r modes,
# the sparse passes, plain, thresholded and (word pass only) bf16r, and the
# batched fit's row pass for B ("batch") and word pass for A ("batch_word", the
# sparse word pass over a grid of runs), the sparse passes past 256 topics on
# the wide walk (em_sparse_wide.cu), plain and thresholded; then the dense B
# pass and the word pass in the five ratio modes that only the divide
# experiment's step runs (cuda_em._em_accumulators_ratio); then the UMAP
# layout, every epoch in one launch (cuda_umap.py); then the random init drawn
# on the card, a chunk of rows a count (its twist and its rows, ops/init.py)
LAUNCHES = {"em": 0, "refit": 0, "ll": 0, "em_bf16r": 0, "refit_bf16r": 0,
            "word_pass": 0, "word_pass_thresh": 0, "word_pass_bf16r": 0,
            "doc_pass": 0, "doc_pass_thresh": 0, "batch": 0, "batch_word": 0,
            "word_pass_wide": 0, "word_pass_wide_thresh": 0, "doc_pass_wide": 0,
            "doc_pass_wide_thresh": 0,
            **{f"{kind}_{mode}": 0 for mode in RATIO_MODES[1:-1]
               for kind in ("em", "word_pass")},
            "umap_layout": 0, "mt_uniform": 0}

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_D, _U = ctypes.c_double, ctypes.c_uint
# C signatures of the entry points, by library
_SIGNATURES = {
    "em_dense": {
        # x_bf16, ratio, with_b, compute_ll, lanes, tpl, warps, stages, window, queue,
        # X, zd, wzT, w, B, ll_part, n, m, kp, stream
        "enstop_em_dense": (_I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                            _LL, _LL, _I, _P),
    },
    "em_sparse": {
        # word, thresholded, compute_ll, ratio, lanes, tpl, runs, seg_ptr, seg_owner,
        # owner_seg_ptr, idx, vals, zd, wzT, w, thresh, partial, ll_seg, out, n_seg,
        # n_owner, n_index, kp, stream
        "enstop_em_sparse": (_I, _I, _I, _I, _I, _I, _LL, _P, _P, _P, _P, _P, _P, _P, _P,
                             _F, _P, _P, _P, _LL, _LL, _LL, _I, _P),
    },
    "em_sparse_wide": {
        # em_sparse's arguments (ratio 0 and lanes 32 only)
        "enstop_em_sparse_wide": (_I, _I, _I, _I, _I, _I, _LL, _P, _P, _P, _P, _P, _P, _P,
                                  _P, _F, _P, _P, _P, _LL, _LL, _LL, _I, _P),
    },
    "em_batch": {
        # x_bf16, lanes, tpl, warps, stages, window, queue, X, zd, wzT, B, R, n, m, kp,
        # stream
        "enstop_em_batch": (_I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _LL, _LL, _LL, _I,
                            _P),
    },
    "umap_layout": {
        # packed, scratch, n_edges, n, dim, n_epochs, rounds, initial_alpha, a, b,
        # b_minus_1, c_att, c_rep, seed, shared, blocks, threads, stream
        "enstop_umap_layout": (_P, _P, _LL, _I, _I, _I, _I, _D, _F, _F, _F, _F, _F, _U, _I,
                               _I, _I, _P),
    },
    "mt_uniform": {
        # host_key, host_pos, state, scratch, rows, len, piece, guard, sums, room, out,
        # stride, stream
        "enstop_mt_uniform": (_P, _I, _P, _P, _LL, _LL, _LL, _I, _P, _LL, _P, _LL, _P),
    },
}

_loaded: dict[str, ctypes.CDLL] = {}
# seconds spent in nvcc and the compiler's report, by library (empty when cached)
BUILD_LOG: dict[str, dict] = {}


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [shutil.which("nvcc")]
    if cuda_home:
        candidates.append(os.path.join(cuda_home, "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found (looked on PATH, in $CUDA_HOME/bin and /usr/local/cuda/bin); "
        "the CUDA kernels are built from source at first use"
    )


def _local_includes(path):
    """The ``csrc`` headers that ``path`` includes with quotes, directly or
    through another such header, each once, in order of first inclusion."""
    found, todo = [], [path]
    while todo:
        cur = todo.pop(0)
        for inc in re.findall(r'^\s*#\s*include\s*"([^"]+)"', cur.read_text(), re.MULTILINE):
            header = (cur.parent / inc).resolve()
            if header not in found:
                found.append(header)
                todo.append(header)
    return found


def digest(name, csrc=_CSRC):
    """The hash that names the library of ``csrc/<name>.cu``: its source, the
    headers it includes and the flags."""
    src = csrc / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in _local_includes(src):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library(name):
    """The loaded ctypes library built from ``csrc/<name>.cu`` (built if needed)."""
    if name in _loaded:
        return _loaded[name]
    src = _CSRC / f"{name}.cu"
    so = _BUILD_DIR / f"lib{name}_{digest(name)}.so"
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed building {src.name} (exit {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, so)
        BUILD_LOG[name] = {"seconds": time.perf_counter() - t0,
                           "report": proc.stderr + proc.stdout}
    lib = ctypes.CDLL(str(so))
    for fn_name, argtypes in _SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    _loaded[name] = lib
    return lib


def build_all(names=tuple(_SIGNATURES)):
    """Build and load every library in ``names``, one ``nvcc`` each, all
    started together; returns the libraries in order."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return list(pool.map(library, names))


def launch(key, fn, dev, *args):
    """Call the entry point ``fn`` with ``args`` and the current stream of the
    CUDA device ``dev``, raise on the CUDA error it returns, and count the
    launch as ``LAUNCHES[key]``."""
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: cudaError {err}")
    LAUNCHES[key] += 1
