"""Build the CUDA kernels from ``ops/csrc`` at first use and bind them with ctypes.

``nvcc`` compiles each source into a shared library with a plain C interface
(no PyTorch headers, so a build takes seconds), under ``enstop_torch/_build/``
(git-ignored). The library's name carries a hash of the source and the flags,
so an edited source is rebuilt and a stale library is never loaded.
:func:`build_all` runs one ``nvcc`` per source, all started together.

``LAUNCHES`` counts kernel launches by kernel and mode; each wrapper raises
its count where it launches its kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# launches by kernel and mode: the dense EM kernel's B + LL launch of the EM
# step ("em"), of the refit ("refit"), its LL sweep ("ll"), their bf16r modes,
# and the sparse passes, plain, thresholded and (word pass only) bf16r
LAUNCHES = {"em": 0, "refit": 0, "ll": 0, "em_bf16r": 0, "refit_bf16r": 0,
            "word_pass": 0, "word_pass_thresh": 0, "word_pass_bf16r": 0,
            "doc_pass": 0, "doc_pass_thresh": 0}

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C signatures of the entry points, by library
_SIGNATURES = {
    "em_dense": {
        # x_bf16, bf16_r, with_b, compute_ll, X, zd, wzT, w, B, ll_part, n, m, kp, stream
        "enstop_em_dense": (_I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _LL, _LL, _I, _P),
    },
    "em_sparse": {
        # word, thresholded, compute_ll, bf16_r, seg_ptr, seg_owner, owner_seg_ptr, idx,
        # vals, zd, wzT, w, thresh, partial, ll_seg, out, n_seg, n_owner, kp, stream
        "enstop_em_sparse": (_I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _F, _P, _P,
                             _P, _LL, _LL, _I, _P),
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


def library(name):
    """The loaded ctypes library built from ``csrc/<name>.cu`` (built if needed)."""
    if name in _loaded:
        return _loaded[name]
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = _BUILD_DIR / f"lib{name}_{digest}.so"
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
