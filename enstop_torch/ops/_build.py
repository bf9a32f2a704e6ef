"""Build the CUDA kernels from ``ops/csrc`` at first use and bind them with ctypes.

``nvcc`` compiles each source into a shared library with a plain C interface
(no PyTorch headers, so a build takes seconds), under ``enstop_torch/_build/``
(git-ignored). The library's name carries a hash of the source and the flags,
so an edited source is rebuilt and a stale library is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C signatures of the entry points, by library
_SIGNATURES = {
    "em_dense": {
        # x_bf16, bf16_r, with_a, with_b, compute_ll, X, zd, wzT, w, AT, B, ll, n, m, kp,
        # stream
        "enstop_em_dense": (_I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _LL, _LL, _I, _P),
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
