"""enstop_torch: the PyTorch + CUDA (Hopper) port of enstop_tpu.

PLSA fit and transform with hand-written CUDA EM kernels on an NVIDIA GPU
(``device="cuda"``), or the plain PyTorch ops on the CPU (``device="cpu"``).
The package imports torch, numpy and scipy only.
"""

from .models.plsa import PLSA
from .ops.cuda_em import LAUNCHES
from .ops.driver import PreparedCounts, plsa_fit, plsa_refit, prepare_counts
from .utils import normalize, standardize_input

__all__ = [
    "PLSA",
    "PreparedCounts",
    "prepare_counts",
    "plsa_fit",
    "plsa_refit",
    "normalize",
    "standardize_input",
    "LAUNCHES",
]
