"""enstop_torch: the PyTorch + CUDA (Hopper) port of enstop_tpu.

``PLSA`` (and ``GPUPLSA``, ``PLSA`` pinned to the CUDA kernels; ``TPUPLSA``
is the same class under the JAX package's name), the ``EnsembleTopics``
ensemble of pLSA or NMF runs, and ``StreamedPLSA``, which streams a corpus
larger than the card through it block by block, with hand-written CUDA EM
kernels on an NVIDIA GPU (``device="cuda"``), or the plain PyTorch ops on the
CPU (``device="cpu"``), on a padded dense corpus (``prepare_counts``) or the
O(nnz) sparse layout (``backend="sparse"``, ``prepare_sell``); and the topic
metrics (``coherence``, ``log_lift`` and their means). The package imports
torch, numpy and scipy only.
"""

from .models.accelerated import GPUPLSA, TPUPLSA
from .models.ensemble import EnsembleTopics, ensemble_fit, ensemble_of_topics
from .models.plsa import PLSA
from .models.streamed import StreamedPLSA
from .ops.cuda_em import LAUNCHES
from .ops.driver import PreparedCounts, plsa_fit, plsa_refit, prepare_counts
from .ops.metrics import coherence, log_lift, mean_coherence, mean_log_lift
from .ops.sell import PreparedSell, prepare_sell
from .utils import normalize, standardize_input

__all__ = [
    "PLSA",
    "GPUPLSA",
    "TPUPLSA",
    "StreamedPLSA",
    "EnsembleTopics",
    "ensemble_fit",
    "ensemble_of_topics",
    "PreparedCounts",
    "prepare_counts",
    "PreparedSell",
    "prepare_sell",
    "plsa_fit",
    "plsa_refit",
    "coherence",
    "mean_coherence",
    "log_lift",
    "mean_log_lift",
    "normalize",
    "standardize_input",
    "LAUNCHES",
]
