"""enstop_torch: the PyTorch + CUDA (Hopper) port of enstop_tpu.

``PLSA`` (and ``GPUPLSA``, ``PLSA`` pinned to the CUDA kernels; ``TPUPLSA``
is the same class under the JAX package's name), the ``EnsembleTopics``
ensemble of pLSA or NMF runs, ``StreamedPLSA``, which streams a corpus
larger than the card through it block by block, and the mesh estimators
``BlockParallelPLSA`` and ``DistributedPLSA``, which lay the corpus over a
grid of devices (or of tiles on one card), with hand-written CUDA EM
kernels on an NVIDIA GPU (``device="cuda"``), or the plain PyTorch ops on the
CPU (``device="cpu"``), on a padded dense corpus (``prepare_counts``) or the
O(nnz) sparse layout (``backend="sparse"``, ``prepare_sell``); and the topic
metrics (``coherence``, ``log_lift`` and their means). The package imports
torch, numpy and scipy only.

The reference's module paths are here too: ``enstop_torch.plsa`` (its
functional kernel API and EM loops, ``plsa_fit_inner``), ``cuda_plsa``,
``block_parallel_plsa``, ``distributed_plsa``, ``streamed_plsa`` and
``enstop_``, each at the JAX package's signatures with a trailing
``device``.
"""

__version__ = "0.2.0"

from .models.accelerated import GPUPLSA, TPUPLSA
from .models.ensemble import EnsembleTopics, ensemble_fit, ensemble_of_topics
from .models.mesh import BlockParallelPLSA, DistributedPLSA
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
    "BlockParallelPLSA",
    "DistributedPLSA",
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
