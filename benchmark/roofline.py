"""The least time one pLSA EM iteration can take on one NVIDIA H100 SXM.

Counted from the work of the algorithm at a corpus's ``nnz``, ``n_docs``,
``n_words`` and ``k``, never from an implementation's padded or dense
shapes, so no implementation can read above 100 % of it and a change of
algorithm (dense rectangle, sorted sides, fused passes) cannot move it.

Bytes: each nonzero's value and word index read once (4 + 4 B), and both
factor tables, ``P(z|d)`` (n_docs, k) and ``P(w|z)`` (k, n_words), read once
and written once in float32: ``(n_docs + n_words) * k * 8`` B.

Operations: 6 float32 operations per nonzero per topic: the product
``P(z|d) P(w|z)``, its sum over z, the ratio (a multiply and a divide) and
the two accumulations, into ``P(z|d)`` and into ``P(w|z)``.

The least time is the larger of bytes over the HBM bandwidth and
operations over the float32 rate outside the tensor cores, the published
peaks of one H100 SXM at its full 700 W (NVIDIA's data sheet). A card set
below 700 W (``nvidia-smi`` ``power.limit``, printed by every run) is held
to the same peaks.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BYTES_PER_NONZERO = 8
FLOP_PER_NONZERO_TOPIC = 6


def em_step_bytes(nnz, n_docs, n_words, k):
    return BYTES_PER_NONZERO * nnz + (n_docs + n_words) * k * 8


def em_step_flop(nnz, k):
    return FLOP_PER_NONZERO_TOPIC * nnz * k


def em_step_least_s(nnz, n_docs, n_words, k):
    """Seconds: the larger of the byte bound and the operation bound."""
    return max(em_step_bytes(nnz, n_docs, n_words, k) / HBM_BYTES_PER_S,
               em_step_flop(nnz, k) / FP32_FLOP_PER_S)
