"""The least time one Kullback-Leibler multiplicative update of NMF (``W``
then ``H``, :mod:`reference.ensemble_nmf`) can take on one NVIDIA H100 SXM.

Counted from the work of the algorithm at a corpus's ``nnz``, ``n_docs``,
``n_words`` and ``k``, as ``roofline.py`` counts a pLSA EM iteration, whose
peaks it takes.

Bytes: ``roofline.em_step_bytes``, the same as an EM iteration's. The H
update's ratios need the new ``W`` only at their own document, and ``H`` not
yet changed, so one walk over the documents can update a document's ``W``
row and then add its entries' share to ``H``'s numerator: the corpus is read
once (value and word index, 4 + 4 B a nonzero), and both factor tables read
once and written once in float32, ``(n_docs + n_words) * k * 8`` B.

Operations: 8 float32 operations per nonzero per topic, where an EM
iteration has 6: the product ``W H`` at the nonzero and its sum over the
topics, for the old ``W`` and again for the new one (4), and the two
accumulations, ratio times ``H`` into ``W``'s numerator and ratio times ``W``
into ``H``'s (4). The ratio itself is one division a nonzero, and the
updates of the factors themselves ``O((n_docs + n_words) k)``: neither is
counted.

The least time is the larger of bytes over the HBM bandwidth and
operations over the float32 rate outside the tensor cores. At the whole
UCI NYTimes corpus and k = 20 the bytes bound it (0.186 ms; the operations
0.166 ms).
"""

from __future__ import annotations

from roofline import FP32_FLOP_PER_S, HBM_BYTES_PER_S, em_step_bytes

FLOP_PER_NONZERO_TOPIC = 8


def mu_step_flop(nnz, k):
    return FLOP_PER_NONZERO_TOPIC * nnz * k


def mu_step_least_s(nnz, n_docs, n_words, k):
    """Seconds: the larger of the byte bound and the operation bound."""
    return max(em_step_bytes(nnz, n_docs, n_words, k) / HBM_BYTES_PER_S,
               mu_step_flop(nnz, k) / FP32_FLOP_PER_S)
