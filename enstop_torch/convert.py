"""State carried across from the JAX package.

A model fitted by ``enstop_tpu`` reaches the port as numpy arrays: either a
checkpoint written by its ``save()`` (read with
``enstop_torch.models.base.TopicModelBase.load``, which builds the class the
checkpoint records: ``PLSA``, ``EnsembleTopics``, ``StreamedPLSA``,
``BlockParallelPLSA``, ``DistributedPLSA``, or ``GPUPLSA`` for the JAX
package's ``TPUPLSA``/``GPUPLSA``; or with that class's own ``load``) or the
arrays themselves (:func:`from_jax_state` for the pLSA estimators,
``enstop_torch.EnsembleTopics.from_state`` for an ensemble). :func:`pad_state`
turns numpy factors into the padded device tensors the EM ops take; a mesh
model's go on to ``enstop_torch.parallel.mesh.shard_factors``.
"""

from __future__ import annotations

import torch

from .models.base import _estimator_class
from .models.plsa import PLSA
from .ops.data import pad_factors

__all__ = ["from_jax_state", "pad_state"]


def from_jax_state(components, embedding, history=None, params=None, estimator=PLSA):
    """A fitted port estimator from the JAX model's ``components_``,
    ``embedding_``, ``history_`` and ``get_params()``. ``estimator``: the
    port's class, or the JAX class's name (``type(model).__name__``), e.g.
    ``"BlockParallelPLSA"`` for a mesh model; a :class:`PLSA` by default."""
    cls = _estimator_class(estimator) if isinstance(estimator, str) else estimator
    if cls is None:
        raise ValueError(f"no port estimator is called {estimator!r}")
    return cls.from_state(components, embedding, history, params)


def pad_state(zd, wz, n_pad, m_pad, device):
    """Zero-padded float32 tensors ``(P(z|d) (n_pad, kp), P(w|z) (kp, m_pad))``
    on ``device``, with the topic count padded to a multiple of 8."""
    zd_p, wz_p = pad_factors(zd, wz, n_pad, m_pad)
    return torch.from_numpy(zd_p).to(device), torch.from_numpy(wz_p).to(device)
