"""State carried across from the JAX package.

A model fitted by ``enstop_tpu`` reaches the port as numpy arrays: either a
checkpoint written by its ``save()`` (read with
``enstop_torch.models.base.TopicModelBase.load``, which builds the class the
checkpoint records: ``PLSA``, ``EnsembleTopics``, ``StreamedPLSA``, or
``GPUPLSA`` for the JAX package's ``TPUPLSA``/``GPUPLSA``; or with that
class's own ``load``) or the arrays themselves
(:func:`from_jax_state` for a PLSA, ``enstop_torch.EnsembleTopics.from_state``
for an ensemble). :func:`pad_state` turns numpy factors into the padded device
tensors the EM ops take.
"""

from __future__ import annotations

import torch

from .models.plsa import PLSA
from .ops.data import pad_factors

__all__ = ["from_jax_state", "pad_state"]


def from_jax_state(components, embedding, history=None, params=None):
    """A fitted port :class:`PLSA` from the JAX model's ``components_``,
    ``embedding_``, ``history_`` and ``get_params()``."""
    return PLSA.from_state(components, embedding, history, params)


def pad_state(zd, wz, n_pad, m_pad, device):
    """Zero-padded float32 tensors ``(P(z|d) (n_pad, kp), P(w|z) (kp, m_pad))``
    on ``device``, with the topic count padded to a multiple of 8."""
    zd_p, wz_p = pad_factors(zd, wz, n_pad, m_pad)
    return torch.from_numpy(zd_p).to(device), torch.from_numpy(wz_p).to(device)
