"""All-pairs distances between topic distributions (counterpart of
``enstop_tpu/cluster/distances.py``).

Both matrices are matmul-shaped:

* Hellinger: ``H_ij = sqrt(1 - sum_w sqrt(t_i t_j))``, one Gram matrix of the
  row-sqrt'd topics;
* KL (base 2): ``KL_ij = sum_w t_i (log2 t_i - log2 t_j)`` over the entries
  where both are positive, an inner product of ``t_i`` with ``log2 t_j`` plus a
  row entropy.

The inputs are small (``n_runs * k`` topic rows), so the products are plain
``torch.matmul`` on the stack's device, in full float32 with TF32 off: the
matrices feed HDBSCAN, whose dendrogram is sensitive to last-ulp ties (the JAX
package uses ``Precision.HIGHEST`` for the same reason).

A tensor stack is used on its own device. Any other stack (numpy, a list)
goes to ``device``: the card by default, as JAX puts such input on its
default device; a CUDA device that is missing raises, nothing falls back to
the CPU. ``device="cpu"`` asks for the host.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..ops.data import resolve_device

__all__ = ["all_pairs_hellinger_distance", "all_pairs_kl_divergence",
           "hellinger", "kl_divergence", "full_fp32_matmul", "stack_device"]


@contextlib.contextmanager
def full_fp32_matmul():
    """Float32 matrix products in full float32 (no TF32) inside the block."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def kl_divergence(a, b):
    """KL divergence between two multinomials in bits, skipping entries where
    either side is zero."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    mask = (a > 0) & (b > 0)
    return float(np.sum(a[mask] * (np.log2(a[mask]) - np.log2(b[mask]))))


def hellinger(a, b):
    """Hellinger distance between two l1-normalized distributions."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    sim = np.sum(np.sqrt(a * b))
    l1a, l1b = a.sum(), b.sum()
    if l1a == 0 and l1b == 0:
        return 0.0
    if l1a == 0 or l1b == 0:
        return 1.0
    return float(np.sqrt(max(0.0, 1.0 - sim / np.sqrt(l1a * l1b))))


def stack_device(distributions, device=None):
    """The device a topic stack is used on: a tensor's own, else ``device``
    (``"cuda"`` when None)."""
    if isinstance(distributions, torch.Tensor):
        return distributions.device
    return resolve_device("cuda" if device is None else device)


def _as_f32(distributions, device=None):
    # a tensor stays on its device: the ensemble fan-out hands over the topic
    # stack where it was fitted
    if isinstance(distributions, torch.Tensor):
        return distributions.float()
    dev = stack_device(distributions, device)
    return torch.from_numpy(np.asarray(distributions, dtype=np.float32)).to(dev)


def _to_host(d):
    out = d.cpu().numpy().astype(np.float64)
    np.fill_diagonal(out, 0.0)
    return out


def _hellinger_matrix(T):
    sq = T.clamp_min(0.0).sqrt()
    with full_fp32_matmul():
        sim = sq @ sq.t()
    l1 = T.sum(dim=1)
    denom = torch.outer(l1, l1).sqrt()
    zero = l1 == 0
    both_zero = zero[:, None] & zero[None, :]
    one_zero = (zero[:, None] | zero[None, :]) & ~both_zero
    ratio = torch.where(denom > 0, sim / denom.clamp_min(1e-30), 0.0)
    d = (1.0 - ratio).clamp_min(0.0).sqrt()
    return torch.where(both_zero, 0.0, torch.where(one_zero, 1.0, d))


def all_pairs_hellinger_distance(distributions, device=None):
    """Pairwise Hellinger distances as float64 numpy, zero diagonal."""
    return _to_host(_hellinger_matrix(_as_f32(distributions, device)))


def _kl_matrix(T):
    pos = T > 0
    logT = torch.where(pos, T.clamp_min(1e-38).log2(), 0.0)
    with full_fp32_matmul():
        # cross_ij = sum_w t_i log2 t_j over w where t_i > 0 and t_j > 0
        cross = torch.where(pos, T, 0.0) @ logT.t()
        # the self term drops the entries where t_j == 0 as well:
        # self_ij = sum_w t_i log2 t_i [t_j > 0]
        self_cross = torch.where(pos, T * logT, 0.0) @ pos.float().t()
    return self_cross - cross


def all_pairs_kl_divergence(distributions, device=None):
    """Pairwise KL divergences in bits as float64 numpy, zero diagonal."""
    return _to_host(_kl_matrix(_as_f32(distributions, device)))
