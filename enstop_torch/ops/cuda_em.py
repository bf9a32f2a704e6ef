"""Wrappers of the hand-written CUDA EM kernels (counterpart of
``enstop_tpu/ops/pallas_em.py``).

``em_accumulators_fused``, ``em_step_fused``, ``refit_step_fused`` and
``log_likelihood_fused`` take the same arguments as their JAX counterparts,
without the TPU tile shape (``bd``, ``bw``): the CUDA kernel has none (see
``csrc/em_dense.cu``). ``refit_accumulators_fused`` returns the refit's raw
``(B, ll)``, as ``em_accumulators_fused`` does for the EM step, so the
kernels can be held against the plain accumulators before normalisation.
On a CPU tensor each wrapper computes its plain PyTorch
version from :mod:`.em`; on a CUDA tensor it launches the kernel or raises.
Normalising the factors after the accumulators is plain torch, as it sits
outside the Pallas kernel in JAX too.

``precision``: ``"highest"`` and ``"default"`` are both served by the fp32
kernel. ``"fast"`` (bf16 responsibilities) is not ported yet.

``LAUNCHES`` counts kernel launches by kernel; it is raised only where a
kernel is launched.
"""

from __future__ import annotations

import torch

from . import em as em_ops
from ._build import library

_TINY = em_ops._TINY
MAX_KP = 256  # the kernel holds at most 8 topics per lane in registers

LAUNCHES = {"em": 0, "refit": 0, "ll": 0}


def _check_precision(precision):
    if precision == "fast":
        raise NotImplementedError(
            "precision='fast' (bf16 responsibilities) has no CUDA kernel yet; "
            "use 'default' or 'highest'"
        )
    if precision not in ("default", "highest"):
        raise ValueError(f"Unrecognized precision {precision!r}")


def _on_cpu(X):
    if X.device.type == "cpu":
        return True
    if X.device.type != "cuda":
        raise ValueError(f"EM kernels run on 'cuda' or 'cpu' tensors, not {X.device}")
    return False


def _weights(sample_weight, n, device):
    if sample_weight is None:
        return torch.ones(n, dtype=torch.float32, device=device)
    if sample_weight.shape != (n,):
        raise ValueError(f"sample_weight has shape {tuple(sample_weight.shape)}, "
                         f"expected ({n},)")
    return sample_weight.to(device=device, dtype=torch.float32).contiguous()


def _launch(kind, X, zd, wz, sample_weight, with_a, with_b, compute_ll):
    """Validate, allocate and launch one kernel; returns ``(AT, B, ll)``."""
    if X.dim() != 2 or zd.dim() != 2 or wz.dim() != 2:
        raise ValueError("X, p_z_given_d and p_w_given_z must be 2-D")
    n, m = X.shape
    kp = zd.shape[1]
    if zd.shape[0] != n or wz.shape != (kp, m):
        raise ValueError(
            f"shape mismatch: X {tuple(X.shape)}, p_z_given_d {tuple(zd.shape)}, "
            f"p_w_given_z {tuple(wz.shape)}"
        )
    if X.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"X must be bfloat16 or float32, not {X.dtype}")
    if zd.dtype != torch.float32 or wz.dtype != torch.float32:
        raise TypeError("factors must be float32")
    if not 0 < kp <= MAX_KP:
        raise ValueError(f"padded topic count {kp} must be in 1..{MAX_KP}")
    if (m * X.element_size()) % 16:
        raise ValueError(f"padded width {m} must fill whole 16-byte rows")
    devices = {t.device for t in (X, zd, wz)}
    if len(devices) != 1:
        raise ValueError(f"X and the factors lie on different devices: {devices}")
    if not (X.is_contiguous() and zd.is_contiguous()):
        raise ValueError("X and p_z_given_d must be contiguous")
    if X.data_ptr() % 16:
        raise ValueError("X must be 16-byte aligned")
    dev = X.device
    w = _weights(sample_weight, n, dev)
    wzT = wz.t().contiguous()  # (m, kp): a nonzero's topic column is contiguous
    AT = torch.zeros((m, kp), dtype=torch.float32, device=dev) if with_a else None
    B = torch.empty((n, kp), dtype=torch.float32, device=dev) if with_b else None
    ll = torch.zeros((1,), dtype=torch.float32, device=dev)
    fn = library("em_dense").enstop_em_dense
    with torch.cuda.device(dev):
        err = fn(
            int(X.dtype == torch.bfloat16), int(with_a), int(with_b), int(compute_ll),
            X.data_ptr(), zd.data_ptr(), wzT.data_ptr(), w.data_ptr(),
            None if AT is None else AT.data_ptr(),
            None if B is None else B.data_ptr(),
            ll.data_ptr(), n, m, kp, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"em_dense kernel launch failed: cudaError {err}")
    LAUNCHES[kind] += 1
    return AT, B, ll[0]


def em_accumulators_fused(X, p_z_given_d, p_w_given_z, sample_weight=None,
                          compute_ll=True, precision="default"):
    """Raw ``(A, B, ll)`` accumulators before normalisation. With
    ``compute_ll=False`` the returned ``ll`` is 0."""
    _check_precision(precision)
    if _on_cpu(X):
        A, B, ll = em_ops.em_accumulators_dense(X, p_z_given_d, p_w_given_z, sample_weight)
        return A, B, ll if compute_ll else torch.zeros_like(ll)
    AT, B, ll = _launch("em", X, p_z_given_d, p_w_given_z, sample_weight,
                        True, True, compute_ll)
    return AT.t(), B, ll


def em_step_fused(X, p_z_given_d, p_w_given_z, sample_weight=None,
                  compute_ll=True, precision="default"):
    """Fused equivalent of :func:`.em.em_step_dense`:
    ``(next_zd, next_wz, ll_of_inputs)``."""
    A, B, ll = em_accumulators_fused(X, p_z_given_d, p_w_given_z, sample_weight,
                                     compute_ll, precision)
    next_wz = p_w_given_z * A
    next_wz = next_wz / next_wz.sum(dim=1, keepdim=True).clamp_min(_TINY)
    next_zd = p_z_given_d * B
    next_zd = next_zd / next_zd.sum(dim=1, keepdim=True).clamp_min(_TINY)
    return next_zd, next_wz, ll


def refit_accumulators_fused(X, p_z_given_d, p_w_given_z, sample_weight=None,
                             compute_ll=True, precision="default"):
    """Raw frozen-topics ``(B, ll)``: ``B`` unweighted, the LL weighted. With
    ``compute_ll=False`` the returned ``ll`` is 0."""
    _check_precision(precision)
    if _on_cpu(X):
        B, ll = em_ops.refit_accumulators_dense(X, p_z_given_d, p_w_given_z,
                                                sample_weight)
        return B, ll if compute_ll else torch.zeros_like(ll)
    _, B, ll = _launch("refit", X, p_z_given_d, p_w_given_z, sample_weight,
                       False, True, compute_ll)
    return B, ll


def refit_step_fused(X, p_z_given_d, p_w_given_z, sample_weight=None,
                     compute_ll=True, precision="default"):
    """Frozen-topics EM step (only ``P(z|d)`` updates):
    ``(next_zd, ll_of_inputs)``."""
    B, ll = refit_accumulators_fused(X, p_z_given_d, p_w_given_z, sample_weight,
                                     compute_ll, precision)
    next_zd = p_z_given_d * B
    return next_zd / next_zd.sum(dim=1, keepdim=True).clamp_min(_TINY), ll


def log_likelihood_fused(X, p_z_given_d, p_w_given_z, sample_weight=None,
                         precision="default"):
    """``sum w * X * log max(P(z|d) P(w|z), 1e-30)``."""
    _check_precision(precision)
    if _on_cpu(X):
        return em_ops.log_likelihood_dense(X, p_z_given_d, p_w_given_z, sample_weight)
    return _launch("ll", X, p_z_given_d, p_w_given_z, sample_weight,
                   False, False, True)[2]
