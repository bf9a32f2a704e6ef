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

The EM step on the card is two launches: the dense kernel's B (and LL) over
the rows of X, and the word pass of :mod:`.cuda_sparse` for A over the
word-major nonzeros of X (``word``, the :class:`~.cuda_sparse.Side` that
``prepare_counts`` builds), one owner per word. Every element of A, B and the
LL is summed in one fixed order, so a step gives the same bits from launch to
launch.

``precision``: ``"highest"`` and ``"default"`` are both served by the fp32
kernel. ``"fast"`` runs the EM and refit steps through the kernel's
bf16-responsibilities mode (``BF16R``; plain version ``em.*_bf16r``), the
counterpart of the TPU's ``jo_res_bf16r`` layout; its log-likelihood sweep is
the fp32 LL kernel, as in JAX.

``LAUNCHES`` counts kernel launches by kernel and mode (``em_bf16r`` and
``refit_bf16r`` are the fast modes); it is raised only where a kernel is
launched.
"""

from __future__ import annotations

import torch

from . import em as em_ops
from ._build import LAUNCHES, library
from .cuda_sparse import MAX_KP, build_side, word_pass

_TINY = em_ops._TINY
_WARPS = 8  # document rows per block of the dense kernel (csrc/em_dense.cu: kWarps)


def _check_precision(precision):
    """True for ``"fast"`` (bf16 responsibilities), False for the fp32 modes."""
    if precision not in ("default", "highest", "fast"):
        raise ValueError(f"Unrecognized precision {precision!r}")
    return precision == "fast"


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


def word_side_of(X):
    """The word-major nonzeros of a padded dense ``X`` as a
    :class:`~.cuda_sparse.Side` (one ``nonzero`` pass over X; ``prepare_counts``
    builds it once from the COO instead)."""
    cols_rows = torch.nonzero(X.t())  # sorted by (column, row)
    cols, rows = cols_rows[:, 0], cols_rows[:, 1]
    return build_side(cols, rows, X[rows, cols].float(), X.shape[1], X.shape[0])


def _launch(kind, X, zd, wz, sample_weight, with_b, compute_ll, bf16_r=False):
    """Validate, allocate and launch one dense kernel; returns ``(B, ll, wzT, w)``."""
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
    B = torch.empty((n, kp), dtype=torch.float32, device=dev) if with_b else None
    # one LL partial per block of the grid, summed below in a fixed order
    ll_part = torch.empty((min(-(-n // _WARPS), 1 << 30) if compute_ll else 0,),
                          dtype=torch.float32, device=dev)
    fn = library("em_dense").enstop_em_dense
    with torch.cuda.device(dev):
        err = fn(
            int(X.dtype == torch.bfloat16), int(bf16_r), int(with_b), int(compute_ll),
            X.data_ptr(), zd.data_ptr(), wzT.data_ptr(), w.data_ptr(),
            None if B is None else B.data_ptr(), ll_part.data_ptr(),
            n, m, kp, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"em_dense kernel launch failed: cudaError {err}")
    LAUNCHES[kind + "_bf16r" if bf16_r else kind] += 1
    return B, ll_part.sum(), wzT, w


def em_accumulators_fused(X, p_z_given_d, p_w_given_z, sample_weight=None,
                          compute_ll=True, precision="default", word=None):
    """Raw ``(A, B, ll)`` accumulators before normalisation. With
    ``compute_ll=False`` the returned ``ll`` is 0. ``word``: the word-major
    nonzeros of X (``PreparedCounts.word``); made from X when None."""
    bf16_r = _check_precision(precision)
    if _on_cpu(X):
        plain = em_ops.em_accumulators_bf16r if bf16_r else em_ops.em_accumulators_dense
        A, B, ll = plain(X, p_z_given_d, p_w_given_z, sample_weight)
        return A, B, ll if compute_ll else torch.zeros_like(ll)
    B, ll, wzT, w = _launch("em", X, p_z_given_d, p_w_given_z, sample_weight,
                            True, compute_ll, bf16_r)
    AT, _ = word_pass(word_side_of(X) if word is None else word, p_z_given_d, wzT, w,
                      compute_ll=False, bf16r=bf16_r)
    return AT.t(), B, ll


def em_step_fused(X, p_z_given_d, p_w_given_z, sample_weight=None,
                  compute_ll=True, precision="default", word=None):
    """Fused equivalent of :func:`.em.em_step_dense`:
    ``(next_zd, next_wz, ll_of_inputs)``."""
    A, B, ll = em_accumulators_fused(X, p_z_given_d, p_w_given_z, sample_weight,
                                     compute_ll, precision, word)
    next_wz = p_w_given_z * A
    next_wz = next_wz / next_wz.sum(dim=1, keepdim=True).clamp_min(_TINY)
    next_zd = p_z_given_d * B
    next_zd = next_zd / next_zd.sum(dim=1, keepdim=True).clamp_min(_TINY)
    return next_zd, next_wz, ll


def refit_accumulators_fused(X, p_z_given_d, p_w_given_z, sample_weight=None,
                             compute_ll=True, precision="default"):
    """Raw frozen-topics ``(B, ll)``: ``B`` unweighted, the LL weighted. With
    ``compute_ll=False`` the returned ``ll`` is 0."""
    bf16_r = _check_precision(precision)
    if _on_cpu(X):
        plain = em_ops.refit_accumulators_bf16r if bf16_r else em_ops.refit_accumulators_dense
        B, ll = plain(X, p_z_given_d, p_w_given_z, sample_weight)
        return B, ll if compute_ll else torch.zeros_like(ll)
    B, ll, _, _ = _launch("refit", X, p_z_given_d, p_w_given_z, sample_weight,
                          True, compute_ll, bf16_r)
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
    """``sum w * X * log max(P(z|d) P(w|z), 1e-30)``; float32 at every
    precision."""
    _check_precision(precision)
    if _on_cpu(X):
        return em_ops.log_likelihood_dense(X, p_z_given_d, p_w_given_z, sample_weight)
    return _launch("ll", X, p_z_given_d, p_w_given_z, sample_weight, False, True)[1]
