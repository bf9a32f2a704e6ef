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
``refit_bf16r`` are the fast modes, ``em_<mode>`` and ``word_pass_<mode>``
the ratio modes below); it is raised only where a kernel is launched.

``_em_accumulators_ratio`` (private: no estimator reaches it) is the port of
the TPU experiment ``scripts/exp_divide_pipeline.py`` (``_make_em_call``):
the EM step's ``(A, B)`` without the LL, its ratio ``x / max(S, 1e-30)`` in
one of ``RATIO_MODES`` (``csrc/lane_walk.cuh``). ``"f32div"`` is the fp32
step and ``"bf16r"`` the fast one, the same launches as
:func:`em_accumulators_fused`; the five others are built for bf16 X at kp
17-32 only. The experiment's other kernel, the mask-free step of
``scripts/exp_kernel_variants.py``, is the shipped step.

The dense kernel walks each row as ``csrc/row_walk.cuh`` describes: X staged
through a ring of windows in shared memory, its nonzeros compacted into a
queue and walked by lane groups of the shape ``cuda_sparse.walk_shape(kp)``.
:class:`RowStream` is the stream's shape (``ROW_STREAM`` by default; the
batched row pass of :mod:`.cuda_batch` takes the same); no choice of it
changes a bit of the results.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import em as em_ops
from ._build import LAUNCHES, library
from .cuda_sparse import (MAX_KP, MAX_NARROW_KP, _pass, _ratio_of, build_side, walk_shape,
                          word_pass)

RATIO_MODES = em_ops.RATIO_MODES
_SMEM_LIMIT = 232_448 - 1024  # shared memory a block may use on an H100, less the static part
# the walk shapes (L, TPL) built beside cuda_sparse.WALK_SHAPES, for bf16 X in the
# B-only mode with kp % 4 == 0 (csrc/row_walk.cuh: kSweepShapes)
SWEEP_SHAPES = ((1, 24), (2, 12), (8, 4), (8, 16), (32, 4))


class RowStream(NamedTuple):
    """How the row walk streams X (``csrc/row_walk.cuh``): ``warps`` rows a
    block (1-16), a ring of ``stages`` windows (2-8) of ``window`` bytes (a
    multiple of 512) a warp, and a queue of ``queue`` nonzeros a warp (a
    multiple of 32, at least 256). The defaults measured best for the dense
    kernel on an H100 at 20NG (scripts/torch_dense_sweep.py)."""

    warps: int = 4
    stages: int = 2
    window: int = 4096
    queue: int = 256

    def smem_bytes(self):
        """Dynamic shared memory of a block (``row_walk::smem_bytes``)."""
        bars = -(-self.warps * self.stages * 8 // 128) * 128
        return bars + self.warps * (self.stages * self.window + 8 * self.queue)

    def check(self):
        """Raise ``ValueError`` on a shape the kernels do not take."""
        if not (1 <= self.warps <= 16 and 2 <= self.stages <= 8 and self.window > 0
                and self.window % 512 == 0 and self.queue >= 256 and self.queue % 32 == 0):
            raise ValueError(f"the row walk does not take {self}")
        if self.smem_bytes() > _SMEM_LIMIT:
            raise ValueError(f"{self} needs {self.smem_bytes()} bytes of shared memory a "
                             f"block, more than {_SMEM_LIMIT}")
        return self


ROW_STREAM = RowStream()  # the dense kernel's stream (scripts/torch_dense_sweep.py)


def _check_narrow(kp):
    """Raise ``ValueError`` on a padded topic count the row walk (#1-#3, #6,
    #7) and the batched kernel (#10) do not take; the sparse passes take more."""
    if not 0 < kp <= MAX_NARROW_KP:
        raise ValueError(f"padded topic count {kp} must be in 1..{MAX_NARROW_KP} on the dense "
                         f"path and the batched fit; backend='sparse' fits up to {MAX_KP} "
                         f"topics")


def walk_args(kp, shape, stream):
    """The walk's and the stream's integer arguments of both row kernels:
    ``(lanes, tpl, warps, stages, window, queue)``. ``shape`` is ``(L,
    TPL)``, ``walk_shape(kp)`` when None."""
    _check_narrow(kp)
    lanes, tpl = walk_shape(kp) if shape is None else shape
    if lanes * tpl < kp:
        raise ValueError(f"walk shape {(lanes, tpl)} holds fewer than {kp} topics")
    return (lanes, tpl, *stream.check())


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


def _launch(kind, X, zd, wz, sample_weight, with_b, compute_ll, ratio="f32div", shape=None,
            stream=ROW_STREAM):
    """Validate, allocate and launch one dense kernel; returns ``(B, ll, wzT, w)``.
    ``ratio`` is one of ``RATIO_MODES`` (``"bf16r"``: ``precision="fast"``);
    ``shape`` (L, TPL) and ``stream`` (:class:`RowStream`) shape the walk."""
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
    if (m * X.element_size()) % 16 or m >= 2**31:
        raise ValueError(f"padded width {m} must fill whole 16-byte rows, below 2^31")
    args = walk_args(kp, shape, stream)
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
    ll_part = torch.empty((-(-n // stream.warps) if compute_ll else 0,),
                          dtype=torch.float32, device=dev)
    fn = library("em_dense").enstop_em_dense
    with torch.cuda.device(dev):
        err = fn(
            int(X.dtype == torch.bfloat16), RATIO_MODES.index(ratio), int(with_b),
            int(compute_ll), *args,
            X.data_ptr(), zd.data_ptr(), wzT.data_ptr(), w.data_ptr(),
            None if B is None else B.data_ptr(), ll_part.data_ptr(),
            n, m, kp, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"em_dense kernel launch failed: cudaError {err}")
    LAUNCHES[kind if ratio == "f32div" else f"{kind}_{ratio}"] += 1
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
                            True, compute_ll, _ratio_of(bf16_r))
    AT, _ = word_pass(word_side_of(X) if word is None else word, p_z_given_d, wzT, w,
                      compute_ll=False, bf16r=bf16_r)
    return AT.t(), B, ll


def _em_accumulators_ratio(X, p_z_given_d, p_w_given_z, sample_weight=None, mode="f32div",
                           word=None):
    """Raw ``(A, B)`` of one EM step without the LL, the ratio in ``mode``
    (one of ``RATIO_MODES``): the counterpart of ``_make_em_call(mode, ...)``
    in ``scripts/exp_divide_pipeline.py``. On a CUDA tensor the dense B pass,
    then the word pass for A over ``word`` (made from X when None), both in
    ``mode``. Raises ``ValueError`` on an unknown mode, and for the five modes
    other than ``"f32div"`` and ``"bf16r"`` unless X is bfloat16 and kp lies
    in 17-32 (the walk shape (4, 8), the only one they are built at)."""
    if mode not in RATIO_MODES:
        raise ValueError(f"unknown ratio mode {mode!r}; one of {RATIO_MODES}")
    kp = p_z_given_d.shape[-1]
    if mode not in ("f32div", "bf16r") and (X.dtype != torch.bfloat16
                                            or walk_shape(kp) != (4, 8)):
        raise ValueError(f"ratio mode {mode!r} is built for bfloat16 X at kp 17-32, not "
                         f"{X.dtype} at kp {kp}")
    if _on_cpu(X):
        return em_ops.em_accumulators_ratio(X, p_z_given_d, p_w_given_z, sample_weight, mode)
    B, _, wzT, w = _launch("em", X, p_z_given_d, p_w_given_z, sample_weight, True, False, mode)
    AT, _ = _pass(word_side_of(X) if word is None else word, p_z_given_d, wzT, w, True, None,
                  False, mode)
    return AT.t(), B


def em_step_fused(X, p_z_given_d, p_w_given_z, sample_weight=None,
                  compute_ll=True, precision="default", word=None):
    """Fused equivalent of :func:`.em.em_step_dense`:
    ``(next_zd, next_wz, ll_of_inputs)``."""
    A, B, ll = em_accumulators_fused(X, p_z_given_d, p_w_given_z, sample_weight,
                                     compute_ll, precision, word)
    next_wz = em_ops._rownorm(p_w_given_z * A)
    return em_ops._rownorm(p_z_given_d * B), next_wz, ll


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
                          True, compute_ll, _ratio_of(bf16_r))
    return B, ll


def refit_step_fused(X, p_z_given_d, p_w_given_z, sample_weight=None,
                     compute_ll=True, precision="default"):
    """Frozen-topics EM step (only ``P(z|d)`` updates):
    ``(next_zd, ll_of_inputs)``."""
    B, ll = refit_accumulators_fused(X, p_z_given_d, p_w_given_z, sample_weight,
                                     compute_ll, precision)
    return em_ops._rownorm(p_z_given_d * B), ll


def log_likelihood_fused(X, p_z_given_d, p_w_given_z, sample_weight=None,
                         precision="default"):
    """``sum w * X * log max(P(z|d) P(w|z), 1e-30)``; float32 at every
    precision."""
    _check_precision(precision)
    if _on_cpu(X):
        return em_ops.log_likelihood_dense(X, p_z_given_d, p_w_given_z, sample_weight)
    return _launch("ll", X, p_z_given_d, p_w_given_z, sample_weight, False, True)[1]
