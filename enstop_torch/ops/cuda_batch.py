"""Wrappers of the hand-written CUDA batched EM kernel (counterpart of
``enstop_tpu/ops/pallas_batch.py``): R runs that share one X, each with its
own factors and document weights, in one pass over X a step.

The functions take the JAX functions' arguments without the TPU tile shape
(``bd``, ``bw``), as :mod:`.cuda_em` does: X (n, m), ``zds`` (R, n, kp),
``wzs`` (R, kp, m), ``ws`` (R, n) or None. ``batched_accumulators`` returns
the raw ``(A (R, kp, m), B (R, n, kp))``, A weighted and B never. On a CPU
tensor it computes the plain version (:func:`.em.batched_accumulators_dense`);
on a CUDA tensor it launches the kernels or raises: the row pass of
``csrc/em_batch.cu`` for B, counted as ``"batch"``, and for A the word pass of
``csrc/em_sparse.cu`` over the word-major nonzeros ``word``, all R runs in
one launch, counted as ``"batch_word"``. ``batched_em_step``
normalises outside the kernel, as JAX does; ``batched_em_fit`` runs a fixed
number of steps, with no log-likelihood, no tests and no early stop, as in
JAX. ``batched_em_step_`` is the step in place on a group's tables, each
run's next factors a single-run ``em_step_fused``'s bit for bit.

``precision``: ``"default"``, ``"highest"`` and ``"fast"`` all run fp32. The
JAX batch kernel has no bf16-responsibilities layout, and its ``"fast"``
resolves to the same matmul precision as ``"default"``; the port maps that
precision class to fp32.

``word`` is the word-major :class:`~.cuda_sparse.Side` of X (from
:func:`.cuda_em.word_side_of` or ``PreparedCounts.word``). It depends on X
only, so every run and every step shares one; ``batched_em_fit`` builds it
once when it is not given.

Each run's A and B are those of a single-run ``em_accumulators_fused`` bit
for bit: the row pass walks each run with the dense kernel's walk under the
order invariant of ``csrc/row_walk.cuh``, and the word pass walks each run as
a run of its own. The row pass streams X once for all runs: each warp
compacts its row's nonzeros into a queue of ``BATCH_STREAM.queue`` entries in
shared memory and walks it once a run (a row with more nonzeros is streamed
again for each run after the first).

``EnsembleTopics`` fits its bootstrap runs on this path where the corpus is
staged dense (a ``PreparedCounts``) and the step is fp32 (``"default"``,
``"highest"``): ``ops/driver.py`` ``fit_padded_runs`` advances a group of runs
by ``batched_em_step_`` between test points and retires each run at its own
test, so every run keeps the single-run schedule, early stop and bits. The
sparse layout (``PreparedSell``) and ``precision="fast"`` (bf16
responsibilities, which this kernel has no layout for) fit one run after
another.
"""

from __future__ import annotations

import numpy as np
import torch

from . import em as em_ops
from ._build import LAUNCHES, launch, library
from .cuda_em import (ROW_STREAM, _check_narrow, _check_precision, _on_cpu, walk_args,
                      word_side_of)
from .cuda_sparse import launch_pass
from .data import resolve_device

__all__ = ["BATCH_STREAM", "batch_rows", "batch_words", "batched_accumulators",
           "batched_em_step", "batched_em_step_", "batched_em_fit"]

# the row pass's stream: a queue that holds a whole row of the corpora at hand
# (a 20NG row has at most 196 nonzeros), so X is streamed once for all runs;
# 2 KB windows measured best at R = 16 on an H100 (scripts/torch_dense_sweep.py)
BATCH_STREAM = ROW_STREAM._replace(window=2048, queue=512)


def _check_tables(zds, wzT, n, m, device, ws=None):
    """The run tables the passes read: ``zds`` (R, n, kp), ``wzT`` (R, m, kp)
    and, for the word pass, ``ws`` (R, n); float32, contiguous, on the CUDA
    ``device``. Returns ``(R, kp)``."""
    if zds.dim() != 3 or wzT.dim() != 3:
        raise ValueError("zds and wzT must be 3-D")
    R, _, kp = zds.shape
    shapes = [(zds, (R, n, kp)), (wzT, (R, m, kp))] + ([] if ws is None else [(ws, (R, n))])
    for t, shape in shapes:
        if tuple(t.shape) != shape:
            raise ValueError(f"a run table has shape {tuple(t.shape)}, expected {shape}")
    for t, _ in shapes:
        if t.dtype != torch.float32:
            raise TypeError(f"run tables must be float32, not {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("run tables must be contiguous")
        if t.device != device or device.type != "cuda":
            raise ValueError(f"a run table lies on {t.device}, the pass runs on {device}")
    _check_narrow(kp)
    return R, kp


def batch_rows(X, zds, wzT, shape=None, stream=BATCH_STREAM):
    """The row pass: ``B`` (R, n, kp) from X (n, m), bf16 or float32, and the
    run tables ``zds`` (R, n, kp) and ``wzT`` (R, m, kp). ``shape`` (L, TPL)
    and ``stream`` (:class:`~.cuda_em.RowStream`) shape the walk."""
    if X.dim() != 2 or X.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"X must be a 2-D bfloat16 or float32 tensor, not {X.dtype} "
                        f"of {X.dim()} dimensions")
    n, m = X.shape
    if ((m * X.element_size()) % 16 or m >= 2**31 or not X.is_contiguous()
            or X.data_ptr() % 16):
        raise ValueError(f"X must be contiguous and 16-byte aligned in whole 16-byte rows "
                         f"(padded width {m}, below 2^31)")
    R, kp = _check_tables(zds, wzT, n, m, X.device)
    args = walk_args(kp, shape, stream)
    B = torch.empty((R, n, kp), dtype=torch.float32, device=X.device)
    launch("batch", library("em_batch").enstop_em_batch, X.device,
           int(X.dtype == torch.bfloat16), *args,
           X.data_ptr(), zds.data_ptr(), wzT.data_ptr(), B.data_ptr(), R, n, m, kp)
    return B


def batch_words(word, zds, wzT, ws):
    """The word pass: ``A^T`` (R, m, kp) over the word-major ``word`` side of
    X, from the run tables ``zds`` (R, n, kp), ``wzT`` (R, m, kp) and the
    document weights ``ws`` (R, n): the sparse word pass, one launch for all
    runs."""
    m, n = word.n_owner, word.n_index
    R, kp = _check_tables(zds, wzT, n, m, word.device, ws)
    if R > 65535:
        raise ValueError(f"the word pass takes at most 65535 runs a launch, not {R}")
    AT, _ = launch_pass(word, zds, wzT, ws, True)
    LAUNCHES["batch_word"] += 1
    return AT


def batched_accumulators(X, zds, wzs, ws=None, precision="default", word=None):
    """Raw ``(A (R, kp, m), B (R, n, kp))`` of every run before normalisation.
    ``ws``: per-run document weights, any shape of R * n elements, or None.
    ``word``: the word-major nonzeros of X; made from X when None."""
    _check_precision(precision)
    if ws is not None:
        ws = ws.reshape(zds.shape[0], zds.shape[1])
    if _on_cpu(X):
        return em_ops.batched_accumulators_dense(X, zds, wzs, ws)
    if wzs.dim() != 3:
        raise ValueError(f"wzs must be (R, kp, m), not of shape {tuple(wzs.shape)}")
    zds = zds.contiguous()
    wzT = wzs.transpose(1, 2).contiguous()  # (R, m, kp): a word's topic row is contiguous
    ws = (torch.ones(zds.shape[:2], device=X.device) if ws is None
          else ws.to(torch.float32).contiguous())
    B = batch_rows(X, zds, wzT)
    AT = batch_words(word_side_of(X) if word is None else word, zds, wzT, ws)
    return AT.transpose(1, 2), B


def batched_em_step(X, zds, wzs, ws=None, precision="default", word=None):
    """One EM step of every run: ``(next_zds, next_wzs)``."""
    A, B = batched_accumulators(X, zds, wzs, ws, precision, word)
    next_wz = em_ops._rownorm(wzs * A)
    return em_ops._rownorm(zds * B), next_wz


def _rownorm_runs_(P, out):
    """``em._rownorm`` of each run's rows of ``P`` (R, rows, cols) into ``out``:
    the sums run by run, so each run's sum is that of a single-run tensor (a
    reduction's order follows its tensor's shape), the quotients over the
    batch (elementwise, the same bits)."""
    S = P.new_empty((*P.shape[:-1], 1))
    for r in range(P.shape[0]):
        torch.sum(P[r], dim=-1, keepdim=True, out=S[r])
    torch.div(P, S.clamp_min_(em_ops._TINY), out=out)


def batched_em_step_(X, zds, wzs, wzT, ws, word=None):
    """One EM step of every run in place: ``zds`` (R, n, kp) and ``wzs`` (R, kp,
    m) take the next factors, and on a CUDA tensor ``wzT`` (R, m, kp), their
    transpose, too (None on the CPU); ``ws`` (R, n) are the document weights;
    all contiguous. Each run's next factors are a single-run
    ``em_step_fused``'s bit for bit: A and B as :func:`batched_accumulators`
    gives them, normalised as ``em._rownorm`` normalises them. On the card
    the word pass runs first, so its partials are let go before B is made."""
    if _on_cpu(X):
        A, B = em_ops.batched_accumulators_dense(X, zds, wzs, ws)
    else:
        A = batch_words(word_side_of(X) if word is None else word, zds, wzT, ws).transpose(1, 2)
        B = batch_rows(X, zds, wzT)
    _rownorm_runs_(wzs.mul_(A), wzs)
    del A
    _rownorm_runs_(B.mul_(zds), zds)
    if wzT is not None:
        wzT.copy_(wzs.transpose(1, 2))


def _on(device, a, dtype=None):
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(a)
    if dtype is None and a.dtype not in (torch.bfloat16, torch.float32):
        dtype = torch.float32
    return a.to(device=device, dtype=dtype)


def batched_em_fit(X, zds, wzs, ws, n_iter, precision="default", word=None, device="cuda"):
    """A fixed number of batched EM steps of every run; ``(zds, wzs)``.

    Arrays (numpy or tensors) go to ``device``, which defaults to the card and
    raises where there is none; pass ``device="cpu"`` for the plain path. X
    keeps a bfloat16 or float32 type and takes float32 otherwise."""
    dev = resolve_device(device)
    _check_precision(precision)
    X = _on(dev, X)
    zds, wzs = _on(dev, zds, torch.float32), _on(dev, wzs, torch.float32)
    ws = None if ws is None else _on(dev, ws, torch.float32)
    if dev.type == "cuda" and word is None:
        word = word_side_of(X)
    for _ in range(n_iter):
        zds, wzs = batched_em_step(X, zds, wzs, ws, precision, word)
    return zds, wzs
