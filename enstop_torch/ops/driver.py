"""Fit and refit drivers: host-side orchestration around the EM loops
(counterpart of ``enstop_tpu/ops/driver.py``).

Stage the counts on the device as a zero-padded dense matrix (or as the
sparse layout of :mod:`.sell`), initialise the factors (the random init drawn
on the card where :func:`.init._draws_on_device` allows, the host's bits
either way), run the EM loop, undo the padding.

Backends, resolved from the explicit ``device``:

``"cuda"``    the hand-written CUDA kernels of :mod:`.cuda_em` (``device="cuda"``)
``"torch"``   the plain PyTorch ops of :mod:`.em` (``device="cpu"``)
``"sparse"``  the O(nnz) path of :mod:`.sell` on either device (its kernels
              on ``"cuda"``, their plain versions on ``"cpu"``); the only path
              that applies ``e_step_thresh`` exactly
``"auto"``    whichever of the dense two matches the device; raw input with a
              materially firing ``e_step_thresh`` (> 1e-30) runs ``"sparse"``

A :class:`PreparedCounts` always runs dense and a :class:`~.sell.PreparedSell`
sparse, whatever the threshold, as in the JAX package. The layout is decided
once, where the corpus is staged (:func:`_staged`); past that a fit, a refit
or the ensemble's runs ask the staged corpus (:class:`~.data._Staged`) and
never its class.
"""

from __future__ import annotations

import itertools

import numpy as np
import scipy.sparse as sp
import torch

from ..profiling import count, is_open, request, span
from ..utils import check_random_state, standardize_input
from . import cuda_batch, cuda_em, em as em_ops
from .data import (COL_MULTIPLE, K_MULTIPLE, ROW_MULTIPLE, _is_staged, _padded_on, _Staged,
                   _weighted, pad_factors, pad_vector, resolve_device, round_up, ship_coo,
                   unpad_factors)
from .fit import FitResult, _Trace, em_fit_loop, em_fit_loop_folded
from .init import _draws_on_device, _uniform_rows, plsa_init
from .sell import _material_thresh, prepare_sell, word_side

__all__ = [
    "PreparedCounts", "prepare_counts", "plsa_fit", "plsa_refit",
    "resolve_device", "resolve_backend", "kernel_steps", "plain_steps",
    "fit_padded", "fit_padded_runs", "refit_padded",
]


def resolve_backend(backend, device):
    if backend == "sparse":
        return backend
    expected = "cuda" if device.type == "cuda" else "torch"
    if backend == "auto":
        return expected
    if backend not in ("cuda", "torch"):
        raise ValueError(f"Unrecognized backend {backend!r}")
    if backend != expected:
        raise ValueError(f"backend={backend!r} does not run on device {str(device)!r}; "
                         f"use {expected!r}")
    return backend


def kernel_steps(precision="default", word=None):
    """The step functions of the fit loops, through the :mod:`.cuda_em`
    wrappers (kernels on CUDA tensors, plain ops on CPU tensors). ``word``:
    the word-major nonzeros of the X the steps get (``PreparedCounts.word``).
    At the fp32 precisions they include ``em_batch``, the batched step in
    place on a group of runs (:func:`.cuda_batch.batched_em_step_`); the
    batched kernel has no bf16-responsibilities layout."""
    fast = cuda_em._check_precision(precision)

    def em(X, zd, wz, w):
        return cuda_em.em_step_fused(X, zd, wz, w, compute_ll=False, precision=precision,
                                     word=word)

    def em_ll(X, zd, wz, w):
        return cuda_em.em_step_fused(X, zd, wz, w, compute_ll=True, precision=precision,
                                     word=word)

    def refit(X, zd, wz, w):
        return cuda_em.refit_step_fused(X, zd, wz, w, compute_ll=False, precision=precision)

    def ll(X, zd, wz, w):
        return cuda_em.log_likelihood_fused(X, zd, wz, w, precision=precision)

    steps = {"em": em, "em_ll": em_ll, "refit": refit, "ll": ll}
    if not fast:
        def em_batch(X, zds, wzs, wzT, ws):
            cuda_batch.batched_em_step_(X, zds, wzs, wzT, ws, word)

        steps["em_batch"] = em_batch
    return steps


def plain_steps(precision="default"):
    """The same step functions from the plain PyTorch ops on any device: the
    reference the kernels are held against (the bf16-responsibilities steps
    at ``"fast"``)."""
    if cuda_em._check_precision(precision):
        em, refit = em_ops.em_step_bf16r, em_ops.refit_step_bf16r
    else:
        em, refit = em_ops.em_step_dense, em_ops.refit_step_dense
    return {"em": em, "em_ll": em, "refit": refit, "ll": em_ops.log_likelihood_dense}


def fit_padded(Xd, zd, wz, w, n_iter, n_iter_per_test, tolerance, steps):
    """EM on padded device tensors with the folded-LL loop; a FitResult."""
    def step(state, fn):
        new_zd, new_wz, ll = fn(Xd, state[0], state[1], w)
        return (new_zd, new_wz), ll

    return em_fit_loop_folded(
        lambda s: step(s, steps["em_ll"]), lambda s: step(s, steps["em"]),
        lambda s: steps["ll"](Xd, s[0], s[1], w),
        (zd, wz), n_iter, n_iter_per_test, tolerance,
    )


def fit_padded_runs(Xd, runs, sizes, n_iter, n_iter_per_test, tolerance, steps):
    """EM of many runs on one padded ``Xd``, a group of runs at a time, each run
    on :func:`em_fit_loop_folded`'s schedule with its bits, its steps and its
    log-likelihood trace.

    ``runs`` yields each run's padded ``(zd, wz, w)`` on Xd's device; ``sizes``
    are the groups' sizes in order, summing to the number of runs. A group's
    runs are drawn in order into its tables and start together, so their test
    points (after steps 1, 1 + npt, 1 + 2 npt, ...) coincide. Between tests
    every live run advances by ``steps["em_batch"]``, one pass over Xd a step
    for the group; the step after a test point T is each live run's own
    ``steps["em_ll"]`` step, whose log-likelihood is LL(state_T), and the
    group's values come back in one read. A run that converges is retired at
    T with state_T (its folded step discarded) and the group's tables shrink;
    a test point at ``n_iter`` reads ``steps["ll"]``. Yields ``(i,
    FitResult)`` as run ``i`` ends; its state is views of the group's tables,
    which hold until the next item is drawn. Counts the run-steps taken in
    batched launches (``batched_run_steps``)."""
    n_iter, npt = int(n_iter), max(int(n_iter_per_test), 1)
    runs = enumerate(runs)
    for size in sizes:
        ids, zds, wzs, ws = [], None, None, None
        for j, (i, (zd, wz, w)) in enumerate(itertools.islice(runs, size)):
            if j == 0:
                zds = zd.new_empty((size, *zd.shape), dtype=torch.float32)
                wzs = wz.new_empty((size, *wz.shape), dtype=torch.float32)
                ws = w.new_empty((size, *w.shape), dtype=torch.float32)
            zds[j].copy_(zd)
            wzs[j].copy_(wz)
            ws[j].copy_(w)
            ids.append(i)
            del zd, wz, w  # the tables hold the run now
        yield from _fit_group(Xd, ids, zds, wzs, ws, n_iter, npt, tolerance, steps)


def _fit_group(Xd, ids, zds, wzs, ws, n_iter, npt, tolerance, steps):
    """:func:`fit_padded_runs` for one group: ``ids`` the runs' indices, their
    factors and weights in the tables ``zds`` (R, n, kp), ``wzs`` (R, kp, m),
    ``ws`` (R, n)."""
    wzT = wzs.transpose(1, 2).contiguous() if Xd.is_cuda else None
    tables = [t for t in (zds, wzs, wzT, ws) if t is not None]
    R, batched = len(ids), 0

    def read(lls):
        """Each run's LL as a float32, the group's in one read."""
        count("host_syncs")
        return torch.stack(lls).cpu().numpy()

    def ll_steps(fn):
        outs = [fn(Xd, zds[j], wzs[j], ws[j]) for j in range(R)]
        return outs, read([o[-1] for o in outs])

    def take(outs, keep):
        # the continuing runs take their folded step's state
        for j in keep:
            zds[j].copy_(outs[j][0])
            wzs[j].copy_(outs[j][1])
            if wzT is not None:
                wzT[j].copy_(outs[j][1].t())

    def ended(j, n_steps, rec):
        return ids[j], FitResult((zds[j], wzs[j]), n_steps, float(rec.prev), rec.trace, rec.t)

    # the first step carries LL(state0) out for free
    outs, lls = ll_steps(steps["em_ll"])
    recs = [_Trace(ll, tolerance) for ll in lls]
    if n_iter == 0:
        for j in range(R):
            yield ended(j, 0, recs[j])
        return
    take(outs, range(R))
    del outs
    done = next_tp = 1
    while R and (done < n_iter or next_tp <= n_iter):
        T = min(next_tp, n_iter)
        for _ in range(T - done):
            steps["em_batch"](Xd, zds[:R], wzs[:R], None if wzT is None else wzT[:R], ws[:R])
        batched += (T - done) * R
        if T < next_tp:  # the steps after the last test point up to n_iter
            done = n_iter
            continue
        if T < n_iter:
            outs, lls = ll_steps(steps["em_ll"])
            done = T + 1
        else:
            outs, lls = None, read([steps["ll"](Xd, zds[j], wzs[j], ws[j]) for j in range(R)])
            done = T
        converged = [recs[j].test(lls[j]) for j in range(R)]
        for j in range(R):
            if converged[j]:  # the reference stops AT the test point
                yield ended(j, T, recs[j])
        keep = [j for j in range(R) if not converged[j]]
        if outs is not None:
            take(outs, keep)
        del outs
        for new, old in enumerate(keep):  # the retired runs leave the tables
            if new != old:
                for t in tables:
                    t[new].copy_(t[old])
        ids, recs, R = [ids[j] for j in keep], [recs[j] for j in keep], len(keep)
        next_tp = T + npt
    for j in range(R):
        yield ended(j, done, recs[j])
    count("batched_run_steps", batched)


def refit_padded(Xd, zd, wz, w, n_iter, n_iter_per_test, tolerance, steps):
    """Frozen-topics EM on padded device tensors; a FitResult."""
    def step(state):
        new_zd, ll = steps["refit"](Xd, state[0], state[1], w)
        return (new_zd, state[1]), ll

    return em_fit_loop(step, lambda s: steps["ll"](Xd, s[0], s[1], w),
                       (zd, wz), n_iter, n_iter_per_test, tolerance)


def _nnz_of(X):
    return int(X.nnz) if sp.issparse(X) else int(np.count_nonzero(X))


def _resolve_x_dtype(X, x_dtype, will_standardize=True):
    """``"auto"`` -> bfloat16 exactly when it is lossless (integer-valued
    counts <= 256), else float32; bfloat16 forces bfloat16 and any other
    dtype float32, as in the JAX package."""
    if x_dtype != "auto":
        return torch.bfloat16 if str(x_dtype) in ("bfloat16", "torch.bfloat16") else torch.float32
    vals = X.data if sp.issparse(X) else np.asarray(X).ravel()
    if vals.size == 0:
        return torch.float32
    if np.issubdtype(vals.dtype, np.integer):
        return torch.bfloat16 if vals.max() <= 256 else torch.float32
    if np.issubdtype(vals.dtype, np.floating) and not will_standardize:
        # float-typed but integral counts are bf16-exact when <= 256, valid
        # only when no l1-normalization follows
        if vals.size <= 50_000_000 and np.all(vals == np.round(vals)):
            return torch.bfloat16 if vals.max() <= 256 else torch.float32
    return torch.float32


def _stage_dense(X, device, x_dtype):
    """Stage the zero-padded ``(round_up(n, 8), round_up(m, 128))`` rectangle
    on ``device``, and its word-major nonzeros (the EM step's A is summed over
    them, one owner per word). The corpus ships as COO (O(nnz) bytes) and is
    densified on the device with one scatter; each (row, col) is unique, and
    bf16 is chosen only where it holds the counts exactly. Returns
    ``(Xd, n, m, word)``."""
    n, m = X.shape
    n_pad = round_up(max(n, 1), ROW_MULTIPLE)
    m_pad = round_up(max(m, 1), COL_MULTIPLE)
    rows, cols, vals = ship_coo(X, device)
    with span("stage.layout"):
        vals = vals.to(x_dtype)
        Xd = torch.zeros((n_pad, m_pad), dtype=x_dtype, device=device)
        Xd[rows, cols] = vals
        return Xd, n, m, word_side(rows, cols, vals, m_pad, n_pad)


class PreparedCounts(_Staged):
    """A device-resident, padded count matrix reusable across fits, with its
    word-major nonzeros ``word`` (a :class:`~.cuda_sparse.Side`). Its fit
    (:class:`~.data._Staged`) is :func:`fit_padded` on :func:`kernel_steps`,
    the factors padded; it applies no ``e_step_thresh``, whatever its value."""

    __slots__ = ("device_array", "n", "m", "nnz", "backend", "word")

    def __init__(self, device_array, n, m, nnz, backend, word):
        self.device_array = device_array
        self.n = n
        self.m = m
        self.nnz = nnz
        self.backend = backend
        self.word = word

    @property
    def device(self):
        return self.device_array.device

    def _padded(self, k):
        n_pad, m_pad = self.device_array.shape
        return n_pad, round_up(k, K_MULTIPLE), m_pad

    def _pad(self, zd, wz):
        return pad_factors(zd, wz, *self.device_array.shape)

    def _weights(self, sample_weight):
        w = np.asarray(sample_weight, dtype=np.float32) if _weighted(sample_weight) else np.ones(
            self.n, np.float32)
        count("host_syncs")  # a copy from pageable memory waits
        return torch.from_numpy(pad_vector(w, self.device_array.shape[0])).to(self.device)

    def _steps(self, precision, path):
        return kernel_steps(precision, self.word)

    def _fit(self, zd, wz, w, n_iter, n_iter_per_test, tolerance, steps, e_step_thresh=None,
             refit=False):
        return (refit_padded if refit else fit_padded)(
            self.device_array, *self._place(zd, wz), w, n_iter, n_iter_per_test, tolerance, steps)

    def _fit_runs(self, runs, n_runs, k, n_iter, n_iter_per_test, tolerance, steps):
        """The runs together on the batched step (:func:`fit_padded_runs`, in
        the groups of :meth:`_run_groups`) where ``steps`` has one, else one
        after another."""
        if "em_batch" not in steps:
            return super()._fit_runs(runs, n_runs, k, n_iter, n_iter_per_test, tolerance, steps)
        return fit_padded_runs(self.device_array, runs, self._run_groups(k, n_runs), n_iter,
                               n_iter_per_test, tolerance, steps)

    def _run_groups(self, k, n_runs):
        """The sizes of the groups :meth:`_fit_runs` fits ``n_runs`` runs of
        ``k`` topics in: as many runs a group as keep the runs' device memory
        within what this layout's staging held beside it, and the groups as
        even as that allows.

        Staging held, as it built the word side, the COO (rows and columns as
        int64 and the values at X's width), the sort's order (int64) and the
        COO gathered by it: ``40 + 2 * X.element_size()`` bytes a nonzero. The
        runs hold, besides the layout, the topic stack (``n_runs * k * m``
        float32) and one run's own step at a test point (its B, wzT, A and
        word-pass partials), and for each run of a group its tables (zd, wz,
        wzT, w) and the larger of a batched step's A and word-pass partials
        (``kp * (m_pad + n_seg)``) or a test point's next zd and wz (``kp *
        (n_pad + m_pad)``)."""
        n_pad, kp, m_pad = self._padded(k)
        n_seg = self.word.n_seg
        staging = self.word.nnz * (40 + 2 * self.device_array.element_size())
        fixed = 4 * (n_runs * k * self.m + n_pad * kp + 2 * kp * m_pad + n_seg * kp)
        per_run = 4 * (n_pad * kp + 3 * kp * m_pad + n_pad + kp * max(n_seg, n_pad))
        most = max(1, (staging - fixed) // per_run)
        n_groups = -(-n_runs // most)
        return [n_runs // n_groups + (g < n_runs % n_groups) for g in range(n_groups)]


def prepare_counts(X, backend="auto", x_dtype="auto", standardize=True, device="cuda"):
    """Densify, pad, and ship a count matrix to ``device`` once.

    ``x_dtype``: ``"auto"`` stores bf16 exactly when that is lossless
    (integer counts <= 256), otherwise float32. ``standardize`` l1-normalizes
    float inputs, like the estimators do.
    """
    dev = resolve_device(device)
    backend = resolve_backend(backend, dev)
    if backend == "sparse":
        raise ValueError("prepare_counts stages the dense layout; use prepare_sell for "
                         "backend='sparse'")
    x_dtype = _resolve_x_dtype(X, x_dtype, will_standardize=standardize)
    if standardize:
        X = standardize_input(X)
    return _staged(X, backend, x_dtype=x_dtype, device=dev)


def _read_back(*tensors):
    """Device tensors as numpy, in the span ``readback``: each copy waits."""
    with span("readback"):
        count("host_syncs", len(tensors))
        return tuple(t.cpu().numpy() for t in tensors)


def _staged(X, backend="auto", e_step_thresh=None, x_dtype="auto", device="cuda",
            counts=False):
    """The staged corpus a fit runs on: ``X`` itself when it is one, else ``X``
    staged on the JAX package's route: the sparse layout for
    ``backend="sparse"``, and for raw input under ``"auto"`` with a material
    threshold; the dense one otherwise (a :class:`PreparedCounts` never goes
    sparse). Neither standardizes, which is the estimators' job. ``counts``:
    float-typed ``X`` holds raw counts (the ensemble's), which bf16 may hold
    exactly."""
    if _is_staged(X):
        return X
    if backend == "sparse" or (backend == "auto" and _material_thresh(e_step_thresh) is not None):
        return prepare_sell(X, standardize=False, device=device)
    dev = resolve_device(device)
    backend = resolve_backend(backend, dev)
    Xd, n, m, word = _stage_dense(X, dev, _resolve_x_dtype(X, x_dtype, not counts))
    return PreparedCounts(Xd, n, m, _nnz_of(X), backend, word)


def _check_prepared_init(X, init):
    if _is_staged(X) and init != "random" and not isinstance(init, (tuple, list)):
        raise ValueError(
            f"{type(X).__name__} supports init='random' or an explicit factor "
            "tuple; data-dependent inits need the raw matrix"
        )


def _info(n_steps, final_ll, ll_trace, n_tests, wall, nnz, k, backend):
    return {
        "n_steps": n_steps,
        "log_likelihood": final_ll,
        "ll_trace": ll_trace[:n_tests],
        "wall_time_s": wall,
        "nnz_k_updates_per_s": n_steps * nnz * k / max(wall, 1e-9),
        "backend": backend,
    }


def plsa_fit(
    X,
    k,
    sample_weight=None,
    init="random",
    n_iter=100,
    n_iter_per_test=10,
    tolerance=0.001,
    e_step_thresh=1e-32,
    random_state=None,
    backend="auto",
    x_dtype="auto",
    precision="default",
    return_info=False,
    device="cuda",
):
    """Fit pLSA factors ``(P(z|d), P(w|z))`` to a count matrix, a
    :class:`PreparedCounts` or a :class:`~.sell.PreparedSell`. Returns numpy
    float32 factors, and with ``return_info`` a dict with ``n_steps``,
    ``log_likelihood``, ``ll_trace``, ``wall_time_s``,
    ``nnz_k_updates_per_s`` and ``backend``.

    ``precision``: ``"default"`` and ``"highest"`` both run the fp32 kernel;
    ``"fast"`` runs its bf16-responsibilities mode (the LL sweep stays fp32).
    The sparse path has no such mode: ``"fast"`` warns there and runs fp32.
    ``e_step_thresh`` above 1e-30 routes raw input under ``backend="auto"``
    to the sparse path, the only one that applies it (exactly).

    Inside an open request (:func:`~enstop_torch.profiling.is_open`) the
    fit's spans join it; else the fit is a request ``fit`` of its own, and
    the info carries its record as ``"trace"`` (:mod:`enstop_torch.profiling`).
    """
    args = (X, k, sample_weight, init, n_iter, n_iter_per_test, tolerance, e_step_thresh,
            random_state, backend, x_dtype, precision, device)
    if is_open():
        zd, wz, info = _fit(*args)
    else:
        with request("fit", backend=backend) as req:
            zd, wz, info = _fit(*args)
        info["trace"] = req.record
    return (zd, wz, info) if return_info else (zd, wz)


def _fit(X, k, sample_weight, init, n_iter, n_iter_per_test, tolerance, e_step_thresh,
         random_state, backend, x_dtype, precision, device):
    """:func:`plsa_fit`'s ``(P(z|d), P(w|z), info)`` (spans ``stage``,
    ``init``, ``loop``)."""
    rng = check_random_state(random_state)
    cuda_em._check_precision(precision)
    _check_prepared_init(X, init)
    with span("stage"):
        prep = _staged(X, backend, e_step_thresh, x_dtype, device)
        w = prep._weights(sample_weight)
    with span("init"):
        zd, wz = _initial_factors(prep, X, k, init, rng)
    with span("loop") as loop:
        res = prep._fit(zd, wz, w, n_iter, n_iter_per_test, tolerance,
                        prep._steps(precision, "sparse"), e_step_thresh)
        zd_f, wz_f = _read_back(*res.state)
    return (*unpad_factors(zd_f, wz_f, prep.n, prep.m, k),
            _info(res.n_steps, res.final_ll, res.ll_trace, res.n_tests, loop.seconds, prep.nnz,
                  k, prep.backend))


def plsa_refit(
    X,
    topics,
    sample_weight=None,
    n_iter=50,
    n_iter_per_test=10,
    tolerance=0.005,
    e_step_thresh=1e-32,
    random_state=None,
    backend="auto",
    x_dtype="auto",
    precision="default",
    device="cuda",
):
    """Fit only ``P(z|d)`` against frozen ``topics``; returns it as numpy.
    Routes to the sparse path as :func:`plsa_fit` does. Its spans
    (``stage``, ``init``, ``loop``) join an open request."""
    rng = check_random_state(random_state)
    cuda_em._check_precision(precision)
    k = topics.shape[0]
    topics = np.asarray(topics, dtype=np.float32)
    with span("stage"):
        prep = _staged(X, backend, e_step_thresh, x_dtype, device)
        w = prep._weights(sample_weight)
    with span("init"):
        zd, wz = _refit_factors(prep, k, topics, rng)
    with span("loop"):
        res = prep._fit(zd, wz, w, n_iter, n_iter_per_test, tolerance,
                        prep._steps(precision, "sparse refit"), e_step_thresh, refit=True)
        return _read_back(res.state[0])[0][:prep.n, :k]


def _initial_factors(prep, X, k, init, rng):
    """The fit's initial factors at the staged corpus's shapes (``prep._padded``):
    :func:`.init.plsa_init`'s, drawn on the card (``P(w|z)`` first, as the
    host draws) where :func:`.init._draws_on_device` allows, else on the host
    and padded (counter ``device_init_values`` 0). The same bits either way."""
    if init == "random" and _draws_on_device(rng, prep.device, (prep.n + prep.m) * k):
        n_pad, kp, m_pad = prep._padded(k)
        zd = torch.zeros((n_pad, kp), device=prep.device)
        wz = torch.zeros((kp, m_pad), device=prep.device)
        _uniform_rows(rng, [wz[:k, :prep.m], zd[:prep.n, :k]])
        return zd, wz
    count("device_init_values", 0)
    return prep._pad(*plsa_init(X, k, init=init, rng=rng))


def _refit_factors(prep, k, topics, rng):
    """The refit's initial ``P(z|d)`` (:func:`_refit_init`'s bits, drawn on
    the card where :func:`.init._draws_on_device` allows) and the frozen
    ``topics``, at the staged corpus's shapes."""
    if _draws_on_device(rng, prep.device, prep.n * k):
        n_pad, kp, m_pad = prep._padded(k)
        zd = torch.zeros((n_pad, kp), device=prep.device)
        _uniform_rows(rng, [zd[:prep.n, :k]], guard=False)
        return zd, _padded_on(topics, (kp, m_pad), prep.device)
    count("device_init_values", 0)
    return prep._pad(_refit_init(rng, prep.n, k), topics)


def _refit_init(rng, n, k):
    """The refit's initial ``P(z|d)``: uniform draws, rows normalised."""
    p_z_given_d = rng.rand(n, k)
    p_z_given_d /= p_z_given_d.sum(axis=1, keepdims=True)
    return p_z_given_d.astype(np.float32)
