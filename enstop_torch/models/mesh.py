"""The mesh estimators ``BlockParallelPLSA`` and ``DistributedPLSA``
(counterpart of ``enstop_tpu/models/mesh.py``), over the tile grid of
:mod:`enstop_torch.parallel.mesh`.

``BlockParallelPLSA(n_row_blocks, n_col_blocks)`` asks for a ``(docs, vocab)``
mesh of that shape, clamped to the devices :meth:`~BlockParallelPLSA._devices`
returns (every CUDA card for ``device="cuda"``, the CPU for ``"cpu"``). A
subclass whose ``_devices()`` names one device several times lays that many
tiles on it: that is how a test, or a run on one card, exercises the mesh's
layout and reductions. A 1 x 1 mesh runs the single-device kernels in the
single-device order, so its fit is ``PLSA``'s bit for bit.

``DistributedPLSA`` lays the docs axis over every device; under an
initialised ``torch.distributed`` process group it spans the ranks too, as
JAX's spans hosts under ``jax.distributed``. Every rank is given the whole
corpus, stages only its own tiles or shards, and returns the whole embedding.
``layout="sparse"`` shards the corpus by its nonzeros over a docs mesh
(:mod:`enstop_torch.parallel.sparse_mesh`), as does a materially firing
``e_step_thresh`` (> 1e-30) on either class, the one mesh path that applies it
exactly.
"""

from __future__ import annotations

import time

import numpy as np

from ..ops.data import pad_factors, pad_vector
from ..ops.driver import _weighted, resolve_backend
from ..ops.init import plsa_init
from ..ops.sell import THRESH_MATERIAL
from ..parallel import mesh as mesh_lib
from ..parallel.sparse_mesh import make_docs_mesh, sparse_mesh_fit, sparse_mesh_refit
from ..utils import check_random_state
from .base import (TopicModelBase, check_counts, reinsert_zero_rows, split_zero_rows,
                   validate_corpus)

__all__ = ["BlockParallelPLSA", "DistributedPLSA"]


def _fit_on_mesh(X, k, mesh, sample_weight=None, init="random", n_iter=100,
                 n_iter_per_test=10, tolerance=0.001, random_state=None):
    rng = check_random_state(random_state)
    pzd0, pwz0 = plsa_init(X, k, init=init, rng=rng)
    tiles, n, m = mesh_lib.stage_sharded_counts(mesh, X)
    n_pad = tiles[0][0].n * mesh.shape["docs"]
    m_pad = tiles[0][0].m * mesh.shape["vocab"]
    zd, wz = pad_factors(pzd0, pwz0, n_pad, m_pad)
    w = pad_vector(np.asarray(sample_weight, np.float32) if _weighted(sample_weight)
                   else np.ones(n, np.float32), n_pad)
    run = mesh_lib.build_sharded_fit(mesh, n_iter, n_iter_per_test)
    t0 = time.perf_counter()
    res = run(tiles, *mesh_lib.shard_factors(mesh, zd, wz, w), tolerance)
    U = mesh_lib.gather_rows(mesh, res.state[0])[:n, :k]  # sync
    wall = time.perf_counter() - t0
    info = {"n_steps": res.n_steps, "log_likelihood": res.final_ll,
            "ll_trace": res.ll_trace[:res.n_tests], "wall_time_s": wall}
    return U, mesh_lib.gather_cols(res.state[1])[:k, :m], info


def _refit_on_mesh(X, topics, mesh, n_iter=50, n_iter_per_test=5, tolerance=0.001,
                   random_state=None):
    rng = check_random_state(random_state)
    k = topics.shape[0]
    pzd0 = rng.rand(X.shape[0], k)
    pzd0 /= pzd0.sum(axis=1, keepdims=True)
    tiles, n, m = mesh_lib.stage_sharded_counts(mesh, X)
    n_pad = tiles[0][0].n * mesh.shape["docs"]
    zd, wz = pad_factors(pzd0.astype(np.float32), np.asarray(topics, np.float32), n_pad,
                         tiles[0][0].m * mesh.shape["vocab"])
    run = mesh_lib.build_sharded_fit(mesh, n_iter, n_iter_per_test, refit=True)
    res = run(tiles, *mesh_lib.shard_factors(mesh, zd, wz, np.ones(n_pad, np.float32)),
              tolerance)
    return mesh_lib.gather_rows(mesh, res.state[0])[:n, :k]


class BlockParallelPLSA(TopicModelBase):
    """pLSA over a ``(docs, vocab)`` mesh of devices.

    Parameters are the JAX package's, plus ``device`` (``"cuda"`` by default;
    a CUDA device that is missing raises, nothing falls back to the CPU).
    ``n_row_blocks`` / ``n_col_blocks`` ask for the mesh's shape; they are
    clamped to the devices :meth:`_devices` returns (their product must divide
    the device count after clamping). ``backend`` is ``"auto"`` or the name
    that matches the device (``"cuda"`` or ``"torch"``).

    A materially firing ``e_step_thresh`` (> 1e-30; the default 1e-32 is not)
    routes the fit to the nonzeros-sharded docs mesh, the mesh path with the
    reference's exact masked E-step; the dense tiles treat a smaller
    threshold as the numerical no-op it is. Fitted attributes:
    ``components_``, ``embedding_``, ``history_``, ``n_iter_``,
    ``fit_info_``, ``training_data_``.
    """

    _spans_ranks = False

    def __init__(
        self,
        n_components=10,
        init="random",
        n_row_blocks=None,
        n_col_blocks=1,
        n_iter=100,
        n_iter_per_test=10,
        tolerance=0.001,
        e_step_thresh=1e-32,
        transform_random_seed=42,
        random_state=None,
        backend="auto",
        device="cuda",
    ):
        self.n_components = n_components
        self.init = init
        self.n_row_blocks = n_row_blocks
        self.n_col_blocks = n_col_blocks
        self.n_iter = n_iter
        self.n_iter_per_test = n_iter_per_test
        self.tolerance = tolerance
        self.e_step_thresh = e_step_thresh
        self.transform_random_seed = transform_random_seed
        self.random_state = random_state
        self.backend = backend
        self.device = device

    def _devices(self):
        """The devices the mesh is laid over: :func:`~..parallel.mesh.local_devices`
        of ``device``. A subclass may return one device several times."""
        return mesh_lib.local_devices(self.device)

    def _checked_devices(self):
        devices = self._devices()
        if resolve_backend(self.backend, devices[0]) == "sparse":
            raise ValueError("the mesh estimators' dense layout has no backend='sparse'; use "
                             "DistributedPLSA(layout='sparse')")
        return devices

    def _make_mesh(self):
        devices = self._checked_devices()
        cols = mesh_lib.largest_divisor(len(devices), self.n_col_blocks)
        per_col = len(devices) // cols
        rows = mesh_lib.largest_divisor(
            per_col, per_col if self.n_row_blocks is None else self.n_row_blocks)
        return mesh_lib.make_mesh(rows, cols, devices=devices[:rows * cols])

    def _docs_mesh(self):
        return make_docs_mesh(devices=self._checked_devices(), span_ranks=self._spans_ranks)

    def _thresh_is_material(self):
        return self.e_step_thresh is not None and self.e_step_thresh > THRESH_MATERIAL

    def _record(self, X, good_rows, zero_rows_found, U, V, info):
        if zero_rows_found:
            self.embedding_ = reinsert_zero_rows(U, good_rows, X.shape[0], self.n_components)
        else:
            self.embedding_ = U
        self.components_ = V
        self.training_data_ = X
        self.n_iter_ = info["n_steps"]
        self.history_ = np.asarray(info["ll_trace"], dtype=np.float64)
        self.fit_info_ = info
        return self.embedding_

    def fit_transform(self, X, y=None, sample_weight=None):
        """Fit and return the document embedding ``P(z|d)``."""
        if self._thresh_is_material():
            return self._fit_transform_sparse(X, sample_weight)
        X, sample_weight = validate_corpus(X, sample_weight)
        data, good_rows, zero_rows_found = split_zero_rows(X)
        U, V, info = _fit_on_mesh(
            data, self.n_components, self._make_mesh(),
            sample_weight=sample_weight[good_rows] if zero_rows_found else sample_weight,
            init=self.init, n_iter=self.n_iter, n_iter_per_test=self.n_iter_per_test,
            tolerance=self.tolerance, random_state=self.random_state,
        )
        return self._record(X, good_rows, zero_rows_found, U, V, info)

    def _fit_transform_sparse(self, X, sample_weight):
        """The fit on the nonzeros-sharded docs mesh (exact ``e_step_thresh``;
        a device holds only its documents' nonzeros)."""
        X, sample_weight = validate_corpus(X, sample_weight)
        data, good_rows, zero_rows_found = split_zero_rows(X)
        t0 = time.perf_counter()
        U, V, n_steps, trace = sparse_mesh_fit(
            data, self.n_components, mesh=self._docs_mesh(),
            sample_weight=sample_weight[good_rows] if zero_rows_found else sample_weight,
            init=self.init, n_iter=self.n_iter, n_iter_per_test=self.n_iter_per_test,
            tolerance=self.tolerance, e_step_thresh=self.e_step_thresh,
            random_state=self.random_state,
        )
        info = {"n_steps": n_steps,
                "log_likelihood": float(trace[-1]) if len(trace) else float("nan"),
                "ll_trace": trace, "wall_time_s": time.perf_counter() - t0}
        return self._record(X, good_rows, zero_rows_found, U, V, info)

    def transform(self, X, y=None):
        """Embed new documents against the fitted topics: the frozen-topics
        refit over the mesh (50 iterations, a test every 5, tolerance 1e-3;
        on the sparse layout 50, 10 and 5e-3, as in JAX)."""
        if self._thresh_is_material():
            return self._transform_sparse(X)
        X = check_counts(X)
        self._validate_transform_input(X)
        return _refit_on_mesh(X, self.components_, self._make_mesh(),
                              random_state=check_random_state(self.transform_random_seed))

    def _transform_sparse(self, X):
        X = check_counts(X)
        self._validate_transform_input(X)
        return sparse_mesh_refit(X, self.components_, mesh=self._docs_mesh(),
                                 e_step_thresh=self.e_step_thresh,
                                 random_state=check_random_state(self.transform_random_seed))


class DistributedPLSA(BlockParallelPLSA):
    """pLSA across every device, and across the ranks of an initialised
    ``torch.distributed`` process group (docs axis only: ``n_col_blocks > 1``
    across ranks raises ``ValueError``). Every rank passes the whole corpus
    and gets the whole embedding back. Unlike the reference's dask variant it
    takes ``sample_weight``.

    ``layout="sparse"`` shards the corpus by its nonzeros over a docs mesh: a
    device holds only its documents' nonzeros plus the topics. Use it when a
    dense tile would not fit.
    """

    _spans_ranks = True

    def __init__(
        self,
        n_components=10,
        init="random",
        n_row_blocks=None,
        n_col_blocks=1,
        n_iter=100,
        n_iter_per_test=10,
        tolerance=0.001,
        e_step_thresh=1e-32,
        transform_random_seed=42,
        random_state=None,
        backend="auto",
        layout="dense",
        device="cuda",
    ):
        super().__init__(
            n_components=n_components, init=init, n_row_blocks=n_row_blocks,
            n_col_blocks=n_col_blocks, n_iter=n_iter, n_iter_per_test=n_iter_per_test,
            tolerance=tolerance, e_step_thresh=e_step_thresh,
            transform_random_seed=transform_random_seed, random_state=random_state,
            backend=backend, device=device,
        )
        self.layout = layout

    def fit_transform(self, X, y=None, sample_weight=None):
        if self.layout not in ("dense", "sparse"):
            raise ValueError(f"layout must be 'dense' or 'sparse', got {self.layout!r}")
        if self.layout == "sparse":
            return self._fit_transform_sparse(X, sample_weight)
        return super().fit_transform(X, y=y, sample_weight=sample_weight)

    def transform(self, X, y=None):
        if self.layout == "sparse":
            return self._transform_sparse(X)
        return super().transform(X, y=y)

    def _make_mesh(self):
        devices = self._checked_devices()
        if (self.n_col_blocks or 1) > 1 and mesh_lib.process_ranks()[0] > 1:
            raise ValueError("across ranks only the docs axis is sharded: DistributedPLSA "
                             "under a process group takes n_col_blocks=1")
        cols = mesh_lib.largest_divisor(len(devices), self.n_col_blocks)
        return mesh_lib.make_mesh(len(devices) // cols, cols, devices=devices, span_ranks=True)
