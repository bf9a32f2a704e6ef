"""EM on the O(nnz) layout sharded by document range (counterpart of
``enstop_tpu/parallel/sparse_mesh.py``).

A 1-D ``("docs",)`` mesh (:func:`make_docs_mesh`); each shard holds its own
document range, packed by itself in both sort orders on its device
(:func:`shard_sell`: local document ids, global word ids):

* ``P(z|d)`` is sharded by document: its update and row norms stay on the
  shard (the doc pass, kernel #9, over the shard's nonzeros);
* ``P(w|z)`` is whole on every device; each shard's word pass (kernel #8)
  gives a full-width ``A^T`` partial from its own nonzeros, and the partials
  are summed in shard order (:func:`~.mesh.psum`), the mesh's one reduction
  of a factor;
* the log-likelihood is summed over the shards the same way.

With a material ``e_step_thresh`` (above 1e-30) the passes apply it exactly
and their contributions already hold the old factor, so the M-step
numerators are the raw accumulators (as in ``ops/sell.py:em_step_sell``).
Under a process group the mesh's docs axis spans the ranks
(``make_docs_mesh(span_ranks=True)``): every rank is given the whole corpus
and packs only its own shards.

Each shard keeps its ``P(z|d)`` at its own height. JAX pads every shard to a
common bucketed height and lane width (``_bucket_rows``, ``_auto_lane``) so
that one compiled program serves them all; the port compiles nothing and has
no lanes, and the padding is absorbing, so no result changes.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..ops.cuda_sparse import doc_pass, word_pass
from ..ops.driver import _weighted
from ..ops.fit import em_fit_loop_folded
from ..ops.init import plsa_init
from ..ops.sell import THRESH_MATERIAL, _normalize, prepare_sell
from ..utils import check_random_state
from .mesh import Mesh, _grid, gather_rows, local_devices, process_ranks, psum

__all__ = ["make_docs_mesh", "shard_sell", "build_sharded_sparse_fit", "sparse_mesh_fit",
           "sparse_mesh_refit"]


def make_docs_mesh(n_shards=None, devices=None, span_ranks=False):
    """A 1-D ``("docs",)`` mesh over the first ``n_shards`` of ``devices``
    (by default :func:`~.mesh.local_devices`, all of them); ``span_ranks`` as
    for :func:`~.mesh.make_mesh`."""
    devices = list(local_devices() if devices is None else devices)
    n_shards = n_shards or len(devices)
    world, rank = process_ranks(span_ranks)
    return Mesh(_grid(devices[:n_shards], (n_shards,)), ("docs",), world, rank)


def shard_sell(mesh, X):
    """Pack this rank's document ranges, each by itself on its device.
    Returns ``(preps, bounds, n, m)``: ``preps[s]`` the
    :class:`~..ops.sell.PreparedSell` of documents ``bounds[g] ..
    bounds[g + 1] - 1`` for global shard ``g = mesh.first + s``."""
    Xcsr = sp.csr_matrix(X) if sp.issparse(X) else sp.csr_matrix(np.asarray(X))
    n, m = Xcsr.shape
    bounds = np.linspace(0, n, mesh.shape["docs"] + 1).astype(np.int64)
    preps = [prepare_sell(Xcsr[bounds[g]:bounds[g + 1]], standardize=False, device=dev)
             for g, dev in enumerate(mesh.devices, start=mesh.first)]
    return preps, bounds, n, m


def _scatter_doc_sharded(mesh, rows, bounds):
    """This rank's shards' rows of ``rows`` (numpy), each on its device."""
    return [torch.from_numpy(np.ascontiguousarray(rows[bounds[g]:bounds[g + 1]])).to(dev)
            for g, dev in enumerate(mesh.devices, start=mesh.first)]


def _gather_doc_sharded(mesh, parts, bounds):
    """Inverse of :func:`_scatter_doc_sharded` over every rank: the whole
    ``(n, k)`` array as numpy. The shards are padded to one height for the
    gather and cut back after it."""
    height = int(np.diff(bounds).max())
    padded = [torch.cat([p, p.new_zeros((height - p.shape[0],) + p.shape[1:])]) for p in parts]
    flat = gather_rows(mesh, padded)
    return np.concatenate([flat[g * height:g * height + int(bounds[g + 1] - bounds[g])]
                           for g in range(len(bounds) - 1)])


def _material_thresh(e_step_thresh):
    """None unless the threshold can fire in float32 (as on one device)."""
    if e_step_thresh is not None and e_step_thresh > THRESH_MATERIAL:
        return float(e_step_thresh)
    return None


def build_sharded_sparse_fit(mesh, n_iter, n_iter_per_test, refit=False, e_step_thresh=None):
    """``(preps, zd, wz, w, tolerance) -> FitResult`` over the docs mesh, by
    :func:`~..ops.fit.em_fit_loop_folded` as in JAX: ``preps`` from
    :func:`shard_sell`, ``zd`` and ``w`` one block a shard on its device,
    ``wz`` (k, m) whole on ``mesh.devices[0]``. ``refit``: the frozen-topics
    refit (the doc pass alone). ``e_step_thresh`` is honoured exactly when
    material."""
    thresh = _material_thresh(e_step_thresh)
    ranks = mesh.world > 1
    home = mesh.devices[0]

    def tables(wz):
        """``P(w|z)^T``, once on every device of the mesh."""
        wzT = wz.t().contiguous()
        return {dev: wzT.to(dev) for dev in set(mesh.devices)}

    def shards(preps, zd, w):
        return zip(preps, zd, w, mesh.devices)

    def em(preps, state, w, compute_ll):
        zd, wz = state
        wzT = tables(wz)
        AT, lls, next_zd = [], [], []
        for prep, zd_s, w_s, dev in shards(preps, zd, w):
            AT_s, ll = word_pass(prep.word, zd_s, wzT[dev], w_s, thresh, compute_ll)
            B, _ = doc_pass(prep.doc, zd_s, wzT[dev], w_s, thresh, compute_ll=False)
            next_zd.append(_normalize(B if thresh is not None else zd_s * B))
            AT.append(AT_s)
            lls.append(ll)
        AT = psum(AT, home, ranks).t()
        next_wz = _normalize(AT if thresh is not None else wz * AT)
        return (next_zd, next_wz), psum(lls, home, ranks)

    def refit_step(preps, state, w, compute_ll):
        zd, wz = state
        wzT = tables(wz)
        lls, next_zd = [], []
        for prep, zd_s, w_s, dev in shards(preps, zd, w):
            B, ll = doc_pass(prep.doc, zd_s, wzT[dev], w_s, thresh, compute_ll)
            next_zd.append(_normalize(B if thresh is not None else zd_s * B))
            lls.append(ll)
        return (next_zd, wz), psum(lls, home, ranks)

    def ll_of(preps, state, w):
        wzT = tables(state[1])
        return psum([doc_pass(prep.doc, zd_s, wzT[dev], w_s)[1]
                     for prep, zd_s, w_s, dev in shards(preps, state[0], w)], home, ranks)

    step = refit_step if refit else em

    def run(preps, zd, wz, w, tolerance):
        return em_fit_loop_folded(lambda s: step(preps, s, w, True),
                                  lambda s: step(preps, s, w, False),
                                  lambda s: ll_of(preps, s, w), (zd, wz), n_iter,
                                  n_iter_per_test, tolerance)

    return run


def sparse_mesh_fit(X, k, mesh=None, sample_weight=None, init="random", n_iter=100,
                    n_iter_per_test=10, tolerance=0.001, e_step_thresh=None,
                    random_state=None):
    """Fit pLSA with the corpus sharded by its nonzeros over a docs mesh (by
    default every local CUDA card). Returns ``(P(z|d), P(w|z), n_steps,
    ll_trace)`` as numpy, on every rank."""
    rng = check_random_state(random_state)
    mesh = make_docs_mesh() if mesh is None else mesh
    preps, bounds, n, m = shard_sell(mesh, X)
    pzd0, pwz0 = plsa_init(X, k, init=init, rng=rng)
    w = (np.asarray(sample_weight, np.float32) if _weighted(sample_weight)
         else np.ones(n, np.float32))
    run = build_sharded_sparse_fit(mesh, n_iter, n_iter_per_test, e_step_thresh=e_step_thresh)
    res = run(preps, _scatter_doc_sharded(mesh, pzd0.astype(np.float32), bounds),
              torch.from_numpy(pwz0.astype(np.float32)).to(mesh.devices[0]),
              _scatter_doc_sharded(mesh, w, bounds), tolerance)
    return (_gather_doc_sharded(mesh, res.state[0], bounds), res.state[1].cpu().numpy(),
            res.n_steps, res.ll_trace[:res.n_tests])


def sparse_mesh_refit(X, topics, mesh=None, n_iter=50, n_iter_per_test=10, tolerance=0.005,
                      e_step_thresh=None, random_state=None):
    """Frozen-topics refit with the corpus sharded by its nonzeros over the
    docs mesh (the sparse layout's transform); ``P(z|d)`` as numpy."""
    rng = check_random_state(random_state)
    mesh = make_docs_mesh() if mesh is None else mesh
    preps, bounds, n, m = shard_sell(mesh, X)
    zd0 = rng.rand(n, topics.shape[0]).astype(np.float32)
    zd0 /= zd0.sum(axis=1, keepdims=True)
    run = build_sharded_sparse_fit(mesh, n_iter, n_iter_per_test, refit=True,
                                   e_step_thresh=e_step_thresh)
    res = run(preps, _scatter_doc_sharded(mesh, zd0, bounds),
              torch.tensor(np.asarray(topics, np.float32), device=mesh.devices[0]),
              _scatter_doc_sharded(mesh, np.ones(n, np.float32), bounds), tolerance)
    return _gather_doc_sharded(mesh, res.state[0], bounds)
