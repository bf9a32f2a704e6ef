"""Mini-UMAP: low-dimensional embedding for stable-topic clustering
(counterpart of ``enstop_tpu/cluster/umap.py``).

The reference's default topic combiner embeds the ensemble's topic vectors to 5D
with UMAP under the Hellinger metric before HDBSCAN (enstop_.py:385-394).  umap-learn
is a large numba package; the inputs here are tiny (N = n_runs · k points), so this
is a compact, self-contained implementation of the same pipeline:

  exact kNN (any callable/precomputed metric) -> smoothed-kNN fuzzy simplicial set
  (rho/sigma binary search, log2(k) calibration) -> fuzzy union -> spectral init
  from the symmetric normalized Laplacian -> SGD layout with negative sampling on
  the attractive/repulsive gradients of the (a, b) rational kernel.

Deviation from umap-learn: the layout SGD applies each epoch's edge updates
vectorized (numpy) rather than Hogwild-sequential; at these sizes the embeddings
are equivalent for clustering purposes.

Everything up to the layout is NumPy/SciPy and gives the JAX package's numbers
bit for bit; so does the host layout (:func:`_optimize_layout`). The device
layout (:func:`_optimize_layout_device`) is the JAX package's compiled epoch
loop: on a CUDA device one launch of a hand-written kernel for every epoch
(``ops/csrc/umap_layout.cu``), on the CPU the same epochs as a torch loop.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import cuda_umap
from ..ops.data import resolve_device
from ..profiling import count
from ..utils import check_random_state

__all__ = ["umap_embed", "UMAP", "fuzzy_simplicial_set", "find_ab_params"]

SMOOTH_K_TOLERANCE = 1e-5
MIN_K_DIST_SCALE = 1e-3


@lru_cache(maxsize=8)
def find_ab_params(spread=1.0, min_dist=0.1):
    """Fit the (a, b) of 1/(1 + a d^{2b}) to the desired min_dist/spread curve.
    Cached: the curve_fit result is a pure function of (spread, min_dist), and
    the default pair is re-requested on every ensemble fit."""
    from scipy.optimize import curve_fit

    def curve(x, a, b):
        return 1.0 / (1.0 + a * x ** (2 * b))

    xv = np.linspace(0, spread * 3, 300)
    yv = np.zeros_like(xv)
    yv[xv < min_dist] = 1.0
    yv[xv >= min_dist] = np.exp(-(xv[xv >= min_dist] - min_dist) / spread)
    params, _ = curve_fit(curve, xv, yv)
    return params[0], params[1]


def smooth_knn_dist(knn_dists, n_neighbors, n_iter=64):
    """Per-point (rho, sigma): rho = nearest nonzero distance; sigma solves
    sum_j exp(-(max(0, d_j - rho)) / sigma) = log2(n_neighbors).

    All rows run the binary search together (the per-row scalar loop cost
    ~1s of host time per ensemble fit on this throttled host); each row's
    lo/hi/mid sequence matches the scalar algorithm's search, computed in
    float64.  (Bit-equality to a float32 scalar loop is numpy-promotion-
    dependent — a scalar version under legacy promotion keeps float32 for
    float32 inputs — so the claim is "same search sequence at float64", not
    an unconditional bit match.)"""
    target = np.log2(n_neighbors)
    D = np.asarray(knn_dists, np.float64)
    n = D.shape[0]
    mean_all = D.mean() or 1.0

    pos = D > 0
    has_pos = pos.any(axis=1)
    first_pos = np.where(has_pos, pos.argmax(axis=1), 0)
    rho = np.where(has_pos, D[np.arange(n), first_pos], 0.0)

    d_adj = np.maximum(D[:, 1:] - rho[:, None], 0.0)
    lo = np.zeros(n)
    hi = np.full(n, np.inf)
    mid = np.ones(n)
    done = np.zeros(n, bool)
    for _ in range(n_iter):
        val = np.exp(-d_adj / mid[:, None]).sum(axis=1)
        done |= np.abs(val - target) < SMOOTH_K_TOLERANCE
        if done.all():
            break
        act = ~done
        gt = act & (val > target)
        lt = act & (val <= target)
        hi = np.where(gt, mid, hi)            # val > target: hi = mid first
        lo = np.where(lt, mid, lo)            # val < target: lo = mid first
        mid = np.where(gt, (lo + hi) / 2.0, mid)
        mid = np.where(lt, np.where(np.isinf(hi), mid * 2.0, (lo + hi) / 2.0),
                       mid)
    row_mean = D.mean(axis=1)
    floor = MIN_K_DIST_SCALE * np.where(row_mean > 0, row_mean, mean_all)
    return rho, np.maximum(mid, floor)


def fuzzy_simplicial_set(dmat, n_neighbors):
    """Symmetrized fuzzy graph (dense, tiny N) from a distance matrix."""
    n = dmat.shape[0]
    n_neighbors = min(n_neighbors, n - 1)
    knn_idx = np.argsort(dmat, axis=1)[:, : n_neighbors + 1]  # includes self at 0
    knn_d = np.take_along_axis(dmat, knn_idx, axis=1)
    rho, sigma = smooth_knn_dist(knn_d, n_neighbors)

    # row i's neighbor columns are distinct, so a flat assignment fills W
    # exactly like the per-entry loop
    W = np.zeros((n, n))
    vals = np.exp(-np.maximum(knn_d[:, 1:] - rho[:, None], 0.0) / sigma[:, None])
    rows = np.repeat(np.arange(n), knn_idx.shape[1] - 1)
    W[rows, knn_idx[:, 1:].ravel()] = vals.ravel()
    # fuzzy set union
    return W + W.T - W * W.T


def _spectral_init(W, dim, rng):
    from scipy.linalg import eigh

    n = W.shape[0]
    deg = W.sum(axis=1)
    inv_sqrt = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
    L = np.eye(n) - (inv_sqrt[:, None] * W) * inv_sqrt[None, :]
    try:
        vals, vecs = eigh(L)
        emb = vecs[:, 1 : dim + 1]
    except np.linalg.LinAlgError:
        emb = rng.uniform(-1, 1, (n, dim))
    expansion = 10.0 / max(np.abs(emb).max(), 1e-12)
    emb = emb * expansion
    return (emb + rng.normal(0, 0.0001, emb.shape)).astype(np.float64)


def _scatter_add(emb, idx, updates):
    """emb[idx] += updates with duplicate indices — ONE flattened np.bincount
    (faster than np.add.at and than a bincount per column; each output bin
    still accumulates its contributions in input order, so the result is
    bit-identical to the per-column form)."""
    n, dim = emb.shape
    flat = np.bincount(
        (idx[:, None] * dim + np.arange(dim)).ravel(),
        weights=updates.ravel(), minlength=n * dim,
    )
    emb += flat.reshape(n, dim)


def _optimize_layout(emb, W, n_epochs, a, b, rng, negative_sample_rate=5,
                     initial_alpha=1.0):
    heads, tails = np.nonzero(W)
    weights = W[heads, tails]
    if heads.size == 0:
        return emb
    # umap's epochs_per_sample scheme: stronger edges are sampled more often
    eps_per_sample = weights.max() / np.maximum(weights, 1e-12)
    next_epoch = eps_per_sample.copy()
    n = emb.shape[0]

    for epoch in range(n_epochs):
        alpha = initial_alpha * (1.0 - epoch / n_epochs)
        active = next_epoch <= epoch + 1.0
        if not active.any():
            continue
        h, t = heads[active], tails[active]
        d = emb[h] - emb[t]
        dsq = (d * d).sum(1)
        # attractive gradient of log(1/(1+a d^{2b}))
        grad_coeff = np.where(
            dsq > 0, (-2.0 * a * b * dsq ** (b - 1.0)) / (a * dsq ** b + 1.0), 0.0
        )
        g = np.clip(grad_coeff[:, None] * d, -4.0, 4.0)
        _scatter_add(emb, h, alpha * g)
        _scatter_add(emb, t, -alpha * g)

        # negative samples
        for _ in range(negative_sample_rate):
            neg = rng.randint(0, n, h.size)
            d = emb[h] - emb[neg]
            dsq = (d * d).sum(1)
            rep = np.where(
                dsq > 0, (2.0 * b) / ((0.001 + dsq) * (a * dsq ** b + 1.0)), 0.0
            )
            mask = neg != h
            g = np.clip(rep[:, None] * d, -4.0, 4.0) * mask[:, None]
            _scatter_add(emb, h, alpha * g)
        next_epoch[active] += eps_per_sample[active]
    return emb


# lowbias32 (C. Wellons), a bijection of 32-bit words: ``mix32`` of
# ops/csrc/umap_layout.cu, in 64-bit words masked to 32 bits
_MASK32 = np.uint64(0xFFFFFFFF)
_GOLDEN = 0x9E3779B9


def _mix32(x):
    x = np.asarray(x, np.uint64)
    x = x ^ (x >> np.uint64(16))
    x = (x * np.uint64(0x7FEB352D)) & _MASK32
    x = x ^ (x >> np.uint64(15))
    x = (x * np.uint64(0x846CA68B)) & _MASK32
    return x ^ (x >> np.uint64(16))


def _negative_samples(seed, epoch, rnd, n_edges, n):
    """The negative samples of round ``rnd`` of ``epoch``: for each edge
    ``e < n_edges`` a point in ``[0, n)``, from a counter-based hash of the low
    32 bits of ``seed``, ``epoch``, ``rnd`` and ``e``, taken to ``[0, n)`` by
    multiply-shift. The layout kernel draws the same (``draw`` in
    ``ops/csrc/umap_layout.cu``), so the CPU loop and the card run one
    schedule: with ``b = 1`` the two give the same bits."""
    key = _mix32(_mix32(_mix32(np.uint64((int(seed) & 0xFFFFFFFF) ^ _GOLDEN))
                        ^ np.uint64(epoch)) ^ np.uint64(rnd))
    h = _mix32(key ^ np.arange(n_edges, dtype=np.uint64))
    return ((h * np.uint64(n)) >> np.uint64(32)).astype(np.int64)


def _segments(index, n):
    """The edges grouped by ``index`` in a fixed (stable) order, as
    ``(edge ids, group offsets)`` for :func:`_ordered_add`."""
    order = np.argsort(index, kind="stable")
    offsets = np.searchsorted(index[order], np.arange(n))
    return torch.from_numpy(order.astype(np.int64)), torch.from_numpy(offsets.astype(np.int64))


def _ordered_add(x, segments, g):
    """``x[index[e]] += g[e]`` for every edge e, each point's terms summed in
    one fixed order, the edges' own."""
    x.add_(F.embedding_bag(segments[0], g, segments[1], mode="sum"))


def _sq_norms(d):
    """The rows' squared norms, the dimensions summed in order, as the layout
    kernel sums them."""
    dsq = d[:, 0] * d[:, 0]
    for k in range(1, d.shape[1]):
        dsq = dsq + d[:, k] * d[:, k]
    return dsq


def _layout_loop(x, heads, tails, eps, n_epochs, a, b, seed, negative_sample_rate,
                 initial_alpha):
    """The layout's epochs as a float32 torch loop on the CPU: what the layout
    kernel computes, the scatter-adds as fixed-order segment sums."""
    n, n_edges = x.shape[0], heads.size
    h, t = torch.from_numpy(heads), torch.from_numpy(tails)
    by_head, by_tail = _segments(heads, n), _segments(tails, n)
    x = torch.from_numpy(x.copy())
    eps = torch.from_numpy(eps)
    next_epoch = eps.clone()
    for epoch in range(n_epochs):
        alpha = initial_alpha * (1.0 - epoch / n_epochs)
        active = next_epoch <= epoch + 1.0
        d = x[h] - x[t]
        dsq = _sq_norms(d)
        gc = torch.where(dsq > 0, (-2.0 * a * b * dsq ** (b - 1.0)) / (a * dsq ** b + 1.0), 0.0)
        g = (gc[:, None] * d).clamp(-4.0, 4.0) * active[:, None]
        _ordered_add(x, by_head, alpha * g)
        _ordered_add(x, by_tail, -alpha * g)
        for rnd in range(negative_sample_rate):
            neg = torch.from_numpy(_negative_samples(seed, epoch, rnd, n_edges, n))
            d = x[h] - x[neg]
            dsq = _sq_norms(d)
            rep = torch.where(dsq > 0, (2.0 * b) / ((0.001 + dsq) * (a * dsq ** b + 1.0)), 0.0)
            g = (rep[:, None] * d).clamp(-4.0, 4.0) * ((neg != h) & active)[:, None]
            _ordered_add(x, by_head, alpha * g)
        next_epoch = torch.where(active, next_epoch + eps, next_epoch)
    return x.numpy()


def _layout_inputs(emb, W, a, b):
    """The layout's inputs in the float32 and int the epochs run in: the
    start, the graph's edges (heads nondecreasing, tails), their epochs per
    sample, a and b; None for a graph with no edge."""
    heads, tails = np.nonzero(W)
    weights = W[heads, tails]
    if heads.size == 0:
        return None
    eps = (weights.max() / np.maximum(weights, 1e-12)).astype(np.float32)
    return (np.asarray(emb, np.float32), heads, tails, eps,
            float(np.float32(a)), float(np.float32(b)))


def _optimize_layout_device(emb, W, n_epochs, a, b, seed, device="cpu",
                            negative_sample_rate=5, initial_alpha=1.0):
    """The same SGD as :func:`_optimize_layout` in float32 on ``device``: the
    same update schedule and gradient math, each point's terms summed in one
    fixed order (so a layout is the same from run to run), and the negative
    samples of :func:`_negative_samples` keyed by ``seed``. On a CUDA device
    every epoch runs in one launch of the layout kernel
    (``ops/csrc/umap_layout.cu``); on the CPU the same epochs run as a torch
    loop (:func:`_layout_loop`). That random stream differs from the numpy
    path's and from the JAX package's, which is equivalent for clustering
    purposes, like the numpy path's own deviation from umap-learn's Hogwild."""
    inputs = _layout_inputs(emb, W, a, b)
    if inputs is None:
        return emb
    x, heads, tails, eps, a, b = inputs
    # the edges and the start copied up in one copy, and the layout read back
    count("host_syncs", 2)
    args = (x, heads, tails, eps, n_epochs, a, b, seed)
    dev = torch.device(device)
    if dev.type == "cuda":
        out = cuda_umap.optimize_layout(*args, dev, negative_sample_rate, initial_alpha)
        count("layout_launches")
    else:
        out = _layout_loop(*args, negative_sample_rate, initial_alpha)
    return out.astype(np.float64)


def umap_embed(
    X=None,
    dmat=None,
    n_components=5,
    n_neighbors=15,
    metric=None,
    min_dist=0.1,
    spread=1.0,
    n_epochs=None,
    random_state=None,
    layout="auto",
    device="cuda",
):
    """Embed points to ``n_components`` dims. Provide either a precomputed distance
    matrix or data + a metric callable (rows assumed l1-normalized for hellinger).

    ``device``: ``"cuda"`` by default; a CUDA device that is missing raises,
    nothing falls back to the CPU. ``layout``: ``"auto"`` runs the SGD as the
    layout kernel on ``device`` when that is a CUDA device and in numpy
    otherwise; ``"device"``/``"host"`` force a path (``"device"`` with a CPU
    ``device`` runs the kernel's epochs as a torch loop on the CPU)."""
    device = resolve_device(device)
    rng = check_random_state(random_state)
    if dmat is None:
        if callable(metric):
            X = np.asarray(X, dtype=np.float64)
            n = X.shape[0]
            dmat = np.zeros((n, n))
            for i in range(n):
                for j in range(i + 1, n):
                    dmat[i, j] = dmat[j, i] = metric(X[i], X[j])
        elif metric in (None, "hellinger"):
            from .distances import all_pairs_hellinger_distance

            dmat = all_pairs_hellinger_distance(X, device)
        elif metric == "euclidean":
            X = np.asarray(X, dtype=np.float64)
            diff = X[:, None, :] - X[None, :, :]
            dmat = np.sqrt((diff * diff).sum(-1))
        else:
            raise ValueError("Unrecognized metric {!r}".format(metric))

    n = dmat.shape[0]
    if n <= n_components + 1:
        return rng.uniform(-10, 10, (n, n_components))
    if n_epochs is None:
        n_epochs = 500 if n < 10000 else 200

    W = fuzzy_simplicial_set(dmat, n_neighbors)
    emb = _spectral_init(W, n_components, rng)
    a, b = find_ab_params(spread, min_dist)
    seed = rng.randint(np.iinfo(np.int32).max)
    if layout == "auto":
        layout = "device" if device.type == "cuda" else "host"
    if layout == "device":
        return _optimize_layout_device(emb, W, n_epochs, a, b, seed, device=device)
    return _optimize_layout(emb, W, n_epochs, a, b, np.random.RandomState(seed))


class UMAP:
    """Minimal facade matching the constructor surface the reference uses
    (enstop_.py:385-387), plus ``device`` (``"cuda"`` by default, as
    :func:`umap_embed`)."""

    def __init__(self, n_neighbors=15, n_components=2, metric="euclidean",
                 min_dist=0.1, spread=1.0, n_epochs=None, random_state=None, device="cuda"):
        self.n_neighbors = n_neighbors
        self.n_components = n_components
        self.metric = metric
        self.min_dist = min_dist
        self.spread = spread
        self.n_epochs = n_epochs
        self.random_state = random_state
        self.device = device

    def fit_transform(self, X):
        return umap_embed(
            X=X,
            n_components=self.n_components,
            n_neighbors=self.n_neighbors,
            metric=self.metric,
            min_dist=self.min_dist,
            spread=self.spread,
            n_epochs=self.n_epochs,
            random_state=self.random_state,
            device=self.device,
        )
