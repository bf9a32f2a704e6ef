"""Ensemble topic modelling, EnsTop (counterpart of
``enstop_tpu/models/ensemble.py``).

Pipeline: bootstrap-resample the documents, fit k topics per run (pLSA or
NMF), stack the ``n_runs * k`` topic vectors, cluster them into stable topics (Hellinger
distance, UMAP, HDBSCAN), merge each cluster (the membership-weighted square
of the mean of square roots), and refit the documents against the stable
topics.

On one device the runs share one staged copy of the padded corpus (the
``"weights"`` fan-out): each bootstrap is a vector of multinomial document
weights, ``Multinomial(n, 1/n)``, the row multiset that a row resample
materialises, so no run copies the data. Each run is the ordinary fit loop
(``ops/driver.py:fit_padded``) from a random init made on the device. The
topic stack stays on the device for the distance matrix and the merge; the
UMAP layout runs on the device too, HDBSCAN on the host.

With ``backend="sparse"`` (or a :class:`~enstop_torch.ops.sell.PreparedSell`)
the runs share one copy of the O(nnz) sparse layout instead and each is a
sparse fit; the final refit runs on the same layout with the ensemble's
``e_step_thresh`` (``ensemble_fit``'s own default of 1e-16 applies exactly
there; the estimator passes 1e-32).

``model="nmf"`` runs each bootstrap as a materialised row resample (the
``"resample"`` fan-out, as in the JAX package): multiplicative updates on the
device (``solver="mu"``, :func:`~enstop_torch.ops.nmf.nmf_fit_mu`) or
coordinate descent on the host (``solver="cd"``); the stack then joins the
card for the combine stage, and the final embedding is ``nmf_fit_mu`` against
the frozen stable topics.

``parallelism="sharded"`` lays the pLSA runs over a runs mesh
(:mod:`enstop_torch.parallel.mesh`): the runs are cut into contiguous blocks,
one a device, and each device fits its block against its own replica of the
staged corpus (devices named more than once share one). ``"auto"`` picks it
when the runs divide over more than one device. A run's result does not
depend on its block, so the stack is the same for any number of shards.
"""

from __future__ import annotations

import time
import warnings

import numpy as np
import torch

from ..cluster.distances import (all_pairs_hellinger_distance, all_pairs_kl_divergence,
                                 full_fp32_matmul, stack_device)
from ..cluster.hdbscan import (HDBSCAN, compute_stability, condense_tree,
                               labels_and_probabilities, mst_linkage, select_clusters,
                               single_linkage_tree)
from ..cluster.umap import umap_embed
from ..ops import cuda_em
from ..ops.data import K_MULTIPLE, pad_factors, pad_vector, round_up
from ..ops.driver import (PreparedCounts, _warn_fast_unsupported, fit_padded, kernel_steps,
                          plsa_fit, plsa_refit, prepare_counts, resolve_device)
from ..ops.init import plsa_init
from ..ops.nmf import nmf_cd, nmf_fit_mu
from ..ops.sell import PreparedSell, prepare_sell, sell_fit
from ..parallel import mesh as mesh_lib
from ..utils import _check_sample_weight, check_random_state, normalized
from .base import TopicModelBase, check_counts

__all__ = ["EnsembleTopics", "ensemble_fit", "ensemble_of_topics", "plsa_topics",
           "nmf_topics", "resolve_parallelism"]

PARALLELISM = ("auto", "weights", "sharded", "resample", "none", "joblib", "dask")


def _check_model(model):
    if model not in ("plsa", "nmf"):
        raise ValueError('Model must be one of "plsa" or "nmf"')


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# bootstrap topic workers
# ---------------------------------------------------------------------------

def plsa_topics(X, k, **kwargs):
    """One bootstrap-resampled pLSA run on a materialised row resample;
    returns the (k, n_words) topics."""
    A = X.tocsr()
    if kwargs.get("bootstrap", True):
        rng = check_random_state(kwargs.get("random_state", None))
        B = A[rng.randint(0, A.shape[0], size=A.shape[0])]
    else:
        B = A
    _, topics = plsa_fit(
        B,
        k,
        sample_weight=_check_sample_weight(None, B, dtype=np.float32),
        init=kwargs.get("init", "random"),
        n_iter=kwargs.get("n_iter", 100),
        n_iter_per_test=kwargs.get("n_iter_per_test", 10),
        tolerance=kwargs.get("tolerance", 0.001),
        e_step_thresh=kwargs.get("e_step_thresh", 1e-16),
        random_state=kwargs.get("random_state", None),
        backend=kwargs.get("backend", "auto"),
        precision=kwargs.get("precision", "default"),
        device=kwargs.get("device", "cuda"),
    )
    return topics


def nmf_topics(X, k, **kwargs):
    """One bootstrap-resampled NMF run; returns the (k, n_words) topics,
    l1-normalised. ``solver="mu"`` runs :func:`~enstop_torch.ops.nmf.nmf_fit_mu`
    on ``device``; ``solver="cd"`` the host coordinate descent with
    scikit-learn's ``NMF(alpha_W=alpha / n_features, alpha_H=alpha /
    n_samples)`` scaling, which puts the reference's unscaled ``alpha`` on
    both factors' L2 terms."""
    A = X.tocsr()
    if kwargs.get("bootstrap", True):
        rng = check_random_state(kwargs.get("random_state", None))
        B = A[rng.randint(0, A.shape[0], size=A.shape[0])]
    else:
        B = A
    init = kwargs.get("init", "nndsvd")
    alpha = float(kwargs.get("alpha", 0.0))
    if kwargs.get("solver", "mu") == "cd":
        _, topics, _ = nmf_cd(B, k, init=init, l2_reg=alpha,
                              random_state=kwargs.get("random_state", None))
    else:
        _, topics = nmf_fit_mu(
            B, k,
            beta_loss=kwargs.get("beta_loss", 1),
            init="nndsvd" if isinstance(init, (tuple, list)) else init,
            alpha=alpha,
            random_state=kwargs.get("random_state", None),
            device=kwargs.get("device", "cuda"),
        )
    return normalized(np.asarray(topics, dtype=np.float64), axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# ensemble fan-out
# ---------------------------------------------------------------------------

def _run_devices(devices, device, prepared=None):
    """The devices the runs may use: ``devices``, else every card of the
    corpus's device (:func:`~enstop_torch.parallel.mesh.local_devices`)."""
    if devices is not None:
        return list(devices)
    if isinstance(prepared, PreparedSell):
        device = prepared.device
    elif isinstance(prepared, PreparedCounts):
        device = prepared.device_array.device
    return mesh_lib.local_devices(device)


def resolve_parallelism(parallelism, model="plsa", backend="auto", n_runs=16, prepared=None,
                        devices=None):
    """The fan-out by topology, as in the JAX package. ``devices``: those the
    runs may use (None: one). For pLSA ``"auto"`` is ``"sharded"`` when the
    runs divide over more than one device, else ``"weights"``; sparse input
    (``backend="sparse"`` or a :class:`PreparedSell`) always ``"weights"``,
    and an explicit ``"sharded"`` on it raises ``ValueError`` (it has no
    sparse variant); an explicit ``"sharded"`` on one device warns and runs.
    For NMF ``"auto"`` is ``"resample"``, and every name but
    ``"joblib"``/``"dask"`` runs as ``"resample"``. An unknown name raises
    ``ValueError``."""
    if parallelism not in PARALLELISM:
        raise ValueError(f"Unrecognized parallelism {parallelism!r}; should be one of "
                         f"{tuple(sorted(PARALLELISM))}")
    n_devices = 1 if devices is None else len(devices)
    sparse_input = backend == "sparse" or isinstance(prepared, PreparedSell)
    if parallelism == "auto":
        if model != "plsa":
            return "resample"
        if sparse_input:
            return "weights"
        return "sharded" if mesh_lib.largest_divisor(n_runs, n_devices) > 1 else "weights"
    if parallelism == "sharded" and model == "plsa":
        if sparse_input:
            raise ValueError(
                "parallelism='sharded' has no sparse variant: the weights fan-out on the "
                "sparse layout is the sparse program; use parallelism='weights' or 'auto' "
                "with backend='sparse'")
        if n_devices == 1:
            warnings.warn(
                "parallelism='sharded' on a single device fits the runs one after another "
                "in one shard, as 'weights' does (it exists for a fan-out over several "
                "devices); use parallelism='auto' to route by topology",
                stacklevel=3,
            )
    return parallelism


def _device_init(n_pad, kp, n, k, m_pad, m, seed, device):
    """Random l1-normalised factors made on ``device`` from a
    ``torch.Generator`` seeded with ``seed``, padding exactly zero (the
    counterpart of the JAX package's ``_dense_init_fn``; another random
    stream)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    zd = torch.rand((n_pad, kp), generator=gen, device=device)
    zd[n:] = 0.0
    zd[:, k:] = 0.0
    zd /= zd.sum(dim=1, keepdim=True).clamp_min(1e-30)
    wz = torch.rand((kp, m_pad), generator=gen, device=device)
    wz[k:] = 0.0
    wz[:, m:] = 0.0
    wz /= wz.sum(dim=1, keepdim=True).clamp_min(1e-30)
    return zd, wz


def bootstrap_inputs(prepared, k, n_runs, rng, bootstrap=True, init="random", X=None):
    """Yield each run's ``(P(z|d), P(w|z), document weights)`` on the device of
    ``prepared``: padded for a :class:`PreparedCounts`, at the layout's own
    shapes (n, k) and (k, m) for a :class:`PreparedSell`. Draws from ``rng``
    in the JAX package's order: one ``randint`` for the init seed when
    ``init="random"`` (run ``i`` then seeds its device generator with
    ``seed * 2**20 + i``), then per run the init (a factor tuple draws
    nothing) and one ``multinomial(n, 1/n)``."""
    n, m = prepared.n, prepared.m
    sparse = isinstance(prepared, PreparedSell)
    if sparse:
        n_pad, m_pad, kp, dev = n, m, k, prepared.device
    else:
        (n_pad, m_pad), dev = prepared.device_array.shape, prepared.device_array.device
        kp = round_up(k, K_MULTIPLE)
    uniform = np.full(n, 1.0 / n)
    base_seed = int(rng.randint(np.iinfo(np.int32).max)) if init == "random" else None
    for i in range(n_runs):
        if base_seed is not None:
            zd, wz = _device_init(n_pad, kp, n, k, m_pad, m, base_seed * (1 << 20) + i, dev)
        else:
            pzd0, pwz0 = plsa_init(prepared if X is None else X, k, init=init, rng=rng)
            factors = (pzd0, pwz0) if sparse else pad_factors(pzd0, pwz0, n_pad, m_pad)
            zd, wz = (torch.from_numpy(a).to(dev) for a in factors)
        counts = (rng.multinomial(n, uniform) if bootstrap else np.ones(n)).astype(np.float32)
        yield zd, wz, torch.from_numpy(pad_vector(counts, n_pad)).to(dev)


def _device_resident_plsa_runs(X, k, n_runs, rng, bootstrap=True, init="random",
                               n_iter=100, n_iter_per_test=10, tolerance=0.001,
                               backend="auto", precision="default", x_dtype="auto",
                               prepared=None, device="cuda"):
    """``n_runs`` bootstrap fits against ONE staged copy of X (dense, or the
    sparse layout for ``backend="sparse"``), each bootstrap as document
    weights; the ``(n_runs * k, m)`` stack stays on the device."""
    if prepared is None and backend == "sparse":
        prepared = prepare_sell(X, standardize=False, device=device)
    elif prepared is None:
        prepared = prepare_counts(X, backend=backend, x_dtype=x_dtype, standardize=False,
                                  device=device)
    if isinstance(prepared, PreparedSell):
        if precision == "fast":
            _warn_fast_unsupported("sparse ensemble fan-out")
        return _sparse_resident_plsa_runs(X, k, n_runs, rng, prepared, bootstrap, init,
                                          n_iter, n_iter_per_test, tolerance)
    steps = kernel_steps(precision, prepared.word)
    topics = []
    for zd, wz, w in bootstrap_inputs(prepared, k, n_runs, rng, bootstrap, init, X):
        res = fit_padded(prepared.device_array, zd, wz, w, n_iter, n_iter_per_test,
                         tolerance, steps)
        topics.append(res.state[1][:k, :prepared.m])
    return torch.cat(topics, dim=0)


def _sparse_resident_plsa_runs(X, k, n_runs, rng, prepared, bootstrap=True, init="random",
                               n_iter=100, n_iter_per_test=10, tolerance=0.001):
    """The bootstrap fan-out on the O(nnz) layout: each run a sparse fit with
    multinomial document weights, from a device init at the layout's own
    shapes. As in the JAX package, the runs take no ``e_step_thresh``."""
    topics = []
    for zd, wz, w in bootstrap_inputs(prepared, k, n_runs, rng, bootstrap, init, X):
        topics.append(sell_fit(prepared, zd, wz, sample_weight=w, n_iter=n_iter,
                               n_iter_per_test=n_iter_per_test, tolerance=tolerance)[1])
    return torch.cat(topics, dim=0)


def _sharded_plsa_runs(X, k, n_runs, rng, bootstrap=True, init="random", n_iter=100,
                       n_iter_per_test=10, tolerance=0.001, backend="auto", precision="default",
                       x_dtype="auto", prepared=None, devices=None):
    """``n_runs`` bootstrap fits over a runs mesh of ``devices``
    (:func:`~enstop_torch.parallel.mesh.build_ensemble_runs_sharded`), as many
    shards as the largest divisor of ``n_runs`` the devices allow. Draws
    from ``rng`` in the JAX package's sharded order: every run's
    ``multinomial(n, 1/n)`` first, then one ``randint`` for the init seed
    with ``init="random"`` (run ``i`` seeds its device generator with
    ``seed * 2**20 + i``, as in the weights fan-out), or one init a run. The
    ``(n_runs * k, m)`` stack lies on the staged corpus's device."""
    mesh = mesh_lib.make_runs_mesh(mesh_lib.largest_divisor(n_runs, len(devices)), devices)
    if prepared is None:
        prepared = prepare_counts(X, backend=backend, x_dtype=x_dtype, standardize=False,
                                  device=mesh.devices[0])
    n, m = prepared.n, prepared.m
    n_pad, m_pad = prepared.device_array.shape
    kp = round_up(k, K_MULTIPLE)
    uniform = np.full(n, 1.0 / n)
    ws = [pad_vector((rng.multinomial(n, uniform) if bootstrap else np.ones(n)).astype(
        np.float32), n_pad) for _ in range(n_runs)]
    if init == "random":
        base_seed = int(rng.randint(np.iinfo(np.int32).max))

        def factors(i, dev):
            return _device_init(n_pad, kp, n, k, m_pad, m, base_seed * (1 << 20) + i, dev)
    else:
        host = [pad_factors(*plsa_init(prepared if X is None else X, k, init=init, rng=rng),
                            n_pad, m_pad) for _ in range(n_runs)]

        def factors(i, dev):
            return tuple(torch.from_numpy(a).to(dev) for a in host[i])

    def inputs(i, dev):
        return (*factors(i, dev), torch.from_numpy(ws[i]).to(dev))

    run = mesh_lib.build_ensemble_runs_sharded(mesh, precision)
    home = prepared.device_array.device
    return torch.cat([wz[:k, :m].to(home)
                      for wz in run(prepared, n_runs, inputs, tolerance, n_iter, n_iter_per_test)])


def ensemble_of_topics(X, k, model="plsa", n_jobs=4, n_runs=16, parallelism="auto",
                       **kwargs):
    """Generate ``n_runs * k`` candidate topics as a writable numpy array.

    ``parallelism``:
      * ``"auto"`` (default): ``"sharded"`` when the runs divide over more
        than one device, else ``"weights"`` (see :func:`resolve_parallelism`);
      * ``"weights"``: bootstraps as document weights against one staged copy
        of the corpus (the single-device path);
      * ``"sharded"``: the same runs cut into blocks over a runs mesh, each
        block on its own device against its own copy of the corpus;
      * ``"resample"`` / ``"none"``: a materialised row resample per run, fits
        run one after another;
      * ``"joblib"`` / ``"dask"``: the same runs in a thread pool of ``n_jobs``
        workers where they run on the host (the CPU device, or NMF's
        ``solver="cd"``); otherwise they warn and run one after another.

    Keyword arguments: those of :func:`ensemble_fit`'s runs, plus ``device``,
    ``devices`` and ``prepared``.
    """
    _check_model(model)
    devices = _run_devices(kwargs.pop("devices", None), kwargs.get("device", "cuda"),
                           kwargs.get("prepared"))
    parallelism = resolve_parallelism(parallelism, model, kwargs.get("backend", "auto"),
                                      n_runs, kwargs.get("prepared"), devices)
    out = _ensemble_of_topics_device(X, k, model=model, n_jobs=n_jobs, n_runs=n_runs,
                                     parallelism=parallelism, devices=devices, **kwargs)
    if isinstance(out, torch.Tensor):
        return np.array(out.cpu())
    return out


def _ensemble_of_topics_device(X, k, model="plsa", n_jobs=4, n_runs=16,
                               parallelism="weights", **kwargs):
    """Internal fan-out, for a resolved ``parallelism``: the ``"weights"``
    and ``"sharded"`` paths return the stack as a tensor on the device."""
    device = kwargs.get("device", "cuda")
    rng = check_random_state(kwargs.get("random_state", None))
    if model == "plsa" and parallelism == "sharded":
        return _sharded_plsa_runs(
            X, k, n_runs, rng,
            bootstrap=kwargs.get("bootstrap", True),
            init=kwargs.get("init", "random"),
            n_iter=kwargs.get("n_iter", 100),
            n_iter_per_test=kwargs.get("n_iter_per_test", 10),
            tolerance=kwargs.get("tolerance", 0.001),
            backend=kwargs.get("backend", "auto"),
            precision=kwargs.get("precision", "default"),
            x_dtype=kwargs.get("x_dtype", "auto"),
            prepared=kwargs.get("prepared"),
            devices=kwargs["devices"],
        )
    if model == "plsa" and parallelism == "weights":
        return _device_resident_plsa_runs(
            X, k, n_runs, rng,
            bootstrap=kwargs.get("bootstrap", True),
            init=kwargs.get("init", "random"),
            n_iter=kwargs.get("n_iter", 100),
            n_iter_per_test=kwargs.get("n_iter_per_test", 10),
            tolerance=kwargs.get("tolerance", 0.001),
            backend=kwargs.get("backend", "auto"),
            precision=kwargs.get("precision", "default"),
            x_dtype=kwargs.get("x_dtype", "auto"),
            prepared=kwargs.get("prepared"),
            device=device,
        )

    # seeds drawn up front: run i's stream is the same whether the fits run
    # one after another or in a thread pool
    seeds = [rng.randint(np.iinfo(np.int32).max) for _ in range(n_runs)]

    create_topics = plsa_topics if model == "plsa" else nmf_topics

    def one_run(seed):
        return create_topics(X, k, **dict(kwargs, random_state=seed))

    if parallelism in ("joblib", "dask"):
        # the host solver's runs spread over threads on any device
        host_bound = model == "nmf" and kwargs.get("solver", "mu") == "cd"
        if host_bound or resolve_device(device).type == "cpu":
            if n_jobs != 1 and n_runs > 1:
                import os
                from concurrent.futures import ThreadPoolExecutor

                workers = n_jobs if n_jobs > 0 else (os.cpu_count() or 1)
                with ThreadPoolExecutor(max_workers=min(workers, n_runs)) as ex:
                    return np.vstack(list(ex.map(one_run, seeds)))
        else:
            warnings.warn(
                f"parallelism={parallelism!r} fans bootstrap fits out over host "
                "threads, which cannot help a device-bound workload on "
                f"{device!r}; running sequentially (use parallelism='auto' for "
                "the device fan-out)",
                stacklevel=3,
            )
    return np.vstack([one_run(s) for s in seeds])


# ---------------------------------------------------------------------------
# topic combiners
# ---------------------------------------------------------------------------

def _merge_topics_device(T, W):
    """``W`` is the (n_clusters, n_topics) row-normalised membership-weight
    matrix; the square-root average is one float32 product on T's device."""
    with full_fp32_matmul():
        avg = W @ T.clamp_min(0.0).sqrt()
    sq = avg * avg
    return sq / sq.sum(dim=1, keepdim=True).clamp_min(1e-30)


def _merge_topics_by_label(all_topics, labels, weights=None):
    """Cluster merge rule: squared (weighted) mean of the square-root topic
    vectors, renormalised. A tensor stack is merged on its device; only the
    small stable-topic matrix comes back to the host."""
    n_clusters = int(labels.max()) + 1
    if isinstance(all_topics, torch.Tensor):
        W = np.zeros((n_clusters, all_topics.shape[0]), np.float32)
        for i in range(n_clusters):
            mask = labels == i
            w = weights[mask] if weights is not None else np.ones(mask.sum())
            if weights is not None and w.sum() <= 0:
                w = np.ones(mask.sum())
            W[i, mask] = w / w.sum()
        merged = _merge_topics_device(all_topics.float(),
                                      torch.from_numpy(W).to(all_topics.device))
        return merged.cpu().numpy()
    result = np.empty((n_clusters, all_topics.shape[1]), dtype=np.float32)
    for i in range(n_clusters):
        mask = labels == i
        if weights is not None:
            w = weights[mask]
            if w.sum() <= 0:
                w = np.ones(mask.sum())
            result[i] = np.average(np.sqrt(all_topics[mask]), axis=0, weights=w) ** 2
        else:
            result[i] = np.mean(np.sqrt(all_topics[mask]), axis=0) ** 2
        result[i] /= result[i].sum()
    return result


def generate_combined_topics_kl(all_topics, min_samples=5, min_cluster_size=5, device=None):
    """KL-divergence combiner: hand-built mutual reachability over the
    (asymmetric) divergence matrix, MST, leaf selection. ``device``: where a
    stack that is not a tensor is used (the card by default; a tensor stays on
    its own device), as for the distances."""
    divergence_matrix = all_pairs_kl_divergence(all_topics, device)
    core = np.sort(divergence_matrix, axis=1)[:, min_samples]
    tiled = np.tile(core, (core.shape[0], 1))
    mutual_reach = np.dstack(
        [divergence_matrix, divergence_matrix.T, tiled, tiled.T]
    ).max(axis=-1)
    ct = condense_tree(single_linkage_tree(mst_linkage(mutual_reach)), min_cluster_size)
    selected = select_clusters(ct, compute_stability(ct), method="leaf")
    if not selected:
        labels = np.zeros(all_topics.shape[0], dtype=np.intp)
    else:
        labels, _ = labels_and_probabilities(ct, selected, all_topics.shape[0])
    if labels.max() < 0:
        labels = np.zeros(all_topics.shape[0], dtype=np.intp)
    return _merge_topics_by_label(all_topics, labels)


def generate_combined_topics_hellinger(all_topics, min_samples=5, min_cluster_size=5,
                                       device=None):
    """Hellinger combiner: precomputed-metric HDBSCAN, leaf selection;
    ``device`` as for :func:`generate_combined_topics_kl`."""
    labels = HDBSCAN(
        min_samples=min_samples,
        min_cluster_size=min_cluster_size,
        metric="precomputed",
        cluster_selection_method="leaf",
    ).fit_predict(all_pairs_hellinger_distance(all_topics, device))
    if labels.max() < 0:
        labels = np.zeros(all_topics.shape[0], dtype=np.intp)
    return _merge_topics_by_label(all_topics, labels)


def generate_combined_topics_hellinger_umap(
    all_topics, min_samples=5, min_cluster_size=5, n_neighbors=15, reduced_dim=5,
    random_state=None, device=None,
):
    """Default combiner: 5-D UMAP embedding under Hellinger distance (its
    layout on the stack's device), then euclidean HDBSCAN with leaf selection
    and ``allow_single_cluster``; clusters merged with membership-strength
    weights. ``device`` as for :func:`generate_combined_topics_kl`."""
    device = stack_device(all_topics, device)
    embedding = umap_embed(
        dmat=all_pairs_hellinger_distance(all_topics, device),
        n_components=reduced_dim,
        n_neighbors=n_neighbors,
        random_state=random_state,
        device=device,
    )
    clusterer = HDBSCAN(
        min_samples=min_samples,
        min_cluster_size=min_cluster_size,
        cluster_selection_method="leaf",
        allow_single_cluster=True,
    ).fit(embedding)
    labels = clusterer.labels_
    strengths = clusterer.probabilities_
    if labels.max() < 0:
        labels = np.zeros(all_topics.shape[0], dtype=np.intp)
        strengths = np.ones(all_topics.shape[0])
    return _merge_topics_by_label(all_topics, labels, weights=strengths)


_topic_combiner = {
    "kl_divergence": generate_combined_topics_kl,
    "hellinger": generate_combined_topics_hellinger,
    "hellinger_umap": generate_combined_topics_hellinger_umap,
}


# ---------------------------------------------------------------------------
# ensemble fit
# ---------------------------------------------------------------------------

def ensemble_fit(
    X,
    estimated_n_topics=10,
    model="plsa",
    init="random",
    min_samples=3,
    min_cluster_size=4,
    n_starts=16,
    n_jobs=1,
    parallelism="auto",
    topic_combination="hellinger_umap",
    bootstrap=True,
    n_iter=100,
    n_iter_per_test=10,
    tolerance=0.001,
    e_step_thresh=1e-16,
    lift_factor=1,
    beta_loss=1,
    alpha=0.0,
    solver="mu",
    random_state=None,
    backend="auto",
    x_dtype="auto",
    precision="default",
    device="cuda",
    devices=None,
):
    """Full ensemble pipeline; returns ``(doc_vectors, stable_topics)`` as numpy.

    Stage wall times land in ``ensemble_fit.last_timings`` (``staging_s``,
    ``runs_s``, ``combine_s``, ``refit_s``); each stage ends with a device
    synchronise, so a stage's time holds its own device work.

    ``precision``: the bootstrap fits' and the final refit's (``"default"``,
    ``"highest"`` or ``"fast"``, see :func:`~enstop_torch.ops.driver.plsa_fit`).
    ``"fast"`` (bf16 responsibilities) moves each run's factors at bf16
    rounding level; the topic clustering is built to be stable under such
    run-to-run jitter. ``beta_loss``, ``alpha`` and ``solver`` are the NMF
    runs' parameters (``model="nmf"``: KL or Frobenius multiplicative updates
    on the device with ``solver="mu"``, host coordinate descent with
    ``"cd"``); its final embedding solves for the documents against the
    frozen stable topics by multiplicative updates. ``X`` may be a count matrix, a
    :class:`~enstop_torch.ops.driver.PreparedCounts` or a
    :class:`~enstop_torch.ops.sell.PreparedSell` (then its device wins over
    ``device``). ``backend="sparse"`` stages the sparse layout; on it the
    runs, which have no bf16 mode, warn at ``"fast"`` and run fp32.
    ``e_step_thresh`` goes to the final refit: a :class:`PreparedCounts`
    refits dense whatever its value, the sparse layout and raw input above
    1e-30 refit sparse and apply it exactly. ``devices``: those the
    ``"sharded"`` fan-out lays its runs over and ``"auto"`` counts (by
    default every card of the corpus's device; one device may be named more
    than once).
    """
    _check_model(model)
    cuda_em._check_precision(precision)
    if topic_combination not in _topic_combiner:
        raise ValueError(f"topic_combination must be one of {tuple(_topic_combiner)}")

    timings = {}
    t0 = time.perf_counter()
    is_prepared = isinstance(X, (PreparedCounts, PreparedSell))
    devices = _run_devices(devices, device, X if is_prepared else None)
    parallelism = resolve_parallelism(parallelism, model, backend, n_starts,
                                      X if is_prepared else None, devices)
    if is_prepared:
        prepared, X = X, None
        if model != "plsa" or parallelism not in ("weights", "sharded"):
            raise ValueError("Prepared input requires model='plsa' and parallelism='weights' "
                             "or 'sharded'")
        dev = (prepared.device if isinstance(prepared, PreparedSell)
               else prepared.device_array.device)
    else:
        # raw float32 counts, not l1-normalised: the ensemble fits the counts
        X = check_counts(X, dtype=np.float32)
        dev = resolve_device(device)
        prepared = None
        if model == "plsa" and parallelism == "weights" and backend == "sparse":
            prepared = prepare_sell(X, standardize=False, device=dev)
        elif model == "plsa" and parallelism in ("weights", "sharded"):
            prepared = prepare_counts(X, backend=backend, x_dtype=x_dtype,
                                      standardize=False, device=dev)
    _sync(dev)
    timings["staging_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    all_topics = _ensemble_of_topics_device(
        X,
        estimated_n_topics,
        model=model,
        n_jobs=n_jobs,
        n_runs=n_starts,
        parallelism=parallelism,
        init=init,
        n_iter=n_iter,
        n_iter_per_test=n_iter_per_test,
        tolerance=tolerance,
        e_step_thresh=e_step_thresh,
        bootstrap=bootstrap,
        beta_loss=beta_loss,
        alpha=alpha,
        solver=solver,
        random_state=random_state,
        backend=backend,
        x_dtype=x_dtype,
        precision=precision,
        prepared=prepared,
        device=dev,
        devices=devices,
    )
    if dev.type == "cuda" and not isinstance(all_topics, torch.Tensor):
        # a stack fitted run by run comes back as numpy: the combine stage
        # runs on the card all the same
        all_topics = torch.from_numpy(all_topics).to(dev)
    _sync(dev)
    timings["runs_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    cluster_topics = _topic_combiner[topic_combination]
    if topic_combination == "hellinger_umap":
        stable_topics = cluster_topics(all_topics, min_samples, min_cluster_size,
                                       random_state=random_state, device=dev)
    else:
        stable_topics = cluster_topics(all_topics, min_samples, min_cluster_size, device=dev)
    timings["combine_s"] = time.perf_counter() - t0

    if lift_factor != 1:
        stable_topics = stable_topics ** lift_factor
        stable_topics /= stable_topics.sum(axis=1, keepdims=True)

    t0 = time.perf_counter()
    if model == "nmf":
        doc_vectors, _ = nmf_fit_mu(X, stable_topics.shape[0], beta_loss=beta_loss,
                                    H_init=stable_topics, update_H=False,
                                    random_state=random_state, device=dev)
    else:
        refit_input = prepared if prepared is not None else X
        doc_vectors = plsa_refit(
            refit_input,
            stable_topics,
            sample_weight=_check_sample_weight(None, refit_input, dtype=np.float32),
            e_step_thresh=e_step_thresh,
            random_state=random_state,
            backend=backend,
            precision=precision,
            device=dev,
        )
    timings["refit_s"] = time.perf_counter() - t0

    ensemble_fit.last_timings = timings
    return doc_vectors, stable_topics


class EnsembleTopics(TopicModelBase):
    """Ensemble topic modelling estimator on PyTorch.

    Parameters are the JAX package's, plus ``device`` (``"cuda"`` by default;
    a CUDA device that is missing raises, nothing falls back to the CPU).
    ``precision="fast"`` runs the bootstrap fits and the refit through the
    bf16-responsibilities kernels. ``backend="sparse"`` runs them, and
    ``transform``, on the O(nnz) sparse layout. ``parallelism="sharded"`` (or
    ``"auto"`` with several devices) splits the runs over :meth:`_devices`.
    Fitted attributes: ``components_``
    (n_components_, n_words), ``embedding_``, ``training_data_`` and
    ``n_components_``, the number of stable topics found (may differ from
    ``n_components``).
    """

    def __init__(
        self,
        n_components=10,
        model="plsa",
        init="random",
        n_starts=16,
        min_samples=3,
        min_cluster_size=5,
        n_jobs=8,
        parallelism="auto",
        topic_combination="hellinger_umap",
        bootstrap=True,
        n_iter=80,
        n_iter_per_test=10,
        tolerance=0.001,
        e_step_thresh=1e-32,
        lift_factor=1,
        beta_loss=1,
        alpha=0.0,
        solver="mu",
        transform_random_seed=42,
        random_state=None,
        backend="auto",
        x_dtype="auto",
        precision="default",
        device="cuda",
    ):
        self.n_components = n_components
        self.model = model
        self.init = init
        self.n_starts = n_starts
        self.min_samples = min_samples
        self.min_cluster_size = min_cluster_size
        self.n_jobs = n_jobs
        self.parallelism = parallelism
        self.topic_combination = topic_combination
        self.bootstrap = bootstrap
        self.n_iter = n_iter
        self.n_iter_per_test = n_iter_per_test
        self.tolerance = tolerance
        self.e_step_thresh = e_step_thresh
        self.lift_factor = lift_factor
        self.beta_loss = beta_loss
        self.alpha = alpha
        self.solver = solver
        self.transform_random_seed = transform_random_seed
        self.random_state = random_state
        self.backend = backend
        self.x_dtype = x_dtype
        self.precision = precision
        self.device = device

    def fit_transform(self, X, y=None, **fit_params):
        if fit_params.pop("sample_weight", None) is not None:
            raise TypeError(
                "EnsembleTopics does not support sample_weight (the reference's "
                "ensemble has no weighted path); weight the individual PLSA fits "
                "instead"
            )
        prepared = isinstance(X, (PreparedCounts, PreparedSell))
        if not prepared:
            X = check_counts(X)
            if np.any(X.data < 0):
                raise ValueError(
                    "EnsembleTopics is only valid for matrices with non-negative "
                    "entries (Negative values in data passed to fit)"
                )
        U, V = ensemble_fit(
            X,
            self.n_components,
            model=self.model,
            init=self.init,
            min_samples=self.min_samples,
            min_cluster_size=self.min_cluster_size,
            n_starts=self.n_starts,
            n_jobs=self.n_jobs,
            parallelism=self.parallelism,
            topic_combination=self.topic_combination,
            bootstrap=self.bootstrap,
            n_iter=self.n_iter,
            n_iter_per_test=self.n_iter_per_test,
            tolerance=self.tolerance,
            e_step_thresh=self.e_step_thresh,
            lift_factor=self.lift_factor,
            beta_loss=self.beta_loss,
            alpha=self.alpha,
            solver=self.solver,
            random_state=self.random_state,
            backend=self.backend,
            x_dtype=self.x_dtype,
            precision=self.precision,
            device=self.device,
            devices=None if prepared else self._devices(),
        )
        self.components_ = V
        self.embedding_ = U
        self.training_data_ = None if prepared else X
        self.n_components_ = self.components_.shape[0]
        return U

    def _devices(self):
        """The devices the ``"sharded"`` fan-out lays its runs over, and that
        ``"auto"`` counts: :func:`~enstop_torch.parallel.mesh.local_devices`
        of ``device`` (a prepared corpus uses every card of its own device). A
        subclass may return one device several times."""
        return mesh_lib.local_devices(self.device)

    def transform(self, X, y=None):
        """Embed new documents against the stable topics (a refit of
        ``P(z|d)`` only: 50 iterations, a test every 5, tolerance 1e-3)."""
        X = check_counts(X)
        self._validate_transform_input(X)
        return plsa_refit(
            X,
            self.components_,
            n_iter=50,
            n_iter_per_test=5,
            tolerance=0.001,
            random_state=check_random_state(self.transform_random_seed),
            backend=self.backend,
            precision=self.precision,
            device=self.device,
        )

    @classmethod
    def from_state(cls, components, embedding, history=None, params=None):
        model = super().from_state(components, embedding, history, params)
        model.n_components_ = model.components_.shape[0]
        return model
