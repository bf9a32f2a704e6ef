"""The port's stable-topic clustering against the JAX package's, on the same
numpy inputs.

* HDBSCAN (``enstop_torch.cluster.hdbscan``, a NumPy copy): identical labels
  and probabilities (exact) on the blob and precomputed-Hellinger cases of
  ``tests/test_hdbscan_golden.py``; its euclidean distances equal
  scikit-learn's ``pairwise_distances`` bit for bit.
* Distance matrices: float64 numpy with a zero diagonal, within 1e-6 of the
  JAX package's (Hellinger absolute; KL relative to the largest divergence):
  both are float32 products, summed in different orders.
* UMAP, host layout: bit for bit with the JAX package given the same distance
  matrix and seed. Device layout (a torch loop, run here on CPU tensors): the
  behaviour gates of ``tests/test_umap_behavior.py``, since its random stream
  is torch's.
"""

import numpy as np
import pytest
import torch
from sklearn.manifold import trustworthiness
from sklearn.metrics import pairwise_distances

from enstop_torch.cluster import distances as port_dist
from enstop_torch.cluster import hdbscan as port_hdbscan
from enstop_torch.cluster import umap as port_umap
from enstop_torch.models import ensemble as port_ens
from enstop_tpu.cluster import distances as jax_dist
from enstop_tpu.cluster import hdbscan as jax_hdbscan
from enstop_tpu.cluster import umap as jax_umap
from test_hdbscan_golden import CASES as BLOB_CASES
from test_hdbscan_golden import _blobs
from test_umap_behavior import _topic_stack

torch.set_num_threads(1)


def _hellinger_topics():
    rng = np.random.RandomState(5)
    base = rng.dirichlet(np.full(60, 0.2), size=6)
    topics = np.vstack([np.abs(base[i % 6] + rng.randn(60) * 0.01) for i in range(48)])
    return (topics / topics.sum(1, keepdims=True)).astype(np.float32)


def _same_clustering(X, **kw):
    ours = port_hdbscan.HDBSCAN(**kw).fit(X)
    ref = jax_hdbscan.HDBSCAN(**kw).fit(X)
    np.testing.assert_array_equal(ours.labels_, ref.labels_)
    np.testing.assert_array_equal(ours.probabilities_, ref.probabilities_)
    return ours


@pytest.mark.parametrize("case", BLOB_CASES)
@pytest.mark.parametrize("method", ["eom", "leaf"])
def test_hdbscan_blobs_match_jax(case, method):
    X = _blobs(**case)
    np.testing.assert_array_equal(port_hdbscan.euclidean_distances(X), pairwise_distances(X))
    _same_clustering(X, min_samples=3, min_cluster_size=4, cluster_selection_method=method)
    _same_clustering(X, min_samples=3, min_cluster_size=5, cluster_selection_method=method,
                     allow_single_cluster=True)


@pytest.mark.parametrize("method", ["eom", "leaf"])
def test_hdbscan_precomputed_hellinger_matches_jax(method):
    dmat = jax_dist.all_pairs_hellinger_distance(_hellinger_topics())
    dmat = (dmat + dmat.T) / 2
    np.fill_diagonal(dmat, 0.0)
    ours = _same_clustering(dmat, metric="precomputed", min_samples=3, min_cluster_size=4,
                            cluster_selection_method=method)
    assert ours.labels_.max() >= 1


@pytest.mark.parametrize("as_tensor", [False, True])
def test_distance_matrices_match_jax(as_tensor):
    T = _hellinger_topics()
    T[3] = 0.0  # an all-zero row: distance 1 to the others, 0 to itself
    T[7, :20] = 0.0  # zeros that the KL terms skip
    T[7] /= T[7].sum()
    inp = torch.from_numpy(T) if as_tensor else T
    for port_fn, jax_fn, atol in (
            (port_dist.all_pairs_hellinger_distance, jax_dist.all_pairs_hellinger_distance, 1e-6),
            (port_dist.all_pairs_kl_divergence, jax_dist.all_pairs_kl_divergence, None)):
        got, want = port_fn(inp), jax_fn(T)
        assert got.dtype == np.float64 and got.shape == (48, 48)
        assert np.all(np.diag(got) == 0.0)
        np.testing.assert_allclose(got, want, rtol=0, atol=atol or 1e-6 * np.abs(want).max())
    hell = port_dist.all_pairs_hellinger_distance(inp)
    assert np.all(hell[3, np.arange(48) != 3] == 1.0)
    for a, b in ((T[0], T[1]), (T[3], T[3]), (T[3], T[5]), (T[7], T[9])):
        assert port_dist.hellinger(a, b) == jax_dist.hellinger(a, b)
        assert port_dist.kl_divergence(a, b) == jax_dist.kl_divergence(a, b)


def test_distances_keep_tf32_setting():
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with port_dist.full_fp32_matmul():
            assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _dmat(seed, n_groups, copies):
    T = _topic_stack(seed, n_groups=n_groups, copies=copies)
    dmat = np.asarray(jax_dist.all_pairs_hellinger_distance(T), dtype=np.float64)
    dmat = (dmat + dmat.T) / 2
    np.fill_diagonal(dmat, 0)
    return T, dmat


@pytest.mark.parametrize("seed,n_groups,copies", [(0, 5, 10), (3, 8, 6)])
def test_host_umap_is_bit_identical(seed, n_groups, copies):
    _, dmat = _dmat(seed, n_groups, copies)
    for n_neighbors in (10, 15):
        got = port_umap.umap_embed(dmat=dmat, n_components=5, n_neighbors=n_neighbors,
                                   random_state=seed, device="cpu")
        want = jax_umap.umap_embed(dmat=dmat, n_components=5, n_neighbors=n_neighbors,
                                   random_state=seed)
        np.testing.assert_array_equal(got, want)
    # "auto" on the CPU is the host layout
    np.testing.assert_array_equal(
        port_umap.umap_embed(dmat=dmat, random_state=seed, layout="auto", device="cpu"),
        jax_umap.umap_embed(dmat=dmat, random_state=seed, layout="host"))
    np.testing.assert_array_equal(port_umap.fuzzy_simplicial_set(dmat, 15),
                                  jax_umap.fuzzy_simplicial_set(dmat, 15))
    assert port_umap.find_ab_params(1.0, 0.1) == jax_umap.find_ab_params(1.0, 0.1)
    # the estimator facade, on raw points under the euclidean metric
    pts = np.random.RandomState(seed).rand(40, 6)
    np.testing.assert_array_equal(
        port_umap.UMAP(n_components=3, n_neighbors=8, random_state=seed,
                       device="cpu").fit_transform(pts),
        jax_umap.UMAP(n_components=3, n_neighbors=8, random_state=seed).fit_transform(pts))


@pytest.mark.parametrize("seed", [0, 2])
def test_device_layout_trustworthiness(seed):
    _, dmat = _dmat(seed, 5, 10)
    emb = port_umap.umap_embed(dmat=dmat, n_components=5, n_neighbors=10,
                               random_state=seed, layout="device", device="cpu")
    assert emb.dtype == np.float64 and emb.shape == (50, 5)
    tw = trustworthiness(dmat, emb, n_neighbors=8, metric="precomputed")
    assert tw > 0.9, f"trustworthiness {tw:.3f}"


def test_device_layout_combiner_recovers_groups(monkeypatch):
    """End-to-end combiner gate with the device layout forced (what a CUDA
    stack runs)."""
    monkeypatch.setattr(
        port_ens, "umap_embed",
        lambda *a, **k: port_umap.umap_embed(*a, **{**k, "layout": "device"}),
    )
    n_groups, copies, seed = 4, 12, 0
    T = _topic_stack(seed, n_groups, copies)
    stable = port_ens.generate_combined_topics_hellinger_umap(
        torch.from_numpy(T), min_samples=3, min_cluster_size=4, random_state=seed)
    assert n_groups <= stable.shape[0] <= 2 * n_groups, f"found {stable.shape[0]}"
    np.testing.assert_allclose(stable.sum(axis=1), 1.0, rtol=1e-5)
    rng = np.random.RandomState(seed)
    protos = rng.dirichlet(np.full(T.shape[1], 0.15), size=n_groups)
    protos = protos / protos.sum(1, keepdims=True)
    d = np.sqrt(((np.sqrt(stable[:, None, :]) - np.sqrt(protos[None, :, :])) ** 2
                 ).sum(-1)) / np.sqrt(2)
    assert d.min(axis=0).max() < 0.45
    assert d.min(axis=1).max() < 0.45
    assert set(d.argmin(axis=1).tolist()) == set(range(n_groups))


def test_device_layout_deterministic():
    _, dmat = _dmat(7, 4, 10)
    runs = [port_umap.umap_embed(dmat=dmat, n_components=5, n_neighbors=10, random_state=42,
                                 layout="device", device="cpu") for _ in range(2)]
    np.testing.assert_array_equal(runs[0], runs[1])
    other = port_umap.umap_embed(dmat=dmat, n_components=5, n_neighbors=10, random_state=43,
                                 layout="device", device="cpu")
    assert not np.array_equal(runs[0], other)
