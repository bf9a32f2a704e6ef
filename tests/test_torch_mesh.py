"""The port's dense device mesh, mesh estimators and sharded ensemble against
the JAX package on the CPU.

JAX runs on the conftest's 8 virtual CPU devices with ``backend="xla"``; the
port runs ``device="cpu"`` with 8 tiles on the one CPU device, through
subclasses whose ``_devices()`` return ``[cpu] * 8``. Both sides get the same
numpy inputs and, for the estimators, the same injected initial factors.
Tolerances:

* one sharded EM or refit step: factors rtol 1e-5 / atol 1e-7, the LL rtol
  1e-5 (float32 sums in another order);
* fits: ``n_iter_`` equal, ``history_`` rtol 1e-5, ``components_`` and
  ``embedding_`` (and ``transform``) rtol 5e-4 / atol 1e-5 (``FACTOR_TOL``,
  as in ``test_torch_plsa.py``);
* staging: the tiles equal the padded rectangle cut into tiles, exactly;
* a 1 x 1 mesh: ``PLSA``'s fit bit for bit (the same ops in the same order);
* the sharded ensemble: the bootstrap weights equal JAX's exactly, the topic
  stack within ``FACTOR_TOL``, and the stack at 1, 2 and 4 runs-shards bit
  for bit the same.
"""

import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import enstop_torch
import enstop_tpu
from conftest import make_corpus
from enstop_torch import convert
from enstop_torch.models import ensemble as port_ens
from enstop_torch.models.base import TopicModelBase
from enstop_torch.ops import cuda_sparse
from enstop_torch.ops import em as port_em
from enstop_torch.ops.data import pad_dense_counts, pad_factors
from enstop_torch.ops.driver import _stage_dense
from enstop_torch.parallel import mesh as port_mesh
from enstop_torch.synthetic import synthetic_corpus
from enstop_tpu.models import ensemble as jax_ens
from enstop_tpu.ops.init import plsa_init
from enstop_tpu.parallel import mesh as jax_mesh

torch.set_num_threads(1)

CPU = torch.device("cpu")
MESHES = [(8, 1), (4, 2), (2, 4), (1, 8)]
STEP_TOL = dict(rtol=1e-5, atol=1e-7)
FACTOR_TOL = dict(rtol=5e-4, atol=1e-5)
K = 4


class PortBlock(enstop_torch.BlockParallelPLSA):
    def _devices(self):
        return [CPU] * 8


class PortDistributed(enstop_torch.DistributedPLSA):
    def _devices(self):
        return [CPU] * 8


def _corpus():
    X = make_corpus(np.random.RandomState(0), n_docs=70, n_words=130, seed=7)
    X[5] = 0.0  # a zero row: split off before the fit, put back after it
    w = np.random.RandomState(3).uniform(0.5, 1.5, X.shape[0]).astype(np.float32)
    return X, w


def _counts(seed=9):
    return sp.csr_matrix(make_corpus(np.random.RandomState(1), n_docs=60, n_words=150,
                                     seed=seed).astype(np.int64))


def _padded(shape, k=5):
    X = sp.csr_matrix(make_corpus(np.random.RandomState(0), n_docs=60, n_words=90, seed=3))
    pzd, pwz = plsa_init(X, k, rng=np.random.RandomState(0))
    jm = jax_mesh.make_mesh(*shape)
    Xd, n, m = pad_dense_counts(X, *jax_mesh.mesh_layout_multiples(jm, "xla"))
    zd, wz = pad_factors(pzd, pwz, *Xd.shape)
    w = np.random.RandomState(1).uniform(0.5, 2.0, Xd.shape[0]).astype(np.float32)
    return X, Xd, zd, wz, w, jm, port_mesh.make_mesh(*shape, devices=[CPU] * 8)


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_em_step_matches_jax(shape):
    X, Xd, zd, wz, w, jm, pm = _padded(shape)
    want_zd, want_wz, want_ll = jax_mesh.build_sharded_em_step(jm, inner="xla")(
        *jax_mesh.shard_inputs(jm, Xd, zd, wz, w))
    tiles, n, m = port_mesh.stage_sharded_counts(pm, X)
    got_zd, got_wz, got_ll = port_mesh.build_sharded_em_step(pm)(
        tiles, *port_mesh.shard_factors(pm, zd, wz, w))
    assert len(got_zd) == shape[0] and len(got_wz) == shape[1]
    np.testing.assert_allclose(port_mesh.gather_rows(pm, got_zd), np.asarray(want_zd),
                               **STEP_TOL)
    np.testing.assert_allclose(port_mesh.gather_cols(got_wz), np.asarray(want_wz), **STEP_TOL)
    np.testing.assert_allclose(float(got_ll), float(want_ll), rtol=1e-5)


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_refit_step_matches_jax(shape):
    X, Xd, zd, wz, _, jm, pm = _padded(shape)
    ones = np.ones(Xd.shape[0], np.float32)
    Xs, zds, wzs, _ = jax_mesh.shard_inputs(jm, Xd, zd, wz, ones)
    want_zd, want_ll = jax_mesh.build_sharded_refit_step(jm, inner="xla")(Xs, zds, wzs)
    tiles, _, _ = port_mesh.stage_sharded_counts(pm, X)
    p_zd, p_wz, _ = port_mesh.shard_factors(pm, zd, wz, ones)
    got_zd, got_ll = port_mesh.build_sharded_refit_step(pm)(tiles, p_zd, p_wz)
    np.testing.assert_allclose(port_mesh.gather_rows(pm, got_zd), np.asarray(want_zd),
                               **STEP_TOL)
    np.testing.assert_allclose(float(got_ll), float(want_ll), rtol=1e-5)
    # and the LL alone, as the fit loop's last test point takes it
    ll = port_mesh.build_sharded_ll(pm)(tiles, p_zd, p_wz, port_mesh.shard_factors(
        pm, zd, wz, ones)[2])
    np.testing.assert_allclose(float(ll), float(want_ll), rtol=1e-5)


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4)])
@pytest.mark.parametrize("dense_input", [False, True])
def test_stage_sharded_counts_cuts_the_padded_rectangle(shape, dense_input):
    X = _counts()
    pm = port_mesh.make_mesh(*shape, devices=[CPU] * 8)
    tiles, n, m = port_mesh.stage_sharded_counts(pm, X.toarray() if dense_input else X)
    want, n2, m2 = pad_dense_counts(X, *port_mesh.mesh_layout_multiples(pm))
    jax_tiles = np.asarray(jax_mesh.stage_sharded_counts(jax_mesh.make_mesh(*shape), X)[0])
    np.testing.assert_array_equal(want, jax_tiles)
    assert (n, m) == (n2, m2) == X.shape
    tr, tc = want.shape[0] // shape[0], want.shape[1] // shape[1]
    for i in range(shape[0]):
        for j in range(shape[1]):
            tile = tiles[i][j]
            Xt = tile.device_array
            # integer counts <= 256 stage as bf16, resolved once for every tile
            assert Xt.dtype == torch.bfloat16 and Xt.is_contiguous()
            assert Xt.shape == (tr, tc) and tile.nnz == int(torch.count_nonzero(Xt))
            np.testing.assert_array_equal(Xt.float().numpy(),
                                          want[i * tr:(i + 1) * tr, j * tc:(j + 1) * tc])
            # the tile's word side holds its nonzeros by column, in local indices
            owners = tile.word.owners()
            np.testing.assert_array_equal(Xt.float()[tile.word.idx.long(), owners].numpy(),
                                          tile.word.vals.numpy())
            assert torch.all(owners[1:] >= owners[:-1])


def test_one_by_one_mesh_is_plsa_bit_for_bit():
    X, w = _corpus()
    init = plsa_init(sp.csr_matrix(X), K, rng=np.random.RandomState(5))
    kw = dict(n_components=K, init=init, n_iter=20, device="cpu")
    flat = enstop_torch.PLSA(**kw).fit(X, sample_weight=w)
    mesh = enstop_torch.BlockParallelPLSA(**kw).fit(X, sample_weight=w)
    for name in ("components_", "embedding_", "history_"):
        np.testing.assert_array_equal(getattr(mesh, name), getattr(flat, name))
    assert mesh.n_iter_ == flat.n_iter_
    # the 1 x 1 tile is the single-device staging, word side and all
    tiles, _, _ = port_mesh.stage_sharded_counts(port_mesh.make_mesh(1, 1, [CPU]),
                                                 _counts())
    Xd, _, _, word = _stage_dense(_counts(), CPU, torch.bfloat16)
    assert torch.equal(tiles[0][0].device_array, Xd)
    for f in ("idx", "vals", "seg_ptr", "seg_owner", "owner_seg_ptr"):
        assert torch.equal(getattr(tiles[0][0].word, f), getattr(word, f))


def _assert_same_fit(port, ref):
    assert port.n_iter_ == ref.n_iter_
    np.testing.assert_allclose(port.history_, ref.history_, rtol=1e-5)
    np.testing.assert_allclose(port.components_, ref.components_, **FACTOR_TOL)
    np.testing.assert_allclose(port.embedding_, ref.embedding_, **FACTOR_TOL)


@pytest.mark.parametrize("name,rows,cols", [
    ("BlockParallelPLSA", 4, 2), ("BlockParallelPLSA", 2, 4), ("DistributedPLSA", None, 1),
    ("DistributedPLSA", None, 2)])
def test_mesh_estimators_match_jax(name, rows, cols):
    X, w = _corpus()
    init = plsa_init(sp.csr_matrix(X), K, rng=np.random.RandomState(5))
    kw = dict(n_components=K, init=init, n_row_blocks=rows, n_col_blocks=cols, n_iter=20,
              n_iter_per_test=5)
    port_cls = PortBlock if name == "BlockParallelPLSA" else PortDistributed
    port = port_cls(device="cpu", **kw)
    ref = getattr(enstop_tpu, name)(backend="xla", **kw)
    emb = port.fit_transform(X, sample_weight=w)
    ref.fit(X, sample_weight=w)
    _assert_same_fit(port, ref)
    np.testing.assert_array_equal(emb[5], 0.0)
    assert port.training_data_.shape == X.shape
    assert set(port.fit_info_) == {"n_steps", "log_likelihood", "ll_trace", "wall_time_s"}
    assert port.fit_info_["log_likelihood"] == pytest.approx(port.history_[-1], rel=1e-6)
    np.testing.assert_allclose(port.transform(X[:20]), ref.transform(X[:20]), **FACTOR_TOL)


@pytest.mark.parametrize("rows,cols", [(None, 1), (4, 2), (3, 3), (16, 1), (1, 8), (2, 5),
                                       (None, 3)])
def test_mesh_shape_is_clamped_as_in_jax(rows, cols):
    port = PortBlock(n_row_blocks=rows, n_col_blocks=cols, device="cpu")._make_mesh()
    ref = enstop_tpu.BlockParallelPLSA(n_row_blocks=rows, n_col_blocks=cols)._make_mesh()
    assert port.shape == dict(ref.shape)
    port_d = PortDistributed(n_col_blocks=cols, device="cpu")._make_mesh()
    assert port_d.shape == dict(enstop_tpu.DistributedPLSA(n_col_blocks=cols)._make_mesh().shape)


@pytest.mark.parametrize("thresh", [1e-16, 1e-3])
def test_material_threshold_routes_to_the_sparse_mesh(thresh):
    X = _counts(seed=97)
    kw = dict(n_components=3, n_iter=12, random_state=0, e_step_thresh=thresh)
    em_calls, sparse_calls = dict(port_em.CALLS), dict(cuda_sparse.CALLS)
    port = PortBlock(device="cpu", **kw)
    port.fit(X)
    assert port_em.CALLS == em_calls  # no dense step ran
    # 8 shards, each running the word pass on every one of the 12 steps
    assert cuda_sparse.CALLS["word_pass"] - sparse_calls["word_pass"] == 8 * 12
    ref = enstop_tpu.BlockParallelPLSA(backend="xla", **kw).fit(X)
    _assert_same_fit(port, ref)
    np.testing.assert_allclose(port.transform(X[:10]), ref.transform(X[:10]), **FACTOR_TOL)


def test_jax_mesh_checkpoint_loads_as_the_port_class(tmp_path):
    X, _ = _corpus()
    ref = enstop_tpu.BlockParallelPLSA(n_components=K, n_row_blocks=4, n_col_blocks=2,
                                       n_iter=15, random_state=0, backend="xla").fit(X)
    path = tmp_path / "mesh.npz"
    ref.save(path)
    loaded = TopicModelBase.load(path, device="cpu")
    carried = convert.from_jax_state(ref.components_, ref.embedding_, ref.history_,
                                     ref.get_params(), estimator=type(ref).__name__)
    carried.device = "cpu"
    want = ref.transform(X[:20])
    for model in (loaded, carried):
        assert type(model) is enstop_torch.BlockParallelPLSA
        assert (model.n_row_blocks, model.n_col_blocks, model.backend) == (4, 2, "auto")
        np.testing.assert_array_equal(model.components_, ref.components_)
        np.testing.assert_array_equal(model.history_, ref.history_)
        # on the one CPU device the mesh is 1 x 1: the same refit on one tile
        np.testing.assert_allclose(model.transform(X[:20]), want, **FACTOR_TOL)
    with pytest.raises(ValueError, match="BlockParallelPLSA"):
        enstop_torch.PLSA.load(path)
    with pytest.raises(ValueError, match="no port estimator"):
        convert.from_jax_state(ref.components_, ref.embedding_, estimator="NoSuchPLSA")


def test_mesh_estimators_surface():
    for cls, jax_cls in ((enstop_torch.BlockParallelPLSA, enstop_tpu.BlockParallelPLSA),
                         (enstop_torch.DistributedPLSA, enstop_tpu.DistributedPLSA)):
        params = cls().get_params()
        assert set(params) == set(jax_cls().get_params()) | {"device"}
        assert list(params)[-1] == "device"
        assert params["device"] == "cuda"
    X = _counts()
    with pytest.raises(ValueError, match="layout"):
        PortDistributed(layout="bogus", device="cpu").fit(X)
    with pytest.raises(ValueError, match="sparse"):
        PortBlock(backend="sparse", device="cpu").fit(X)
    with pytest.raises(ValueError, match="does not run"):
        PortBlock(backend="cuda", device="cpu").fit(X)
    with pytest.raises(AttributeError):
        PortBlock(device="cpu").transform(X)
    with pytest.raises(ValueError, match="device count"):
        port_mesh.make_mesh(3, 2, devices=[CPU] * 8)
    if not torch.cuda.is_available():
        for model in (enstop_torch.BlockParallelPLSA(n_components=3),
                      enstop_torch.DistributedPLSA(n_components=3, layout="sparse"),
                      enstop_torch.EnsembleTopics(n_components=3, parallelism="sharded")):
            with pytest.raises(RuntimeError, match="cuda"):
                model.fit(X)


# -- the sharded ensemble ---------------------------------------------------

RUN_KW = dict(n_runs=4, n_iter=20, random_state=0, e_step_thresh=1e-32)


def _ens_corpus():
    X, _ = synthetic_corpus(
        n_docs=240, n_words=320, n_topics=K, tokens_per_doc=150, doc_topic_alpha=0.02, seed=3)
    r = np.random.RandomState(8)
    return X.astype(np.float32), (r.rand(X.shape[0], K), r.rand(K, X.shape[1]))


def _spy_weights(module, monkeypatch, port):
    """Record each run's document weights as the sharded runs receive them."""
    seen = []
    real = module.build_ensemble_runs_sharded

    def spy(*args, **kwargs):
        run = real(*args, **kwargs)
        if port:
            def recorded(prepared, n_runs, inputs, *rest):
                seen.extend(inputs(i, CPU)[2].numpy() for i in range(n_runs))
                return run(prepared, n_runs, inputs, *rest)
        else:
            def recorded(Xs, zds, wzs, ws, *rest):
                seen.extend(np.asarray(ws))
                return run(Xs, zds, wzs, ws, *rest)
        return recorded

    monkeypatch.setattr(module, "build_ensemble_runs_sharded", spy)
    return seen


@pytest.mark.parametrize("injected", [True, False], ids=["factor_tuple", "random"])
def test_sharded_stack_and_weights_match_jax(monkeypatch, injected):
    X, init = _ens_corpus()
    init = init if injected else "random"
    jax_w = _spy_weights(jax_mesh, monkeypatch, port=False)
    port_w = _spy_weights(port_mesh, monkeypatch, port=True)
    want = jax_ens.ensemble_of_topics(X, K, init=init, parallelism="sharded", backend="xla",
                                      **RUN_KW)
    got = enstop_torch.ensemble_of_topics(X, K, init=init, parallelism="sharded",
                                          device="cpu", devices=[CPU] * 4, **RUN_KW)
    assert len(port_w) == len(jax_w) == 4
    for a, b in zip(port_w, jax_w):
        np.testing.assert_array_equal(a, b)
    assert got.shape == want.shape == (4 * K, X.shape[1])
    if injected:  # a random init is another random stream on each side
        np.testing.assert_allclose(got, np.asarray(want), **FACTOR_TOL)
    np.testing.assert_allclose(got.sum(1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("init", ["random", "factor_tuple"])
def test_sharded_stack_is_the_same_at_any_shard_count(init):
    X, factors = _ens_corpus()
    init = factors if init == "factor_tuple" else init
    calls = dict(port_em.CALLS)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # one shard warns
        stacks = [enstop_torch.ensemble_of_topics(X, K, init=init, parallelism="sharded",
                                                  device="cpu", devices=[CPU] * s, **RUN_KW)
                  for s in (1, 2, 4)]
    assert port_em.CALLS["em"] - calls["em"] == 3 * 4 * 20
    for stack in stacks[1:]:
        np.testing.assert_array_equal(stack, stacks[0])
    if init is factors:  # the same runs as the weights fan-out's, whose draws agree
        np.testing.assert_array_equal(stacks[0], enstop_torch.ensemble_of_topics(
            X, K, init=init, parallelism="weights", device="cpu", **RUN_KW))


def test_sharded_estimator_matches_jax():
    X, init = _ens_corpus()
    kw = dict(n_components=K, n_starts=8, n_iter=20, random_state=0, init=init,
              topic_combination="hellinger")

    class Port(enstop_torch.EnsembleTopics):
        def _devices(self):
            return [CPU] * 4

    port = Port(device="cpu", **kw)  # "auto": 8 runs divide over 4 devices
    emb = port.fit_transform(X)
    ref = enstop_tpu.EnsembleTopics(backend="xla", parallelism="sharded", **kw).fit(X)
    assert port.n_components_ == ref.n_components_ == K
    cost = np.abs(port.components_[:, None] - ref.components_[None]).max(-1)
    order = cost.argmin(1)
    assert sorted(order) == list(range(K))
    np.testing.assert_allclose(port.components_, ref.components_[order], rtol=0, atol=1e-5)
    np.testing.assert_allclose(emb, ref.embedding_[:, order], rtol=0, atol=1e-4)


@pytest.mark.parametrize("n_runs,n_devices,want", [
    (16, 1, "weights"), (16, 8, "sharded"), (1, 8, "weights"), (11, 8, "weights"),
    (5, 4, "weights"), (6, 4, "sharded"), (8, 8, "sharded")])
def test_auto_routes_by_topology_as_in_jax(monkeypatch, n_runs, n_devices, want):
    monkeypatch.setattr(jax_ens, "_n_devices", lambda: n_devices)
    assert jax_ens.resolve_parallelism("auto", n_runs=n_runs) == want
    assert port_ens.resolve_parallelism("auto", n_runs=n_runs,
                                        devices=[CPU] * n_devices) == want
    assert port_ens.resolve_parallelism("auto", model="nmf", devices=[CPU] * n_devices) == \
        "resample"
    assert port_ens.resolve_parallelism("auto", backend="sparse", n_runs=n_runs,
                                        devices=[CPU] * n_devices) == "weights"


def test_sharded_takes_a_prepared_corpus():
    X, init = _ens_corpus()
    prep = enstop_torch.prepare_counts(X, standardize=False, device="cpu")
    kw = dict(init=init, n_starts=4, n_iter=20, random_state=0, topic_combination="hellinger",
              devices=[CPU] * 2)
    emb_p, topics_p = enstop_torch.ensemble_fit(prep, K, parallelism="sharded", **kw)
    emb, topics = enstop_torch.ensemble_fit(X, K, parallelism="sharded", device="cpu", **kw)
    np.testing.assert_array_equal(topics_p, topics)
    np.testing.assert_array_equal(emb_p, emb)
    with pytest.raises(ValueError, match="Prepared"):
        enstop_torch.ensemble_fit(prep, K, parallelism="resample")
