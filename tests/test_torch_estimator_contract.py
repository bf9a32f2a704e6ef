"""The port's estimators under scikit-learn's estimator contract, on the CPU.

The counterpart of ``tests/test_estimator_contract.py``:

* scikit-learn's check battery (``parametrize_with_checks``, one case a
  check) over every port estimator. The checks that fail are exactly those
  that fail for the JAX package, for its reasons: the two sample-weight
  equivalence checks for the pLSA classes, the eight ``sample_weight`` checks
  for the ensembles. Each of them is asserted to fail so, every other check
  to pass.
* the JAX file's other tests: parameters and ``clone``, the fit_transform
  contract, the metrics, negative input, the feature count.
* the input rules side by side: every input below goes through the JAX
  estimator (``backend="xla"``) and the port's (``device="cpu"``), ``fit``
  and ``transform``. Both raise the same exception type with the same first
  line of message, or both fit to the same shapes, the pLSA embeddings
  within ``FACTOR_TOL`` (``tests/test_torch_plsa.py``'s tolerance against
  ``backend="xla"``). The ensembles draw their inits from JAX's PRNG on one
  side and numpy on the other, so only their shapes are compared with JAX;
  the port's own fit of such an input is then held bit for bit to its fit of
  the same counts in a plain dtype.
* scikit-learn's metadata routing side by side: ``get_metadata_routing()``
  serialises as JAX's before and after each ``set_*_request``; the request
  methods raise JAX's errors, with routing disabled and on a misspelt key;
  a ``Pipeline`` that routes ``sample_weight`` gives the port's direct
  weighted fit bit for bit and JAX's routed fit within ``FACTOR_TOL`` (the
  ensembles raise JAX's ``TypeError``); and the battery above runs again with
  routing enabled.
* the port without scikit-learn: a subprocess in which ``import sklearn``
  fails fits, transforms, saves and loads; there the routing methods and the
  loader's scikit-learn source raise ``RuntimeError``.
"""

import pathlib
import pickle
import subprocess
import sys
import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import sklearn
import torch
from sklearn.base import clone
from sklearn.pipeline import Pipeline
from sklearn.utils import get_tags
from sklearn.utils.estimator_checks import parametrize_with_checks

import enstop_torch
import enstop_tpu
from conftest import make_corpus
from enstop_torch.models.base import check_array, validate_corpus

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FACTOR_TOL = dict(rtol=5e-4, atol=1e-5)
CPU = torch.device("cpu")


class MeshBlock(enstop_torch.BlockParallelPLSA):
    """The JAX mesh's 8 devices, as 8 tiles on the CPU."""

    def _devices(self):
        return [CPU] * 8


class MeshDistributed(enstop_torch.DistributedPLSA):
    def _devices(self):
        return [CPU] * 8


# -- scikit-learn's check battery ---------------------------------------------

BATTERY = [
    enstop_torch.PLSA(n_components=3, n_iter=5, random_state=0, device="cpu"),
    enstop_torch.StreamedPLSA(n_components=3, n_iter=5, random_state=0, block_size=16,
                              device="cpu"),
    enstop_torch.BlockParallelPLSA(n_components=3, n_iter=5, random_state=0, device="cpu"),
    enstop_torch.DistributedPLSA(n_components=3, n_iter=5, random_state=0, device="cpu"),
    enstop_torch.GPUPLSA(n_components=3, n_iter=5, random_state=0, backend="torch",
                         device="cpu"),
    enstop_torch.EnsembleTopics(n_components=2, n_starts=2, n_iter=5, random_state=0,
                                parallelism="weights", device="cpu"),
    enstop_torch.EnsembleTopics(n_components=2, n_starts=2, n_iter=5, random_state=0,
                                model="nmf", device="cpu"),
]

# the JAX package's expected failures and reasons (tests/test_estimator_contract.py,
# enstop_tpu/models/ensemble.py's fit_transform)
PLSA_EXPECTED = {
    # the reference applies sample_weight to the P(w|z) M-step only, and
    # transform is a stochastic frozen-topic refit: repeating a row is not
    # the same model as weighting it
    f"check_sample_weight_equivalence_on_{kind}_data":
        (AssertionError, "Comparing the output of")
    for kind in ("dense", "sparse")
}
# the reference's ensemble has no weighted path; JAX raises rather than
# return an unweighted fit
ENSEMBLE_EXPECTED = {
    name: (TypeError, "does not support sample_weight")
    for name in ("check_sample_weights_pandas_series", "check_sample_weights_not_an_array",
                 "check_sample_weights_list", "check_all_zero_sample_weights_error",
                 "check_sample_weights_shape", "check_sample_weights_not_overwritten",
                 "check_sample_weight_equivalence_on_dense_data",
                 "check_sample_weight_equivalence_on_sparse_data")
}


def _run_check(estimator, check):
    name = getattr(check, "func", check).__name__
    expected = (ENSEMBLE_EXPECTED if isinstance(estimator, enstop_torch.EnsembleTopics)
                else PLSA_EXPECTED).get(name)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if expected is None:
            check(estimator)
        else:
            with pytest.raises(expected[0], match=expected[1]):
                check(estimator)


@parametrize_with_checks(BATTERY)
def test_sklearn_check_battery(estimator, check):
    _run_check(estimator, check)


@parametrize_with_checks(BATTERY)
def test_sklearn_check_battery_with_routing(estimator, check):
    """The battery with metadata routing enabled, where the JAX estimators
    fail the same checks as without it."""
    with sklearn.config_context(enable_metadata_routing=True):
        _run_check(estimator, check)


def test_tags_are_jax_tags():
    """``get_tags`` gives the JAX estimators' tags for every port class."""
    pairs = [(enstop_torch.PLSA(), enstop_tpu.PLSA()),
             (enstop_torch.StreamedPLSA(), enstop_tpu.StreamedPLSA()),
             (enstop_torch.BlockParallelPLSA(), enstop_tpu.BlockParallelPLSA()),
             (enstop_torch.DistributedPLSA(), enstop_tpu.DistributedPLSA()),
             (enstop_torch.GPUPLSA(), enstop_tpu.TPUPLSA()),
             (enstop_torch.EnsembleTopics(), enstop_tpu.EnsembleTopics())]
    for port, ref in pairs:
        assert get_tags(port) == get_tags(ref)


# -- the JAX file's other tests -----------------------------------------------

CLASSES = [enstop_torch.PLSA, enstop_torch.StreamedPLSA, enstop_torch.BlockParallelPLSA,
           enstop_torch.DistributedPLSA, enstop_torch.GPUPLSA, enstop_torch.EnsembleTopics]


def _fast_params(cls):
    p = {"n_components": 3, "n_iter": 8, "random_state": 0, "device": "cpu"}
    if cls is enstop_torch.EnsembleTopics:
        p.update(n_starts=4, min_samples=2, min_cluster_size=3, parallelism="weights")
    if cls is enstop_torch.GPUPLSA:
        p["backend"] = "torch"
    return p


@pytest.fixture(scope="module")
def corpus():
    return sp.csr_matrix(make_corpus(np.random.RandomState(0), n_docs=50, n_words=60))


@pytest.mark.parametrize("cls", CLASSES, ids=lambda c: c.__name__)
def test_get_set_params_and_clone(cls):
    model = cls(**_fast_params(cls))
    params = model.get_params()
    assert params["n_components"] == 3
    cloned = clone(model)
    assert cloned.get_params() == params and cloned is not model
    model.set_params(n_iter=5)
    assert model.get_params()["n_iter"] == 5
    with pytest.raises(ValueError, match="Invalid parameter"):
        model.set_params(no_such_parameter=1)


@pytest.mark.parametrize("cls", CLASSES, ids=lambda c: c.__name__)
def test_fit_transform_contract(cls, corpus):
    model = cls(**_fast_params(cls))
    emb = model.fit_transform(corpus)
    k_fit = getattr(model, "n_components_", model.n_components)
    assert emb.shape == (corpus.shape[0], k_fit)
    assert model.components_.shape == (k_fit, corpus.shape[1])
    assert model.embedding_ is emb or np.array_equal(model.embedding_, emb)
    assert model.training_data_ is not None
    assert model.transform(corpus[:7]).shape == (7, k_fit)
    assert isinstance(cls(**_fast_params(cls)).fit(corpus), cls)


@pytest.mark.parametrize("cls", CLASSES, ids=lambda c: c.__name__)
def test_metrics_available(cls, corpus):
    model = cls(**_fast_params(cls)).fit(corpus)
    assert np.isfinite(model.coherence(n_words=5))
    assert np.isfinite(model.log_lift(n_words=5))


@pytest.mark.parametrize("cls_kw", [
    ("StreamedPLSA", dict(n_components=3, n_iter=5, block_size=16)),
    ("EnsembleTopics", dict(n_components=2, n_starts=2, n_iter=5, parallelism="weights")),
    ("BlockParallelPLSA", dict(n_components=3, n_iter=5)),
    ("PLSA", dict(n_components=3, n_iter=5)),
])
def test_estimators_reject_negative_input(cls_kw):
    name, kw = cls_kw
    X = np.random.RandomState(0).poisson(1.0, (30, 12)).astype(float)
    X[3, 4] = -1.0
    with pytest.raises(ValueError, match="non-negative"):
        getattr(enstop_torch, name)(random_state=0, device="cpu", **kw).fit(X)


@pytest.mark.parametrize("cls_kw", [
    ("PLSA", dict(n_components=3, n_iter=5)),
    ("StreamedPLSA", dict(n_components=3, n_iter=5, block_size=16)),
    ("EnsembleTopics", dict(n_components=2, n_starts=2, n_iter=5, parallelism="weights")),
    ("BlockParallelPLSA", dict(n_components=3, n_iter=5)),
])
def test_transform_checks_feature_count(cls_kw):
    name, kw = cls_kw
    X = np.random.RandomState(0).poisson(1.0, (40, 12)).astype(np.int64)
    m = getattr(enstop_torch, name)(random_state=0, device="cpu", **kw).fit(X)
    assert m.n_features_in_ == 12
    with pytest.raises(ValueError, match="features"):
        m.transform(X[:, :8])


@pytest.mark.parametrize("cls", CLASSES[:5], ids=lambda c: c.__name__)
def test_fit_positional_sample_weight(cls, corpus):
    """The reference's ``fit(self, X, y=None, sample_weight=None)``."""
    model = cls(**_fast_params(cls)).fit(corpus, None, np.ones(corpus.shape[0]))
    assert model.components_.shape[0] == 3


def test_all_zero_sample_weights_raise(corpus):
    with pytest.raises(ValueError, match="weights"):
        enstop_torch.PLSA(n_components=3, n_iter=5, device="cpu").fit(
            corpus, sample_weight=np.zeros(corpus.shape[0]))


# -- the input rules, side by side with JAX -----------------------------------

ESTIMATORS = {  # name: (JAX estimator, port estimator)
    "PLSA": (lambda **kw: enstop_tpu.PLSA(backend="xla", precision="highest", **kw),
             lambda **kw: enstop_torch.PLSA(device="cpu", **kw)),
    "StreamedPLSA": (lambda **kw: enstop_tpu.StreamedPLSA(block_size=16, **kw),
                     lambda **kw: enstop_torch.StreamedPLSA(block_size=16, device="cpu", **kw)),
    "BlockParallelPLSA": (lambda **kw: enstop_tpu.BlockParallelPLSA(backend="xla", **kw),
                          lambda **kw: MeshBlock(device="cpu", **kw)),
    "DistributedPLSA": (lambda **kw: enstop_tpu.DistributedPLSA(backend="xla", **kw),
                        lambda **kw: MeshDistributed(device="cpu", **kw)),
    "GPUPLSA": (lambda **kw: enstop_tpu.TPUPLSA(backend="xla", precision="highest", **kw),
                lambda **kw: enstop_torch.GPUPLSA(backend="torch", device="cpu", **kw)),
    "EnsembleTopics": (
        lambda **kw: enstop_tpu.EnsembleTopics(n_starts=2, parallelism="weights", **kw),
        lambda **kw: enstop_torch.EnsembleTopics(n_starts=2, parallelism="weights",
                                                 device="cpu", **kw)),
    "EnsembleTopics-nmf": (
        lambda **kw: enstop_tpu.EnsembleTopics(n_starts=2, model="nmf", **kw),
        lambda **kw: enstop_torch.EnsembleTopics(n_starts=2, model="nmf", device="cpu",
                                                 **kw)),
}
EST_KW = dict(n_components=3, n_iter=5, random_state=0)


def _counts():
    C = np.random.RandomState(0).poisson(0.5, (60, 40)).astype(np.int64)
    C[C.sum(1) == 0, 0] = 1
    return C


def _read_only_memmap(C, directory):
    path = directory / "counts.npy"
    out = np.lib.format.open_memmap(path, mode="w+", dtype=C.dtype, shape=C.shape)
    out[:] = C
    out.flush()
    return np.load(path, mmap_mode="r")


def _inputs(directory):
    """``name: (input, the same counts in a plain dtype, or None)``: the rows of
    the fault table in ROADMAP.md's Queue 3 and the further inputs JAX's
    ``check_array`` rules on."""
    C = _counts()
    with_nan, with_inf = C.astype(np.float64), C.astype(np.float64)
    with_nan[3, 4], with_inf[5, 6] = np.nan, np.inf
    return {
        "int64": (C, None),
        "bool": (C > 0, (C > 0).astype(np.uint8)),
        "bool_csr": (sp.csr_matrix(C > 0), (C > 0).astype(np.uint8)),
        "object": (C.astype(object), C.astype(np.float64)),
        "object_strings": (np.full(C.shape, "a", dtype=object), None),
        "strings": (np.full(C.shape, "a"), None),
        "complex": (C + 1j * C, None),
        "complex_csr": (sp.csr_matrix(C + 1j * C), None),
        "zero_features": (np.zeros((10, 0)), None),
        "zero_samples": (np.zeros((0, C.shape[1])), None),
        "1d": (C[0], None),
        "scalar": (np.float64(3.0), None),
        "3d": (C[None], None),
        "nan": (with_nan, None),
        "inf": (with_inf, None),
        "np_matrix": (np.matrix(C), None),
        "int8": (C.astype(np.int8), C),
        "uint8": (C.astype(np.uint8), C),
        "float16": (C.astype(np.float16), None),
        "float32": (C.astype(np.float32), None),
        "csc": (sp.csc_matrix(C), C),
        "coo": (sp.coo_matrix(C), C),
        "csr_array": (sp.csr_array(C), C),
        "memmap_read_only": (_read_only_memmap(C, directory), C),
    }


INPUT_NAMES = [
    "int64", "bool", "bool_csr", "object", "object_strings", "strings", "complex",
    "complex_csr", "zero_features", "zero_samples", "1d", "scalar", "3d", "nan", "inf",
    "np_matrix", "int8", "uint8", "float16", "float32", "csc", "coo", "csr_array",
    "memmap_read_only"]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    made = _inputs(tmp_path_factory.mktemp("memmap"))
    assert list(made) == INPUT_NAMES
    return made


@pytest.fixture(scope="module")
def fitted():
    """Each estimator pair fitted on the int64 counts, for ``transform``."""
    cache = {}

    def get(name):
        if name not in cache:
            make_ref, make_port = ESTIMATORS[name]
            cache[name] = (make_ref(**EST_KW).fit(_counts()),
                           make_port(**EST_KW).fit(_counts()))
        return cache[name]
    return get


def _outcome(call):
    """``("ok", result)`` or ``("raised", exception)``."""
    try:
        return "ok", call()
    except Exception as err:  # the outcome is what is compared
        return "raised", err


def _assert_same_outcome(ref, port, what):
    assert ref[0] == port[0], (what, ref, port)
    if ref[0] == "raised":
        assert type(port[1]) is type(ref[1]), (what, ref[1], port[1])
        assert str(port[1]).splitlines()[0] == str(ref[1]).splitlines()[0], what
        return
    assert np.shape(port[1]) == np.shape(ref[1]), what


@pytest.mark.parametrize("input_name", INPUT_NAMES)
@pytest.mark.parametrize("est", list(ESTIMATORS))
def test_input_rules_match_jax(est, input_name, inputs, fitted):
    X, plain = inputs[input_name]
    make_ref, make_port = ESTIMATORS[est]
    ensemble = est.startswith("Ensemble")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = _outcome(lambda: make_ref(**EST_KW).fit_transform(X))
        port = _outcome(lambda: make_port(**EST_KW).fit_transform(X))
        _assert_same_outcome(ref, port, "fit_transform")
        ref_model, port_model = fitted(est)
        ref_t = _outcome(lambda: ref_model.transform(X))
        port_t = _outcome(lambda: port_model.transform(X))
        _assert_same_outcome(ref_t, port_t, "transform")
        if port[0] == "ok" and not ensemble:
            np.testing.assert_allclose(port[1], ref[1], **FACTOR_TOL)
            np.testing.assert_allclose(port_t[1], ref_t[1], **FACTOR_TOL)
        if port[0] == "ok" and plain is not None:
            np.testing.assert_array_equal(port[1], make_port(**EST_KW).fit_transform(plain))
            np.testing.assert_array_equal(port_t[1], port_model.transform(plain))


@pytest.mark.parametrize("est", list(ESTIMATORS))
def test_fit_params_match_jax(est):
    """``fit(X, extra=1)``: the ensembles take ``**fit_params`` and the pLSA
    classes raise ``TypeError``; ``fit(X, sample_weight=w)``: the other way
    round. The same outcome as JAX's."""
    make_ref, make_port = ESTIMATORS[est]
    C = _counts()
    for kwargs in ({"extra": 1}, {"sample_weight": np.ones(C.shape[0])}):
        ref = _outcome(lambda: make_ref(**EST_KW).fit(C, **kwargs).embedding_)
        port = _outcome(lambda: make_port(**EST_KW).fit(C, **kwargs).embedding_)
        assert ref[0] == port[0], (kwargs, ref, port)
        if ref[0] == "raised":
            assert type(port[1]) is type(ref[1]) is TypeError
        else:
            assert port[1].shape == ref[1].shape
    ensemble = est.startswith("Ensemble")
    assert (ref[0] == "raised") == ensemble


def test_object_counts_fit_the_normalized_corpus():
    """An object array of integer counts is cast to float64, which is l1-row
    normalized as every float input is, in both packages; bool stays counts."""
    C = _counts()
    X, _ = validate_corpus(C.astype(object))
    assert X.dtype == np.float64
    np.testing.assert_allclose(np.asarray(X.sum(axis=1)).ravel(), 1.0)
    Xb, _ = validate_corpus(C > 0)
    assert Xb.dtype == np.bool_ and Xb.nnz == np.count_nonzero(C)
    assert check_array(C.astype(object)).dtype == np.float64
    assert check_array(C, dtype=np.float32).dtype == np.float32


def test_check_array_copies_only_when_it_converts():
    C = _counts()
    assert check_array(C) is C
    Xs = sp.csr_matrix(C)
    assert np.shares_memory(check_array(Xs).data, Xs.data)
    assert not np.shares_memory(check_array(C.astype(object)), C)


@pytest.mark.parametrize("est", ["StreamedPLSA", "PLSA", "EnsembleTopics"])
def test_zero_features_fail_in_validation(est, monkeypatch):
    """A 10 x 0 matrix raises in the input check, before any fit code runs
    (``StreamedPLSA`` used to fail inside ``torch.cat``)."""
    def no_cat(*args, **kwargs):
        raise AssertionError("torch.cat reached")

    monkeypatch.setattr(torch, "cat", no_cat)
    with pytest.raises(ValueError, match=r"Found array with 0 feature\(s\)"):
        ESTIMATORS[est][1](**EST_KW).fit(np.zeros((10, 0)))


# -- scikit-learn's metadata routing, side by side with JAX -------------------


def _serialized(model):
    return model.get_metadata_routing()._serialize()


def _request_methods(model):
    return [name for name in dir(model) if name.startswith("set_") and name.endswith("_request")
            and hasattr(model, name)]


@pytest.mark.parametrize("est", list(ESTIMATORS))
def test_metadata_routing_matches_jax(est):
    """The same requests serialise the same before and after each
    ``set_*_request``, which returns the estimator; ``clone`` and pickling
    keep them and ``get_params`` does not hold them."""
    make_ref, make_port = ESTIMATORS[est]
    ref, port = make_ref(**EST_KW), make_port(**EST_KW)
    assert _request_methods(port) == _request_methods(ref) == (
        ["set_fit_request", "set_transform_request"] if est == "StreamedPLSA"
        else ["set_fit_request"])
    with sklearn.config_context(enable_metadata_routing=True):
        assert type(port.get_metadata_routing()) is type(ref.get_metadata_routing())
        assert _serialized(port) == _serialized(ref)
        for method in [name[4:-8] for name in _request_methods(ref)]:
            for value in (True, "w", False, None):
                for model in (ref, port):
                    assert getattr(model, f"set_{method}_request")(sample_weight=value) is model
                assert _serialized(port) == _serialized(ref), (method, value)
            for model in (ref, port):
                getattr(model, f"set_{method}_request")(sample_weight="w")
        assert _serialized(port) == _serialized(ref)
        for call in (lambda model: model.set_fit_request(sampel_weight=True),
                     lambda model: model.set_fit_request(True)):
            ref_err, port_err = _outcome(lambda: call(ref)), _outcome(lambda: call(port))
            assert ref_err[0] == "raised"
            _assert_same_outcome(ref_err, port_err, "set_fit_request")
        assert _serialized(clone(port)) == _serialized(ref)
        assert _serialized(pickle.loads(pickle.dumps(port))) == _serialized(ref)
        assert "_metadata_request" not in port.get_params()


@pytest.mark.parametrize("est", list(ESTIMATORS))
def test_request_methods_refuse_without_routing(est):
    """With routing disabled every ``set_*_request`` raises JAX's
    ``RuntimeError`` with its message."""
    make_ref, make_port = ESTIMATORS[est]
    ref, port = make_ref(**EST_KW), make_port(**EST_KW)
    with sklearn.config_context(enable_metadata_routing=False):
        for name in _request_methods(ref):
            ref_err = _outcome(lambda: getattr(ref, name)(sample_weight=True))
            port_err = _outcome(lambda: getattr(port, name)(sample_weight=True))
            assert ref_err[0] == port_err[0] == "raised"
            assert type(port_err[1]) is type(ref_err[1]) is RuntimeError
            assert str(port_err[1]) == str(ref_err[1])


@pytest.mark.parametrize("est", list(ESTIMATORS))
def test_pipeline_routes_sample_weight(est, tmp_path):
    """``Pipeline.fit_transform(X, sample_weight=w)`` with the weights
    requested: the pLSA estimators give the port's direct ``fit(X,
    sample_weight=w)`` bit for bit and JAX's routed fit within
    ``FACTOR_TOL``, and a fitted model with requests saves and loads; the
    ensembles raise JAX's ``TypeError``."""
    make_ref, make_port = ESTIMATORS[est]
    C = _counts()
    w = np.random.RandomState(3).uniform(0.5, 2.0, C.shape[0])

    def routed(make):
        model = make(**EST_KW).set_fit_request(sample_weight=True)
        if hasattr(model, "set_transform_request"):
            model.set_transform_request(sample_weight=True)
        return _outcome(lambda: (Pipeline([("topics", model)]).fit_transform(
            C, sample_weight=w), model))

    with sklearn.config_context(enable_metadata_routing=True):
        ref, port = routed(make_ref), routed(make_port)
    assert ref[0] == port[0]
    if ref[0] == "raised":
        assert est.startswith("Ensemble")
        assert type(port[1]) is type(ref[1]) is TypeError
        assert str(port[1]) == str(ref[1])
        return
    (embedding, model), (_, ref_model) = port[1], ref[1]
    direct = make_port(**EST_KW).fit(C, sample_weight=w)
    np.testing.assert_array_equal(embedding, direct.embedding_)
    np.testing.assert_array_equal(model.components_, direct.components_)
    np.testing.assert_allclose(model.embedding_, ref_model.embedding_, **FACTOR_TOL)
    np.testing.assert_allclose(model.components_, ref_model.components_, **FACTOR_TOL)
    model.save(tmp_path / "routed.npz")
    loaded = type(model).load(tmp_path / "routed.npz")
    np.testing.assert_array_equal(loaded.components_, model.components_)


# -- the port without scikit-learn --------------------------------------------

NO_SKLEARN = """
import sys
sys.modules["sklearn"] = None  # any import of scikit-learn now fails
import numpy as np, scipy.sparse as sp
import enstop_torch
import enstop_torch.datasets
from enstop_torch.models.base import TopicModelBase
try:
    import sklearn
    raise SystemExit("sklearn imported")
except ImportError:
    pass
C = sp.csr_matrix(np.random.RandomState(0).poisson(0.8, (60, 50)))
for model in (enstop_torch.PLSA(n_components=3, n_iter=10, random_state=0, device="cpu"),
              enstop_torch.EnsembleTopics(n_components=3, n_starts=2, n_iter=10,
                                          random_state=0, parallelism="weights",
                                          device="cpu")):
    emb = model.fit_transform(C)
    model.fit(C > 0)
    assert model.transform(C[:7]).shape == (7, model.components_.shape[0])
    params = model.get_params()
    model.set_params(n_iter=12)
    assert model.get_params()["n_iter"] == 12
    path = sys.argv[1] + "/" + type(model).__name__ + ".npz"
    model.save(path)
    loaded = TopicModelBase.load(path)
    assert type(loaded) is type(model)
    assert np.array_equal(loaded.components_, model.components_)
    assert loaded.transform(C[:7]).shape == (7, model.components_.shape[0])
    try:
        model.__sklearn_tags__()
        raise SystemExit("tags without scikit-learn")
    except RuntimeError as err:
        assert "scikit-learn is not loaded" in str(err)
    for call in (model.get_metadata_routing, lambda: model.set_fit_request(sample_weight=True)):
        try:
            call()
            raise SystemExit("metadata routing without scikit-learn")
        except RuntimeError as err:
            assert "scikit-learn is not loaded" in str(err)
    try:
        model.fit(np.zeros((10, 0)))
        raise SystemExit("a 10 x 0 matrix fitted")
    except ValueError:
        pass
try:
    enstop_torch.datasets.load_20newsgroups_counts(data_home=sys.argv[1])
    raise SystemExit("20-Newsgroups loaded without a source")
except RuntimeError:
    pass
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "enstop_tpu")
             or (m.startswith("sklearn") and sys.modules[m] is not None))
print(bad)
"""


def test_port_runs_without_sklearn(tmp_path):
    """The card's machine has no scikit-learn: there ``import enstop_torch``,
    fit, transform, ``get_params``/``set_params``, save and load work for
    ``PLSA`` and ``EnsembleTopics``, and ``__sklearn_tags__``, the routing
    methods and the 20-Newsgroups loader's scikit-learn source say why they
    cannot answer."""
    out = subprocess.run([sys.executable, "-S", "-c", NO_SKLEARN, str(tmp_path)], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={"PYTHONPATH": ":".join(sys.path)})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "[]"
