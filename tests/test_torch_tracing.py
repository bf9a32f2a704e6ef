"""The spans and counters of ``enstop_torch.profiling`` inside a fit.

On the CPU: each fit's record (``fit_info_["trace"]``) holds the spans of
its path in order, each child inside its parent, one ``id`` a fit;
``wall_time_s`` is the ``loop`` span's length; ``stage.copy`` carries the
corpus's bytes; ``host_syncs`` counts the schedule's waits exactly; nothing
is left open after a fit; the spans reach a ``torch.profiler`` export as
``enstop.*`` ranges; :func:`~enstop_torch.profiling.idle_by_span` puts a
made-up trace's idle time down to the innermost range; ``StepTimer``
sections and ``ensemble_fit``'s stages are spans; an ensemble fit keeps its
record (``fit_info_["trace"]``: ``validate``, ``staging``, ``runs``,
``combine`` with its four stages, ``refit``) and counts its runs, their EM
steps and its stable topics.

On the card (marked ``cuda``; ``python -m pytest tests/test_torch_tracing.py
-q --noconftest -m cuda``): ``host_syncs`` equals the synchronisations that
``torch.cuda.set_sync_debug_mode("warn")`` reports over a fit, dense and
sparse, with the host's init and with the init drawn on the card, and over an
ensemble call. This file imports no JAX.
"""

import json
import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import enstop_torch
from enstop_torch import profiling
from enstop_torch.models import ensemble
from enstop_torch.ops import init as init_ops

SCHEDULE = dict(n_iter=100, n_iter_per_test=10, tolerance=0.0)
STAGED = ["stage", *["stage.copy"] * 3, "stage.coo", "stage.layout"]
# 100 steps, a test every 10: 11 log-likelihoods read back, and the two
# factors copied up and read back; the corpus's indptr, indices and data copied
# up (3) and the canonical check's flag read back; each side of the layout
# reads back 6 (bincount's 2, the index bounds, the segment count, the end
# offset copied up); the dense path copies the document weights up
HOST_SYNCS = {("dense", "raw"): 26, ("sparse", "raw"): 31, ("dense", "prepared"): 16,
              ("sparse", "prepared"): 15}


def _corpus(seed=0, n=60, m=90):
    X = np.random.RandomState(seed).poisson(0.6, (n, m)).astype(np.int64)
    X[:, 0] += 1  # no empty document
    return sp.csr_matrix(X)


def _fit(path, kind, X=None, **kw):
    X = _corpus() if X is None else X
    backend = "sparse" if path == "sparse" else "auto"
    if kind == "prepared":
        X = (enstop_torch.prepare_sell(X, device="cpu") if path == "sparse"
             else enstop_torch.prepare_counts(X, device="cpu"))
    model = enstop_torch.PLSA(n_components=4, random_state=0, backend=backend,
                              device="cpu", **SCHEDULE, **kw)
    return model.fit(X), X


CASES = [(p, k) for p in ("dense", "sparse") for k in ("raw", "prepared")]


@pytest.mark.parametrize("path,kind", CASES)
def test_a_fit_records_its_spans(path, kind):
    model, X = _fit(path, kind)
    record = model.fit_info_["trace"]
    spans = record["spans"]
    names = [s["name"] for s in spans]
    staged = STAGED if kind == "raw" else ["stage"]
    assert names == ["fit", "validate", *staged, "init", "loop", "readback", "finish"]
    assert spans[0]["parent"] is None and spans[0]["start"] == 0.0
    assert spans[0]["attrs"] == {"estimator": "PLSA", "backend": model.backend}
    by_name = {s["name"]: i for i, s in enumerate(spans)}
    for s in spans[1:]:
        parent = spans[s["parent"]]
        assert parent["start"] <= s["start"] <= s["end"] <= parent["end"], s
    assert spans[by_name["readback"]]["parent"] == by_name["loop"]
    if kind == "raw":
        copies = [s for s in spans if s["name"] == "stage.copy"]
        assert {s["parent"] for s in copies} == {names.index("stage")}
        assert sum(s["attrs"]["bytes"] for s in copies) == (
            X.indptr.nbytes + X.indices.nbytes + X.data.nbytes)
    loop = spans[by_name["loop"]]
    assert model.fit_info_["wall_time_s"] == loop["end"] - loop["start"]
    # the host drew the init: none of it on a card
    counters = {"host_syncs": HOST_SYNCS[path, kind], "device_init_values": 0}
    if kind == "raw":
        counters["coo_as_is"] = 1  # a canonical CSR ships as it stands
    assert record["counters"] == counters
    assert not profiling.is_open()


@pytest.mark.parametrize("path", ["dense", "sparse"])
def test_each_fit_is_a_request_of_its_own(path):
    first, _ = _fit(path, "raw")
    second, _ = _fit(path, "raw")
    assert isinstance(first.fit_info_["trace"]["id"], int)
    assert first.fit_info_["trace"]["id"] != second.fit_info_["trace"]["id"]
    # the same schedule counts the same waits, whatever the data
    other, _ = _fit(path, "raw", X=_corpus(seed=1))
    assert other.fit_info_["trace"]["counters"] == first.fit_info_["trace"]["counters"]


@pytest.mark.parametrize("path", ["dense", "sparse"])
def test_plsa_fit_is_a_request_unless_one_is_open(path):
    X = _corpus()
    backend = "sparse" if path == "sparse" else "auto"
    zd, wz, info = enstop_torch.plsa_fit(X, 4, return_info=True, backend=backend,
                                         device="cpu", **SCHEDULE)
    names = [s["name"] for s in info["trace"]["spans"]]
    assert names == ["fit", *STAGED, "init", "loop", "readback"]
    assert info["trace"]["counters"]["host_syncs"] == HOST_SYNCS[path, "raw"]
    assert zd.shape == (60, 4) and wz.shape == (4, 90)
    # inside a caller's request its spans join the caller's, and the record is the caller's
    with profiling.request("caller") as req:
        with profiling.span("work"):
            _, _, info = enstop_torch.plsa_fit(X, 4, return_info=True, backend=backend,
                                               device="cpu", **SCHEDULE)
    assert "trace" not in info
    names = [s["name"] for s in req.record["spans"]]
    assert names == ["caller", "work", *STAGED, "init", "loop", "readback"]
    parents = {s["parent"] for s in req.record["spans"] if s["name"] in ("stage", "init")}
    assert parents == {1}


@pytest.mark.parametrize("path", ["dense", "sparse"])
def test_a_canonical_corpus_ships_as_it_stands(path):
    model, _ = _fit(path, "raw")
    counters = model.fit_info_["trace"]["counters"]
    assert counters["coo_as_is"] == 1
    assert counters.get("coo_canonicalized", 0) == 0


@pytest.mark.parametrize("path", ["dense", "sparse"])
def test_a_corpus_with_duplicates_is_canonicalised_first(path):
    X = _corpus()
    half = X.data // 2  # each nonzero split in two entries in a row, the first maybe zero
    dup = sp.csr_matrix((np.stack([half, X.data - half], 1).ravel(), np.repeat(X.indices, 2),
                         2 * X.indptr), shape=X.shape)
    model, _ = _fit(path, "raw", X=dup)
    counters = model.fit_info_["trace"]["counters"]
    assert counters["coo_canonicalized"] == 1 and "coo_as_is" not in counters
    # the flag read back, then the canonical copy's three arrays copied up
    assert counters["host_syncs"] == HOST_SYNCS[path, "raw"] + 3
    names = [s["name"] for s in model.fit_info_["trace"]["spans"]]
    assert names[2:11] == ["stage", *["stage.copy"] * 3, "stage.coo", "stage.coo",
                           *["stage.copy"] * 3]
    canonical, _ = _fit(path, "raw")
    np.testing.assert_array_equal(model.embedding_, canonical.embedding_)
    np.testing.assert_array_equal(model.components_, canonical.components_)


def test_a_zero_row_is_put_back_in_finish():
    X = _corpus().tolil()
    X[7] = 0
    model, _ = _fit("dense", "raw", X=sp.csr_matrix(X))
    assert np.all(model.embedding_[7] == 0)
    assert model.fit_info_["trace"]["counters"]["host_syncs"] == HOST_SYNCS["dense", "raw"]


def test_no_state_is_left_behind():
    assert not profiling.is_open()
    with profiling.span("loose") as s:
        profiling.count("host_syncs")
    assert s.seconds is None  # no request, no profiler: nothing recorded
    with pytest.raises(RuntimeError):
        with profiling.request("failing") as req:
            with profiling.span("inner"):
                raise RuntimeError("boom")
    assert not profiling.is_open()
    assert [s["name"] for s in req.record["spans"]] == ["failing", "inner"]
    assert all(s["end"] is not None for s in req.record["spans"])
    # a request opened inside another is a root of its own; the outer resumes after it
    with profiling.request("outer") as outer:
        with profiling.request("inner") as inner:
            profiling.count("n", 2)
        profiling.count("n")
    assert inner.id != outer.id
    assert inner.record["counters"] == {"n": 2} and outer.record["counters"] == {"n": 1}
    assert not profiling.is_open()


def test_transform_and_fit_reach_the_profiler(tmp_path):
    model, X = _fit("dense", "raw")
    with profiling.trace(tmp_path) as prof:
        model.fit(X)
        model.transform(X[:5])
    assert prof is not None
    (path,) = tmp_path.glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    ranges = [e["name"] for e in events
              if e.get("cat") == "user_annotation" and e["name"].startswith("enstop.")]
    for name in ["fit", "validate", *STAGED, "init", "loop", "readback", "finish",
                 "transform"]:
        assert f"enstop.{name}" in ranges, name
    assert ranges.count("enstop.loop") == 2  # the fit's and the transform's
    # the spans of the traced fit were recorded as well
    assert [s["name"] for s in model.fit_info_["trace"]["spans"]][0] == "fit"
    idle = profiling.idle_by_span(path)  # no device here: the window is idle throughout
    assert idle["idle_s"] == pytest.approx(idle["window_s"])
    assert sum(idle["by_span"].values()) + idle["outside_s"] == pytest.approx(idle["idle_s"])
    assert idle["by_span"]["stage.layout"] > 0


def _event(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_idle_by_span_takes_the_innermost_range(tmp_path):
    events = [
        _event("user_annotation", "enstop.fit", 0, 100),
        _event("user_annotation", "enstop.stage", 10, 40),
        _event("user_annotation", "enstop.stage.copy", 20, 10),
        _event("user_annotation", "bench.window", 0, 120),  # not the program's
        _event("user_annotation", "enstop.empty", 55, 0),
        _event("kernel", "k", 25, 10),
        _event("gpu_memcpy", "Memcpy HtoD", 60, 20),
        _event("cuda_runtime", "cudaDeviceSynchronize", 85, 10),
        _event("cpu_op", "aten::to", 15, 30),
        _event("kernel", "k2", 110, 10),
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 5},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = profiling.idle_by_span(path)
    # busy 25-35, 60-80, 110-120 of 0-120
    assert got["window_s"] == pytest.approx(120e-6)
    assert got["idle_s"] == pytest.approx(80e-6)
    assert got["by_span"] == pytest.approx({"fit": 40e-6, "stage": 25e-6,
                                            "stage.copy": 5e-6})
    assert got["outside_s"] == pytest.approx(10e-6)
    empty = tmp_path / "e.json"
    empty.write_text(json.dumps({"traceEvents": []}))
    assert profiling.idle_by_span(empty) == {"window_s": 0.0, "idle_s": 0.0,
                                             "outside_s": 0.0, "by_span": {}}


def test_step_timer_sections_are_spans():
    timer = profiling.StepTimer()
    with profiling.request("timed") as req:
        for _ in range(2):
            with timer.section("em"):
                with timer.section("ll"):
                    pass
    spans = req.record["spans"]
    assert [s["name"] for s in spans] == ["timed", "em", "ll", "em", "ll"]
    assert [s["parent"] for s in spans] == [None, 0, 1, 0, 3]
    report = timer.report()
    assert report["em"]["calls"] == 2 and report["ll"]["calls"] == 2
    assert report["em"]["total_s"] >= sum(s["end"] - s["start"] for s in spans
                                          if s["name"] == "ll")


def test_the_ensemble_stages_are_spans(tmp_path):
    X = _corpus(n=80, m=120)
    with profiling.trace(tmp_path):
        enstop_torch.EnsembleTopics(n_components=3, n_starts=3, random_state=0,
                                    parallelism="weights", device="cpu").fit(X)
    timings = ensemble.ensemble_fit.last_timings
    assert set(timings) == {"staging_s", "runs_s", "combine_s", "refit_s"}
    assert all(v > 0 for v in timings.values())
    (path,) = tmp_path.glob("*.pt.trace.json")
    ranges = {e["name"] for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation"}
    assert {"enstop.ensemble", "enstop.staging", "enstop.runs", "enstop.combine",
            "enstop.refit", "enstop.stage.copy"} <= ranges


ENSEMBLE_STAGES = ["validate", "staging", "runs", "combine", "refit"]
COMBINE_STAGES = ["combine.distances", "combine.layout", "combine.cluster", "combine.merge"]


@pytest.mark.parametrize("backend", ["auto", "sparse"])
def test_an_ensemble_fit_keeps_its_record(backend):
    model = enstop_torch.EnsembleTopics(n_components=3, n_starts=4, random_state=0,
                                        backend=backend, device="cpu").fit(
                                            _corpus(n=80, m=120))
    record = model.fit_info_["trace"]
    spans = record["spans"]
    assert spans[0]["name"] == "ensemble" and spans[0]["parent"] is None
    assert spans[0]["attrs"] == {"estimator": "EnsembleTopics", "model": "plsa",
                                 "backend": backend, "n_starts": 4}
    children = [s["name"] for s in spans if s["parent"] == 0]
    assert children == ENSEMBLE_STAGES
    combine = next(i for i, s in enumerate(spans) if s["name"] == "combine")
    assert [s["name"] for s in spans if s["parent"] == combine] == COMBINE_STAGES
    for s in spans[1:]:
        parent = spans[s["parent"]]
        assert parent["start"] <= s["start"] <= s["end"] <= parent["end"], s
    steps = model.fit_info_["run_steps"]
    assert len(steps) == 4 and all(1 <= n <= model.n_iter for n in steps)
    counters = record["counters"]
    assert counters["runs"] == 4 and counters["em_steps"] == sum(steps)
    assert model.fit_info_["n_steps"] == sum(steps)
    assert counters["stable_topics"] == model.n_components_
    assert counters["host_syncs"] > 0
    runs = next(s for s in spans if s["name"] == "runs")
    assert model.fit_info_["wall_time_s"] == runs["end"] - runs["start"]
    assert model.topic_stack_.shape == (4 * 3, 120)
    assert model.topic_layout_.shape == (12, 5) and model.topic_labels_.shape == (12,)
    assert not profiling.is_open()


def test_an_ensemble_fit_is_a_request_of_its_own():
    X = _corpus(n=80, m=120)
    fits = [enstop_torch.EnsembleTopics(n_components=3, n_starts=2, random_state=0,
                                        device="cpu").fit(X) for _ in range(2)]
    assert fits[0].fit_info_["trace"]["id"] != fits[1].fit_info_["trace"]["id"]
    assert (fits[0].fit_info_["trace"]["counters"]
            == fits[1].fit_info_["trace"]["counters"])
    # the function inside a caller's request adds its stages to the caller's
    with profiling.request("caller") as req:
        ensemble.ensemble_fit(X, 3, n_starts=2, random_state=0, device="cpu")
    assert [s["name"] for s in req.record["spans"] if s["parent"] == 0] == ENSEMBLE_STAGES[1:]


# -- on the card ----------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["cuda", "sparse"])
def test_host_syncs_are_the_sync_debug_modes(cuda, backend, monkeypatch):
    """The host's init (its draw held on the host here; the card's is the next
    test's)."""
    monkeypatch.setattr(init_ops, "DEVICE_DRAW_MIN", 10**12)
    X = _corpus(n=600, m=900)
    model = enstop_torch.PLSA(n_components=20, random_state=0, backend=backend,
                              **SCHEDULE)
    syncs, sites = _fit_syncs(model, X)
    counted = model.fit_info_["trace"]["counters"]["host_syncs"]
    assert len(syncs) == counted, sites
    assert counted == HOST_SYNCS["sparse" if backend == "sparse" else "dense", "raw"]


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["cuda", "sparse"])
def test_host_syncs_of_the_init_drawn_on_the_card(cuda, backend):
    """(600 + 900) 20 values: the init is drawn on the card, which waits once
    (the stream's state read back) where the host's init copies two factors."""
    X = _corpus(n=600, m=900)
    model = enstop_torch.PLSA(n_components=20, random_state=0, backend=backend,
                              **SCHEDULE)
    syncs, sites = _fit_syncs(model, X)
    counters = model.fit_info_["trace"]["counters"]
    assert len(syncs) == counters["host_syncs"], sites
    assert counters["host_syncs"] == HOST_SYNCS[
        "sparse" if backend == "sparse" else "dense", "raw"] - 1
    assert counters["device_init_values"] == (600 + 900) * 20


def _fit_syncs(model, X):
    """The synchronisations the sync debug mode reports over ``model.fit(X)``
    after a first fit has built the kernels, and their sites."""
    model.fit(X)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            model.fit(X)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "called a synchronizing" in str(w.message)]
    return syncs, sorted({(w.filename.rsplit("/", 1)[-1], w.lineno) for w in syncs})


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["cuda", "sparse"])
def test_ensemble_host_syncs_are_the_sync_debug_modes(cuda, backend):
    X = _corpus(n=600, m=900)
    model = enstop_torch.EnsembleTopics(n_components=20, random_state=0, backend=backend)
    model.fit(X)  # builds the kernels
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            model.fit(X)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "called a synchronizing" in str(w.message)]
    sites = sorted({(w.filename.rsplit("/", 1)[-1], w.lineno) for w in syncs})
    assert len(syncs) == model.fit_info_["trace"]["counters"]["host_syncs"], sites
