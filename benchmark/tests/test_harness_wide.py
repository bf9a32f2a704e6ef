"""The cell ``nytimes-k1000.fit-wide`` in miniature, on the CPU: its mix
(``traffic/fit-wide.json``) and its reference (``reference/plsa_wide.py``)
on the tiny corpus at k = 300, past the 256 topics of the lane-group walk,
so that the port's passes run where the card takes the wide walk. A run is
correct, the bf16r control is not, a fit with its EM step frozen is not,
and the cell's readers (the wide walk's roofline and the fit cells') read
it; the wide reference gives the plain reference's fit."""

import json
import time
from types import SimpleNamespace

import harness
import numpy as np
import pytest
from conftest import BENCH

SEED = 2**31 + 17
CELL = "tiny-wide.fit-wide"
# the cell's readers: the wide walk's own, and those of the fit cells
FIT_READERS = ("outside_loop_ms.fit", "em_step_mfu.fit", "kernel_roofline.fit",
               "device_idle.fit", "validate_ms.fit", "staging_ms.fit", "h2d_gbps.fit",
               "init_ms.fit", "host_syncs.fit")
READERS = ("walk_roofline.wide",) + FIT_READERS


@pytest.fixture
def wide_root(tiny_root):
    """``tiny_root`` with the configuration ``tiny-wide`` (the tiny corpus at
    k = 300) and its cell under the mix ``fit-wide``, listed where the real
    cell is."""
    configs = tiny_root / "benchmark" / "configs"
    config = json.loads((configs / "tiny.json").read_text())
    config.update(name="tiny-wide", n_components=300)
    (configs / "tiny-wide.json").write_text(json.dumps(config))
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(spec["configs"][0], name="tiny-wide",
                                file="benchmark/configs/tiny-wide.json"))
    spec["workloads"].append({"name": CELL, "config": "tiny-wide", "traffic": "fit-wide",
                              "chips": 1, "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "nytimes-k1000.fit-wide" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    return tiny_root


def _run(root, **kw):
    return harness.run(harness.find_cell(CELL, root), SEED, 0.0, device="cpu", max_calls=1,
                       **kw)


def test_the_wide_cell_is_found(wide_root):
    cell = harness.find_cell(CELL, wide_root)
    assert cell.config["n_components"] == 300 and cell.traffic["reference"] == "plsa_wide"
    assert {m["name"] for m in cell.end_to_end} == {"fit_s", "peak_device_gib", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == set(READERS)
    real = harness.find_cell("nytimes-k1000.fit-wide")
    assert real.config["n_components"] == 1000
    assert real.config["corpus"] == json.loads(
        (BENCH / "configs" / "nytimes-k20.json").read_text())["corpus"]


def test_wide_runs_are_correct(wide_root):
    result = _run(wide_root)
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == set(
        json.loads((BENCH / "traffic" / "fit-wide.json").read_text())["limits"])


def test_the_wide_control_is_not_correct(wide_root):
    assert not _run(wide_root, variant="control")["correct"]


def test_a_frozen_wide_step_is_not_correct(wide_root, monkeypatch):
    from enstop_torch.ops import sell

    step = sell.em_step_sell
    monkeypatch.setattr(sell, "em_step_sell",
                        lambda prep, zd, wz, *a, **k: (zd, wz, step(prep, zd, wz, *a, **k)[2]))
    assert not _run(wide_root)["correct"]


def test_the_wide_readers_read_a_cell_on_the_cpu(wide_root):
    """Each of the cell's readers reads a fit of the cell: the fit cells' from
    its spans, its calls and a device trace, ``walk_roofline.wide`` from the
    wide walk's kernels in that trace (here one made up with them in it); the
    fit counts its passes on the wide walk."""
    cell = harness.find_cell(CELL, wide_root)
    assert {m["name"] for m in cell.per_layer} == set(READERS)
    entry = harness.load(wide_root, "entries", "fit").Entry(cell, SEED, "cpu")
    entry.setup()
    rs = entry.prepare(0)
    t0 = time.perf_counter()
    info = entry.call(rs)
    calls = [(t0, t0, time.perf_counter())]
    entry.keep(0, rs, info)
    assert entry.infos[0]["trace"]["counters"]["wide_passes"] == 2 * 50 + 6
    trace = {"device_ops": [["void (anonymous namespace)::wide_walk_segments<32, 4, true, "
                             "false>(...)", 0.75],
                            ["void (anonymous namespace)::wide_walk_reduce<32, 4>(...)", 0.25],
                            ["void (anonymous namespace)::segment_pass<4, 8, 4>(...)", 9.0]],
             "kernel_s": 10.0, "busy_s": 10.5, "window_s": 12.0}
    rec = SimpleNamespace(infos=entry.infos, counts=entry.counts, trace=trace, calls=calls)
    values = {name: harness.load(wide_root, "metrics", name).read(rec) for name in READERS}
    assert all(v is not None and v > 0 for v in values.values()), values
    import roofline

    least = roofline.em_step_least_s(**entry.counts)
    assert values["walk_roofline.wide"] == pytest.approx(100 * least * 50 / 1.0)
    assert values["kernel_roofline.fit"] == pytest.approx(100 * least * 50 / 10.0)


@pytest.mark.parametrize("name", READERS)
def test_a_wide_reader_reads_nothing_without_a_trace(name):
    """Where the fits kept no trace (the reference in the program's place),
    each reader returns None and does not raise."""
    counts = {"nnz": 10, "n_docs": 5, "n_words": 4, "k": 300}
    for infos in ([], [None]):
        rec = SimpleNamespace(infos=infos, counts=counts, trace=None, calls=[])
        assert harness.load(BENCH.parent, "metrics", name).read(rec) is None


def test_the_wide_walk_reader_reads_nothing_off_the_wide_walk():
    """A trace that holds none of the wide walk's kernels (a program without
    it) reads nothing."""
    counts = {"nnz": 10, "n_docs": 5, "n_words": 4, "k": 300}
    narrow = {"n_steps": 50, "wall_time_s": 2.0, "trace": {"spans": [], "counters": {}}}
    trace = {"device_ops": [["void (anonymous namespace)::segment_pass<4, 8>(...)", 1.0]]}
    rec = SimpleNamespace(infos=[narrow], counts=counts, trace=trace)
    assert harness.load(BENCH.parent, "metrics", "walk_roofline.wide").read(rec) is None


def test_the_wide_reference_is_the_plain_reference():
    """``plsa_wide``'s sparse products give ``plsa``'s gathered blocks' fit:
    float64 against float64, blocks of a few rows, weighted and not, and the
    bf16r control."""
    import scipy.sparse as sp
    from reference import plsa, plsa_wide

    rng = np.random.RandomState(0)
    X = sp.csr_matrix(rng.poisson(0.3, (120, 90)).astype(np.int64))
    k = 40
    corpus = plsa_wide.corpus_of(X, k, "cpu")._replace(
        doc_blocks=plsa_wide._blocks(X.indptr, 50),
        word_blocks=plsa_wide._blocks(np.concatenate([[0], np.cumsum(np.bincount(
            X.indices, minlength=90))]), 50))
    assert len(corpus.doc_blocks) > 10 and len(corpus.word_blocks) > 10
    zd0, wz0 = plsa.random_init(120, 90, k, 4)
    w = rng.uniform(0.5, 1.5, 120)
    for weight in (None, w):
        for mode, tol in (("exact", 1e-13), ("bf16r", 1e-6)):
            a = plsa.em(plsa.coo_of(X, "cpu"), zd0, wz0, 12, 5, 0.0, weight=weight,
                        mode=mode)[-1]
            b = plsa_wide.em(corpus, zd0, wz0, 12, 5, 0.0, weight=weight, mode=mode)[-1]
            assert a.n_steps == b.n_steps == 12
            assert float((a.zd - b.zd).abs().max()) <= tol
            assert float((a.wz - b.wz).abs().max()) <= tol
