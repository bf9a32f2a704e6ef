"""The cell ``nytimes-enstop-nmf-k20.ensemble-nmf`` in miniature, on the CPU:
its mix (``traffic/ensemble-nmf.json``), entry (``entries/ensemble_nmf.py``)
and reference (``reference/ensemble_nmf.py``) on a small corpus at k = 5. A
run is correct; the bf16r control is not, nor a run with a fault planted in
the program's runs, layout, merge or embedding, each by the number that
judges it; the entry fails in set-up on a program that does not expose what
the check reads; the cell's readers read it, and the NMF readers nothing
where no call kept their spans; a call's trace holds the NMF spans and
counters."""

import json
from types import SimpleNamespace

import harness
import numpy as np
import pytest
import torch
from conftest import BENCH

SEED = 2**31 + 29
REAL = "nytimes-enstop-nmf-k20.ensemble-nmf"
CELL = "tiny-nmf.ensemble-nmf"
ENSEMBLE_READERS = ("staging_ms.ensemble", "combine_ms.ensemble", "layout_ms.ensemble",
                    "refit_ms.ensemble", "host_syncs.ensemble")
NMF_READERS = ("resample_ms.nmf", "mu_step_mfu.nmf")
READERS = ENSEMBLE_READERS + NMF_READERS
NMF_SPANS = ("runs.resample", "runs.stage", "runs.mu", "refit.stage", "refit.mu")


@pytest.fixture
def nmf_root(tiny_root):
    """``tiny_root`` with the configuration ``tiny-nmf`` (a small corpus at
    k = 5) and the real cell renamed onto it, listed where the real cell is."""
    configs = tiny_root / "benchmark" / "configs"
    config = json.loads((configs / "tiny.json").read_text())
    config.update(name="tiny-nmf", n_components=5)
    config["corpus"].update(n_docs=200, n_words=300, tokens_per_doc=40, n_heldout=0)
    (configs / "tiny-nmf.json").write_text(json.dumps(config))
    path = tiny_root / "BENCHMARK.json"
    spec = json.loads(path.read_text().replace(REAL, CELL))
    spec["configs"].append(dict(spec["configs"][0], name="tiny-nmf",
                                file="benchmark/configs/tiny-nmf.json"))
    next(w for w in spec["workloads"] if w["name"] == CELL)["config"] = "tiny-nmf"
    path.write_text(json.dumps(spec))
    return tiny_root


def _run(root, calls=1, **kw):
    return harness.run(harness.find_cell(CELL, root), SEED, 0.0, device="cpu",
                       max_calls=calls, **kw)


def _mix():
    return json.loads((BENCH / "traffic" / "ensemble-nmf.json").read_text())


def test_the_nmf_cell_is_found(nmf_root):
    cell = harness.find_cell(CELL, nmf_root)
    assert cell.traffic["entry"] == "ensemble_nmf" and cell.traffic["estimator"]["model"] == "nmf"
    assert {m["name"] for m in cell.end_to_end} == {"fit_s", "peak_device_gib", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == set(READERS)
    real = harness.find_cell(REAL)
    assert real.config["corpus"] == json.loads(
        (BENCH / "configs" / "nytimes-enstop-k20.json").read_text())["corpus"]
    assert real.config["source_counts"]["nnz"] == 69_679_427


def test_nmf_runs_are_correct(nmf_root):
    result = _run(nmf_root, calls=2)
    assert result["correct"], result["checks"]
    assert result["attempted"] == 2 and result["failed"] == 0
    assert {"fit_s", "setup_s"} <= set(result["metrics"])
    assert set(result["checks"]) == set(_mix()["limits"])


def test_the_nmf_control_is_not_correct(nmf_root):
    result = _run(nmf_root, variant="control")
    assert not result["correct"]
    checks = result["checks"]
    for name in ("run_wz_l1_mean", "refit_zd_l1_mean"):
        assert checks[name]["value"] > checks[name]["limit"], name


def _frozen_topics(monkeypatch):
    """Each run's H update leaves H as it was."""
    from enstop_torch.ops import nmf

    step = nmf._mu_step_kl
    monkeypatch.setattr(nmf, "_mu_step_kl", lambda prep, W, H, l1, l2, update_H: (
        step(prep, W, H, l1, l2, False)[0], H))
    return "run_wz_l1_max"


def _shuffled_layout(monkeypatch):
    """The layout's rows in another order: each topic placed at another's point."""
    from enstop_torch.models import ensemble

    embed = ensemble.umap_embed

    def shuffled(**kw):
        out = embed(**kw)
        return out[np.random.RandomState(0).permutation(out.shape[0])]

    monkeypatch.setattr(ensemble, "umap_embed", shuffled)
    return "layout_untrust"


def _plain_mean(monkeypatch):
    """The merge averages the topics themselves, not their square roots."""
    from enstop_torch.models import ensemble

    def plain(all_topics, labels, weights=None):
        T = torch.as_tensor(all_topics).double().cpu()
        out = np.stack([T[torch.from_numpy(labels == c)].mean(0).numpy()
                        for c in range(int(labels.max()) + 1)])
        return (out / out.sum(1, keepdims=True)).astype(np.float32)

    monkeypatch.setattr(ensemble, "_merge_topics_by_label", plain)
    return "merge_l1_max"


def _embedding_from_its_first_updates(monkeypatch):
    """The embedding stops after 20 of its 200 updates."""
    from enstop_torch.models import ensemble

    fit_mu = ensemble._fit_mu

    def short(X, k, **kw):
        return fit_mu(X, k, **dict(kw, n_iter=20) if kw["where"] == "refit" else kw)

    monkeypatch.setattr(ensemble, "_fit_mu", short)
    return "refit_zd_l1_max"


@pytest.mark.parametrize("fault", [_frozen_topics, _shuffled_layout, _plain_mean,
                                   _embedding_from_its_first_updates])
def test_a_broken_nmf_stage_is_not_correct(nmf_root, fault, monkeypatch):
    judged = fault(monkeypatch)
    result = _run(nmf_root)
    assert not result["correct"]
    assert result["checks"][judged]["value"] > result["checks"][judged]["limit"]


def test_a_program_without_the_check_inputs_fails_in_set_up(nmf_root, monkeypatch):
    from enstop_torch.models import ensemble

    fit_transform = ensemble.EnsembleTopics.fit_transform

    def bare(self, X, y=None, **kw):  # the fit as it was before the check's inputs
        out = fit_transform(self, X, y, **kw)
        del self.topic_stack_, self.topic_layout_, self.topic_labels_, self.fit_info_
        return out

    monkeypatch.setattr(ensemble.EnsembleTopics, "fit_transform", bare)
    calls = []
    entry = harness.load(nmf_root, "entries", "ensemble_nmf").Entry(
        harness.find_cell(CELL, nmf_root), SEED, "cpu")
    monkeypatch.setattr(entry, "call", calls.append)
    with pytest.raises(RuntimeError, match="does not expose"):
        entry.setup()
    assert calls == []


def _read(name, infos, counts=None):
    rec = SimpleNamespace(infos=infos, counts=counts)
    return harness.load(BENCH.parent, "metrics", name).read(rec)


def test_the_nmf_readers_read_a_cell_and_its_trace(nmf_root):
    """Each reader reads two calls of the cell; each call's trace holds the
    five NMF spans, 16 runs of 200 updates and a 200-update embedding."""
    cell = harness.find_cell(CELL, nmf_root)
    entry = harness.load(nmf_root, "entries", "ensemble_nmf").Entry(cell, SEED, "cpu")
    entry.setup()
    for i in range(2):
        rs = entry.prepare(i)
        entry.keep(i, rs, entry.call(rs))
    traces = [info["trace"] for info in entry.infos]
    for t in traces:
        names = [s["name"] for s in t["spans"]]
        assert all(names.count(n) == 16 for n in NMF_SPANS[:3])
        assert all(names.count(n) == 1 for n in NMF_SPANS[3:])
        parents = {t["spans"][s["parent"]]["name"] for s in t["spans"] if s["name"] in NMF_SPANS}
        assert parents == {"runs", "refit"}
        assert t["counters"]["runs"] == 16
        assert t["counters"]["mu_steps"] == 16 * 200
        assert t["counters"]["refit_mu_steps"] == 200
    values = {name: _read(name, entry.infos, entry.counts) for name in READERS}
    assert all(v is not None and v > 0 for v in values.values()), values
    assert values["mu_step_mfu.nmf"] < 100.0
    spent = [sum(s["end"] - s["start"] for s in t["spans"]
                 if s["name"] in ("runs.resample", "runs.stage")) for t in traces]
    assert values["resample_ms.nmf"] == pytest.approx(1e3 * sum(spent) / 2)


@pytest.mark.parametrize("name", NMF_READERS)
def test_an_nmf_reader_without_its_spans_reads_nothing(name):
    """No trace (the reference in the program's place), or a pLSA ensemble's
    trace, which has no NMF span or counter: None, and no error."""
    counts = {"nnz": 10, "n_docs": 2, "n_words": 5, "k": 2}
    plsa = {"trace": {"spans": [{"name": "runs", "parent": 0, "start": 0.0, "end": 1.0}],
                      "counters": {"runs": 16, "em_steps": 800}}}
    for infos in ([], [None, None], [plsa]):
        assert _read(name, infos, counts) is None


def test_the_mu_roofline_at_the_cells_counts():
    """The least time of a KL update: an EM iteration's bytes, 8 operations a
    nonzero and topic; bound by the bytes at the cell's counts."""
    import roofline
    import roofline_nmf

    nnz, n, m, k = 69_679_427, 300_000, 102_660, 20
    assert roofline_nmf.mu_step_flop(nnz, k) == 8 * nnz * k
    assert roofline_nmf.mu_step_least_s(nnz, n, m, k) == pytest.approx(185.6e-6, rel=1e-3)
    assert roofline_nmf.mu_step_flop(nnz, k) / 67e12 == pytest.approx(166.4e-6, rel=1e-3)
    assert roofline_nmf.mu_step_least_s(nnz, n, m, k) == roofline.em_step_least_s(nnz, n, m, k)
    # at many topics the operations bound it: 8 * nnz * k / 67e12
    assert roofline_nmf.mu_step_least_s(10**6, 10, 10, 1000) == pytest.approx(8e9 / 67e12)
