"""The ensemble cells on the CPU at a small size: both mixes run end to end
and come out correct; the control and each fault planted in the program's
stages come out not correct, by the number that judges that stage; the
entry fails in set-up, before any call, on a program that does not expose
what the check reads; and the six readers of the ensemble's spans read the
calls of a cell, and nothing where no call kept a trace.

The faults are planted underneath the entry, where the program does the
work: the layout's rows shuffled, two clusters' labels merged, the merge a
plain mean of the topics (not of their square roots), and the refit run
against the stack's first topics in place of the stable ones."""

import json
from types import SimpleNamespace

import harness
import numpy as np
import pytest
import torch
from conftest import BENCH

CELLS = ("tiny.ensemble", "tiny.ensemble-sparse")
READERS = ("staging_ms.ensemble", "em_step_mfu.ensemble", "combine_ms.ensemble",
           "layout_ms.ensemble", "refit_ms.ensemble", "host_syncs.ensemble")
SEED = 2**31 + 23


@pytest.fixture
def tiny_root(tiny_root):
    """conftest's root, with the ensemble's own configuration's cell renamed
    to ``tiny.ensemble-sparse`` like the others."""
    path = tiny_root / "BENCHMARK.json"
    text = path.read_text().replace("nytimes-enstop-k20.", "tiny.")
    path.write_text(text)
    return tiny_root


def _run(root, name, calls=2, **kw):
    return harness.run(harness.find_cell(name, root), SEED, 0.0, device="cpu",
                       max_calls=calls, **kw)


def _mix(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def test_the_ensemble_cells_are_found(tiny_root):
    for name in CELLS:
        cell = harness.find_cell(name, tiny_root)
        assert cell.traffic["entry"] == "ensemble"
        assert {m["name"] for m in cell.end_to_end} == {"fit_s", "peak_device_gib", "setup_s"}
        assert {m["name"] for m in cell.per_layer} == set(READERS)


@pytest.mark.parametrize("name", CELLS)
def test_ensemble_runs_are_correct(tiny_root, name):
    result = _run(tiny_root, name)
    assert result["correct"], result["checks"]
    assert result["attempted"] == 2 and result["failed"] == 0
    assert {"fit_s", "setup_s"} <= set(result["metrics"])
    assert set(result["checks"]) == set(_mix(name.split(".")[1])["limits"])


@pytest.mark.parametrize("name", CELLS)
def test_the_ensemble_control_is_not_correct(tiny_root, name):
    assert not _run(tiny_root, name, calls=1, variant="control")["correct"]


def _shuffled_layout(monkeypatch):
    """The layout's rows in another order: each topic placed at another's point."""
    from enstop_torch.models import ensemble

    embed = ensemble.umap_embed

    def shuffled(**kw):
        out = embed(**kw)
        return out[np.random.RandomState(0).permutation(out.shape[0])]

    monkeypatch.setattr(ensemble, "umap_embed", shuffled)
    return "layout_untrust"


def _labels_off_by_one_merge(monkeypatch):
    """Cluster 1 labelled as cluster 0, the clusters above it one down."""
    from enstop_torch.models import ensemble

    labelled = ensemble._labels_or_one_cluster

    def merged(labels, strengths=None):
        labels, strengths = labelled(labels, strengths)
        return np.where(labels >= 1, labels - 1, labels), strengths

    monkeypatch.setattr(ensemble, "_labels_or_one_cluster", merged)
    return "cluster_mismatch"


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


def _refit_on_first_topics(monkeypatch):
    """The refit against the stack's first topics, as many as the stable ones."""
    from enstop_torch.models import ensemble

    runs, refit, seen = ensemble._ensemble_of_topics_device, ensemble.plsa_refit, {}

    def keep(*a, **kw):
        seen["stack"], steps = runs(*a, **kw)
        return seen["stack"], steps

    def wrong(X, topics, **kw):
        first = torch.as_tensor(seen["stack"])[:topics.shape[0]].cpu().numpy()
        return refit(X, first, **kw)

    monkeypatch.setattr(ensemble, "_ensemble_of_topics_device", keep)
    monkeypatch.setattr(ensemble, "plsa_refit", wrong)
    return "refit_zd_l1_max"


@pytest.mark.parametrize("fault", [_shuffled_layout, _labels_off_by_one_merge, _plain_mean,
                                   _refit_on_first_topics])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_ensemble_stage_is_not_correct(tiny_root, name, fault, monkeypatch):
    judged = fault(monkeypatch)
    result = _run(tiny_root, name, calls=1)
    assert not result["correct"]
    assert result["checks"][judged]["value"] > result["checks"][judged]["limit"]


def test_a_program_without_the_check_inputs_fails_in_set_up(tiny_root, monkeypatch):
    from enstop_torch.models import ensemble

    fit_transform = ensemble.EnsembleTopics.fit_transform

    def bare(self, X, y=None, **kw):  # the fit as it was before the check's inputs
        out = fit_transform(self, X, y, **kw)
        del self.topic_stack_, self.topic_layout_, self.topic_labels_, self.fit_info_
        return out

    monkeypatch.setattr(ensemble.EnsembleTopics, "fit_transform", bare)
    calls = []
    entry = harness.load(tiny_root, "entries", "ensemble").Entry(
        harness.find_cell("tiny.ensemble", tiny_root), SEED, "cpu")
    monkeypatch.setattr(entry, "call", calls.append)
    with pytest.raises(RuntimeError, match="does not expose"):
        entry.setup()
    assert calls == []


def _read(name, infos, counts=None):
    rec = SimpleNamespace(infos=infos, counts=counts)
    return harness.load(BENCH.parent, "metrics", name).read(rec)


@pytest.mark.parametrize("cell_name", CELLS)
def test_the_ensemble_readers_read_a_cell(tiny_root, cell_name):
    cell = harness.find_cell(cell_name, tiny_root)
    entry = harness.load(tiny_root, "entries", "ensemble").Entry(cell, SEED, "cpu")
    entry.setup()
    for i in range(2):
        rs = entry.prepare(i)
        entry.keep(i, rs, entry.call(rs))
    values = {name: _read(name, entry.infos, entry.counts) for name in READERS}
    assert all(v is not None and v > 0 for v in values.values()), values
    assert values["em_step_mfu.ensemble"] < 100.0
    traces = [info["trace"] for info in entry.infos]
    assert values["host_syncs.ensemble"] == sum(
        t["counters"]["host_syncs"] for t in traces) / 2


@pytest.mark.parametrize("name", READERS)
def test_an_ensemble_reader_without_spans_reads_nothing(name):
    counts = {"nnz": 10, "n_docs": 2, "n_words": 5, "k": 2}
    assert _read(name, [], counts) is None
    assert _read(name, [None, None], counts) is None  # the reference in the program's place
