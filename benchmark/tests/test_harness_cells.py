"""Whole runs of the harness on the CPU, at a small size: a cell, a mix, an
estimator, an entry or a loop added as files alone is found and run, its
answers come out correct, and the control and each fault a cell can have
come out not correct.

The faults are planted underneath the entry the window drives, where the
program does the work: an EM step that returns its state unchanged, half
of the documents left out of the M step (the mean taken over the rest),
an answer altered where it is produced (a fit's two topics swapped, or one
document's topics rolled). The cells run on one chip, so no exchange
between chips can be left out."""

import json

import harness
import numpy as np
import pytest
from conftest import BENCH, add_cell

CELLS = ("tiny.fit", "tiny.fit-sparse")
SEED = 2**31 + 17


def _run(root, name, calls=3, **kw):
    return harness.run(harness.find_cell(name, root), SEED, 0.0, device="cpu",
                       max_calls=calls, **kw)


def _mix(name="fit"):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def test_a_cell_added_as_files_is_found(tiny_root):
    cell = harness.find_cell("tiny.fit", tiny_root)
    assert cell.config["name"] == "tiny" and cell.traffic["entry"] == "fit"
    assert {m["name"] for m in cell.end_to_end} == {"fit_s", "peak_device_gib", "setup_s"}
    assert "em_step_mfu.fit" in {m["name"] for m in cell.per_layer}
    with pytest.raises(SystemExit):
        harness.find_cell("tiny.nothing", tiny_root)


def test_a_new_estimator_is_a_data_file(tiny_root):
    """Another estimator class of the program, named in a mix alone."""
    mix = _mix()
    mix["estimator_class"] = "StreamedPLSA"
    mix["estimator"]["block_size"] = 128
    add_cell(tiny_root, "fit-streamed", "fit-streamed", mix)
    result = _run(tiny_root, "tiny.fit-streamed")
    assert result["correct"], result["checks"]
    assert "fit_s" in result["metrics"]
    assert list(result)[-1] == "checks"


ENTRY = '''
from harness import ROOT, load


class Entry(load(ROOT, "entries", "fit").Entry):
    """fit_transform: the embedding is the answer; the model is kept for the check."""

    def call(self, rs):
        model = self._model(rs)
        model.fit_transform(self.X)
        return model
'''

LOOP = '''
import time


def drive(entry, spec, seed, end, max_calls, log):
    """Arrivals every ``gap_s``, each call served when it and the last are due."""
    calls, t = [], time.perf_counter()
    for i in range(max_calls):
        arrival = t + i * spec["gap_s"]
        while time.perf_counter() < arrival:
            pass
        args = entry.prepare(i)
        t0 = time.perf_counter()
        out = entry.call(args)
        calls.append((arrival, t0, time.perf_counter()))
        entry.keep(i, args, out)
    return calls, 0
'''


def test_a_new_entry_and_loop_are_files(tiny_root):
    """An entry and a loop written as files under the root's own folder,
    named by a mix; the harness edits nothing to run them."""
    (tiny_root / "benchmark" / "entries" / "fit-transform.py").write_text(ENTRY)
    (tiny_root / "benchmark" / "loops" / "paced.py").write_text(LOOP)
    mix = dict(_mix(), entry="fit-transform", loop={"kind": "paced", "gap_s": 0.01})
    add_cell(tiny_root, "fit-transform", "fit-transform", mix)
    result = _run(tiny_root, "tiny.fit-transform")
    assert result["correct"], result["checks"]
    assert result["attempted"] == 3


@pytest.mark.parametrize("name", CELLS)
def test_runs_are_correct(tiny_root, name):
    result = _run(tiny_root, name)
    assert result["correct"], result["checks"]
    assert result["attempted"] == 3 and result["failed"] == 0
    assert "setup_s" in result["metrics"]
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == set(_mix(name.split(".")[1])["limits"])


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(tiny_root, name):
    assert not _run(tiny_root, name, variant="control")["correct"]


def _frozen_steps(monkeypatch):
    """Every EM step returns the state it was given."""
    from enstop_torch.ops import cuda_em, sell

    step = cuda_em.em_step_fused
    monkeypatch.setattr(cuda_em, "em_step_fused",
                        lambda X, zd, wz, w, **k: (zd, wz, step(X, zd, wz, w, **k)[2]))
    step_sell = sell.em_step_sell
    monkeypatch.setattr(sell, "em_step_sell",
                        lambda prep, zd, wz, *a, **k: (zd, wz, step_sell(prep, zd, wz, *a, **k)[2]))


def _half_batch(monkeypatch):
    """The fit's M step sees the first half of the documents only."""
    from enstop_torch.models import plsa

    fit = plsa.plsa_fit

    def half_fit(X, k, sample_weight=None, **kw):
        w = np.array(sample_weight, dtype=np.float32, copy=True)
        w[len(w) // 2:] = 0.0
        return fit(X, k, sample_weight=w, **kw)

    monkeypatch.setattr(plsa, "plsa_fit", half_fit)


def _swapped_topics(monkeypatch):
    """A fit's first two topics change places in ``components_``."""
    from enstop_torch.models import plsa

    fit = plsa.plsa_fit

    def swapped(*a, **kw):
        zd, wz, info = fit(*a, **kw)
        return zd, wz[[1, 0, *range(2, wz.shape[0])]], info

    monkeypatch.setattr(plsa, "plsa_fit", swapped)


def _one_document_rolled(monkeypatch):
    """One document's topics rolled by one: a single wrong row, which moves
    a mean over the rows by 1/n of its gap and the widest row by all of it."""
    from enstop_torch.models import plsa

    fit = plsa.plsa_fit

    def rolled(*a, **kw):
        zd, wz, info = fit(*a, **kw)
        zd = np.array(zd, copy=True)
        zd[-1] = np.roll(zd[-1], 1)
        return zd, wz, info

    monkeypatch.setattr(plsa, "plsa_fit", rolled)


@pytest.mark.parametrize("fault", [_frozen_steps, _half_batch, _swapped_topics,
                                   _one_document_rolled])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(tiny_root, name, fault, monkeypatch):
    fault(monkeypatch)
    result = _run(tiny_root, name)
    assert not result["correct"]
    checks = result["checks"]
    if fault is _one_document_rolled and "zd_l1_max" in checks:  # caught by the row alone
        assert checks["zd_l1_max"]["value"] > checks["zd_l1_max"]["limit"]
