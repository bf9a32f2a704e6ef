"""The readers of the program's spans (``fit_info_["trace"]``): each reads a
made-up trace exactly, returns None where no fit kept one (a program
without the spans, or the reference in the program's place), and reads the
fits of a cell run on the CPU."""

from types import SimpleNamespace

import harness
import pytest
from conftest import BENCH

SPAN_METRICS = ("validate_ms.fit", "staging_ms.fit", "h2d_gbps.fit", "init_ms.fit",
                "host_syncs.fit")
SEED = 2**31 + 17


def _span(name, start, end, parent=0, **attrs):
    return {"name": name, "parent": parent, "start": start, "end": end, "attrs": attrs,
            "counters": {}}


def _trace(scale, syncs):
    """A fit's record: every span ``scale`` times as long, ``syncs`` host syncs."""
    spans = [_span("fit", 0.0, 10 * scale, parent=None),
             _span("validate", 0.0, 1 * scale),
             _span("stage", 1 * scale, 5 * scale),
             _span("stage.copy", 2 * scale, 4 * scale, parent=2, bytes=int(4e9 * scale)),
             _span("init", 5 * scale, 5.5 * scale),
             _span("loop", 5.5 * scale, 9 * scale)]
    return {"id": 1, "spans": spans, "counters": {"host_syncs": syncs}}


# each reader on two fits: one at scale 1 and 16 syncs, one at scale 3 and 20
EXPECTED = {"validate_ms.fit": 2000.0, "staging_ms.fit": 8000.0, "h2d_gbps.fit": 2.0,
            "init_ms.fit": 1000.0, "host_syncs.fit": 18.0}


def _read(name, infos):
    return harness.load(BENCH.parent, "metrics", name).read(SimpleNamespace(infos=infos))


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_reader_reads_the_spans(name):
    infos = [{"wall_time_s": 3.5, "trace": _trace(1.0, 16)},
             {"wall_time_s": 10.5, "trace": _trace(3.0, 20)}, None]
    assert _read(name, infos) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_reader_without_spans_reads_nothing(name):
    assert _read(name, []) is None
    assert _read(name, [None, None]) is None  # the reference in the program's place
    assert _read(name, [{"n_steps": 100, "wall_time_s": 0.05}]) is None  # no spans kept


@pytest.mark.parametrize("cell_name", ["tiny.fit", "tiny.fit-sparse"])
def test_the_readers_read_a_cell_on_the_cpu(tiny_root, cell_name):
    cell = harness.find_cell(cell_name, tiny_root)
    assert set(SPAN_METRICS) <= {m["name"] for m in cell.per_layer}
    entry = harness.load(tiny_root, "entries", "fit").Entry(cell, SEED, "cpu")
    entry.setup()
    for i in range(2):
        rs = entry.prepare(i)
        entry.keep(i, rs, entry.call(rs))
    values = {name: _read(name, entry.infos) for name in SPAN_METRICS}
    assert all(v > 0 for v in values.values()), values
    # 100 steps, a test every 10 (tolerance 0): 11 LL readbacks, the two
    # factors there and back, the corpus's three arrays, the layout's reads
    # back (6 a side: the dense path has one side, the sparse path two), and
    # the dense path's document weights
    assert values["host_syncs.fit"] == (25 if cell_name == "tiny.fit" else 30)
