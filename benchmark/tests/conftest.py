"""The harness's tests: the benchmark's folder and the checkout's root on
the path, and a checkout in miniature (``tiny_root``) whose cells are the
real mixes on a small corpus, added as files alone."""

import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

TINY_CORPUS = {"n_docs": 400, "n_words": 700, "tokens_per_doc": 60}


def _tiny(name):
    return name.replace("20ng-k20", "tiny").replace("nytimes-k20", "tiny")


@pytest.fixture
def tiny_root(tmp_path):
    """A root with a ``BENCHMARK.json`` whose cells run the real mixes on the
    configuration ``tiny``; entries, loops, metrics, corpora and the
    reference come from this folder."""
    (tmp_path / "benchmark" / "configs").mkdir(parents=True)
    for kind in ("traffic", "entries", "loops"):
        (tmp_path / "benchmark" / kind).mkdir()
    config = json.loads((BENCH / "configs" / "20ng-k20.json").read_text())
    config["name"] = "tiny"
    config["corpus"].update(TINY_CORPUS)
    (tmp_path / "benchmark" / "configs" / "tiny.json").write_text(json.dumps(config))
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    spec["configs"] = [dict(spec["configs"][0], name="tiny",
                            file="benchmark/configs/tiny.json")]
    for w in spec["workloads"]:
        w["config"], w["name"] = "tiny", _tiny(w["name"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [_tiny(x) for x in m["workloads"]]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp_path


def add_cell(root, name, traffic, mix=None, metrics=("fit_s",)):
    """Adds the cell ``tiny.<name>`` of the mix ``traffic`` to ``root``'s
    ``BENCHMARK.json``, writing the mix's file when ``mix`` is given, and
    lists the cell in the ``workloads`` of each of ``metrics``."""
    if mix is not None:
        (root / "benchmark" / "traffic" / f"{traffic}.json").write_text(json.dumps(mix))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": f"tiny.{name}", "config": "tiny", "traffic": traffic,
                              "chips": 1, "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m and m["name"] in metrics:
            m["workloads"].append(f"tiny.{name}")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
