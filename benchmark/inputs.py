"""What every entry draws from the seed: the configuration's corpus, each
call's ``random_state`` and the sample of answers the check judges."""

from __future__ import annotations

import time

import numpy as np

from harness import load, log


def make_corpus(cell, seed, device):
    """The configuration's corpus, made by ``corpora/<generator>.py`` from the seed."""
    spec = cell.config["corpus"]
    t0 = time.perf_counter()
    corpus = load(cell.root, "corpora", spec["generator"]).make(spec, seed, device)
    X = corpus["train"]
    log(f"corpus {cell.config['name']} in {time.perf_counter() - t0:.2f} s: "
        f"{X.shape[0]} x {X.shape[1]}, nnz {X.nnz}"
        + ("" if corpus["heldout"] is None else f"; held out {corpus['heldout'].shape[0]} "
           f"docs, nnz {corpus['heldout'].nnz}"))
    return corpus


def random_state(seed, i):
    """The ``random_state`` of call ``i`` (``-1``: set-up's) under ``seed``."""
    return int(np.random.default_rng([int(seed), i + 1]).integers(2**31 - 1))


class Reservoir:
    """A uniform sample of ``size`` of the items offered, drawn from the seed."""

    def __init__(self, size, seed):
        self.size, self.rng, self.items, self.seen = size, np.random.default_rng([seed, 0]), [], 0

    def offer(self, item):
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = int(self.rng.integers(self.seen + 1))
            if j < self.size:
                self.items[j] = item
        self.seen += 1
