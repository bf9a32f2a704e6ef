"""The entry ``ensemble_nmf``: ``EnsembleTopics(model="nmf", **estimator).fit(X)``
on the configuration's corpus, a new ``random_state`` a call, each sampled
call judged stage by stage against ``reference/ensemble_nmf.py``.

The mix's keys: ``estimator_class`` (``EnsembleTopics``); ``estimator``, its
parameters (``model="nmf"``; ``n_starts`` and the clustering's sizes, which
the reference takes too); ``reference``; ``check``: ``sample``, the calls
judged, and ``runs``, the runs judged of each; ``control``, the reference's
``mode`` whose runs and embedding stand around the program's own combine in
the program's place; ``limits``, and ``limits_why``, each limit's reason.

Set-up, the calls and what a call keeps are ``entries/ensemble.py``'s: the
corpus, a probe on its first documents that fails at once where the program
does not expose what the check reads, one warm call; a call's check inputs
are kept only when the sample keeps the call, its stack then copied to the
host after the call's stamped time.

The check, for each kept call: the sampled runs' topics against the
reference's runs from the same resample and start (``run_wz_l1_*``: the
widest and the mean of the l1 gaps of all the sampled runs' topic rows; a
run's final topics can lie 7e-3 from float64 in float32 alone, so the mix
samples every run and the mean over them separates rounding from a fault);
the combine as the pLSA ensemble's cells judge it, on the program's own
stack and layout (``layout_untrust``, ``cluster_mismatch``,
``n_components_gap``, ``merge_l1_max``); the reference's embedding against
``components_`` from the call's own start against ``embedding_``
(``refit_zd_l1_*``, each document's l1 gap over the l1 norm of the
reference's row, since an NMF embedding is not normalised). The worst kept
call counts.
"""

from __future__ import annotations

import importlib
import time

import numpy as np
import torch

from harness import ROOT, load, log
from inputs import Reservoir
from reference import compare


class ReferenceEnsemble:
    """The control: the reference's runs and embedding in ``mode`` around the
    program's own combine."""

    def __init__(self, entry, rs):
        self.entry, self.seed = entry, rs

    def fit(self, X):
        from enstop_torch.models.ensemble import _combine_hellinger_umap

        e, est = self.entry, self.entry.cell.traffic["estimator"]
        n_runs = est["n_starts"]
        stack = [e.ref.topics(e.ref.run(X, e.k, self.seed, i, e.device, n_runs,
                                        mode=e.mode)[1]).float() for i in range(n_runs)]
        self.topic_stack_ = torch.cat(stack)
        combined = _combine_hellinger_umap(self.topic_stack_, est["min_samples"],
                                           est["min_cluster_size"], random_state=self.seed,
                                           device=e.device)
        self.components_ = combined.stable_topics
        self.topic_layout_, self.topic_labels_ = combined.layout, combined.labels
        self.n_components_ = self.components_.shape[0]
        self.embedding_ = e.ref.embedding(X, self.components_, self.seed, e.device,
                                          mode=e.mode).cpu().numpy()
        self.fit_info_ = {"run_steps": None}
        return self


class Entry(load(ROOT, "entries", "ensemble").Entry):
    """The pLSA ensemble's entry (set-up, calls, what a call keeps) with its
    own control and check."""

    def __init__(self, cell, seed, device, variant=None):
        traffic = cell.traffic
        self.cell, self.seed, self.device = cell, seed, device
        self.k = int(cell.config["n_components"])
        self.ref = importlib.import_module(f"reference.{traffic['reference']}")
        self.params = dict(traffic["estimator"], n_components=self.k, device=device)
        self.mode = traffic["control"].get("reference") if variant == "control" else None
        self.infos, self.copies_ms = [], []
        self.kept = Reservoir(int(traffic["check"]["sample"]), seed)

    def _model(self, rs):
        if self.mode is not None:
            return ReferenceEnsemble(self, rs)
        return super()._model(rs)

    def check(self):
        ref, est, check = self.ref, self.cell.traffic["estimator"], self.cell.traffic["check"]
        n_runs, k = int(est["n_starts"]), self.k
        pick = np.random.default_rng([self.seed, 1])
        worst = {}

        def judged(name, value):
            worst[name] = max(worst.get(name, 0.0), float(value))

        for item in self.kept.items:
            rs, stack = item["rs"], item["stack"]
            t0, gaps = time.perf_counter(), []
            for i in sorted(pick.choice(n_runs, int(check["runs"]), replace=False)):
                topics = ref.topics(ref.run(self.X, k, rs, int(i), self.device, n_runs)[1])
                gaps.append(compare.row_l1(stack[i * k:(i + 1) * k].numpy(), topics).cpu())
                del topics
            gaps = torch.cat(gaps)
            judged("run_wz_l1_max", gaps.max())
            judged("run_wz_l1_mean", gaps.mean())
            log(f"check: {len(gaps) // k} runs against the reference in "
                f"{time.perf_counter() - t0:.1f} s")
            dmat = ref.hellinger(stack.to(self.device))
            judged("layout_untrust", 1.0 - ref.trustworthiness(dmat, item["layout"]))
            labels, strengths = ref.clusters_of(item["layout"], est["min_samples"],
                                                est["min_cluster_size"])
            wrong, pairs = ref.match(item["labels"], labels)
            judged("cluster_mismatch", wrong)
            merged = ref.merge(stack.to(self.device), labels, strengths)
            components = item["components"]
            judged("n_components_gap", abs(components.shape[0] - merged.shape[0]))
            paired = {pairs[r]: r for r in range(merged.shape[0]) if r in pairs}
            for p in range(max(components.shape[0], merged.shape[0])):
                r = paired.get(p)
                judged("merge_l1_max", 2.0 if r is None or p >= components.shape[0] else
                       compare.row_l1_max(components[p:p + 1], merged[r:r + 1]))
            t0 = time.perf_counter()
            W = ref.embedding(self.X, components, rs, self.device)
            gaps = ref.relative_row_l1(item["embedding"], W)
            judged("refit_zd_l1_max", gaps.max())
            judged("refit_zd_l1_mean", gaps.mean())
            log(f"check: the embedding against the reference in {time.perf_counter() - t0:.1f} s")
        log(f"check: {len(self.kept.items)} of {self.kept.seen} calls against the reference, "
            f"{int(check['runs'])} runs each; stacks copied to the host "
            f"{len(self.copies_ms)} times, {sum(self.copies_ms):.1f} ms in all")
        return worst
