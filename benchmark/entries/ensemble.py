"""The entry ``ensemble``: ``EnsembleTopics(**estimator).fit(X)`` on the
configuration's corpus, a new ``random_state`` a call, each sampled call
judged stage by stage against ``reference/ensemble.py``.

The mix's keys: ``estimator_class`` (``EnsembleTopics``); ``estimator``, its
parameters, the schedule and the clustering's sizes among them, which the
reference takes too; ``init_pad``, the padding of the layout the runs' init
draws are made at (``reference/ensemble.py``); ``reference``; ``check``:
``sample``, the calls judged, and ``runs``, the runs judged of each;
``control``, the estimator's parameters or the reference's ``mode`` that
put the control in the program's place (with a ``mode`` the reference's runs
and refit in that mode around the program's own combine); ``limits``, and
``limits_why``, each limit's reason.

Set-up makes the corpus, fits the first ``PROBE_DOCS`` documents once to
make sure the program exposes what the check reads (and fails at once where
it does not), and warms one call. A call's check inputs (``topic_stack_``,
``topic_layout_``, ``topic_labels_`` and ``fit_info_["run_steps"]``) are
kept only when the sample keeps the call: its stack then comes to the host,
after the call's stamped time; every call's device stack is let go.

The check, for each kept call: the sampled runs' topics against the
reference's runs from the same weights and init (``run_wz_l1_*``,
``run_steps_gap``); the layout's trustworthiness against the reference's
Hellinger distances of the call's stack (``layout_untrust``, one minus it);
the reference's HDBSCAN on the call's layout against the call's labels
(``cluster_mismatch``, the topics whose cluster differs once the clusters
are paired); the reference's merge of the call's stack by those clusters
against ``components_`` (``merge_l1_max``; a cluster left unpaired reads 2)
and its count against ``n_components_`` (``n_components_gap``); the
reference's refit against ``components_`` (``refit_zd_l1_*``). The worst
kept call counts.
"""

from __future__ import annotations

import importlib
import time

import numpy as np
import torch

from harness import log
from inputs import Reservoir, make_corpus, random_state
from reference import compare

PROBE_DOCS = 2000
CHECKED = ("topic_stack_", "topic_layout_", "topic_labels_")


class ReferenceEnsemble:
    """The control: the reference's runs and refit in ``mode`` around the
    program's own combine."""

    def __init__(self, entry, rs):
        self.entry, self.seed = entry, rs

    def fit(self, X):
        from enstop_torch.models.ensemble import _combine_hellinger_umap

        e, est = self.entry, self.entry.cell.traffic["estimator"]
        schedule = (est["n_iter"], est["n_iter_per_test"], est["tolerance"])
        coo = e.ref.coo_of(X, e.device)
        runs = [e.ref.run(X, e.k, self.seed, i, *schedule, e.device, e.pad, mode=e.mode,
                          coo=coo)[-1] for i in range(est["n_starts"])]
        self.topic_stack_ = torch.cat([c.wz.float() for c in runs])
        combined = _combine_hellinger_umap(self.topic_stack_, est["min_samples"],
                                           est["min_cluster_size"], random_state=self.seed,
                                           device=e.device)
        self.components_ = combined.stable_topics
        self.topic_layout_, self.topic_labels_ = combined.layout, combined.labels
        self.n_components_ = self.components_.shape[0]
        zd = e.ref.refit(X, self.components_, self.seed, e.device, mode=e.mode, coo=coo)[-1].zd
        self.embedding_ = zd.cpu().numpy()
        self.fit_info_ = {"run_steps": [c.n_steps for c in runs]}
        return self


class Entry:
    def __init__(self, cell, seed, device, variant=None):
        traffic = cell.traffic
        self.cell, self.seed, self.device = cell, seed, device
        self.k = int(cell.config["n_components"])
        self.ref = importlib.import_module(f"reference.{traffic['reference']}")
        self.pad = tuple(traffic["init_pad"])
        self.params = dict(traffic["estimator"], n_components=self.k, device=device)
        self.mode = None
        if variant == "control":
            control = traffic["control"]
            self.params.update(control.get("estimator", {}))
            self.mode = control.get("reference")
        self.infos, self.copies_ms = [], []
        self.kept = Reservoir(int(traffic["check"]["sample"]), seed)

    def _model(self, rs):
        if self.mode is not None:
            return ReferenceEnsemble(self, rs)
        import enstop_torch

        return getattr(enstop_torch, self.cell.traffic["estimator_class"])(
            **self.params, random_state=rs)

    def setup(self):
        self.X = make_corpus(self.cell, self.seed, self.device)["train"]
        self.counts = {"nnz": self.X.nnz, "n_docs": self.X.shape[0], "n_words": self.X.shape[1],
                       "k": self.k}
        if self.mode is not None:  # a control needs no warm call
            return
        rs = random_state(self.seed, -1)
        probe = self._model(rs).fit(self.X[:PROBE_DOCS])
        info = getattr(probe, "fit_info_", None)
        missing = [a for a in CHECKED if not hasattr(probe, a)]
        if not isinstance(info, dict) or "trace" not in info or "run_steps" not in info:
            missing.append("fit_info_ with 'trace' and 'run_steps'")
        if missing:
            raise RuntimeError(f"the program does not expose {', '.join(missing)}, which "
                               "this entry's check reads")
        del probe
        self._model(rs).fit(self.X)

    def prepare(self, i):
        return random_state(self.seed, i)

    def call(self, rs):
        return self._model(rs).fit(self.X)

    def keep(self, i, rs, model):
        info = model.fit_info_
        self.infos.append(info if "trace" in info else None)
        item = {"rs": rs, "stack": model.topic_stack_, "layout": model.topic_layout_,
                "labels": model.topic_labels_, "components": model.components_,
                "embedding": model.embedding_, "n_components": model.n_components_,
                "run_steps": info["run_steps"]}
        self.kept.offer(item)
        if any(kept is item for kept in self.kept.items):
            t0 = time.perf_counter()
            item["stack"] = torch.as_tensor(item["stack"]).cpu()
            self.copies_ms.append(1e3 * (time.perf_counter() - t0))
        else:
            item["stack"] = None
        model.topic_stack_ = None  # the window holds one call's device memory

    def release(self):
        pass  # the kept stacks are on the host

    def check(self):
        ref, est, check = self.ref, self.cell.traffic["estimator"], self.cell.traffic["check"]
        schedule = (est["n_iter"], est["n_iter_per_test"], est["tolerance"])
        coo = ref.coo_of(self.X, self.device)
        pick = np.random.default_rng([self.seed, 1])
        worst = {}

        def judged(name, value):
            worst[name] = max(worst.get(name, 0.0), float(value))

        for item in self.kept.items:
            rs, stack = item["rs"], item["stack"].to(self.device)
            for i in sorted(pick.choice(est["n_starts"], int(check["runs"]), replace=False)):
                wz = stack[i * self.k:(i + 1) * self.k].cpu().numpy()
                cands = ref.run(self.X, self.k, rs, int(i), *schedule, self.device, self.pad,
                                coo=coo)
                n_steps = item["run_steps"][i]
                same = [c for c in cands if c.n_steps == n_steps] or cands[-1:]
                best = min(same, key=lambda c: compare.row_l1_max(wz, c.wz))
                gaps = compare.row_l1(wz, best.wz)
                judged("run_wz_l1_max", gaps.max())
                judged("run_wz_l1_mean", gaps.mean())
                judged("run_steps_gap", min(abs(c.n_steps - n_steps) for c in cands))
            dmat = ref.hellinger(stack)
            judged("layout_untrust", 1.0 - ref.trustworthiness(dmat, item["layout"]))
            labels, strengths = ref.clusters_of(item["layout"], est["min_samples"],
                                                est["min_cluster_size"])
            wrong, pairs = ref.match(item["labels"], labels)
            judged("cluster_mismatch", wrong)
            merged = ref.merge(stack, labels, strengths)
            components = item["components"]
            judged("n_components_gap", abs(components.shape[0] - merged.shape[0]))
            paired = {pairs[r]: r for r in range(merged.shape[0]) if r in pairs}
            for p in range(max(components.shape[0], merged.shape[0])):
                r = paired.get(p)
                judged("merge_l1_max", 2.0 if r is None or p >= components.shape[0] else
                       compare.row_l1_max(components[p:p + 1], merged[r:r + 1]))
            cands = ref.refit(self.X, components, rs, self.device, coo=coo)
            judged("refit_zd_l1_max", compare.embedding_gap(item["embedding"], cands))
            judged("refit_zd_l1_mean", min(float(compare.row_l1(item["embedding"], c.zd).mean())
                                           for c in cands))
        log(f"check: {len(self.kept.items)} of {self.kept.seen} calls against the reference, "
            f"{int(check['runs'])} runs each; stacks copied to the host "
            f"{len(self.copies_ms)} times, {sum(self.copies_ms):.1f} ms in all")
        return worst
