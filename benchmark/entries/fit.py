"""The entry ``fit``: ``<estimator_class>(**estimator).fit(X)`` on the
configuration's corpus, a new ``random_state`` a call, each fitted model
judged against the mix's reference.

The mix's keys: ``estimator_class``, a class of ``enstop_torch`` with the
pLSA estimator's fitted attributes (``embedding_``, ``components_``,
``n_iter_``; ``fit_info_`` where it keeps one); ``estimator``, its
parameters (``n_iter``, ``n_iter_per_test`` and ``tolerance`` are handed to
the reference too); ``reference``, the module of ``benchmark/reference``
whose ``fit`` follows the same schedule; ``check.sample``, the fits judged;
``control``, the estimator's parameters or the reference's ``mode`` that
put the control in the program's place; ``limits``.

Set-up makes the corpus and, for the program, warms one fit. The check
judges a sample of the fits drawn from the seed, after the window, by
``reference/compare.py``'s ``fit_gaps``: the worst sampled fit counts.
"""

from __future__ import annotations

import importlib

from harness import log
from inputs import Reservoir, make_corpus, random_state
from reference import compare


class ReferenceModel:
    """The reference in the program's place (a control): ``fit`` as the
    estimator's, in the reference's ``mode``."""

    def __init__(self, ref, mode, device, n_components, random_state, n_iter,
                 n_iter_per_test, tolerance, **_):
        self.ref, self.mode, self.device = ref, mode, device
        self.k, self.seed = n_components, random_state
        self.schedule = (n_iter, n_iter_per_test, tolerance)

    def fit(self, X):
        last = self.ref.fit(X, self.k, self.seed, *self.schedule, self.device,
                            mode=self.mode)[-1]
        self.embedding_, self.components_ = last.zd.cpu().numpy(), last.wz.cpu().numpy()
        self.n_iter_, self.fit_info_ = last.n_steps, None
        return self


class Entry:
    def __init__(self, cell, seed, device, variant=None):
        traffic = cell.traffic
        self.cell, self.seed, self.device = cell, seed, device
        self.k = int(cell.config["n_components"])
        self.ref = importlib.import_module(f"reference.{traffic['reference']}")
        self.params = dict(traffic["estimator"], n_components=self.k, device=device)
        self.reference_mode = None
        if variant == "control":
            control = traffic["control"]
            self.params.update(control.get("estimator", {}))
            self.reference_mode = control.get("reference")
        self.infos = []
        self.kept = Reservoir(int(traffic["check"]["sample"]), seed)

    def _model(self, rs):
        if self.reference_mode is not None:
            return ReferenceModel(self.ref, self.reference_mode, random_state=rs, **self.params)
        import enstop_torch

        return getattr(enstop_torch, self.cell.traffic["estimator_class"])(
            **self.params, random_state=rs)

    def setup(self):
        self.X = make_corpus(self.cell, self.seed, self.device)["train"]
        self.counts = {"nnz": self.X.nnz, "n_docs": self.X.shape[0], "n_words": self.X.shape[1],
                       "k": self.k}
        if self.reference_mode is None:  # a control needs no warm call
            self._model(random_state(self.seed, -1)).fit(self.X)

    def prepare(self, i):
        return random_state(self.seed, i)

    def call(self, rs):
        return self._model(rs).fit(self.X)

    def keep(self, i, rs, model):
        self.infos.append(getattr(model, "fit_info_", None))
        self.kept.offer((rs, model.embedding_, model.components_, model.n_iter_))

    def release(self):
        pass  # a fitted model holds numpy arrays only

    def check(self):
        est = self.cell.traffic["estimator"]
        worst = {}
        for rs, zd, wz, n_steps in self.kept.items:
            cands = self.ref.fit(self.X, self.k, rs, est["n_iter"], est["n_iter_per_test"],
                                 est["tolerance"], self.device)
            for name, value in compare.fit_gaps(zd, wz, n_steps, cands).items():
                worst[name] = max(worst.get(name, 0.0), value)
        log(f"check: {len(self.kept.items)} of {self.kept.seen} fits against the reference")
        return worst
