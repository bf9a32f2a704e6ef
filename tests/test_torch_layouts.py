"""Each staged layout's fit, refit and ensemble runs against its direct entry
point, bit for bit, on the CPU.

``plsa_fit``, ``plsa_refit`` and ``ensemble_of_topics(parallelism="weights")``
run one body for both layouts and ask the staged corpus which one it is. Here
each is held to what that layout's own loop gives from the same draws: on the
dense layout :func:`~enstop_torch.ops.driver.fit_padded` and
:func:`~enstop_torch.ops.driver.refit_padded` on
:func:`~enstop_torch.ops.driver.kernel_steps`, on the sparse one
:func:`~enstop_torch.ops.sell.sell_fit` and
:func:`~enstop_torch.ops.sell.sell_refit`. The routing cases hold each
(input, backend, threshold) to the layout it must run on: a
:class:`~enstop_torch.PreparedCounts` stays dense whatever the threshold or
backend, a :class:`~enstop_torch.PreparedSell` stays sparse, and raw input
goes sparse under ``backend="auto"`` only above 1e-30. This file imports no
JAX.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import enstop_torch
from enstop_torch.models.ensemble import bootstrap_inputs, ensemble_of_topics
from enstop_torch.ops.data import pad_factors, pad_vector
from enstop_torch.ops.driver import (fit_padded, kernel_steps, plsa_fit, plsa_refit,
                                     refit_padded)
from enstop_torch.ops.init import plsa_init
from enstop_torch.ops.sell import sell_fit, sell_refit

K, SEED = 4, 11
SCHEDULE = dict(n_iter=30, n_iter_per_test=5, tolerance=0.0)
# the sparse cases apply a threshold that fires, which the dense layout has not
THRESH = {"dense": 1e-32, "sparse": 1e-3}
BACKEND = {"dense": "auto", "sparse": "sparse"}


def _corpus(n=60, m=90):
    X = np.random.RandomState(0).poisson(0.7, (n, m)).astype(np.int64)
    X[:, 0] += 1  # no empty document
    return sp.csr_matrix(X)


def _weights(n):
    return (np.random.RandomState(1).rand(n) + 0.5).astype(np.float32)


def _topics(m):
    t = np.random.RandomState(2).rand(K, m).astype(np.float32)
    return t / t.sum(axis=1, keepdims=True)


def _prepared(layout, X):
    if layout == "dense":
        return enstop_torch.prepare_counts(X, standardize=False, device="cpu")
    return enstop_torch.prepare_sell(X, standardize=False, device="cpu")


def _direct_fit(layout, X, prep, w, thresh):
    """The layout's own fit loop from ``plsa_fit``'s init draw."""
    zd0, wz0 = plsa_init(X, K, init="random", rng=np.random.RandomState(SEED))
    if layout == "sparse":
        zd, wz, n_steps, *_ = sell_fit(prep, zd0, wz0, sample_weight=w, e_step_thresh=thresh,
                                       **SCHEDULE)
        return zd.numpy(), wz.numpy(), n_steps
    Xd = prep.device_array
    zd, wz = (torch.from_numpy(a) for a in pad_factors(zd0, wz0, *Xd.shape))
    res = fit_padded(Xd, zd, wz, torch.from_numpy(pad_vector(w, Xd.shape[0])),
                     SCHEDULE["n_iter"], SCHEDULE["n_iter_per_test"], SCHEDULE["tolerance"],
                     kernel_steps("default", prep.word))
    return res.state[0][:prep.n, :K].numpy(), res.state[1][:K, :prep.m].numpy(), res.n_steps


def _direct_refit(layout, prep, topics, w, thresh):
    """The layout's own refit loop from ``plsa_refit``'s init draw."""
    zd0 = np.random.RandomState(SEED).rand(prep.n, K)
    zd0 = (zd0 / zd0.sum(axis=1, keepdims=True)).astype(np.float32)
    if layout == "sparse":
        return sell_refit(prep, zd0, topics, sample_weight=w, e_step_thresh=thresh)[0].numpy()
    Xd = prep.device_array
    zd, wz = (torch.from_numpy(a) for a in pad_factors(zd0, topics, *Xd.shape))
    res = refit_padded(Xd, zd, wz, torch.from_numpy(pad_vector(w, Xd.shape[0])), 50, 10, 0.005,
                       kernel_steps("default"))
    return res.state[0][:prep.n, :K].numpy()


def _direct_runs(layout, prep, n_runs):
    """The bootstrap runs as a loop of the layout's own fit over
    ``bootstrap_inputs``, from ``ensemble_of_topics``'s draws."""
    topics = []
    for zd, wz, w in bootstrap_inputs(prep, K, n_runs, np.random.RandomState(SEED)):
        if layout == "sparse":
            topics.append(sell_fit(prep, zd, wz, sample_weight=w, n_iter=20)[1])
        else:
            res = fit_padded(prep.device_array, zd, wz, w, 20, 10, 0.001,
                             kernel_steps("default", prep.word))
            topics.append(res.state[1][:K, :prep.m])
    return torch.cat(topics).numpy()


@pytest.mark.parametrize("path", ["fit", "refit", "runs"])
@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_each_path_is_its_layouts_own_loop(layout, path):
    X = _corpus()
    prep = _prepared(layout, X)
    w, thresh, backend = _weights(X.shape[0]), THRESH[layout], BACKEND[layout]
    if path == "fit":
        zd, wz, info = plsa_fit(X, K, sample_weight=w, e_step_thresh=thresh, random_state=SEED,
                                backend=backend, return_info=True, device="cpu", **SCHEDULE)
        want_zd, want_wz, n_steps = _direct_fit(layout, X, prep, w, thresh)
        np.testing.assert_array_equal(zd, want_zd)
        np.testing.assert_array_equal(wz, want_wz)
        assert info["n_steps"] == n_steps
        assert info["backend"] == ("sparse" if layout == "sparse" else "torch")
    elif path == "refit":
        topics = _topics(X.shape[1])
        got = plsa_refit(X, topics, sample_weight=w, e_step_thresh=thresh, random_state=SEED,
                         backend=backend, device="cpu")
        np.testing.assert_array_equal(got, _direct_refit(layout, prep, topics, w, thresh))
    else:
        got = ensemble_of_topics(X, K, n_runs=3, parallelism="weights", random_state=SEED,
                                 backend=backend, n_iter=20, device="cpu")
        np.testing.assert_array_equal(got, _direct_runs(layout, prep, 3))


# (input, backend, e_step_thresh) -> the layout the fit must run on
ROUTES = [
    ("raw", "auto", 1e-32, "dense"),
    ("raw", "auto", 1e-30, "dense"),
    ("raw", "auto", 1e-16, "sparse"),
    ("raw", "torch", 1e-16, "dense"),
    ("raw", "sparse", 1e-32, "sparse"),
    ("counts", "auto", 1e-16, "dense"),
    ("counts", "sparse", 1e-16, "dense"),
    ("sell", "auto", 1e-32, "sparse"),
    ("sell", "torch", 1e-16, "sparse"),
]


@pytest.mark.parametrize("given,backend,thresh,layout", ROUTES)
def test_the_route_picks_the_layout(given, backend, thresh, layout):
    X = _corpus()
    data = {"raw": X, "counts": _prepared("dense", X), "sell": _prepared("sparse", X)}[given]
    w = _weights(X.shape[0])
    zd, wz, info = plsa_fit(data, K, sample_weight=w, e_step_thresh=thresh, random_state=SEED,
                            backend=backend, return_info=True, device="cpu", **SCHEDULE)
    prep = data if given != "raw" else _prepared(layout, X)
    want_zd, want_wz, _ = _direct_fit(layout, X, prep, w, thresh)
    np.testing.assert_array_equal(zd, want_zd)
    np.testing.assert_array_equal(wz, want_wz)
    assert info["backend"] == ("sparse" if layout == "sparse" else "torch")
