"""Measurements of the PyTorch port (``enstop_torch``) on one NVIDIA GPU,
beyond what ``chip_smoke.py`` checks.

    PYTHONPATH=. python3 scripts/torch_measure.py [--out FILE]

At the 20-Newsgroups shape (18,846 docs x 25,000 words, k = 20), the two
precisions taking turns so that both see the card in the same state:

* kernels: the CUDA-event mean of 50 launches of each EM kernel mode (em,
  that is the dense B kernel and the word pass, em with the LL, refit; fp32
  and bf16r) in four turns, and of 5 calls of each plain version;
* ``PLSA.fit``, 100 iterations, a test every 10: wall, EM-loop wall and final
  LL;
* ``EnsembleTopics(n_components=20, n_starts=16, n_iter=80, random_state=0)
  .fit_transform``, warm: wall, ``last_timings``, ``n_components_``, and the
  ``transform`` of 2,000 documents;
* the combine stage in parts, on the topic stack of the ensemble's runs:
  Hellinger matrix, UMAP with the device layout and with the host layout,
  HDBSCAN on the device layout's embedding, merge;
* the device busy share of each ensemble stage (runs, combine, refit) in two
  ``fit_transform`` turns: each stage in a ``torch.profiler`` session of its
  own, the union of its device events' intervals over the stage's host wall.
  The profiler's own cost on the host is inside that wall.

Prints one line per measurement and writes them all as JSON to ``--out``.
Needs a CUDA device and ``nvidia-smi``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import enstop_torch  # noqa: E402
from enstop_torch.cluster.distances import all_pairs_hellinger_distance  # noqa: E402
from enstop_torch.cluster.hdbscan import HDBSCAN  # noqa: E402
from enstop_torch.cluster.umap import umap_embed  # noqa: E402
from enstop_torch.models import ensemble as ens  # noqa: E402
from enstop_torch.ops import cuda_em, em  # noqa: E402
from enstop_torch.synthetic import twenty_newsgroups_shape  # noqa: E402

K = 20
N_TRANSFORM = 2000
ENSEMBLE = dict(n_components=K, n_starts=16, n_iter=80, random_state=0)
PRECISIONS = ("default", "fast")
STAGES = ("runs", "combine", "refit")
TURNS = 3  # of the fits, ensembles and combine parts; two of the profiled ensembles


def sync():
    torch.cuda.synchronize()


def timed(fn):
    """Wall seconds of ``fn()`` up to a device synchronise, and its result."""
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return time.perf_counter() - t0, out


def cuda_ms(fn, reps):
    fn()
    sync()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def factors(X, seed=2):
    rng = np.random.RandomState(seed)
    n_pad, m_pad = X.shape
    kp = -(-K // 8) * 8
    zd = torch.zeros((n_pad, kp), device=X.device)
    zd[:, :K] = torch.from_numpy(rng.rand(n_pad, K).astype(np.float32) + 0.01).to(X.device)
    wz = torch.zeros((kp, m_pad), device=X.device)
    wz[:K] = torch.from_numpy(rng.rand(K, m_pad).astype(np.float32) + 0.01).to(X.device)
    zd /= zd.sum(1, keepdim=True)
    wz /= wz.sum(1, keepdim=True)
    return zd, wz, torch.ones(n_pad, device=X.device)


def measure_kernels(prep, out):
    Xd = prep.device_array
    zd, wz, w = factors(Xd)
    modes = {}
    for suffix, precision in (("", "default"), ("_bf16r", "fast")):
        modes["em" + suffix] = lambda p=precision: cuda_em.em_accumulators_fused(
            Xd, zd, wz, w, compute_ll=False, precision=p, word=prep.word)
        modes["em" + suffix + "_ll"] = lambda p=precision: cuda_em.em_accumulators_fused(
            Xd, zd, wz, w, compute_ll=True, precision=p, word=prep.word)
        modes["refit" + suffix] = lambda p=precision: cuda_em.refit_accumulators_fused(
            Xd, zd, wz, w, compute_ll=False, precision=p)
    kernel_ms = {name: [] for name in modes}
    for _ in range(4):
        for name, fn in modes.items():
            kernel_ms[name].append(cuda_ms(fn, 50))
    plain = {"em": em.em_accumulators_dense, "em_bf16r": em.em_accumulators_bf16r,
             "refit": em.refit_accumulators_dense, "refit_bf16r": em.refit_accumulators_bf16r}
    plain_ms = {name: cuda_ms(lambda f=f: f(Xd, zd, wz, w), 5) for name, f in plain.items()}
    out["kernel_ms"], out["plain_ms"] = kernel_ms, plain_ms
    print("kernel ms at 20NG, bf16 X (4 turns of 50 launches):", json.dumps(kernel_ms))
    print("plain ms at 20NG (5 calls):", json.dumps(plain_ms))


def measure_plsa(X, turns, out):
    def fit(precision):
        return enstop_torch.PLSA(n_components=K, n_iter=100, n_iter_per_test=10, tolerance=0,
                                 random_state=0, precision=precision, device="cuda").fit(X)

    for precision in PRECISIONS:  # warm-up
        fit(precision)
    rec = {p: [] for p in PRECISIONS}
    for _ in range(turns):
        for precision in PRECISIONS:
            wall, model = timed(lambda: fit(precision))
            rec[precision].append({"fit_s": wall, "loop_s": model.fit_info_["wall_time_s"],
                                   "final_ll": model.fit_info_["log_likelihood"]})
    out["plsa"] = rec
    print("PLSA.fit, 100 iterations, warm:", json.dumps(rec))


def measure_ensembles(X, docs, turns, out):
    def fit(precision):
        model = enstop_torch.EnsembleTopics(precision=precision, device="cuda", **ENSEMBLE)
        model.fit_transform(X)
        return model

    first = {}
    for precision in PRECISIONS:  # the first ensemble of the process is slower
        wall, _ = timed(lambda: fit(precision))
        first[precision] = {"fit_transform_s": wall, **ens.ensemble_fit.last_timings}
    rec = {p: [] for p in PRECISIONS}
    for _ in range(turns):
        for precision in PRECISIONS:
            wall, model = timed(lambda: fit(precision))
            stages = dict(ens.ensemble_fit.last_timings)
            transform_s, _ = timed(lambda: model.transform(docs))
            rec[precision].append({"fit_transform_s": wall, "transform_s": transform_s,
                                   "n_components_": model.n_components_, **stages})
    out["ensemble_first"], out["ensemble"] = first, rec
    print("ensemble, first of the process:", json.dumps(first))
    print("ensemble, warm, in turns:", json.dumps(rec))


def measure_combine_parts(X, turns, out):
    prepared = enstop_torch.prepare_counts(X.astype(np.float32), standardize=False,
                                           device="cuda")
    stack = ens._ensemble_of_topics_device(
        None, K, n_runs=ENSEMBLE["n_starts"], parallelism="weights", n_iter=ENSEMBLE["n_iter"],
        random_state=ENSEMBLE["random_state"], precision="fast", prepared=prepared,
        device="cuda")
    layout = dict(n_components=5, n_neighbors=15, random_state=ENSEMBLE["random_state"],
                  device="cuda")
    parts = {name: [] for name in ("hellinger", "umap_device", "umap_host", "hdbscan",
                                   "merge")}
    for _ in range(turns):
        wall, dmat = timed(lambda: all_pairs_hellinger_distance(stack))
        parts["hellinger"].append(wall)
        wall, embedding = timed(lambda: umap_embed(dmat=dmat, **layout))
        parts["umap_device"].append(wall)
        parts["umap_host"].append(timed(lambda: umap_embed(dmat=dmat, layout="host",
                                                           **layout))[0])
        wall, clusterer = timed(lambda: HDBSCAN(
            min_samples=3, min_cluster_size=5, cluster_selection_method="leaf",
            allow_single_cluster=True).fit(embedding))
        parts["hdbscan"].append(wall)
        labels, strengths = clusterer.labels_, clusterer.probabilities_
        if labels.max() < 0:
            labels, strengths = np.zeros(len(labels), np.intp), np.ones(len(labels))
        parts["merge"].append(timed(lambda: ens._merge_topics_by_label(stack, labels,
                                                                       strengths))[0])
    out["combine_parts_s"] = parts
    print("combine stage in parts, fast stack (s):", json.dumps(parts))


def _union_us(intervals):
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(intervals):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy


def measure_busy(X, turns, out):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rec = {}

    def staged(name, fn):
        """Run one stage in a profiler session of its own, so its device
        events need no alignment with the host's clock."""
        def run(*args, **kwargs):
            sync()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                result = fn(*args, **kwargs)
                sync()
                span = time.perf_counter() - t0
            # the synchronise waits sit on the device timeline but do no work
            kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                       and "ynchroniz" not in e.name]
            busy = _union_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e6
            by_name = {}
            for e in kernels:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            top = sorted(by_name.items(), key=lambda item: -item[1])[:4]
            rec[precision][name].append({
                "span_s": span, "busy_s": busy, "busy_share": busy / span,
                "device_events": len(kernels), "top_ms": [(n[:80], ms) for n, ms in top]})
            return result
        return run

    originals = (ens._ensemble_of_topics_device, ens._topic_combiner["hellinger_umap"],
                 ens.plsa_refit)
    ens._ensemble_of_topics_device = staged("runs", originals[0])
    ens._topic_combiner["hellinger_umap"] = staged("combine", originals[1])
    ens.plsa_refit = staged("refit", originals[2])
    try:
        for _ in range(turns):
            for precision in PRECISIONS:
                rec.setdefault(precision, {stage: [] for stage in STAGES})
                enstop_torch.EnsembleTopics(precision=precision, device="cuda",
                                            **ENSEMBLE).fit_transform(X)
    finally:
        (ens._ensemble_of_topics_device, ens._topic_combiner["hellinger_umap"],
         ens.plsa_refit) = originals
    out["busy"] = rec
    print("device busy share by ensemble stage, each under torch.profiler:", json.dumps(rec))


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="chiprun_out/torch_measure.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_measure.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    out = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}
    print(card, f"torch {torch.__version__} cuda {torch.version.cuda}")

    X, _ = twenty_newsgroups_shape(seed=0)
    docs = X[:N_TRANSFORM]
    prep = enstop_torch.prepare_counts(X, device="cuda")
    measure_kernels(prep, out)
    del prep
    measure_plsa(X, TURNS, out)
    measure_ensembles(X, docs, TURNS, out)
    measure_combine_parts(X, TURNS, out)
    measure_busy(X, 2, out)

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
