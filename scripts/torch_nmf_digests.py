"""The bits and the time of ``EnsembleTopics(model="nmf")`` on one NVIDIA GPU:
a SHA-256 digest of ``components_`` and of ``embedding_`` of whole calls at
``n_components=20`` and every other default, on the corpora of the benchmark's
configurations ``20ng-k20`` and ``nytimes-enstop-nmf-k20`` (the whole UCI
NYTimes shape, 69.7 M nonzeros), made on the card from a fixed seed by
``benchmark/corpora/topic_mixture.py``.

    PYTHONPATH=. python3 scripts/torch_nmf_digests.py [--root CHECKOUT] --out FILE
        [--against FILE] [--parts]

``--root`` names the checkout whose ``enstop_torch`` fits (this one by
default), so that one call on the card can take a parent's and a change's:
run it on the parent's checkout, then on the change's with ``--against`` the
parent's file; it exits 1 if a digest differs. Each call's wall, its stages
(``ensemble_fit.last_timings``), the spans and counters of its trace and the
device's high-water are printed and written beside the digests. ``--parts``
also times one bootstrap run's pieces at NYTimes, as the run makes them: the
host's row resample, ``prepare_sell`` of it, and 200 KL updates.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[1]
CORPUS_SEED = 2023
CALL_SEEDS = (2300000001, 2300000002)
CONFIGS = ("20ng-k20", "nytimes-enstop-k20")  # nytimes-enstop-nmf-k20's corpus is this one's


def digest(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def corpus(config):
    spec = json.loads((HERE / "benchmark" / "configs" / f"{config}.json").read_text())["corpus"]
    path = HERE / "benchmark" / "corpora" / f"{spec['generator']}.py"
    module_spec = importlib.util.spec_from_file_location("topic_mixture", path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    X = module.make(spec, CORPUS_SEED, "cuda")["train"]
    torch.cuda.empty_cache()
    return X


def spans_of(trace):
    """``{span name: seconds}`` summed, and the counters, of a call's trace."""
    out = {}
    for s in trace["spans"]:
        out[s["name"]] = out.get(s["name"], 0.0) + s["end"] - s["start"]
    return {k: round(v, 6) for k, v in out.items()}, trace["counters"]


def one_call(X, seed):
    import enstop_torch
    from enstop_torch.models.ensemble import ensemble_fit

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = enstop_torch.EnsembleTopics(n_components=20, model="nmf", random_state=seed,
                                        device="cuda").fit(X)
    wall = time.perf_counter() - t0
    spans, counters = spans_of(model.fit_info_["trace"])
    return {"seed": seed, "components": digest(model.components_),
            "embedding": digest(model.embedding_), "n_components_": int(model.n_components_),
            "wall_s": round(wall, 4), "last_timings": ensemble_fit.last_timings,
            "spans_s": spans, "counters": counters,
            "peak_gib": round((torch.cuda.max_memory_allocated() - base) / 2**30, 4)}


def parts(X, seed):
    """One bootstrap run's pieces, as ``nmf_topics`` and ``nmf_fit_mu`` make them."""
    from enstop_torch.ops import nmf
    from enstop_torch.ops.sell import prepare_sell

    A = X.astype(np.float32)
    out = {}
    rng = np.random.RandomState(seed)
    t0 = time.perf_counter()
    B = A[rng.randint(0, A.shape[0], size=A.shape[0])]
    out["resample_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    W0, H0 = np.abs(rng.rand(B.shape[0], 20)), np.abs(rng.rand(20, B.shape[1]))
    W = torch.from_numpy(np.array(W0, dtype=np.float32)).cuda()
    H = torch.from_numpy(np.array(H0, dtype=np.float32)).cuda()
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    prep = prepare_sell(B, standardize=False, device="cuda")
    torch.cuda.synchronize()
    out["stage_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(200):
        W, H = nmf._mu_step_kl(prep, W, H, 0.0, 0.0, True)
    torch.cuda.synchronize()
    out["mu_200_s"] = time.perf_counter() - t0
    return {k: round(v, 4) for k, v in out.items()}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(HERE))
    parser.add_argument("--out", required=True)
    parser.add_argument("--against", help="digests of another checkout, to compare with")
    parser.add_argument("--parts", action="store_true")
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import enstop_torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, "enstop_torch from", Path(enstop_torch.__file__).parent, flush=True)
    result = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
              "calls": {}, "digests": {}}
    for config in CONFIGS:
        t0 = time.perf_counter()
        X = corpus(config)
        print(f"{config}: {X.shape[0]} x {X.shape[1]}, nnz {X.nnz}, made in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        one_call(X[:2000], CALL_SEEDS[0])  # builds and loads the kernels
        for seed in CALL_SEEDS:
            call = one_call(X, seed)
            print(json.dumps(call), flush=True)
            result["calls"][f"{config} {seed}"] = call
            for what in ("components", "embedding"):
                result["digests"][f"{config} {seed} {what}"] = call[what]
        if args.parts and config.startswith("nytimes"):
            result["parts"] = parts(X, CALL_SEEDS[0])
            print("one run's parts:", json.dumps(result["parts"]), flush=True)
        del X
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1) + "\n")
    print(len(result["digests"]), "digests written to", args.out)
    if args.against:
        other = json.loads(Path(args.against).read_text())["digests"]
        differ = sorted(key for key in set(other) | set(result["digests"])
                        if other.get(key) != result["digests"].get(key))
        print(f"against {args.against}: {len(other) - len(differ)} of {len(other)} the same"
              + (f"; differ: {', '.join(differ)}" if differ else ""))
        if differ:
            raise SystemExit(1)


if __name__ == "__main__":
    main()
