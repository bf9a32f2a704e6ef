"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA EM kernels from ``enstop_torch/ops/csrc`` and checks each one
against its plain PyTorch version on the card. Then it drives the main path, a
``PLSA.fit`` at the 20-Newsgroups shape (18,846 docs x 25,000 words, k = 20,
100 iterations) followed by ``transform`` on 2,000 documents, and checks that
every kernel of that path was launched and that the results agree with the
plain path on the card. Prints one line per phase, then a JSON line with each
kernel's launches, error and time, and last a JSON line with the device.
Exits non-zero, with no result line, when anything fails or no GPU is present.

Tolerances: A and B are held to 1e-4 relative and the log-likelihood to 1e-5
relative (max |kernel - plain| / max |plain|). The kernel sums A and the LL
with atomics, in another order than the plain matmuls. The fit's final LL is
held to 1e-4 relative of a plain fit from the same initial factors.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

A_B_RTOL, LL_RTOL, FIT_LL_RTOL, EMBED_ATOL = 1e-4, 1e-5, 1e-4, 1e-4
N_TRANSFORM = 2000  # documents embedded by the transform phase
KERNEL_SOURCE = "enstop_torch/ops/csrc/em_dense.cu"
REPLACES = {
    "em": "enstop_tpu/ops/pallas_em.py:176",
    "refit": "enstop_tpu/ops/pallas_em.py:224",
    "ll": "enstop_tpu/ops/pallas_em.py:255",
}


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def rel_err(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def abs_err(*pairs):
    return max(float((got.float() - want.float()).abs().max()) for got, want in pairs)


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def problem(X, k, weighted, seed):
    """Random padded factors (and weights) for a padded count matrix X."""
    rng = np.random.RandomState(seed)
    n_pad, m_pad = X.shape
    kp = -(-k // 8) * 8
    zd = torch.zeros((n_pad, kp), device=X.device)
    zd[:, :k] = torch.from_numpy(rng.rand(n_pad, k).astype(np.float32) + 0.01).to(X.device)
    wz = torch.zeros((kp, m_pad), device=X.device)
    wz[:k] = torch.from_numpy(rng.rand(k, m_pad).astype(np.float32) + 0.01).to(X.device)
    zd /= zd.sum(1, keepdim=True)
    wz /= wz.sum(1, keepdim=True).clamp_min(1e-30)
    w = torch.from_numpy(rng.uniform(0.5, 1.5, n_pad).astype(np.float32)).to(X.device)
    return zd, wz, (w if weighted else None)


def compare_kernels(name, X, k, cuda_em, em):
    """Phase 2 on one padded X: every kernel mode against its plain version.
    Returns each kernel's largest absolute error: on A and B for the EM
    kernel, on B for the refit kernel, on the LL for the LL kernel (the LL
    outputs of the first two are held to LL_RTOL relative)."""
    worst = {"em": 0.0, "refit": 0.0, "ll": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        Xt = X.to(dtype)
        for weighted in (False, True):
            zd, wz, w = problem(Xt, k, weighted, seed=1)
            A0, B0, ll0 = em.em_accumulators_dense(Xt, zd, wz, w)
            for compute_ll in (False, True):
                A, B, ll = cuda_em.em_accumulators_fused(Xt, zd, wz, w, compute_ll=compute_ll)
                torch.cuda.synchronize()
                ea, eb = rel_err(A, A0), rel_err(B, B0)
                el = rel_err(ll, ll0) if compute_ll else 0.0
                print(f"  {name} em {str(dtype)[6:]} weighted={weighted} "
                      f"compute_ll={compute_ll}: rel err A {ea:.3e} B {eb:.3e} ll {el:.3e}")
                check(ea <= A_B_RTOL and eb <= A_B_RTOL and el <= LL_RTOL, f"{name} em kernel")
                check(compute_ll or float(ll) == 0.0, "ll is 0 with compute_ll=False")
                worst["em"] = max(worst["em"], abs_err((A, A0), (B, B0)))
            B0r, ll0r = em.refit_accumulators_dense(Xt, zd, wz, w)
            for compute_ll in (False, True):
                B, ll = cuda_em.refit_accumulators_fused(Xt, zd, wz, w, compute_ll=compute_ll)
                torch.cuda.synchronize()
                eb, el = rel_err(B, B0r), (rel_err(ll, ll0r) if compute_ll else 0.0)
                print(f"  {name} refit {str(dtype)[6:]} weighted={weighted} "
                      f"compute_ll={compute_ll}: rel err B {eb:.3e} ll {el:.3e}")
                check(eb <= A_B_RTOL and el <= LL_RTOL, f"{name} refit kernel")
                worst["refit"] = max(worst["refit"], abs_err((B, B0r)))
            ll, ll0 = (cuda_em.log_likelihood_fused(Xt, zd, wz, w),
                       em.log_likelihood_dense(Xt, zd, wz, w))
            torch.cuda.synchronize()
            el = rel_err(ll, ll0)
            print(f"  {name} ll {str(dtype)[6:]} weighted={weighted}: rel err ll {el:.3e}")
            check(el <= LL_RTOL, f"{name} ll kernel")
            worst["ll"] = max(worst["ll"], abs_err((ll, ll0)))
    return worst


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    import enstop_torch
    check(Path(enstop_torch.__file__).resolve().parents[1] == Path(__file__).resolve().parent,
          "enstop_torch is imported from the checkout that holds this script")
    from enstop_torch.ops import _build, cuda_em, driver
    from enstop_torch.ops import em
    from enstop_torch.ops.init import plsa_init
    from enstop_torch.convert import pad_state
    from enstop_torch.synthetic import twenty_newsgroups_shape

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions run full fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # -- phase 1: device, versions, kernel build ------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.library("em_dense")
    build = _build.BUILD_LOG.get("em_dense")
    if build is None:  # an earlier run in this checkout left the library
        print(f"phase 1 build: em_dense loaded from enstop_torch/_build in "
              f"{time.perf_counter() - t0:.2f} s")
    else:
        registers = [int(r) for r in re.findall(r"Used (\d+) registers", build["report"])]
        spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", build["report"])]
        print(f"phase 1 build: em_dense built and loaded in {time.perf_counter() - t0:.2f} s "
              f"(nvcc {build['seconds']:.2f} s); ptxas: {len(registers)} kernel instances, "
              f"at most {max(registers)} registers a thread, {sum(s > 0 for s in spills)} "
              f"with spill stores (at most {max(spills)} B)")

    # -- phase 2: each kernel against its plain version -----------------------
    rng = np.random.RandomState(0)
    small = np.zeros((208, 768), np.float32)  # 203 x 650 ragged, padded
    small[:203, :650] = (rng.rand(203, 650) < 0.03) * rng.randint(1, 6, (203, 650))
    compare_kernels("small 203x650 k=20", torch.from_numpy(small).to(dev), 20, cuda_em, em)

    t0 = time.perf_counter()
    X, _labels = twenty_newsgroups_shape(seed=0)
    print(f"corpus: {X.shape[0]} x {X.shape[1]}, nnz {X.nnz}, "
          f"made in {time.perf_counter() - t0:.2f} s")
    prep = enstop_torch.prepare_counts(X, device=dev)
    Xd = prep.device_array
    check(Xd.dtype == torch.bfloat16, "20NG counts stage as bf16")
    docs = X[:N_TRANSFORM]
    batch = enstop_torch.prepare_counts(docs, device=dev).device_array
    # the main path's shapes: the fit's EM steps run on the whole corpus, the
    # transform's refit and LL kernels on the batch
    worst = compare_kernels(f"20NG {Xd.shape[0]}x{Xd.shape[1]} k=20", Xd, 20, cuda_em, em)
    for name, err in compare_kernels(f"batch {batch.shape[0]}x{batch.shape[1]} k=20", batch,
                                     20, cuda_em, em).items():
        worst[name] = max(worst[name], err)
    print("phase 2 kernels vs plain: ok, largest abs err", json.dumps(worst))

    zd, wz, _ = problem(Xd, 20, False, seed=2)
    w1 = torch.ones(Xd.shape[0], device=dev)
    timing = {
        "em": (cuda_ms(lambda: cuda_em.em_accumulators_fused(Xd, zd, wz, w1, compute_ll=False), 50),
               cuda_ms(lambda: em.em_accumulators_dense(Xd, zd, wz, w1), 5)),
        "refit": (cuda_ms(lambda: cuda_em.refit_accumulators_fused(Xd, zd, wz, w1,
                                                                   compute_ll=False), 50),
                  cuda_ms(lambda: em.refit_accumulators_dense(Xd, zd, wz, w1), 5)),
        "ll": (cuda_ms(lambda: cuda_em.log_likelihood_fused(Xd, zd, wz, w1), 50),
               cuda_ms(lambda: em.log_likelihood_dense(Xd, zd, wz, w1), 5)),
    }
    for name, (ms, plain_ms) in timing.items():
        print(f"  time at 20NG, bf16 X: {name} kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    zd_b, wz_b, _ = problem(batch, 20, False, seed=3)
    w_b = torch.ones(batch.shape[0], device=dev)
    for name, kernel, plain_fn in (
            ("refit", lambda: cuda_em.refit_accumulators_fused(batch, zd_b, wz_b, w_b,
                                                               compute_ll=False),
             lambda: em.refit_accumulators_dense(batch, zd_b, wz_b, w_b)),
            ("ll", lambda: cuda_em.log_likelihood_fused(batch, zd_b, wz_b, w_b),
             lambda: em.log_likelihood_dense(batch, zd_b, wz_b, w_b))):
        print(f"  time at the {N_TRANSFORM}-doc batch, bf16 X: {name} kernel "
              f"{cuda_ms(kernel, 50):.4f} ms, plain {cuda_ms(plain_fn, 5):.4f} ms")

    # -- phase 3 + 4: the main path, fit then transform -----------------------
    for key in cuda_em.LAUNCHES:
        cuda_em.LAUNCHES[key] = 0
    for key in em.CALLS:
        em.CALLS[key] = 0
    t0 = time.perf_counter()
    model = enstop_torch.PLSA(n_components=20, n_iter=100, n_iter_per_test=10, tolerance=0,
                              random_state=0, device="cuda").fit(X)
    fit_wall = time.perf_counter() - t0
    fit_launches = dict(cuda_em.LAUNCHES)
    t0 = time.perf_counter()
    embedding = model.transform(docs)
    transform_wall = time.perf_counter() - t0
    launches = dict(cuda_em.LAUNCHES)
    plain_calls = dict(em.CALLS)
    print(f"phase 3 fit: {fit_wall:.3f} s wall ({model.fit_info_['wall_time_s']:.3f} s in the "
          f"EM loop), n_iter_ {model.n_iter_}, launches {json.dumps(fit_launches)}")
    print(f"phase 4 transform: {N_TRANSFORM} docs in {transform_wall:.3f} s wall, "
          f"launches after fit + transform {json.dumps(launches)}, plain calls "
          f"{json.dumps(plain_calls)}")
    check(fit_launches["em"] >= 100, "the fit launched the EM kernel at least 100 times")
    check(launches["refit"] > fit_launches["refit"], "transform launched the refit kernel")
    check(launches["ll"] > fit_launches["ll"], "transform launched the LL kernel")
    check(all(v == 0 for v in plain_calls.values()), "the main path made no plain call")
    check(model.n_iter_ == 100, "n_iter_ == 100")
    hist = np.asarray(model.history_)
    check(hist.shape == (11,) and np.all(np.isfinite(hist)), "history_ has 11 finite entries")
    check(hist[-1] > hist[0], "history_ rises overall")
    check(model.components_.shape == (20, X.shape[1]) and embedding.shape == (N_TRANSFORM, 20),
          "output shapes")
    check(np.all(np.isfinite(model.components_)) and np.all(np.isfinite(embedding)),
          "finite outputs")
    check(np.allclose(model.components_.sum(1), 1, atol=1e-4), "topics are distributions")

    # the plain path on the card, from the same initial factors
    zd0, wz0 = plsa_init(X, 20, rng=np.random.RandomState(0))
    zd_p, wz_p = pad_state(zd0, wz0, *Xd.shape, dev)
    plain = driver.fit_padded(Xd, zd_p, wz_p, w1, 100, 10, 0.0, driver.plain_steps())
    fit_gap = abs(plain.final_ll - model.fit_info_["log_likelihood"]) / abs(plain.final_ll)
    print(f"  final LL kernel {model.fit_info_['log_likelihood']:.6f} plain "
          f"{plain.final_ll:.6f} rel gap {fit_gap:.3e}; history kernel {hist.tolist()}")
    check(plain.n_steps == 100 and fit_gap <= FIT_LL_RTOL, "fit LL agrees with the plain fit")

    r0 = np.random.RandomState(model.transform_random_seed).rand(N_TRANSFORM, 20)
    r0 = (r0 / r0.sum(axis=1, keepdims=True)).astype(np.float32)
    zd_r, wz_r = pad_state(r0, model.components_, *batch.shape, dev)
    plain_r = driver.refit_padded(batch, zd_r, wz_r, w_b, 50, 5, 0.001, driver.plain_steps())
    plain_embedding = plain_r.state[0][:N_TRANSFORM, :20].cpu().numpy()
    embed_err = float(np.abs(embedding - plain_embedding).max())
    print(f"  transform max abs err vs plain refit {embed_err:.3e} "
          f"(plain refit steps {plain_r.n_steps})")
    check(embed_err <= EMBED_ATOL, "transform agrees with the plain refit")

    step_ms = {}
    for label, steps in (("kernel", driver.kernel_steps()), ("plain", driver.plain_steps())):
        state = (zd_p, wz_p)
        for _ in range(3):
            state = steps["em"](Xd, *state, w1)[:2]
        float(state[0][0, 0])
        t0 = time.perf_counter()
        for _ in range(20):
            state = steps["em"](Xd, *state, w1)[:2]
        float(state[0][0, 0])  # host readback
        step_ms[label] = (time.perf_counter() - t0) / 20 * 1e3
    print(f"  EM step at 20NG, warm, to a host readback: kernel {step_ms['kernel']:.4f} ms/iter, "
          f"plain {step_ms['plain']:.4f} ms/iter")

    print(json.dumps({"kernels": [
        {"name": f"em_dense_{name}", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": worst[name], "ms": timing[name][0], "plain_ms": timing[name][1]}
        for name in ("em", "refit", "ll")
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
