"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA EM kernels from ``enstop_torch/ops/csrc`` and checks each one
(the fp32 modes and the bf16-responsibilities modes of ``precision="fast"``)
against its plain PyTorch version on the card. Then it drives the main paths
at the 20-Newsgroups shape (18,846 docs x 25,000 words, k = 20), each with the
launch counts set to 0 just before it and read just after:

1. ``PLSA.fit`` (100 iterations) and ``transform`` on 2,000 documents;
2. the same at ``precision="fast"``;
3. ``EnsembleTopics(n_components=20, n_starts=16, n_iter=80,
   precision="fast").fit_transform`` on the whole corpus, then ``transform``
   on 2,000 documents;
4. the same ensemble at ``precision="default"``.

It checks that every kernel of each path was launched, that no plain op was
called, and that the results agree with the plain path on the card, and it
holds the ensemble's combine stage on the card (Hellinger matrix, merge, UMAP
layout) against the host. Prints one line per phase, then a JSON line with
each kernel's launches, error and time, and last a JSON line with the device.
Exits non-zero, with no result line, when anything fails or no GPU is present.

Tolerances (max |kernel - plain| / max |plain|): the fp32 modes hold A and B
to 1e-4 and the log-likelihood to 1e-5; the kernel sums A and the LL with
atomics, in another order than the plain matmuls. The bf16r modes hold A to
1e-4, B to 1e-3 and the LL to 1e-5 (largest readings on an NVIDIA H100 80GB
HBM3: A 6.6e-6, B 1.5e-4; S summed in another order can flip the bf16
rounding of a ratio, which moves one term of B by 2^-8). As the plain fp32
accumulators lie about 1e-3 from the bf16r ones, each bf16r output must also
lie at least 4 times nearer its bf16r plain version than the fp32 one. A
fit's final LL is held to 1e-4 relative of a plain fit from the same initial
factors (and, for the ensemble's first two bootstrap runs, the same document
weights). The combine stage: squared Hellinger distances within 1e-5 of a
float64 reference (a float32 Gram matrix over 25,000 words; readings on the
H100 2.2e-6 on the card, 9.4e-7 on the host), and bit for bit the matrix the
ensemble used when recomputed with TF32 allowed; the device merge within
1e-5 (max-norm relative) of the numpy merge; the device layout's
trustworthiness at most 0.05 below the host layout's.
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
BF16R_A_RTOL, BF16R_B_RTOL, BF16R_SEPARATION = 1e-4, 1e-3, 4.0
HELLINGER_SQ_ATOL, MERGE_RTOL, UMAP_TW_MARGIN = 1e-5, 1e-5, 0.05
N_TRANSFORM = 2000  # documents embedded by the transform phase
KERNEL_SOURCE = "enstop_torch/ops/csrc/em_dense.cu"
REPLACES = {
    "em": "enstop_tpu/ops/pallas_em.py:176",
    "refit": "enstop_tpu/ops/pallas_em.py:224",
    "ll": "enstop_tpu/ops/pallas_em.py:255",
    "em_bf16r": "enstop_tpu/ops/pallas_em_variants.py:138",
    "refit_bf16r": "enstop_tpu/ops/pallas_em_variants.py:180",
}
ENSEMBLE = dict(n_components=20, n_starts=16, n_iter=80, random_state=0)


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


def compare_fast_kernels(name, X, k, cuda_em, em):
    """The bf16-responsibilities modes (precision="fast") against their plain
    versions on one padded X, and against the fp32 plain accumulators: each
    output must lie BF16R_SEPARATION times nearer the bf16r plain version than
    the fp32 one, so a kernel that skips the roundings fails. Returns each
    mode's largest absolute error (A and B for em_bf16r, B for refit_bf16r)."""
    worst = {"em_bf16r": 0.0, "refit_bf16r": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        Xt = X.to(dtype)
        for weighted in (False, True):
            zd, wz, w = problem(Xt, k, weighted, seed=4)
            A0, B0, ll0 = em.em_accumulators_bf16r(Xt, zd, wz, w)
            B0r, ll0r = em.refit_accumulators_bf16r(Xt, zd, wz, w)
            A32, B32, _ = em.em_accumulators_dense(Xt, zd, wz, w)
            B32r, _ = em.refit_accumulators_dense(Xt, zd, wz, w)
            for compute_ll in (False, True):
                A, B, ll = cuda_em.em_accumulators_fused(Xt, zd, wz, w, compute_ll=compute_ll,
                                                         precision="fast")
                Br, llr = cuda_em.refit_accumulators_fused(Xt, zd, wz, w,
                                                           compute_ll=compute_ll,
                                                           precision="fast")
                torch.cuda.synchronize()
                ea, eb, ebr = rel_err(A, A0), rel_err(B, B0), rel_err(Br, B0r)
                fa, fb, fbr = rel_err(A, A32), rel_err(B, B32), rel_err(Br, B32r)
                el = max(rel_err(ll, ll0), rel_err(llr, ll0r)) if compute_ll else 0.0
                print(f"  {name} fast {str(dtype)[6:]} weighted={weighted} "
                      f"compute_ll={compute_ll}: rel err em A {ea:.3e} B {eb:.3e}, "
                      f"refit B {ebr:.3e}, ll {el:.3e}; from fp32 plain em A {fa:.3e} "
                      f"B {fb:.3e}, refit B {fbr:.3e}")
                check(ea <= BF16R_A_RTOL and max(eb, ebr) <= BF16R_B_RTOL and el <= LL_RTOL,
                      f"{name} bf16r kernels")
                check(all(far > 0 and far >= BF16R_SEPARATION * near
                          for near, far in ((ea, fa), (eb, fb), (ebr, fbr))),
                      f"{name} bf16r kernels round as the bf16r plain version does")
                check(compute_ll or float(ll) == float(llr) == 0.0,
                      "ll is 0 with compute_ll=False")
                worst["em_bf16r"] = max(worst["em_bf16r"], abs_err((A, A0), (B, B0)))
                worst["refit_bf16r"] = max(worst["refit_bf16r"], abs_err((Br, B0r)))
    return worst


def reset_counts(cuda_em, em):
    for counts in (cuda_em.LAUNCHES, em.CALLS):
        for key in counts:
            counts[key] = 0


def read_counts(label, needed, cuda_em, em, totals):
    """Check that the path just driven launched each kernel in ``needed`` and
    called no plain op; add its launches to ``totals``."""
    launches, plain_calls = dict(cuda_em.LAUNCHES), dict(em.CALLS)
    print(f"  {label}: launches {json.dumps(launches)}, plain calls {json.dumps(plain_calls)}")
    for name in needed:
        check(launches[name] > 0, f"{label} launched the {name} kernel")
    check(all(v == 0 for v in plain_calls.values()), f"{label} made no plain call")
    for name, count in launches.items():
        totals[name] += count
    return launches


def check_distributions(a, what):
    check(np.all(np.isfinite(a)) and np.all(a >= 0), f"{what} finite and non-negative")
    check(np.allclose(a.sum(1), 1, atol=1e-4), f"{what} rows are distributions")


def trustworthiness(dmat, emb, k):
    """scikit-learn's ``trustworthiness`` for a precomputed distance matrix."""
    n = dmat.shape[0]
    rows = np.arange(n)[:, None]
    d = dmat.copy()
    np.fill_diagonal(d, np.inf)
    ranks = np.empty((n, n), np.int64)
    ranks[rows, np.argsort(d, axis=1, kind="stable")] = np.arange(1, n + 1)
    e = ((emb[:, None, :] - emb[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(e, np.inf)
    excess = ranks[rows, np.argsort(e, axis=1, kind="stable")[:, :k]] - k
    return 1.0 - 2.0 / (n * k * (2.0 * n - 3.0 * k - 1.0)) * float(excess[excess > 0].sum())


def check_combine(stack, labels, weights, layout, label, merge):
    """The combine stage's device parts against the host. The Hellinger matrix
    of the card's topic stack, computed with TF32 allowed (the module must turn
    it off), must equal the one the ensemble used; it and the same call on the
    host copy are each held to a float64 reference on the squared distance
    (1 - the Gram ratio: the square root amplifies a last-bit difference by
    1/(2d) between near-duplicate topics).
    The device merge of the clusters found is held to the numpy merge. The
    device UMAP layout the ensemble made must be about as trustworthy as the
    host layout (numpy, the JAX package's numbers) from the same inputs."""
    from enstop_torch.cluster.distances import all_pairs_hellinger_distance
    from enstop_torch.cluster.umap import umap_embed

    host = stack.cpu()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        d_dev = all_pairs_hellinger_distance(stack)
        merged_dev = merge(stack, labels, weights)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    d_host = all_pairs_hellinger_distance(host)
    t64 = host.double().numpy()
    sq, l1 = np.sqrt(t64), t64.sum(1)
    d2_ref = np.clip(1.0 - (sq @ sq.T) / np.sqrt(np.outer(l1, l1)), 0.0, None)
    np.fill_diagonal(d2_ref, 0.0)
    e_dev, e_host = (float(np.abs(d * d - d2_ref).max()) for d in (d_dev, d_host))
    e_merge = rel_err(torch.from_numpy(merged_dev),
                      torch.from_numpy(merge(host.numpy(), labels, weights)))
    kwargs, emb_dev = layout
    check(np.array_equal(kwargs["dmat"], d_dev), "UMAP got the device Hellinger matrix")
    emb_host = umap_embed(**{**kwargs, "layout": "host"})
    tw_dev, tw_host = (trustworthiness(d_dev, e, 10) for e in (emb_dev, emb_host))
    print(f"  {label} combine on the card: squared Hellinger max abs err vs float64, device "
          f"{e_dev:.3e} host {e_host:.3e} (distances differ by at most "
          f"{float(np.abs(d_dev - d_host).max()):.3e}); merge of {int(labels.max()) + 1} "
          f"clusters rel err vs numpy {e_merge:.3e}; UMAP trustworthiness (k = 10) device "
          f"layout {tw_dev:.4f}, host layout {tw_host:.4f}")
    check(max(e_dev, e_host) <= HELLINGER_SQ_ATOL, f"{label} Hellinger matrix on the card")
    check(e_merge <= MERGE_RTOL, f"{label} device merge agrees with the numpy merge")
    check(tw_dev >= tw_host - UMAP_TW_MARGIN, f"{label} device UMAP layout")


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

    # -- phase 2b: the bf16r modes (precision="fast") against their plain versions
    fast_worst = compare_fast_kernels("small 203x650 k=20", torch.from_numpy(small).to(dev), 20,
                                      cuda_em, em)
    for shape_name, Xs in ((f"20NG {Xd.shape[0]}x{Xd.shape[1]} k=20", Xd),
                           (f"batch {batch.shape[0]}x{batch.shape[1]} k=20", batch)):
        for name, err in compare_fast_kernels(shape_name, Xs, 20, cuda_em, em).items():
            fast_worst[name] = max(fast_worst[name], err)
    worst.update(fast_worst)
    print("phase 2b bf16r kernels vs plain: ok, largest abs err", json.dumps(fast_worst))
    timing["em_bf16r"] = (
        cuda_ms(lambda: cuda_em.em_accumulators_fused(Xd, zd, wz, w1, compute_ll=False,
                                                      precision="fast"), 50),
        cuda_ms(lambda: em.em_accumulators_bf16r(Xd, zd, wz, w1), 5))
    timing["refit_bf16r"] = (
        cuda_ms(lambda: cuda_em.refit_accumulators_fused(Xd, zd, wz, w1, compute_ll=False,
                                                         precision="fast"), 50),
        cuda_ms(lambda: em.refit_accumulators_bf16r(Xd, zd, wz, w1), 5))
    for name in ("em_bf16r", "refit_bf16r"):
        ms, plain_ms = timing[name]
        fp32 = timing[name.split("_")[0]][0]
        print(f"  time at 20NG, bf16 X: {name} kernel {ms:.4f} ms (fp32 mode {fp32:.4f} ms), "
              f"plain bf16r {plain_ms:.4f} ms")
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
    totals = {name: 0 for name in cuda_em.LAUNCHES}
    reset_counts(cuda_em, em)
    t0 = time.perf_counter()
    model = enstop_torch.PLSA(n_components=20, n_iter=100, n_iter_per_test=10, tolerance=0,
                              random_state=0, device="cuda").fit(X)
    fit_wall = time.perf_counter() - t0
    fit_launches = dict(cuda_em.LAUNCHES)
    t0 = time.perf_counter()
    embedding = model.transform(docs)
    transform_wall = time.perf_counter() - t0
    print(f"phase 3 fit: {fit_wall:.3f} s wall ({model.fit_info_['wall_time_s']:.3f} s in the "
          f"EM loop), n_iter_ {model.n_iter_}, launches {json.dumps(fit_launches)}")
    print(f"phase 4 transform: {N_TRANSFORM} docs in {transform_wall:.3f} s wall")
    launches = read_counts("PLSA fit + transform", ("em", "refit", "ll"), cuda_em, em, totals)
    check(fit_launches["em"] >= 100, "the fit launched the EM kernel at least 100 times")
    check(launches["refit"] > fit_launches["refit"], "transform launched the refit kernel")
    check(launches["ll"] > fit_launches["ll"], "transform launched the LL kernel")
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

    # -- phase 5: PLSA at precision="fast", fit then transform ----------------
    reset_counts(cuda_em, em)
    t0 = time.perf_counter()
    fast = enstop_torch.PLSA(n_components=20, n_iter=100, n_iter_per_test=10, tolerance=0,
                             random_state=0, precision="fast", device="cuda").fit(X)
    fast_fit_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    fast_embedding = fast.transform(docs)
    fast_transform_wall = time.perf_counter() - t0
    print(f"phase 5 fast PLSA: fit {fast_fit_wall:.3f} s wall "
          f"({fast.fit_info_['wall_time_s']:.3f} s in the EM loop), transform "
          f"{fast_transform_wall:.3f} s wall")
    read_counts("fast PLSA fit + transform", ("em_bf16r", "refit_bf16r", "ll"), cuda_em, em,
                totals)
    check(fast.n_iter_ == 100 and np.all(np.isfinite(fast.history_)), "fast fit history")
    check_distributions(fast.components_, "fast topics")
    check_distributions(fast_embedding, "fast transform rows")
    plain_fast = driver.fit_padded(Xd, zd_p, wz_p, w1, 100, 10, 0.0, driver.plain_steps("fast"))
    gap = abs(plain_fast.final_ll - fast.fit_info_["log_likelihood"]) / abs(plain_fast.final_ll)
    print(f"  fast final LL kernel {fast.fit_info_['log_likelihood']:.6f} plain bf16r "
          f"{plain_fast.final_ll:.6f} rel gap {gap:.3e}; fp32 kernel fit "
          f"{model.fit_info_['log_likelihood']:.6f}")
    check(plain_fast.n_steps == 100 and gap <= FIT_LL_RTOL,
          "fast fit LL agrees with the plain bf16r fit")

    # -- phase 6: EnsembleTopics at full width, precision="fast" --------------
    from enstop_torch.models import ensemble as ens

    # what the combine stage was given and made, for check_combine
    captured = {}
    run_all, merge, embed = (ens._ensemble_of_topics_device, ens._merge_topics_by_label,
                             ens.umap_embed)

    def keep_stack(*args, **kwargs):
        captured["stack"] = run_all(*args, **kwargs)
        return captured["stack"]

    def keep_merge(all_topics, labels, weights=None):
        captured["merge"] = (labels, weights, merge(all_topics, labels, weights))
        return captured["merge"][2]

    def keep_layout(**kwargs):
        captured["umap"] = (kwargs, embed(**kwargs))
        return captured["umap"][1]

    ens._ensemble_of_topics_device, ens._merge_topics_by_label, ens.umap_embed = (
        keep_stack, keep_merge, keep_layout)
    walls = {}
    try:
        for precision in ("fast", "default"):
            reset_counts(cuda_em, em)
            t0 = time.perf_counter()
            ensemble = enstop_torch.EnsembleTopics(precision=precision, device="cuda",
                                                   **ENSEMBLE)
            ens_embedding = ensemble.fit_transform(X)
            fit_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            ens_docs = ensemble.transform(docs)
            transform_s = time.perf_counter() - t0
            timings = dict(ens.ensemble_fit.last_timings)
            walls[precision] = (fit_s, transform_s, timings)
            stack = captured["stack"]
            print(f"phase {6 if precision == 'fast' else 7} ensemble {precision}: "
                  f"n_components_ {ensemble.n_components_}, fit_transform {fit_s:.3f} s "
                  f"wall, transform of {N_TRANSFORM} docs {transform_s:.3f} s wall, "
                  f"last_timings {json.dumps(timings)}, topic stack {tuple(stack.shape)} "
                  f"on {stack.device}")
            needed = ("em_bf16r", "refit_bf16r", "ll") if precision == "fast" else (
                "em", "refit", "ll")
            read_counts(f"ensemble {precision} fit + transform", needed, cuda_em, em, totals)
            check(tuple(stack.shape) == (ENSEMBLE["n_starts"] * 20, X.shape[1])
                  and stack.device.type == "cuda", "the topic stack is (320, n_words) on the card")
            check(bool(torch.isfinite(stack).all())
                  and float((stack.sum(1) - 1).abs().max()) <= 1e-4,
                  "the stacked topics are distributions")
            check(ensemble.n_components_ >= 2, "at least two stable topics")
            labels, weights, merged = captured["merge"]
            check(np.array_equal(ensemble.components_, merged),
                  "the stable topics are the merge of the clusters found")
            check_combine(stack, labels, weights, captured["umap"], precision, merge)
            check_distributions(ensemble.components_, f"{precision} stable topics")
            check_distributions(ens_embedding, f"{precision} ensemble embedding")
            check_distributions(ens_docs, f"{precision} ensemble transform rows")
    finally:
        ens._ensemble_of_topics_device, ens._merge_topics_by_label, ens.umap_embed = (
            run_all, merge, embed)
    print("  ensemble wall, fast vs default: fit_transform "
          f"{walls['fast'][0]:.3f} / {walls['default'][0]:.3f} s, stages fast "
          f"{json.dumps(walls['fast'][2])} default {json.dumps(walls['default'][2])}")

    # the ensemble's first two bootstrap runs, kernel against plain bf16r, from
    # the same device init and document weights (the draws of random_state=0)
    prepared = enstop_torch.prepare_counts(X.astype(np.float32), standardize=False, device=dev)
    runs = ens.bootstrap_inputs(prepared, 20, 2, np.random.RandomState(ENSEMBLE["random_state"]))
    for i, (zd_i, wz_i, w_i) in enumerate(runs):
        got = driver.fit_padded(prepared.device_array, zd_i, wz_i, w_i, ENSEMBLE["n_iter"], 10,
                                0.0, driver.kernel_steps("fast"))
        want = driver.fit_padded(prepared.device_array, zd_i, wz_i, w_i, ENSEMBLE["n_iter"], 10,
                                 0.0, driver.plain_steps("fast"))
        gap = abs(got.final_ll - want.final_ll) / abs(want.final_ll)
        print(f"  bootstrap run {i}: final LL kernel {got.final_ll:.6f} plain bf16r "
              f"{want.final_ll:.6f} rel gap {gap:.3e}")
        check(gap <= FIT_LL_RTOL, f"bootstrap run {i} agrees with the plain bf16r fit")

    print(json.dumps({"kernels": [
        {"name": f"em_dense_{name}", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES[name], "launches": totals[name],
         "max_abs_err": worst[name], "ms": timing[name][0], "plain_ms": timing[name][1]}
        for name in ("em", "refit", "ll", "em_bf16r", "refit_bf16r")
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
