"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``enstop_torch/ops/csrc`` (``em_dense.cu``,
``em_sparse.cu`` and ``em_batch.cu``, one ``nvcc`` each, started together)
and checks each kernel (the dense fp32 and bf16-responsibilities modes of
``precision="fast"``, the sparse word and doc passes, plain and thresholded,
the batched row and word passes) against its plain PyTorch version on the
card. Then it drives the main paths, each with the
launch counts set to 0 just before it and read just after:

1. ``PLSA.fit`` (100 iterations) and ``transform`` on 2,000 documents at the
   20-Newsgroups shape (18,846 docs x 25,000 words, k = 20);
2. the same at ``precision="fast"``;
3. ``EnsembleTopics(n_components=20, n_starts=16, n_iter=80,
   precision="fast").fit_transform`` on the whole corpus, then ``transform``
   on 2,000 documents;
4. the same ensemble at ``precision="default"``;
5. determinism: two ``PLSA.fit`` at each precision and two more fast
   ensembles, each pair bit for bit the same;
6. ``PLSA(backend="sparse")`` fit (100 iterations) and ``transform`` on 2,000
   documents at the JAX package's sparse config C (250,000 docs x 141,000
   words, 19 M Zipf draws, k = 20), whose dense rectangle would not fit;
7. ``PLSA(e_step_thresh=1e-16)`` at 20NG, which routes to the sparse path's
   thresholded modes;
8. ``EnsembleTopics(backend="sparse", n_components=20, n_starts=16,
   n_iter=80)`` at config C' (100,000 docs x 141,000 words, 6.2 M draws);
9. ``cuda_batch.batched_em_fit``: 16 bootstrap runs of the 20NG ensemble
   (its own inits and multinomial weights), 80 steps, held against 16
   sequential fits of ``em_step_fused`` (phase 12);
10. ``StreamedPLSA(block_size=65_536)`` at config C (4 blocks streamed from
    pinned host memory each iteration, 100 iterations) against phase 9's
    resident sparse fit from the same init, twice (bit for bit), with its
    peak device memory, copy rate and overlap, and ``transform`` on 2,000
    documents (phase 13);
11. at 20NG: ``EnsembleTopics(model="nmf", n_components=20, n_starts=16)``
    (each run's KL multiplicative updates on the sparse word and doc passes),
    ``PLSA(init="nndsvd")`` and ``PLSA(init="nmf")``, and the topic metrics
    of phase 3's model (phase 14).

Phase 1 prints the sparse walk's shape (``cuda_sparse.walk_shape``: L lanes an
entry, TPL topics a lane) at the main paths' topic counts (k = 20 sparse, kp =
24 dense) with the registers and spill stores of its instances, and fails if
one of them spills; the same for the dense row walk's instances
(``em_accumulate`` and ``batch_rows``, ``csrc/row_walk.cuh``) at kp = 20, 24
and 104, failing on a spill at kp = 20 and 24. Phase 2 also times the dense
kernel alone (B + LL and B only), without the EM step's word pass. It checks
that every kernel of each path was launched,
that no plain op was called, and that the results agree with the plain path
on the card, and it holds the ensemble's combine stage on the card (Hellinger matrix, merge, UMAP
layout) against the host. Prints one line per phase, then a JSON line with
each kernel's launches, error, time, plain time and bound, and last a JSON
line with the device. Exits non-zero, with no result line, when anything
fails or no GPU is present.

Tolerances (max |kernel - plain| / max |plain|): the fp32 dense modes hold A
and B to 1e-4 and the log-likelihood to 1e-5; the kernels sum in another
order than the plain matmuls. The bf16r modes hold A to 1e-4, B to 1e-3 and
the LL to 1e-5 (largest readings on an NVIDIA H100 80GB HBM3: A 6.6e-6, B
1.5e-4; S summed in another order can flip the bf16 rounding of a ratio,
which moves one term of B by 2^-8). As the plain fp32 accumulators lie about
1e-3 from the bf16r ones, each bf16r output must also lie at least 4 times
nearer its bf16r plain version than the fp32 one. The sparse passes hold A
and B to 1e-5 and the LL to 1e-5: both sides sum in fixed orders, not the
same ones, and the threshold mask is the same on both (each product is one
rounded fp32 multiply). The batched kernel holds A and B to 1e-4, as the
dense fp32 modes do; each run's A and B are a single-run step's bit for bit
(the same operations in the same order); and the batched fit's factors lie
within rtol 1e-4 / atol 1e-6 of the sequential fits' (the JAX package's own
test). A fit's final LL is held to 1e-4 relative of a plain fit from the
same initial factors (and, for an ensemble's first two bootstrap runs, the
same document weights); the streamed fit's to 1e-4 relative of the resident
sparse fit from the same init (the same passes on blocks: only the order of
A's block sums differs), and its peak device memory must stay below the
resident fit's. The combine stage: squared Hellinger distances
within 1e-5 of a float64 reference (a float32 Gram matrix over
25,000 words; readings on the H100 2.2e-6 on the card, 9.4e-7 on the host),
and bit for bit the matrix the ensemble used when recomputed with TF32
allowed; the device merge within 1e-5 (max-norm relative) of the numpy merge;
the device layout's trustworthiness at most 0.05 below the host layout's.

Each kernel's bound is the larger of the bytes it must move (each input read
once, each output written once) over 3.35 TB/s and its fp32 operations on
the nonzeros over 67 TFLOP/s (the H100 SXM data sheet's peaks at 700 W).
No single PyTorch call computes any of these functions, so ``library_ms`` is
null throughout.
"""

from __future__ import annotations

import contextlib
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
SPARSE_RTOL = 1e-5  # the sparse passes' A and B (max-norm relative) and LL
N_TRANSFORM = 2000  # documents embedded by the transform phase
HBM_BYTES_PER_S, FP32_FLOP_PER_S = 3.35e12, 67e12  # H100 SXM data sheet, 700 W
DENSE_SOURCE = "enstop_torch/ops/csrc/em_dense.cu"
SPARSE_SOURCE = "enstop_torch/ops/csrc/em_sparse.cu"
BATCH_SOURCE = "enstop_torch/ops/csrc/em_batch.cu"
KERNELS = {  # name in LAUNCHES: (source, the TPU kernel it replaces)
    "em": (DENSE_SOURCE, "enstop_tpu/ops/pallas_em.py:176"),
    "refit": (DENSE_SOURCE, "enstop_tpu/ops/pallas_em.py:224"),
    "ll": (DENSE_SOURCE, "enstop_tpu/ops/pallas_em.py:255"),
    "em_bf16r": (DENSE_SOURCE, "enstop_tpu/ops/pallas_em_variants.py:138"),
    "refit_bf16r": (DENSE_SOURCE, "enstop_tpu/ops/pallas_em_variants.py:180"),
    "word_pass": (SPARSE_SOURCE, "enstop_tpu/ops/pallas_sell.py:456"),
    "word_pass_thresh": (SPARSE_SOURCE, "enstop_tpu/ops/pallas_sell.py:456"),
    "word_pass_bf16r": (SPARSE_SOURCE, "enstop_tpu/ops/pallas_em_variants.py:138"),
    "doc_pass": (SPARSE_SOURCE, "enstop_tpu/ops/pallas_sell.py:490"),
    "doc_pass_thresh": (SPARSE_SOURCE, "enstop_tpu/ops/pallas_sell.py:490"),
    "batch": (BATCH_SOURCE, "enstop_tpu/ops/pallas_batch.py:54"),
    "batch_word": (SPARSE_SOURCE, "enstop_tpu/ops/pallas_batch.py:54"),
}
ENSEMBLE = dict(n_components=20, n_starts=16, n_iter=80, random_state=0)
CONFIG_C = (250_000, 141_000, 19_000_000)    # the JAX package's sparse config C
CONFIG_C2 = (100_000, 141_000, 6_200_000)    # and its config C'
THRESHOLDS = (None, 1e-16, 1e-3)
BATCH_RUNS = 16                              # the ensemble's n_starts
BATCH_FIT_RTOL, BATCH_FIT_ATOL = 1e-4, 1e-6  # the JAX package's batched-fit test
STREAM_BLOCK = 65_536                        # StreamedPLSA's default: 4 blocks at config C
STREAMED = dict(n_components=20, block_size=STREAM_BLOCK, n_iter=100, n_iter_per_test=10,
                tolerance=0, random_state=0, device="cuda")
NMF_ENSEMBLE = dict(n_components=20, n_starts=16, random_state=0)


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
    from enstop_torch.ops import cuda_sparse

    for counts in (cuda_em.LAUNCHES, em.CALLS, cuda_sparse.CALLS):
        for key in counts:
            counts[key] = 0


def read_counts(label, needed, cuda_em, em, totals):
    """Check that the path just driven launched each kernel in ``needed`` and
    called no plain op; add its launches to ``totals``."""
    from enstop_torch.ops import cuda_sparse

    launches = dict(cuda_em.LAUNCHES)
    plain_calls = {**em.CALLS, **{"sparse_" + k: v for k, v in cuda_sparse.CALLS.items()}}
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


def bound(moved, operations):
    """``(ms, "bytes" or "operations")``: the larger of the two least times."""
    by_bytes, by_ops = moved / HBM_BYTES_PER_S, operations / FP32_FLOP_PER_S
    return 1e3 * max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def dense_bound_ms(X, kp, outputs):
    """The least time for one dense kernel: X, both factors and the weights
    read once, ``outputs`` floats written once, over the memory rate; its
    6 kp fp32 operations a nonzero over the fp32 rate (bytes bound it)."""
    n_pad, m_pad = X.shape
    moved = X.numel() * X.element_size() + 4 * (n_pad * kp + kp * m_pad + n_pad + outputs)
    return bound(moved, 6 * kp * int(torch.count_nonzero(X)))


def sparse_bound_ms(side, n, m, k):
    """The least time for one sparse pass: the index and count of each
    nonzero, both factor tables and the weights read once, the (owners, k)
    accumulator written once, over the memory rate; its 4 k fp32 operations a
    nonzero over the fp32 rate."""
    moved = 8 * side.nnz + 4 * (n * k + m * k + n + side.n_owner * k)
    return bound(moved, 4 * k * side.nnz)


def batch_bound_ms(X, R, kp, nnz, part):
    """The least time for the batched kernel's ``part``: ``"rows"`` (B: X,
    and each run's zd, wz and B once; 4 kp fp32 operations a nonzero and
    run), ``"words"`` (A: the index and count of each nonzero, and each run's
    zd, wz, weights and A once; 4 kp operations) or ``"both"`` (the whole
    function: X, and each run's zd, wz, weights, A and B once; 6 kp
    operations)."""
    n_pad, m_pad = X.shape
    factors = n_pad * kp + kp * m_pad
    x_bytes = X.numel() * X.element_size()
    moved, ops = {"rows": (x_bytes + 4 * R * (factors + n_pad * kp), 4),
                  "words": (8 * nnz + 4 * R * (factors + n_pad + kp * m_pad), 4),
                  "both": (x_bytes + 4 * R * (factors + n_pad + kp * m_pad + n_pad * kp), 6)}[part]
    return bound(moved, ops * kp * nnz * R)


def ptxas_instances(report):
    """``{kernel instance: (registers, spill store bytes)}`` from ``-Xptxas -v``."""
    out, name = {}, None
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name = entry.group(1)
            out[name] = (0, 0)
        elif name and (spill := re.search(r"(\d+) bytes spill stores", line)):
            out[name] = (out[name][0], int(spill.group(1)))
        elif name and (used := re.search(r"Used (\d+) registers", line)):
            out[name] = (int(used.group(1)), out[name][1])
    return out


def sparse_instance(mangled):
    """``"L<L>_TPL<TPL>_V<V>_<pass>[_thresh|_bf16r]"`` for a mangled
    ``segment_pass`` instance of ``em_sparse.cu``, else None."""
    m = re.search(r"segment_passILi(\d+)ELi(\d+)ELi(\d+)ELb([01])ELb([01])ELb([01])EE", mangled)
    if m is None:
        return None
    L, tpl, v, word, thresh, bf16r = (int(g) for g in m.groups())
    return (f"L{L}_TPL{tpl}_V{v}_{'word' if word else 'doc'}" + ("_thresh" if thresh else "")
            + ("_bf16r" if bf16r else ""))


def row_instance(mangled):
    """``"<kernel>_<x dtype>_L<L>_TPL<TPL>_V<V>[_B][_LL][_bf16r]"`` for a mangled
    ``em_accumulate`` or ``batch_rows`` instance (``csrc/row_walk.cuh``), else
    None."""
    m = re.search(r"(em_accumulate|batch_rows)I(13__nv_bfloat16|f)Li(\d+)ELi(\d+)ELi(\d+)E"
                  r"(?:Lb([01])ELb([01])ELb([01])E)?E", mangled)
    if m is None:
        return None
    kernel, xt, L, tpl, v, with_b, ll, bf16r = m.groups()
    return (f"{kernel}_{'bf16' if xt != 'f' else 'fp32'}_L{L}_TPL{tpl}_V{v}"
            + ("_B" if with_b != "0" else "") + ("_LL" if ll == "1" else "")
            + ("_bf16r" if bf16r == "1" else ""))


def batch_problem(X, R, k, seed):
    """R runs' random padded factors and weights, stacked."""
    runs = [problem(X, k, True, seed + r) for r in range(R)]
    return tuple(torch.stack([run[i] for run in runs]) for i in range(3))


def sparse_problem(prep, k, weighted, seed):
    """Factors on the card shaped like a fitted model's, so that a threshold
    of 1e-3 keeps some products of an entry and drops others: P(z|d) from a
    Dirichlet(0.3), P(w|z) Zipf over the words (each topic's ranking shifted a
    little), and document weights."""
    rng = np.random.RandomState(seed)
    n, m = prep.shape
    zd = rng.dirichlet(np.full(k, 0.3), n).astype(np.float32)
    zipf = 1.0 / np.arange(1, m + 1) ** 1.05
    wz = np.stack([np.roll(zipf, -rng.randint(50)) for _ in range(k)]) * rng.uniform(
        0.5, 1.5, (k, m))
    wz /= wz.sum(1, keepdims=True)
    dev = prep.device
    w = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32)).to(dev)
    return (torch.from_numpy(zd).to(dev), torch.from_numpy(wz.T.astype(np.float32)).to(dev),
            w if weighted else None)


def compare_sparse(name, prep, k, cuda_sparse):
    """The word and doc passes against their plain versions on one sparse
    layout, weighted and not, each threshold, LL on and off. Returns each
    kernel's largest absolute error on its accumulator."""
    worst = {key: 0.0 for key in ("word_pass", "word_pass_thresh", "doc_pass",
                                  "doc_pass_thresh")}
    for weighted in (False, True):
        zd, wzT, w = sparse_problem(prep, k, weighted, seed=5)
        for thresh in THRESHOLDS:
            if thresh is not None:
                v = zd[prep.doc.owners()[:200_000]] * wzT[prep.doc.idx[:200_000].long()]
                fired = float((v <= thresh).float().mean())
            for word in (True, False):
                side = prep.word if word else prep.doc
                kernel, plain = ((cuda_sparse.word_pass, cuda_sparse.word_pass_plain) if word
                                 else (cuda_sparse.doc_pass, cuda_sparse.doc_pass_plain))
                out0, ll0 = plain(side, zd, wzT, w, thresh=thresh)
                key = ("word_pass" if word else "doc_pass") + ("_thresh" if thresh else "")
                for compute_ll in (False, True):
                    out, ll = kernel(side, zd, wzT, w, thresh=thresh, compute_ll=compute_ll)
                    torch.cuda.synchronize()
                    eo = rel_err(out, out0)
                    el = rel_err(ll, ll0) if compute_ll else 0.0
                    print(f"  {name} {key} weighted={weighted} thresh={thresh}"
                          + (f" (drops {fired:.3f} of the products)" if thresh else "")
                          + f" compute_ll={compute_ll}: rel err {'A' if word else 'B'} "
                            f"{eo:.3e} ll {el:.3e}")
                    check(eo <= SPARSE_RTOL and el <= SPARSE_RTOL, f"{name} {key} kernel")
                    check(compute_ll or float(ll) == 0.0, "ll is 0 with compute_ll=False")
                    worst[key] = max(worst[key], abs_err((out, out0)))
    return worst


@contextlib.contextmanager
def plain_sparse():
    """The sparse path's steps through the plain passes, on the card."""
    from enstop_torch.ops import cuda_sparse, sell

    kernels = sell.word_pass, sell.doc_pass
    sell.word_pass, sell.doc_pass = cuda_sparse.word_pass_plain, cuda_sparse.doc_pass_plain
    try:
        yield
    finally:
        sell.word_pass, sell.doc_pass = kernels


def streamed_sweep_ms(store, zd_blocks, wzT, w_blocks, mode, reps):
    """CUDA-event ms a sweep of the streamed fit's block loop takes at the
    fitted state: ``"full"`` (the copies and the passes, as the fit runs
    them), ``"copy"`` (the copies alone) or ``"kernels"`` (the passes
    alone, every block already on the card)."""
    from enstop_torch.models.streamed_core import _Streamer, _tensors
    from enstop_torch.ops.cuda_sparse import Side, doc_pass, word_pass

    dev = wzT.device

    def passes(b, doc, word):
        AT, _ = word_pass(word, zd_blocks[b], wzT, w_blocks[b], compute_ll=False)
        B, ll = doc_pass(doc, zd_blocks[b], wzT, w_blocks[b])
        return AT, zd_blocks[b] * B, ll

    if mode == "kernels":
        on_card = [{name: Side(*(t.to(dev) for t in _tensors(side)), side.n_owner, side.n_index)
                    for name, side in blk.items()} for blk in store.blocks]
        return cuda_ms(lambda: [passes(b, blk["doc"], blk["word"])
                                for b, blk in enumerate(on_card)], reps)
    streamer = _Streamer(store, dev)
    if mode == "copy":
        ms = cuda_ms(lambda: [None for _ in streamer.sweep(then=True)], reps)
    else:
        ms = cuda_ms(lambda: [passes(b, doc, word) for b, doc, word in streamer.sweep(then=True)],
                     reps)
    streamer.close()
    return ms


def streamed_phase(XC, docs_c, resident, resident_peak, cuda_em, em, cuda_sparse, totals):
    """Phase 13: StreamedPLSA at config C, 4 blocks from pinned host memory.
    Returns the word and doc passes' largest absolute errors on one block."""
    from enstop_torch.models import streamed_core
    from enstop_torch.ops.sell import PreparedSell
    import enstop_torch

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    # (a) one block's passes, on the card where the streamer put them, against
    # their plain versions
    store = streamed_core._BlockStore(XC, STREAM_BLOCK, pin=True)
    streamer = streamed_core._Streamer(store, dev)
    b, doc, word = next(streamer.sweep())
    block = PreparedSell(doc, word, doc.n_owner, word.n_owner)
    worst = compare_sparse(f"config C block {b} ({doc.n_owner} docs)", block, 20, cuda_sparse)
    del block, doc, word
    streamer.close()
    print(f"phase 13 streamed block vs plain: ok, largest abs err {json.dumps(worst)}")

    reset_counts(cuda_em, em)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = enstop_torch.StreamedPLSA(**STREAMED).fit(XC)
    fit_wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    fit_launches = dict(cuda_em.LAUNCHES)
    t0 = time.perf_counter()
    embedding = model.transform(docs_c)
    transform_wall = time.perf_counter() - t0
    info = model.fit_info_
    launches = read_counts("streamed fit + transform", ("word_pass", "doc_pass"), cuda_em, em,
                           totals)
    n_blocks, n_iter = info["n_blocks"], STREAMED["n_iter"]
    print(f"phase 13 StreamedPLSA at config C: {n_blocks} blocks of {STREAM_BLOCK} docs, fit "
          f"{fit_wall:.3f} s wall ({info['store_s']:.3f} s packing the store, "
          f"{info['loop_s']:.3f} s in the EM loop: {info['n_sweeps']} sweeps, "
          f"{info['loop_s'] / info['n_sweeps'] * 1e3:.3f} ms a sweep), transform of "
          f"{N_TRANSFORM} docs {transform_wall:.3f} s wall; fit launches "
          f"{json.dumps(fit_launches)}")
    check(n_blocks == 4, "config C streams in 4 blocks")
    check(fit_launches["word_pass"] == n_blocks * n_iter
          and fit_launches["doc_pass"] >= n_blocks * n_iter,
          "every block's word and doc passes ran every iteration")
    check(launches["doc_pass"] > fit_launches["doc_pass"], "transform ran the doc pass")
    check(all(launches[k] == 0 for k in ("em", "refit", "ll", "em_bf16r", "refit_bf16r")),
          "the streamed path launched no dense kernel")
    check(model.n_iter_ == n_iter and np.all(np.isfinite(model.history_))
          and model.history_[-1] > model.history_[0], "streamed fit history")
    check_distributions(model.components_, "streamed topics")
    check_distributions(embedding, "streamed transform rows")
    # (b) against phase 9's resident sparse fit from the same init
    ll, ll_res = info["log_likelihood"], resident.fit_info_["log_likelihood"]
    gap = abs(ll - ll_res) / abs(ll_res)
    topic_gap = float(np.abs(model.components_ - resident.components_).max())
    print(f"  final LL streamed {ll:.6f} resident {ll_res:.6f} rel gap {gap:.3e}; topics max "
          f"abs gap {topic_gap:.3e}; history streamed {model.history_.tolist()}")
    check(gap <= FIT_LL_RTOL, "the streamed fit's LL agrees with the resident sparse fit")
    # (c) run to run
    again = enstop_torch.StreamedPLSA(**STREAMED).fit(XC)
    same = (np.array_equal(again.components_, model.components_)
            and np.array_equal(again.embedding_, model.embedding_)
            and np.array_equal(again.history_, model.history_))
    print(f"  two streamed fits: {'bit for bit the same' if same else 'DIFFER'}")
    check(same, "repeat streamed fits are bit for bit the same")
    # (d) memory
    print(f"  peak device memory above what was allocated before the fit: streamed "
          f"{peak / 2**20:.1f} MiB, resident sparse fit (phase 9) {resident_peak / 2**20:.1f} "
          f"MiB; the store holds {info['host_bytes'] / 2**20:.1f} MiB of pinned host memory "
          f"({info['host_bytes'] / XC.nnz:.2f} B a nonzero)")
    check(peak < resident_peak, "the streamed fit peaks below the resident one")
    # (e) time per iteration, bytes, copy rate and overlap, at the fitted state
    zd_blocks = [torch.from_numpy(np.ascontiguousarray(model.embedding_[lo:hi])).to(dev)
                 for lo, hi in store.block_rows]
    w_blocks = [torch.ones(hi - lo, device=dev) for lo, hi in store.block_rows]
    wzT = torch.from_numpy(np.ascontiguousarray(model.components_.T)).to(dev)
    sweep = {mode: streamed_sweep_ms(store, zd_blocks, wzT, w_blocks, mode, 10)
             for mode in ("full", "copy", "kernels")}
    per_sweep = info["bytes_per_sweep"]
    rate = per_sweep / (sweep["copy"] * 1e-3)
    hidden = (sweep["copy"] + sweep["kernels"] - sweep["full"]) / sweep["kernels"]
    print(f"  a sweep (CUDA events): copies and passes {sweep['full']:.4f} ms, copies alone "
          f"{sweep['copy']:.4f} ms, passes alone (blocks resident) {sweep['kernels']:.4f} ms; "
          f"{per_sweep / 1e6:.1f} MB shipped a sweep ({info['bytes_shipped'] / 1e6:.1f} MB in "
          f"the fit), copy rate {rate / 1e9:.2f} GB/s; the overlap hides {hidden:.3f} of the "
          f"passes' time")
    print(f"  phase 13 took {time.perf_counter() - t_phase:.1f} s")
    return worst


def surface_phase(X, model, cuda_em, em, totals):
    """Phase 14 at 20NG: the NMF ensemble, the data-dependent inits, the
    topic metrics."""
    from enstop_torch.models import ensemble as ens
    from enstop_torch.ops.init import plsa_init
    import enstop_torch

    t_phase = time.perf_counter()
    reset_counts(cuda_em, em)
    t0 = time.perf_counter()
    nmf = enstop_torch.EnsembleTopics(model="nmf", device="cuda", **NMF_ENSEMBLE)
    nmf_embedding = nmf.fit_transform(X)
    nmf_wall = time.perf_counter() - t0
    launches = read_counts("NMF ensemble fit", ("word_pass", "doc_pass"), cuda_em, em, totals)
    print(f"phase 14 NMF ensemble at 20NG, {NMF_ENSEMBLE['n_starts']} starts: n_components_ "
          f"{nmf.n_components_}, fit_transform {nmf_wall:.3f} s wall, last_timings "
          f"{json.dumps(ens.ensemble_fit.last_timings)}")
    check(launches["word_pass"] >= NMF_ENSEMBLE["n_starts"] * 200
          and launches["doc_pass"] >= launches["word_pass"] + 200,
          "each run's 200 KL updates ran both sparse passes, the embedding 200 doc passes")
    check(nmf.n_components_ >= 2, "the NMF ensemble finds at least two stable topics")
    check_distributions(nmf.components_, "NMF stable topics")
    check(nmf_embedding.shape == (X.shape[0], nmf.n_components_)
          and np.all(np.isfinite(nmf_embedding)) and np.all(nmf_embedding >= 0),
          "the NMF embedding is finite and non-negative")
    for init in ("nndsvd", "nmf"):
        t0 = time.perf_counter()
        plsa_init(X, 20, init=init, rng=np.random.RandomState(0))
        init_s = time.perf_counter() - t0
        reset_counts(cuda_em, em)
        t0 = time.perf_counter()
        fitted = enstop_torch.PLSA(n_components=20, init=init, n_iter=100, n_iter_per_test=10,
                                   tolerance=0, random_state=0, device="cuda").fit(X)
        wall = time.perf_counter() - t0
        read_counts(f"PLSA(init={init!r}) fit", ("em", "word_pass"), cuda_em, em, totals)
        print(f"  PLSA(init={init!r}): init {init_s:.3f} s on the host, fit {wall:.3f} s wall "
              f"({fitted.fit_info_['wall_time_s']:.3f} s in the EM loop), final LL "
              f"{fitted.fit_info_['log_likelihood']:.6f} (random init, phase 3: "
              f"{model.fit_info_['log_likelihood']:.6f})")
        check(fitted.n_iter_ == 100 and np.all(np.isfinite(fitted.history_))
              and fitted.history_[-1] > fitted.history_[0], f"PLSA(init={init!r}) history")
        check_distributions(fitted.components_, f"PLSA(init={init!r}) topics")
    t0 = time.perf_counter()
    metrics = {"coherence": model.coherence(), "log_lift": model.log_lift(),
               "coherence of topic 0": model.coherence(0), "log_lift of topic 0": model.log_lift(0)}
    print(f"  phase 3 model's metrics {json.dumps(metrics)} in "
          f"{time.perf_counter() - t0:.3f} s; phase 14 took {time.perf_counter() - t_phase:.1f} s")
    check(all(np.isfinite(v) for v in metrics.values()), "finite topic metrics")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    import enstop_torch
    check(Path(enstop_torch.__file__).resolve().parents[1] == Path(__file__).resolve().parent,
          "enstop_torch is imported from the checkout that holds this script")
    from enstop_torch.ops import _build, cuda_batch, cuda_em, cuda_sparse, driver, sell
    from enstop_torch.ops import em
    from enstop_torch.ops.init import plsa_init
    from enstop_torch.convert import pad_state
    from enstop_torch.synthetic import sparse_corpus, twenty_newsgroups_shape

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
    _build.build_all()
    for name in ("em_dense", "em_sparse", "em_batch"):
        build = _build.BUILD_LOG.get(name)
        if build is None:  # an earlier run in this checkout left the library
            print(f"phase 1 build: {name} loaded from enstop_torch/_build")
            continue
        registers = [int(r) for r in re.findall(r"Used (\d+) registers", build["report"])]
        spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", build["report"])]
        print(f"phase 1 build: {name} built (nvcc {build['seconds']:.2f} s); ptxas: "
              f"{len(registers)} kernel instances, at most {max(registers)} registers a "
              f"thread, {sum(s > 0 for s in spills)} with spill stores (at most "
              f"{max(spills)} B)")
        if name == "em_sparse":
            instances = {sparse_instance(key): v for key, v in
                         ptxas_instances(build["report"]).items() if sparse_instance(key)}
            for kp in (20, 24):  # the main paths' topic counts: sparse k, padded dense kp
                L, tpl = cuda_sparse.walk_shape(kp)
                shape = f"L{L}_TPL{tpl}_V4_"
                found = {key[len(shape):]: v for key, v in instances.items()
                         if key.startswith(shape)}
                print(f"  em_sparse at kp = {kp}: walk shape L = {L}, TPL = {tpl} "
                      f"({32 // L} entries a warp); registers, spill store bytes by mode "
                      f"{json.dumps(found)}")
                check(len(found) == 5 and all(spill == 0 for _, spill in found.values()),
                      f"the em_sparse instances at kp = {kp} are built and do not spill")
        if name in ("em_dense", "em_batch"):
            instances = {row_instance(key): v for key, v in
                         ptxas_instances(build["report"]).items() if row_instance(key)}
            for kp in (20, 24, 104):  # the main paths' topic counts, and R = 4's k = 100
                L, tpl = cuda_sparse.walk_shape(kp)
                shape = f"L{L}_TPL{tpl}_V4_"
                found = {key: v for key, v in instances.items() if shape in key}
                print(f"  {name} at kp = {kp}: walk shape L = {L}, TPL = {tpl}; registers, "
                      f"spill store bytes by instance {json.dumps(found)}")
                check(found and (kp > 24 or all(spill == 0 for _, spill in found.values())),
                      f"the {name} instances at kp = {kp} are built and do not spill")
    print(f"  all built and loaded in {time.perf_counter() - t0:.2f} s, in parallel")

    # -- phase 2: each dense kernel against its plain version -----------------
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
    kp = zd.shape[1]
    w1 = torch.ones(Xd.shape[0], device=dev)
    timing = {
        "em": (cuda_ms(lambda: cuda_em.em_accumulators_fused(Xd, zd, wz, w1, compute_ll=False,
                                                             word=prep.word), 50),
               cuda_ms(lambda: em.em_accumulators_dense(Xd, zd, wz, w1), 5)),
        "refit": (cuda_ms(lambda: cuda_em.refit_accumulators_fused(Xd, zd, wz, w1,
                                                                   compute_ll=False), 50),
                  cuda_ms(lambda: em.refit_accumulators_dense(Xd, zd, wz, w1), 5)),
        "ll": (cuda_ms(lambda: cuda_em.log_likelihood_fused(Xd, zd, wz, w1), 50),
               cuda_ms(lambda: em.log_likelihood_dense(Xd, zd, wz, w1), 5)),
    }
    n_pad, m_pad = Xd.shape
    bounds = {"em": dense_bound_ms(Xd, kp, kp * (n_pad + m_pad)),
              "refit": dense_bound_ms(Xd, kp, kp * n_pad), "ll": dense_bound_ms(Xd, kp, 1)}
    for name, (ms, plain_ms) in timing.items():
        print(f"  time at 20NG, bf16 X: {name} {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bounds[name][0]:.4f} ms ({bounds[name][1]})")
    # the dense kernel alone, as an EM step launches it (B + LL on a test step,
    # B only otherwise): the EM step's accumulators above add the word pass
    for label, compute_ll in (("B + LL", True), ("B only", False)):
        ms = cuda_ms(lambda: cuda_em._launch("em", Xd, zd, wz, w1, True, compute_ll), 50)
        print(f"  time at 20NG, bf16 X: dense kernel alone ({cuda_em.ROW_STREAM}), {label}: "
              f"{ms:.4f} ms, bound {bounds['refit'][0]:.4f} ms ({bounds['refit'][1]})")

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
                                                      precision="fast", word=prep.word), 50),
        cuda_ms(lambda: em.em_accumulators_bf16r(Xd, zd, wz, w1), 5))
    timing["refit_bf16r"] = (
        cuda_ms(lambda: cuda_em.refit_accumulators_fused(Xd, zd, wz, w1, compute_ll=False,
                                                         precision="fast"), 50),
        cuda_ms(lambda: em.refit_accumulators_bf16r(Xd, zd, wz, w1), 5))
    bounds["em_bf16r"], bounds["refit_bf16r"] = bounds["em"], bounds["refit"]
    for name in ("em_bf16r", "refit_bf16r"):
        ms, plain_ms = timing[name]
        fp32 = timing[name.split("_")[0]][0]
        print(f"  time at 20NG, bf16 X: {name} {ms:.4f} ms (fp32 mode {fp32:.4f} ms), "
              f"plain bf16r {plain_ms:.4f} ms")
    print("  EM step accumulators at 20NG (dense B kernel + word pass, fixed-order sums): "
          f"fp32 {timing['em'][0]:.4f} ms, bf16r {timing['em_bf16r'][0]:.4f} ms; the earlier "
          "kernel with atomics for A: 0.5317-0.5344 / 0.5354-0.5411 ms (PERF.md, rows 1 and 6)")
    # the word pass of the dense EM step, alone (its bf16r mode is the fast step's A)
    wzT = wz.t().contiguous()
    word_worst = 0.0
    for bf16r in (False, True):
        AT, _ = cuda_sparse.word_pass(prep.word, zd, wzT, w1, compute_ll=False, bf16r=bf16r)
        AT0, _ = cuda_sparse.word_pass_plain(prep.word, zd, wzT, w1, bf16r=bf16r)
        torch.cuda.synchronize()
        e = rel_err(AT, AT0)
        check(e <= SPARSE_RTOL, f"dense word pass bf16r={bf16r} against its plain version")
        if bf16r:
            word_worst = abs_err((AT, AT0))
    worst["word_pass_bf16r"] = word_worst
    timing["word_pass_bf16r"] = (
        cuda_ms(lambda: cuda_sparse.word_pass(prep.word, zd, wzT, w1, compute_ll=False,
                                              bf16r=True), 50),
        cuda_ms(lambda: cuda_sparse.word_pass_plain(prep.word, zd, wzT, w1, bf16r=True), 5))
    bounds["word_pass_bf16r"] = sparse_bound_ms(prep.word, *Xd.shape, kp)
    print(f"  word pass bf16r at 20NG: {timing['word_pass_bf16r'][0]:.4f} ms, plain "
          f"{timing['word_pass_bf16r'][1]:.4f} ms, bound {bounds['word_pass_bf16r'][0]:.4f} ms; "
          f"rel err vs plain {e:.3e}")
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

    # -- phase 2c: the sparse passes against their plain versions -------------
    t0 = time.perf_counter()
    sprep = enstop_torch.prepare_sell(X, standardize=False, device=dev)
    torch.cuda.synchronize()
    print(f"phase 2c: 20NG sparse layout staged in {time.perf_counter() - t0:.3f} s "
          f"({sprep.doc.n_seg} doc and {sprep.word.n_seg} word segments)")
    sparse_worst = compare_sparse("20NG", sprep, 20, cuda_sparse)
    t0 = time.perf_counter()
    XC = sparse_corpus(*CONFIG_C, seed=0).astype(np.int64)  # counts, not l1-normalised
    print(f"config C: {XC.shape[0]} x {XC.shape[1]}, nnz {XC.nnz} (dense bf16 rectangle "
          f"{XC.shape[0] * XC.shape[1] * 2 / 1e9:.1f} GB), made in "
          f"{time.perf_counter() - t0:.2f} s; most frequent word in "
          f"{int(np.diff(XC.tocsc().indptr).max())} documents")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cprep = enstop_torch.prepare_sell(XC, standardize=False, device=dev)
    torch.cuda.synchronize()
    staging_c = time.perf_counter() - t0
    print(f"  prepare_sell at config C: {staging_c:.3f} s wall ({cprep.doc.n_seg} doc and "
          f"{cprep.word.n_seg} word segments)")
    for name, err in compare_sparse("config C", cprep, 20, cuda_sparse).items():
        sparse_worst[name] = max(sparse_worst[name], err)
    worst.update(sparse_worst)
    print("phase 2c sparse passes vs plain: ok, largest abs err", json.dumps(sparse_worst))
    for label, p in (("20NG", sprep), ("config C", cprep)):
        zd_s, wzT_s, _ = sparse_problem(p, 20, False, seed=6)
        w_s = torch.ones(p.n, device=dev)
        row = {}
        for key, side, kernel, plain_fn, thresh in (
                ("word_pass", p.word, cuda_sparse.word_pass, cuda_sparse.word_pass_plain, None),
                ("word_pass_thresh", p.word, cuda_sparse.word_pass,
                 cuda_sparse.word_pass_plain, 1e-16),
                ("doc_pass", p.doc, cuda_sparse.doc_pass, cuda_sparse.doc_pass_plain, None),
                ("doc_pass_thresh", p.doc, cuda_sparse.doc_pass, cuda_sparse.doc_pass_plain,
                 1e-16)):
            row[key] = (
                cuda_ms(lambda: kernel(side, zd_s, wzT_s, w_s, thresh=thresh,
                                       compute_ll=False), 20),
                cuda_ms(lambda: plain_fn(side, zd_s, wzT_s, w_s, thresh=thresh), 3))
            least = sparse_bound_ms(side, p.n, p.m, 20)
            print(f"  time at {label}: {key} {row[key][0]:.4f} ms, plain {row[key][1]:.4f} ms, "
                  f"bound {least[0]:.4f} ms ({least[1]})")
            if label == "config C":
                timing[key], bounds[key] = row[key], least

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
    launches = read_counts("PLSA fit + transform", ("em", "word_pass", "refit", "ll"), cuda_em,
                           em, totals)
    check(fit_launches["em"] >= 100 and fit_launches["word_pass"] == fit_launches["em"],
          "each of the fit's 100 or more EM steps launched the B kernel and the word pass")
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

    def step_ms(step, state):
        for _ in range(3):
            state = step(state)
        float(state[0][0, 0])
        t0 = time.perf_counter()
        for _ in range(20):
            state = step(state)
        float(state[0][0, 0])  # host readback
        return (time.perf_counter() - t0) / 20 * 1e3

    steps_ms = {label: step_ms(lambda s: steps["em"](Xd, *s, w1)[:2], (zd_p, wz_p))
                for label, steps in (("kernel", driver.kernel_steps(word=prep.word)),
                                     ("plain", driver.plain_steps()))}
    zd_u, wz_u = torch.from_numpy(zd0).to(dev), torch.from_numpy(wz0).to(dev)
    steps_ms["sparse"] = step_ms(lambda s: sell.em_step_sell(sprep, *s, compute_ll=False)[:2],
                                 (zd_u, wz_u))
    print(f"  EM step at 20NG, warm, to a host readback: dense kernels "
          f"{steps_ms['kernel']:.4f} ms/iter, sparse kernels {steps_ms['sparse']:.4f} ms/iter, "
          f"dense plain {steps_ms['plain']:.4f} ms/iter")

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
    read_counts("fast PLSA fit + transform", ("em_bf16r", "word_pass_bf16r", "refit_bf16r", "ll"),
                cuda_em, em, totals)
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
            needed = (("em_bf16r", "word_pass_bf16r", "refit_bf16r", "ll")
                      if precision == "fast" else ("em", "word_pass", "refit", "ll"))
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
            if precision == "fast":
                first_fast = (stack.clone(), ensemble.n_components_, ensemble.components_)

        # -- phase 8: determinism -------------------------------------------
        for precision in ("default", "fast"):
            a, b = (enstop_torch.PLSA(n_components=20, n_iter=100, n_iter_per_test=10,
                                      tolerance=0, random_state=0, precision=precision,
                                      device="cuda").fit(X) for _ in range(2))
            same = (np.array_equal(a.components_, b.components_)
                    and np.array_equal(a.embedding_, b.embedding_)
                    and np.array_equal(a.history_, b.history_))
            print(f"phase 8 determinism: two PLSA.fit at {precision}: factors and history "
                  f"{'bit for bit the same' if same else 'DIFFER'}")
            check(same, f"repeat PLSA fits at {precision} are bit for bit the same")
        repeats = [first_fast]
        for _ in range(2):
            again = enstop_torch.EnsembleTopics(precision="fast", device="cuda", **ENSEMBLE)
            again.fit(X)
            repeats.append((captured["stack"].clone(), again.n_components_, again.components_))
        for i, (stack_i, n_i, comp_i) in enumerate(repeats[1:], 1):
            same_stack = torch.equal(stack_i, repeats[0][0])
            same_topics = n_i == repeats[0][1] and np.array_equal(comp_i, repeats[0][2])
            print(f"  fast ensemble {i} vs the first: topic stack "
                  f"{'bit for bit the same' if same_stack else 'DIFFERS'}, n_components_ "
                  f"{n_i} vs {repeats[0][1]}, components_ "
                  f"{'identical' if same_topics else 'DIFFER'}")
            check(same_stack, "repeat ensembles give a bit-identical bootstrap topic stack")
            check(same_topics, "repeat ensembles give identical stable topics")
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
                                0.0, driver.kernel_steps("fast", prepared.word))
        want = driver.fit_padded(prepared.device_array, zd_i, wz_i, w_i, ENSEMBLE["n_iter"], 10,
                                 0.0, driver.plain_steps("fast"))
        gap = abs(got.final_ll - want.final_ll) / abs(want.final_ll)
        print(f"  bootstrap run {i}: final LL kernel {got.final_ll:.6f} plain bf16r "
              f"{want.final_ll:.6f} rel gap {gap:.3e}")
        check(gap <= FIT_LL_RTOL, f"bootstrap run {i} agrees with the plain bf16r fit")

    # -- phase 9: sparse PLSA at config C, fit then transform -----------------
    docs_c = XC[:N_TRANSFORM]
    reset_counts(cuda_em, em)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident_base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    sparse_model = enstop_torch.PLSA(n_components=20, n_iter=100, n_iter_per_test=10,
                                     tolerance=0, random_state=0, backend="sparse",
                                     device="cuda").fit(XC)
    sfit_wall = time.perf_counter() - t0
    resident_peak = torch.cuda.max_memory_allocated() - resident_base
    sfit_launches = dict(cuda_em.LAUNCHES)
    t0 = time.perf_counter()
    sparse_embedding = sparse_model.transform(docs_c)
    stransform_wall = time.perf_counter() - t0
    info = sparse_model.fit_info_
    print(f"phase 9 sparse PLSA at config C: fit {sfit_wall:.3f} s wall ({info['wall_time_s']:.3f}"
          f" s in the EM loop, {info['nnz_k_updates_per_s']:.4e} nnz k updates/s), transform "
          f"of {N_TRANSFORM} docs {stransform_wall:.3f} s wall; prepare_sell alone "
          f"{staging_c:.3f} s; launches {json.dumps(sfit_launches)}")
    launches = read_counts("sparse PLSA fit + transform", ("word_pass", "doc_pass"), cuda_em, em,
                           totals)
    check(sfit_launches["word_pass"] == 100 and sfit_launches["doc_pass"] == 100 + 11,
          "the fit ran 100 steps of both passes and 11 LL tests")
    check(launches["doc_pass"] > sfit_launches["doc_pass"], "transform ran the doc pass")
    check(all(launches[k] == 0 for k in ("em", "refit", "ll", "em_bf16r", "refit_bf16r")),
          "the sparse path launched no dense kernel")
    check(sparse_model.n_iter_ == 100 and np.all(np.isfinite(sparse_model.history_))
          and sparse_model.history_[-1] > sparse_model.history_[0], "sparse fit history")
    check(sparse_model.components_.shape == (20, XC.shape[1]), "sparse topics' shape")
    check_distributions(sparse_model.components_, "sparse topics")
    check_distributions(sparse_embedding, "sparse transform rows")
    zd0_c, wz0_c = plsa_init(XC, 20, rng=np.random.RandomState(0))
    with plain_sparse():
        plain_c = sell.sell_fit(cprep, zd0_c, wz0_c, n_iter=100, n_iter_per_test=10,
                                tolerance=0.0)
    gap = abs(plain_c[3] - info["log_likelihood"]) / abs(plain_c[3])
    print(f"  final LL kernel {info['log_likelihood']:.6f} plain {plain_c[3]:.6f} rel gap "
          f"{gap:.3e}")
    check(plain_c[2] == 100 and gap <= FIT_LL_RTOL, "sparse fit LL agrees with the plain fit")

    # -- phase 10: a firing threshold routes to the sparse path ----------------
    reset_counts(cuda_em, em)
    t0 = time.perf_counter()
    thresh_model = enstop_torch.PLSA(n_components=20, n_iter=100, n_iter_per_test=10,
                                     tolerance=0, random_state=0, e_step_thresh=1e-16,
                                     device="cuda").fit(X)
    tfit_wall = time.perf_counter() - t0
    launches = read_counts("PLSA(e_step_thresh=1e-16) fit", ("word_pass_thresh",
                                                              "doc_pass_thresh"),
                           cuda_em, em, totals)
    check(thresh_model.fit_info_["backend"] == "sparse" and launches["word_pass"] == 0
          and launches["word_pass_thresh"] == 100 and launches["doc_pass"] == 11,
          "the steps ran the thresholded modes, the 11 LL tests the plain doc pass")
    with plain_sparse():
        plain_t = sell.sell_fit(sprep, zd0, wz0, n_iter=100, n_iter_per_test=10, tolerance=0.0,
                                e_step_thresh=1e-16)
    t_ll = thresh_model.fit_info_["log_likelihood"]
    gap = abs(plain_t[3] - t_ll) / abs(plain_t[3])
    dense_gap = abs(t_ll - model.fit_info_["log_likelihood"]) / abs(model.fit_info_[
        "log_likelihood"])
    print(f"phase 10 PLSA(e_step_thresh=1e-16) at 20NG: fit {tfit_wall:.3f} s wall "
          f"({thresh_model.fit_info_['wall_time_s']:.3f} s in the EM loop); final LL {t_ll:.6f}, "
          f"plain thresholded {plain_t[3]:.6f}, rel gap {gap:.3e}; gap to the unthresholded "
          f"fit (phase 3) {dense_gap:.3e}")
    check(gap <= FIT_LL_RTOL, "thresholded fit LL agrees with the plain thresholded fit")

    # -- phase 11: the sparse ensemble at config C' -----------------------------
    t0 = time.perf_counter()
    XC2 = sparse_corpus(*CONFIG_C2, seed=0).astype(np.int64)
    print(f"config C': {XC2.shape[0]} x {XC2.shape[1]}, nnz {XC2.nnz}, made in "
          f"{time.perf_counter() - t0:.2f} s")
    reset_counts(cuda_em, em)
    t0 = time.perf_counter()
    sens = enstop_torch.EnsembleTopics(backend="sparse", device="cuda", **ENSEMBLE)
    sens_embedding = sens.fit_transform(XC2)
    sens_wall = time.perf_counter() - t0
    s_timings = dict(ens.ensemble_fit.last_timings)
    launches = read_counts("sparse ensemble fit", ("word_pass", "doc_pass"), cuda_em, em, totals)
    print(f"phase 11 sparse ensemble at config C': n_components_ {sens.n_components_}, "
          f"fit_transform {sens_wall:.3f} s wall, last_timings {json.dumps(s_timings)}")
    check(sens.n_components_ >= 2, "at least two stable topics")
    check_distributions(sens.components_, "sparse ensemble topics")
    check_distributions(sens_embedding, "sparse ensemble embedding")
    c2prep = enstop_torch.prepare_sell(XC2.astype(np.float32), standardize=False, device=dev)
    runs = ens.bootstrap_inputs(c2prep, 20, 2, np.random.RandomState(ENSEMBLE["random_state"]))
    for i, (zd_i, wz_i, w_i) in enumerate(runs):
        got = sell.sell_fit(c2prep, zd_i, wz_i, w_i, ENSEMBLE["n_iter"], 10, 0.0)
        with plain_sparse():
            want = sell.sell_fit(c2prep, zd_i, wz_i, w_i, ENSEMBLE["n_iter"], 10, 0.0)
        gap = abs(got[3] - want[3]) / abs(want[3])
        print(f"  sparse bootstrap run {i}: final LL kernel {got[3]:.6f} plain {want[3]:.6f} "
              f"rel gap {gap:.3e}")
        check(gap <= FIT_LL_RTOL, f"sparse bootstrap run {i} agrees with the plain fit")

    # -- phase 12: the batched multi-run fit at full width ----------------------
    t_phase12 = time.perf_counter()
    # the 20NG ensemble's 16 bootstrap runs: its own device inits and weights
    runs = list(ens.bootstrap_inputs(prep, 20, BATCH_RUNS,
                                     np.random.RandomState(ENSEMBLE["random_state"])))
    zds, wzs, ws = (torch.stack([run[i] for run in runs]) for i in range(3))
    nnz = int(torch.count_nonzero(Xd))
    batch_worst = {"batch": 0.0, "batch_word": 0.0}
    X32 = Xd.float()
    for R, k in ((BATCH_RUNS, 20), (4, 100)):
        inputs = (zds, wzs, ws) if k == 20 else batch_problem(Xd, R, k, seed=7)
        for Xt in (Xd, X32):
            for weighted in (False, True):
                z, w_, wt = inputs[0], inputs[1], inputs[2] if weighted else None
                A, B = cuda_batch.batched_accumulators(Xt, z, w_, wt, word=prep.word)
                A0, B0 = em.batched_accumulators_dense(Xt, z, w_, wt)
                torch.cuda.synchronize()
                ea, eb = rel_err(A, A0), rel_err(B, B0)
                print(f"  batched accumulators R = {R} k = {k} {str(Xt.dtype)[6:]} "
                      f"weighted={weighted}: rel err A {ea:.3e} B {eb:.3e}")
                check(ea <= A_B_RTOL and eb <= A_B_RTOL, f"batched kernel at R = {R}, k = {k}")
                batch_worst["batch"] = max(batch_worst["batch"], abs_err((B, B0)))
                batch_worst["batch_word"] = max(batch_worst["batch_word"], abs_err((A, A0)))
                del A0, B0
    del X32
    worst.update(batch_worst)
    A, B = cuda_batch.batched_accumulators(Xd, zds, wzs, ws, word=prep.word)
    same_runs = True
    for r in range(BATCH_RUNS):
        A1, B1, _ = cuda_em.em_accumulators_fused(Xd, zds[r], wzs[r], ws[r], compute_ll=False,
                                                  word=prep.word)
        same_runs &= torch.equal(A[r], A1) and torch.equal(B[r], B1)
    print("phase 12 batched kernel vs plain: ok, largest abs err", json.dumps(batch_worst),
          f"; each run's A and B against a single-run em_accumulators_fused: "
          f"{'bit for bit the same' if same_runs else 'DIFFER'}")
    check(same_runs, "each batched run's A and B are a single run's bit for bit")

    n_iter = ENSEMBLE["n_iter"]
    reset_counts(cuda_em, em)
    t0 = time.perf_counter()
    zf, wf = cuda_batch.batched_em_fit(Xd, zds, wzs, ws, n_iter, word=prep.word)
    torch.cuda.synchronize()
    batch_fit_s = time.perf_counter() - t0
    launches = read_counts("batched fit", ("batch", "batch_word"), cuda_em, em, totals)
    check(launches["batch"] == n_iter and launches["batch_word"] == n_iter
          and sum(launches.values()) == 2 * n_iter,
          f"the batched fit launched the row and word passes {n_iter} times each, nothing else")
    check(bool(torch.isfinite(zf).all() and torch.isfinite(wf).all()), "finite batched factors")
    check(float((wf[:, :20].sum(2) - 1).abs().max()) <= 1e-4, "batched topics are distributions")

    def sequential_fits():
        """The same runs one after another, each ``n_iter`` single-run steps."""
        out = []
        for r in range(BATCH_RUNS):
            zd_r, wz_r = zds[r], wzs[r]
            for _ in range(n_iter):
                zd_r, wz_r, _ = cuda_em.em_step_fused(Xd, zd_r, wz_r, ws[r], compute_ll=False,
                                                       word=prep.word)
            out.append((zd_r, wz_r))
        return out

    t0 = time.perf_counter()
    seq = sequential_fits()
    torch.cuda.synchronize()
    seq_fit_s = time.perf_counter() - t0
    seq_zd, seq_wz = torch.stack([s_[0] for s_ in seq]), torch.stack([s_[1] for s_ in seq])
    gap = abs_err((zf, seq_zd), (wf, seq_wz))
    close = all(torch.allclose(a, b, rtol=BATCH_FIT_RTOL, atol=BATCH_FIT_ATOL)
                for a, b in ((zf, seq_zd), (wf, seq_wz)))
    zf2, wf2 = cuda_batch.batched_em_fit(Xd, zds, wzs, ws, n_iter, word=prep.word)
    repeat = torch.equal(zf, zf2) and torch.equal(wf, wf2)
    print(f"  batched fit, {BATCH_RUNS} runs x {n_iter} steps: {batch_fit_s:.4f} s wall; "
          f"{BATCH_RUNS} sequential em_step_fused fits {seq_fit_s:.4f} s wall; factors max abs "
          f"gap {gap:.3e} ({'0: bit for bit the same' if gap == 0 else 'not 0'}), within "
          f"rtol {BATCH_FIT_RTOL} / atol {BATCH_FIT_ATOL}: {close}; repeat batched fit "
          f"{'bit for bit the same' if repeat else 'DIFFERS'}")
    check(close, "the batched fit agrees with the sequential fits")
    check(repeat, "repeat batched fits are bit for bit the same")

    wzT_b = wzs.transpose(1, 2).contiguous()
    batch_plain_ms = cuda_ms(lambda: em.batched_accumulators_dense(Xd, zds, wzs, ws), 2)
    timing["batch"] = (cuda_ms(lambda: cuda_batch.batch_rows(Xd, zds, wzT_b), 20),
                       batch_plain_ms)
    timing["batch_word"] = (cuda_ms(lambda: cuda_batch.batch_words(prep.word, zds, wzT_b, ws),
                                    20), batch_plain_ms)
    bounds["batch"] = batch_bound_ms(Xd, BATCH_RUNS, kp, nnz, "rows")
    bounds["batch_word"] = batch_bound_ms(Xd, BATCH_RUNS, kp, nnz, "words")
    both = batch_bound_ms(Xd, BATCH_RUNS, kp, nnz, "both")
    acc_ms = cuda_ms(lambda: cuda_batch.batched_accumulators(Xd, zds, wzs, ws, word=prep.word),
                     20)
    seq_acc_ms = cuda_ms(lambda: [cuda_em.em_accumulators_fused(
        Xd, zds[r], wzs[r], ws[r], compute_ll=False, word=prep.word)
        for r in range(BATCH_RUNS)], 5)
    fit_ms = cuda_ms(lambda: cuda_batch.batched_em_fit(Xd, zds, wzs, ws, n_iter,
                                                       word=prep.word), 1)
    seq_fit_ms = cuda_ms(sequential_fits, 1)
    print(f"  time at 20NG, R = {BATCH_RUNS}, k = 20, bf16 X (CUDA events): batched "
          f"accumulators {acc_ms:.4f} ms (row pass {timing['batch'][0]:.4f} ms, word pass "
          f"{timing['batch_word'][0]:.4f} ms), {BATCH_RUNS} single-run accumulators "
          f"{seq_acc_ms:.4f} ms, plain batched {batch_plain_ms:.4f} ms; bound {both[0]:.4f} ms "
          f"({both[1]}), row pass {bounds['batch'][0]:.4f}, word pass "
          f"{bounds['batch_word'][0]:.4f}")
    print(f"  {n_iter}-step fits (CUDA events): batched {fit_ms:.2f} ms, {BATCH_RUNS} sequential "
          f"{seq_fit_ms:.2f} ms; batched is "
          f"{seq_fit_ms / fit_ms:.2f} times faster; phase 12 took "
          f"{time.perf_counter() - t_phase12:.1f} s")

    for name, err in streamed_phase(XC, docs_c, sparse_model, resident_peak, cuda_em, em,
                                    cuda_sparse, totals).items():
        worst[name] = max(worst[name], err)
    surface_phase(X, model, cuda_em, em, totals)

    print(json.dumps({"kernels": [
        {"name": f"{Path(source).stem}_{name}", "route": "cuda", "source": source,
         "replaces": replaces, "launches": totals[name], "max_abs_err": worst[name],
         "ms": timing[name][0], "plain_ms": timing[name][1], "bound_ms": bounds[name][0],
         "bound_by": bounds[name][1], "library_ms": None}
        for name, (source, replaces) in KERNELS.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
