"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--phase 23]

Builds the CUDA kernels from ``enstop_torch/ops/csrc`` (``em_dense.cu``,
``em_sparse.cu``, ``em_sparse_wide.cu``, ``em_batch.cu``, ``umap_layout.cu`` and
``mt_uniform.cu``, one ``nvcc`` each, started together)
and checks each kernel (the dense fp32 and bf16-responsibilities modes of
``precision="fast"``, the sparse word and doc passes, plain and thresholded,
the batched row and word passes; phase 17: the dense B pass and the word
pass in the E-step's ratio modes) against its plain PyTorch version on the
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
    of phase 3's model (phase 14);
12. the device mesh on the one card (phase 15), its tiles, shards and
    runs-shards laid on cuda:0 by a ``_devices()`` override, after the dense
    kernels on two tiles of a 2 x 2 mesh and the sparse passes on one of
    config C's four docs shards are held against their plain versions:
    (a) ``BlockParallelPLSA`` on its default mesh (1 x 1) at 20NG, 100
    iterations, bit for bit phase 3's ``PLSA.fit``, and its ``transform``;
    (b) a 2 x 2 mesh of four tiles, fit and ``transform``, its final LL within
    1e-5 of (a)'s, a repeat fit bit for bit; (c) ``DistributedPLSA(layout=
    "sparse")`` over 4 docs shards at config C, within 1e-5 of phase 9's fit;
    (d) ``BlockParallelPLSA(e_step_thresh=1e-16)`` over 4 docs shards at
    20NG, within 1e-5 of phase 10's; (e) ``EnsembleTopics(parallelism=
    "sharded")`` at 20NG, 16 runs over 4 runs-shards, its topic stack bit for
    bit that of the same runs on 1 runs-shard. Each path's wall, EM-loop time
    and peak device memory is printed beside its single-device counterpart's;
13. the reference-compatible modules at 20NG, k = 20 (phase 16): (a)
    ``plsa.plsa_fit_inner`` from phase 3's init, 100 iterations, tolerance 0,
    every step on the thresholded word and doc passes (the reference's
    ``e_step_thresh`` 1e-32), held against the same schedule on the plain COO
    steps of ``ops/coo.py`` on the card (the ``(nnz, k)`` responsibilities
    materialised): final LL within 1e-5 relative, the same step count, both
    walls; (b) ``plsa.plsa_refit_inner`` on 2,000 documents against phase 3's
    topics, exactly ``n_iter`` thresholded doc passes, against the plain COO
    refit; (c) ``cuda_plsa.plsa_fit``, ``block_parallel_plsa.plsa_fit`` and
    ``distributed_plsa.plsa_fit`` at their defaults, bit for bit one another;
    (d) ``streamed_plsa.plsa_fit(block_size=4096)``, its LL within 1e-5 of the
    resident sparse fit's from the same seed; (e)
    ``enstop_.generate_combined_topics_hellinger_umap`` on phase 7's topic
    stack as numpy (the default ``device`` takes it to the card) and as the
    CUDA tensor: the Hellinger matrix, the UMAP layout (on the card) and the
    clusters bit for bit, the stable topics within 1e-5 (a numpy stack is
    merged on the host);
14. the E-step's ratio modes at 20NG, kp = 24, bf16 X (phase 17;
    ``cuda_em._em_accumulators_ratio``, the port of the TPU experiment
    ``scripts/exp_divide_pipeline.py``): in each of the seven modes of
    ``cuda_em.RATIO_MODES``, B (the dense kernel) and A (the word pass),
    weighted and not, against the mode's plain version, ``f32div`` and
    ``bf16r`` bit for bit the shipped fp32 and fast steps; then the
    experiment's 20-step EM loop in each mode (best of 3 to a host readback,
    the path whose launches are counted), its LL against the initial one and
    ``f32div``'s; then each mode's step, B pass and word pass alone (CUDA
    events), the word pass also at config C;
15. the estimators' input contract at 20NG (phase 18), through the public
    estimators on the card with phase 3's schedule: (a) ``PLSA.fit`` on
    ``X > 0`` as a bool CSR matrix gives the bits of the same matrix as
    uint8 counts, dense and ``backend="sparse"``; (b) a CSC, a COO and a
    ``csr_array`` of the counts give phase 3's CSR fit bit for bit; (c)
    ``transform`` of 2,000 documents as an ``object`` array of integer counts
    gives the bits of their float64 array; (d) every public estimator's
    ``fit``, and ``transform``, refuse a complex matrix, 0 features, 0
    samples and a 1-D input with ``ValueError``, with the launch counts and
    the device's allocated bytes unchanged. It prints the host validation
    wall of the int64 and bool corpora beside the fit walls;
16. the 20-Newsgroups loader and scikit-learn's metadata routing (phase
    19): (a) phase 3's corpus and labels written with
    ``datasets.save_20newsgroups_npz`` and read back with
    ``load_20newsgroups_counts(local_npz=...)`` give phase 3's ``PLSA.fit``
    bit for bit, with phase 3's launches; (b) ``load_20newsgroups_counts(
    data_home=<empty directory>)`` raises ``RuntimeError`` (no ``.npz``, and
    no scikit-learn or no cache); (c) ``get_metadata_routing()`` and
    ``set_fit_request()`` raise ``RuntimeError`` without scikit-learn loaded.
    (b) and (c) change no launch count and no allocated byte;
17. the 20NG ensemble's runs in groups on the batched kernel (phase 20),
    the fan-out's route (``ops/driver.py`` ``fit_padded_runs``), against the
    same 16 runs one after another on the staged corpus: the stack and each
    run's steps, final state, final LL and LL trace bit for bit, and the
    whole ``EnsembleTopics.fit`` on each route, its stable topics and
    embedding bit for bit. It prints the groups, both routes' walls, their
    device high-water against the staging's (which the runs must not pass)
    and the counters ``em_steps`` and ``batched_run_steps``;
18. the sparse passes past 256 topics (phase 21, ``em_sparse_wide.cu``):
    (a) each pass at k = 1,000 against its plain version on 5,000 documents
    of config C', weighted and not, each threshold, LL on and off; then at
    the corpus of the cell ``nytimes-k1000.fit-wide`` (300,000 x 102,660,
    69.7 M nonzeros, made on the card from a fixed seed) with the LL on,
    unweighted without a threshold and weighted with one, against the plain
    version run over blocks of about 1 GiB of gathered rows, and timed
    there (the threshold the median of the products, where 1e-3 drops every
    one at 1,000 topics); (b) ``PLSA(n_components=1000,
    backend="sparse", n_iter=20, tolerance=0)`` at config C' through its
    normal path, every pass on the wide walk (launches and the trace's
    ``wide_passes``), held to ``benchmark/reference/plsa_wide.py`` (float64
    on the card, same init) by the cell ``nytimes-k1000.fit-wide``'s limits,
    and its ``transform`` of 2,000 documents to the float64 refit within
    5e-5 (widest row, l1). Every kernel instance up to 256 topics giving a
    parent's bits is checked by ``scripts/torch_narrow_bits.py``, run on the
    parent's checkout and this one in one call.
19. the random init drawn on the card (phase 22, ``mt_uniform.cu``) at the
    cell ``nytimes-k1000.fit-wide``'s shapes (300,000 documents, 102,660
    words, k = 1,000): ``plsa_init``'s factors and then ``_refit_init``'s
    into the sparse layout's (n, k) and (k, m), bit for bit the host's, the
    ``RandomState`` after each where the host's draw leaves it, a second
    draw from the same state the same bits; timed against the host's draw,
    split between the twist and the rows kernels by ``torch.profiler``.
20. ``EnsembleTopics(n_components=20, model="nmf")`` at the corpus of the
    cell ``nytimes-enstop-nmf-k20.ensemble-nmf`` (phase 23; the whole UCI
    NYTimes shape, 69.7 M nonzeros): 16 bootstrap runs of 200 KL updates on
    the sparse passes, the combine and the 200-update embedding, through
    ``EnsembleTopics.fit``; its launches, its trace's NMF spans and
    counters, runs 0 and 15 and the embedding against the float64 reference
    ``benchmark/reference/ensemble_nmf.py`` by the cell's limits, and the
    SHA-256 digests of ``components_`` and ``embedding_``.
    ``python3 chip_smoke.py --phase 23`` runs phase 1's build and this phase
    alone (about 2 minutes).

Phase 1 prints the sparse walk's shape (``cuda_sparse.walk_shape``: L lanes an
entry, TPL topics a lane) at the main paths' topic counts (k = 20 sparse, kp =
24 dense) with the registers and spill stores of its instances, and fails if
one of them spills; the same for the dense row walk's instances
(``em_accumulate`` and ``batch_rows``, ``csrc/row_walk.cuh``) at kp = 20, 24
and 104, failing on a spill at kp = 20 and 24, and for the wide walk's
instances (``em_sparse_wide.cu``), failing on a spill at kp = 1000. Phase 2 also times the dense
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
The layout kernel (``umap_layout``), on the spectral start, graph, (a, b) and
seed of the fast ensemble's own layout (phase 6): with b = 1, where powf is
exact, the CPU loop's bits after 1, 5 and 20 epochs (so its negative samples
are the numpy draws); at UMAP's (a, b) within 1e-5, 1e-3 and 5e-2 of the
largest coordinate of the loop's (``tests/test_torch_umap_layout.py``'s
``LOOP_GAP``: powf is the card's on one side and the CPU's on the other); the
ensemble's 500-epoch layout again bit for bit; its time alone against the CPU
loop's, and a bound of its fp32 operations on the one SM its block runs on.
Phase 17: ``f32div``, ``recip_mul``, ``lax_recip``, ``nr1`` and ``nr2`` hold A
and B to 1e-4, as the fp32 dense modes; ``bf16recip_x32`` and ``bf16r`` A to
1e-4 and B to 1e-3 and must lie 4 times nearer their plain version than the
``f32div`` one, as the bf16r modes (the MUFU seed of ``nr1``, ``nr2`` and
``bf16recip_x32`` can differ from the plain version's correctly rounded one
at a bf16 rounding boundary); each fp32-accurate mode's LL after the 20-step
loop lies within 1e-4 relative of ``f32div``'s.

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
# one of its 132 SMs, an fp32 operation a lane a cycle (FP32_FLOP_PER_S counts
# an FMA as two; the layout kernel contracts nothing into one)
FP32_OP_PER_SM_S = FP32_FLOP_PER_S / 2 / 132
# the layout kernel against the CPU loop at UMAP's (a, b), by epochs run: the
# largest coordinate gap over the largest coordinate (tests/test_torch_umap_layout.py)
LAYOUT_GAP = {1: 1e-5, 5: 1e-3, 20: 5e-2}
DENSE_SOURCE = "enstop_torch/ops/csrc/em_dense.cu"
SPARSE_SOURCE = "enstop_torch/ops/csrc/em_sparse.cu"
WIDE_SOURCE = "enstop_torch/ops/csrc/em_sparse_wide.cu"
BATCH_SOURCE = "enstop_torch/ops/csrc/em_batch.cu"
LAYOUT_SOURCE = "enstop_torch/ops/csrc/umap_layout.cu"
MT_SOURCE = "enstop_torch/ops/csrc/mt_uniform.cu"
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
    "word_pass_wide": (WIDE_SOURCE, "enstop_tpu/ops/pallas_sell.py:456"),
    "word_pass_wide_thresh": (WIDE_SOURCE, "enstop_tpu/ops/pallas_sell.py:456"),
    "doc_pass_wide": (WIDE_SOURCE, "enstop_tpu/ops/pallas_sell.py:490"),
    "doc_pass_wide_thresh": (WIDE_SOURCE, "enstop_tpu/ops/pallas_sell.py:490"),
    # no TPU kernel: the JAX package's layout is one compiled lax.fori_loop
    "umap_layout": (LAYOUT_SOURCE, "enstop_tpu/cluster/umap.py:183"),
    # no TPU kernel: the JAX package draws the init on the host
    "mt_uniform": (MT_SOURCE, "enstop_tpu/ops/init.py (numpy, on the host)"),
}
# phase 17: the ratio modes built for the divide experiment's step only
# (cuda_em.RATIO_MODES less "f32div" and "bf16r", which are rows em / em_bf16r)
EXPERIMENT_RATIOS = ("recip_mul", "lax_recip", "nr1", "nr2", "bf16recip_x32")
LOSSY_RATIOS = ("bf16recip_x32", "bf16r")  # held as the bf16r modes are
KERNELS.update({f"{kind}_{mode}": (source, "scripts/exp_divide_pipeline.py:88")
                for mode in EXPERIMENT_RATIOS
                for kind, source in (("em", DENSE_SOURCE), ("word_pass", SPARSE_SOURCE))})
RATIO_STEPS = 20  # phase 17: the experiment's EM loop, best of 3 after a warm one
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
MESH = dict(n_components=20, n_iter=100, n_iter_per_test=10, tolerance=0, random_state=0,
            device="cuda")                   # phase 15, as phase 3's PLSA
MESH_LL_RTOL = 1e-5  # a mesh fit's final LL against its single-device counterpart's
INNER = dict(n_iter=100, n_iter_per_test=10, tolerance=0.0)  # phase 16 (a)
COMPAT_LL_RTOL = 1e-5  # phase 16: the inner loop against the plain steps, streamed vs resident
STREAM_DOCS_16 = 4096  # phase 16 (d)'s block_size
# phase 21: the wide walk's fit at config C', held to the cell nytimes-k1000.fit-wide's
# limits of the float64 reference; its transform to the widest-row l1 limit of
# PERF.md's transform cell (5e-5, at which the sound transform read 1.6-2.4e-7)
WIDE_FIT = dict(n_components=1000, backend="sparse", n_iter=20, n_iter_per_test=10,
                tolerance=0.0, random_state=0, device="cuda")
WIDE_TRANSFORM_L1 = 5e-5
WIDE_CELL, WIDE_CORPUS_SEED = "nytimes-k1000.fit-wide", 2_400_210_001
WIDE_BLOCK_BYTES = 1 << 30  # plain_pass_blocked: gathered rows a block
# phase 22: the init drawn on the card at the cell nytimes-k1000.fit-wide's
# documents, words and topics
MT_SHAPE, MT_SEED = (300_000, 102_660, 1_000), 2_400_220_001
NMF_CELL, NMF_CORPUS_SEED, NMF_CALL_SEED = ("nytimes-enstop-nmf-k20.ensemble-nmf",
                                           2_400_230_001, 2_400_230_002)
NMF_RUNS = (0, 15)  # phase 23: the runs held to the float64 reference


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


def layout_bound_ms(eps, n_epochs, dim, rounds=5):
    """The least time of the layout kernel, whose one block runs on one SM:
    its fp32 operations over that SM's rate. Each active edge of an epoch (the
    schedule of next_epoch, run here) costs in each of its 1 + ``rounds``
    steps dsq (3 a dimension) and a coefficient (6 attracting, 7 repelling,
    powf counted as one), and 6 a coordinate of each end it moves (two in the
    attractive step, the head in a negative round); barriers and the ordered
    sums' latency are not counted."""
    next_epoch, active_edges = eps.copy(), 0
    for epoch in range(n_epochs):
        active = next_epoch <= np.float32(epoch + 1)
        active_edges += int(active.sum())
        next_epoch[active] += eps[active]
    ops = active_edges * ((1 + rounds) * 3 * dim + 6 + 7 * rounds + (2 + rounds) * 6 * dim)
    return 1e3 * ops / FP32_OP_PER_SM_S, "operations"


def check_layout_kernel(optimize, emb, W, n_epochs, a, b, seed, layout):
    """The layout kernel on the inputs of a main-path layout (the start, graph,
    epochs, a, b and seed ``umap_embed`` gave ``optimize``, that is
    ``umap._optimize_layout_device``, and the ``layout`` it returned) against
    the CPU loop, as the module docstring says. Returns ``(max abs gap to the
    loop at UMAP's (a, b), (kernel ms, CPU loop ms), bound)``."""
    from enstop_torch.cluster import umap
    from enstop_torch.ops import cuda_umap

    dev = torch.device("cuda")
    worst = 0.0
    for epochs in sorted(LAYOUT_GAP):
        loop, card = (optimize(emb, W, epochs, a, b, seed, device=d) for d in ("cpu", dev))
        same = np.array_equal(*(optimize(emb, W, epochs, a, 1.0, seed, device=d)
                                for d in ("cpu", dev)))
        gap = float(np.abs(card - loop).max())
        worst = max(worst, gap)
        print(f"  layout kernel vs the CPU loop, {emb.shape[0]} points in {emb.shape[1]} "
              f"dimensions, {epochs} epochs: b = 1 {'bit for bit the same' if same else 'DIFFER'}"
              f"; at UMAP's (a, b) max abs gap {gap:.3e} over max |coordinate| "
              f"{float(np.abs(loop).max()):.3e}")
        check(same, f"the layout kernel gives the CPU loop's bits at b = 1 after {epochs} epochs")
        check(gap <= LAYOUT_GAP[epochs] * float(np.abs(loop).max()),
              f"the layout kernel agrees with the CPU loop after {epochs} epochs")
    check(np.array_equal(optimize(emb, W, n_epochs, a, b, seed, device=dev), layout),
          "the ensemble's layout is the kernel's again, bit for bit")
    x, heads, tails, eps, a32, b32 = umap._layout_inputs(emb, W, a, b)
    n, dim = x.shape
    packed = torch.from_numpy(cuda_umap.pack(x, heads, tails, eps)).to(dev)
    # each launch on a fresh copy of the start (a 20-100 KB copy on the card)
    kernel_ms = cuda_ms(lambda: cuda_umap.launch_layout(packed.clone(), n, dim, n_epochs, a32,
                                                        b32, seed), 5)
    t0 = time.perf_counter()
    optimize(emb, W, n_epochs, a, b, seed, device="cpu")
    loop_ms = 1e3 * (time.perf_counter() - t0)
    least = layout_bound_ms(eps, n_epochs, dim)
    print(f"  layout kernel, {n_epochs} epochs, {heads.size} edges (CUDA events): "
          f"{kernel_ms:.4f} ms, {1e3 * kernel_ms / n_epochs:.2f} us an epoch; the CPU loop "
          f"{loop_ms:.1f} ms; bound {least[0]:.4f} ms ({least[1]}, one SM)")
    return worst, (kernel_ms, loop_ms), least


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


def ratio_suffix(ratio):
    """``""`` for ratio mode 0 (fp32), else ``"_<mode>"`` (``_bf16r`` for 6)."""
    from enstop_torch.ops.em import RATIO_MODES

    return f"_{RATIO_MODES[int(ratio)]}" if int(ratio) else ""


def sparse_instance(mangled):
    """``"L<L>_TPL<TPL>_V<V>_<pass>[_thresh|_<ratio mode>]"`` for a mangled
    ``segment_pass`` instance of ``em_sparse.cu``, else None."""
    m = re.search(r"segment_passILi(\d+)ELi(\d+)ELi(\d+)ELb([01])ELb([01])ELi(\d+)EE", mangled)
    if m is None:
        return None
    L, tpl, v, word, thresh, ratio = (int(g) for g in m.groups())
    return (f"L{L}_TPL{tpl}_V{v}_{'word' if word else 'doc'}" + ("_thresh" if thresh else "")
            + ratio_suffix(ratio))


def wide_instance(mangled):
    """``"TPL<TPL>_V<V>_<pass>[_thresh]"`` for a mangled ``wide_walk_segments``
    instance of ``em_sparse_wide.cu``, ``"reduce_TPL<TPL>_V<V>"`` for a
    ``wide_walk_reduce`` one, else None."""
    m = re.search(r"wide_walk_segmentsILi(\d+)ELi(\d+)ELb([01])ELb([01])EE", mangled)
    if m is not None:
        tpl, v, word, thresh = (int(g) for g in m.groups())
        return f"TPL{tpl}_V{v}_{'word' if word else 'doc'}" + ("_thresh" if thresh else "")
    m = re.search(r"wide_walk_reduceILi(\d+)ELi(\d+)EE", mangled)
    return None if m is None else "reduce_TPL{}_V{}".format(*m.groups())


def row_instance(mangled):
    """``"<kernel>_<x dtype>_L<L>_TPL<TPL>_V<V>[_B][_LL][_<ratio mode>]"`` for a
    mangled ``em_accumulate`` or ``batch_rows`` instance (``csrc/row_walk.cuh``),
    else None."""
    m = re.search(r"(em_accumulate|batch_rows)I(13__nv_bfloat16|f)Li(\d+)ELi(\d+)ELi(\d+)E"
                  r"(?:Lb([01])ELb([01])ELi(\d+)E)?E", mangled)
    if m is None:
        return None
    kernel, xt, L, tpl, v, with_b, ll, ratio = m.groups()
    return (f"{kernel}_{'bf16' if xt != 'f' else 'fp32'}_L{L}_TPL{tpl}_V{v}"
            + ("_B" if with_b != "0" else "") + ("_LL" if ll == "1" else "")
            + ratio_suffix(ratio or 0))


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


def card_problem(prep, k, weighted, seed):
    """Factors shaped as ``sparse_problem``'s, drawn on the card (the cell's
    300,000 x 1,000 Dirichlet draws take numpy about half a minute): P(z|d)
    from a Dirichlet(0.3), P(w|z) Zipf over the words with each topic's
    ranking shifted a little, and document weights."""
    n, m = prep.shape
    dev = prep.device
    torch.manual_seed(seed)
    zd = torch.distributions.Dirichlet(torch.full((k,), 0.3, device=dev)).sample((n,))
    zipf = 1.0 / torch.arange(1, m + 1, device=dev, dtype=torch.float64) ** 1.05
    shift = torch.randint(50, (k, 1), device=dev)
    wz = zipf[(torch.arange(m, device=dev) + shift) % m] * (0.5 + torch.rand(
        (k, m), device=dev, dtype=torch.float64))
    wz /= wz.sum(1, keepdim=True)
    w = 0.5 + torch.rand(n, device=dev)
    return zd.float(), wz.t().float().contiguous(), w if weighted else None

def plain_pass_blocked(side, zd, wzT, w, word, thresh):
    """The plain pass (``cuda_sparse``'s ``word_pass_plain`` / ``doc_pass_plain``)
    over blocks of whole segments, each about ``WIDE_BLOCK_BYTES`` of gathered
    rows, where its (nnz, k) temporaries would not fit the card. Each block's
    owner sums (float64 in the plain pass, rounded once to float32) and its LL
    are added in float64, so an owner split across blocks carries one float32
    rounding a block it spans. Returns the accumulator (float64) and the LL."""
    from enstop_torch.ops import cuda_sparse

    plain = cuda_sparse.word_pass_plain if word else cuda_sparse.doc_pass_plain
    per_block = max(1, WIDE_BLOCK_BYTES // (4 * zd.shape[1]))
    seg_ptr = side.seg_ptr.cpu()
    out = torch.zeros((side.n_owner, zd.shape[1]), dtype=torch.float64, device=zd.device)
    ll = torch.zeros((), dtype=torch.float64, device=zd.device)
    s0 = 0
    while s0 < side.n_seg:
        s1 = int(torch.searchsorted(seg_ptr, seg_ptr[s0] + per_block, right=True)) - 1
        s1 = min(max(s1, s0 + 1), side.n_seg)
        e0, e1 = int(seg_ptr[s0]), int(seg_ptr[s1])
        block = cuda_sparse.Side(side.idx[e0:e1], side.vals[e0:e1], side.seg_ptr[s0:s1 + 1] - e0,
                                 side.seg_owner[s0:s1], side.owner_seg_ptr, side.n_owner,
                                 side.n_index)
        part, part_ll = plain(block, zd, wzT, w, thresh=thresh, compute_ll=True)
        out += part
        ll += part_ll.double()
        s0 = s1
    return out, ll


def compare_sparse(name, prep, k, cuda_sparse):
    """The word and doc passes against their plain versions on one sparse
    layout, weighted and not, each threshold, LL on and off. Returns each
    kernel's largest absolute error on its accumulator."""
    wide = "_wide" if k > cuda_sparse.MAX_NARROW_KP else ""
    worst = {f"{p}{wide}{t}": 0.0 for p in ("word_pass", "doc_pass") for t in ("", "_thresh")}
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
                key = ("word_pass" if word else "doc_pass") + wide + ("_thresh" if thresh else "")
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


def on_one_card(cls, n_tiles):
    """``cls`` with a ``_devices()`` that names the first card ``n_tiles``
    times: the mesh then lays ``n_tiles`` tiles, shards or runs-shards on it."""
    card = torch.device("cuda", 0)
    return type(f"{cls.__name__}On{n_tiles}", (cls,), {"_devices": lambda self: [card] * n_tiles})


def timed_fit(make, X):
    """``(fitted model, wall s, peak device bytes above what was allocated
    before)`` of ``make().fit(X)``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = make().fit(X)
    return model, time.perf_counter() - t0, torch.cuda.max_memory_allocated() - base


def sparse_mesh_loop_s(X, e_step_thresh=None):
    """Seconds of the sparse docs mesh's EM loop alone, four shards on cuda:0
    packed beforehand, from the init and schedule of phase 15's fits, to the
    topics on the host."""
    from enstop_torch.ops.init import plsa_init
    from enstop_torch.parallel import sparse_mesh as sm

    card = torch.device("cuda", 0)
    mesh = sm.make_docs_mesh(devices=[card] * 4)
    preps, bounds, n, _ = sm.shard_sell(mesh, X)
    zd0, wz0 = plsa_init(X, MESH["n_components"], rng=np.random.RandomState(MESH["random_state"]))
    run = sm.build_sharded_sparse_fit(mesh, MESH["n_iter"], MESH["n_iter_per_test"],
                                      e_step_thresh=e_step_thresh)
    zd = sm._scatter_doc_sharded(mesh, zd0, bounds)
    w = sm._scatter_doc_sharded(mesh, np.ones(n, np.float32), bounds)
    wz = torch.from_numpy(wz0).to(card)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(preps, zd, wz, w, MESH["tolerance"]).state[1].cpu()
    return time.perf_counter() - t0


def mesh_phase(X, XC, docs, model, sparse_model, resident_peak, thresh_model, walls, cuda_em,
               em, cuda_sparse, totals):
    """Phase 15: the device mesh on one card, its tiles, shards and
    runs-shards laid on cuda:0 through a ``_devices()`` override. Returns
    the kernels' largest absolute errors at the mesh's shapes."""
    from enstop_torch.models import ensemble as ens
    from enstop_torch.parallel import mesh as mesh_lib
    from enstop_torch.parallel.sparse_mesh import make_docs_mesh, shard_sell
    import enstop_torch

    t_phase = time.perf_counter()
    card = torch.device("cuda", 0)
    # the kernels at the mesh's shapes against their plain versions: two of
    # the 2 x 2 mesh's tiles (both row and both column halves) and the first
    # of config C's four docs shards
    worst = {}
    tiles, _, _ = mesh_lib.stage_sharded_counts(mesh_lib.make_mesh(2, 2, [card] * 4), X)
    for i, j in ((0, 0), (1, 1)):
        Xt = tiles[i][j].device_array
        for name, err in compare_kernels(f"20NG tile ({i}, {j}) {Xt.shape[0]}x{Xt.shape[1]} "
                                         "k=20", Xt, 20, cuda_em, em).items():
            worst[name] = max(worst.get(name, 0.0), err)
    preps = shard_sell(make_docs_mesh(devices=[card] * 4), XC)[0]
    worst.update(compare_sparse(f"config C docs shard 0 ({preps[0].n} docs)", preps[0], 20,
                                cuda_sparse))
    del tiles, preps
    print("phase 15 kernels at the mesh's shapes vs plain: ok, largest abs err",
          json.dumps(worst))

    Block4, Dist4, Ens4 = (on_one_card(cls, 4) for cls in (
        enstop_torch.BlockParallelPLSA, enstop_torch.DistributedPLSA, enstop_torch.EnsembleTopics))
    flat, flat_wall, flat_peak = timed_fit(lambda: enstop_torch.PLSA(**MESH), X)

    # (a) the default mesh: 1 x 1 on one card, PLSA's fit bit for bit
    reset_counts(cuda_em, em)
    one, one_wall, one_peak = timed_fit(lambda: enstop_torch.BlockParallelPLSA(**MESH), X)
    emb_one = one.transform(docs)
    a_launches = read_counts("(a) BlockParallelPLSA 1 x 1 fit + transform",
                             ("em", "word_pass", "refit"), cuda_em, em, totals)
    same = all(np.array_equal(getattr(one, a), getattr(model, a))
               for a in ("components_", "embedding_", "history_"))
    print(f"phase 15 (a) BlockParallelPLSA on its default mesh "
          f"{one._make_mesh().shape}: fit {one_wall:.3f} s wall "
          f"({one.fit_info_['wall_time_s']:.4f} s in the EM loop), PLSA.fit {flat_wall:.3f} s "
          f"({flat.fit_info_['wall_time_s']:.4f} s); peak device memory {one_peak / 2**20:.1f} "
          f"MiB, PLSA {flat_peak / 2**20:.1f} MiB; factors and history against phase 3's "
          f"PLSA.fit: {'bit for bit the same' if same else 'DIFFER'}")
    check(one._make_mesh().shape == {"docs": 1, "vocab": 1}, "the default mesh is 1 x 1")
    check(same, "a 1 x 1 mesh fit is PLSA.fit bit for bit")

    # (b) four tiles of a 2 x 2 mesh on the one card
    reset_counts(cuda_em, em)
    four, four_wall, four_peak = timed_fit(
        lambda: Block4(n_row_blocks=2, n_col_blocks=2, **MESH), X)
    fit_launches = dict(cuda_em.LAUNCHES)
    t0 = time.perf_counter()
    emb_four = four.transform(docs)
    transform_wall = time.perf_counter() - t0
    launches = read_counts("(b) BlockParallelPLSA 2 x 2 fit + transform",
                           ("em", "word_pass", "refit"), cuda_em, em, totals)
    ll_a, ll_b = one.fit_info_["log_likelihood"], four.fit_info_["log_likelihood"]
    gap = abs(ll_b - ll_a) / abs(ll_a)
    embed_gap = float(np.abs(emb_four - emb_one).max())
    again = Block4(n_row_blocks=2, n_col_blocks=2, **MESH).fit(X)
    repeat = all(np.array_equal(getattr(again, a), getattr(four, a))
                 for a in ("components_", "embedding_", "history_"))
    print(f"phase 15 (b) 2 x 2 mesh, four tiles on cuda:0: fit {four_wall:.3f} s wall "
          f"({four.fit_info_['wall_time_s']:.4f} s in the EM loop; 1 x 1 "
          f"{one.fit_info_['wall_time_s']:.4f} s), transform of {N_TRANSFORM} docs "
          f"{transform_wall:.3f} s; peak device memory {four_peak / 2**20:.1f} MiB; final LL "
          f"{ll_b:.6f} vs 1 x 1 {ll_a:.6f}, rel gap {gap:.3e}; n_iter_ {four.n_iter_}; "
          f"transform max abs gap to 1 x 1 {embed_gap:.3e}; repeat fit "
          f"{'bit for bit the same' if repeat else 'DIFFERS'}; fit launches "
          f"{json.dumps(fit_launches)}")
    check(four._make_mesh().shape == {"docs": 2, "vocab": 2}, "the mesh is 2 x 2")
    check(fit_launches["em"] == fit_launches["word_pass"] == 4 * a_launches["em"]
          == 4 * MESH["n_iter"], "every EM step ran #1 and #8 on each of the four tiles")
    check(launches["refit"] > fit_launches["refit"]
          and (launches["refit"] - fit_launches["refit"]) % 4 == 0,
          "transform ran #2 on each of the four tiles")
    check(gap <= MESH_LL_RTOL and four.n_iter_ == one.n_iter_,
          "the 2 x 2 fit agrees with the 1 x 1 fit")
    check(embed_gap <= EMBED_ATOL, "the 2 x 2 transform agrees with the 1 x 1 transform")
    check(repeat, "repeat 2 x 2 fits are bit for bit the same")
    check_distributions(four.components_, "2 x 2 topics")
    del again

    # (c) the sparse docs mesh at config C, four shards on the one card
    reset_counts(cuda_em, em)
    dist, c_wall, c_peak = timed_fit(lambda: Dist4(layout="sparse", **MESH), XC)
    launches = read_counts("(c) DistributedPLSA(layout='sparse') at config C",
                           ("word_pass", "doc_pass"), cuda_em, em, totals)
    ll_c, ll_9 = dist.fit_info_["log_likelihood"], sparse_model.fit_info_["log_likelihood"]
    gap = abs(ll_c - ll_9) / abs(ll_9)
    print(f"phase 15 (c) DistributedPLSA(layout='sparse') at config C, 4 docs shards on cuda:0: "
          f"fit {c_wall:.3f} s wall ({dist.fit_info_['wall_time_s']:.3f} s with the shards' "
          f"packing, {sparse_mesh_loop_s(XC):.3f} s in the EM loop; phase 9's resident fit "
          f"{sparse_model.fit_info_['wall_time_s']:.3f} s in the EM loop); peak device memory "
          f"{c_peak / 2**20:.1f} MiB (phase 9 {resident_peak / 2**20:.1f} MiB); final LL "
          f"{ll_c:.6f} vs phase 9 {ll_9:.6f}, rel gap {gap:.3e}")
    check(launches["word_pass"] == 4 * MESH["n_iter"], "each step ran #8 on each of 4 shards")
    check(all(launches[k] == 0 for k in ("em", "refit", "ll", "em_bf16r", "refit_bf16r")),
          "the sparse mesh launched no dense kernel")
    check(gap <= MESH_LL_RTOL and dist.n_iter_ == sparse_model.n_iter_,
          "the sparse mesh fit agrees with phase 9's resident sparse fit")
    check_distributions(dist.components_, "sparse mesh topics")
    del dist

    # (d) a firing threshold routes BlockParallelPLSA to the sparse docs mesh
    reset_counts(cuda_em, em)
    thresh, d_wall, d_peak = timed_fit(lambda: Block4(e_step_thresh=1e-16, **MESH), X)
    launches = read_counts("(d) BlockParallelPLSA(e_step_thresh=1e-16) fit",
                           ("word_pass_thresh", "doc_pass_thresh"), cuda_em, em, totals)
    ll_d, ll_10 = thresh.fit_info_["log_likelihood"], thresh_model.fit_info_["log_likelihood"]
    gap = abs(ll_d - ll_10) / abs(ll_10)
    print(f"phase 15 (d) BlockParallelPLSA(e_step_thresh=1e-16) at 20NG, 4 docs shards: fit "
          f"{d_wall:.3f} s wall ({thresh.fit_info_['wall_time_s']:.3f} s with the shards' "
          f"packing, {sparse_mesh_loop_s(X, 1e-16):.3f} s in the EM loop; phase 10 "
          f"{thresh_model.fit_info_['wall_time_s']:.3f} s in the EM loop); peak device memory "
          f"{d_peak / 2**20:.1f} MiB; final LL {ll_d:.6f} vs phase 10 {ll_10:.6f}, rel gap "
          f"{gap:.3e}")
    check(launches["word_pass_thresh"] == launches["doc_pass_thresh"] == 4 * MESH["n_iter"]
          and launches["em"] == 0, "the thresholded passes ran on each shard, no dense step")
    check(gap <= MESH_LL_RTOL, "the thresholded mesh fit agrees with phase 10's")

    # (e) the runs-sharded ensemble: 16 runs over 4 runs-shards on the one card
    captured = {}
    run_all = ens._ensemble_of_topics_device

    def keep_stack(*args, **kwargs):
        captured["call"] = (args, kwargs)
        stack, steps = run_all(*args, **kwargs)
        captured["stack"] = stack
        return stack, steps

    ens._ensemble_of_topics_device = keep_stack
    try:
        reset_counts(cuda_em, em)
        ens4, e_wall, e_peak = timed_fit(
            lambda: Ens4(parallelism="sharded", device="cuda", **ENSEMBLE), X)
        timings = dict(ens.ensemble_fit.last_timings)
        read_counts("(e) sharded ensemble fit, 4 runs-shards", ("em", "word_pass", "refit"),
                    cuda_em, em, totals)
    finally:
        ens._ensemble_of_topics_device = run_all
    stack4 = captured["stack"]
    args, kwargs = captured["call"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    stack1, _ = run_all(*args, **{**kwargs, "devices": [card]})  # one runs-shard
    torch.cuda.synchronize()
    one_shard_s = time.perf_counter() - t0
    one_shard_peak = torch.cuda.max_memory_allocated() - base
    same = torch.equal(stack4, stack1)
    fit_s, _, single = walls["default"]
    print(f"phase 15 (e) EnsembleTopics(parallelism='sharded'), {ENSEMBLE['n_starts']} runs on "
          f"4 runs-shards of cuda:0: n_components_ {ens4.n_components_}, fit_transform "
          f"{e_wall:.3f} s wall (phase 7's weights fan-out {fit_s:.3f} s), runs "
          f"{timings['runs_s']:.3f} s (phase 7 {single['runs_s']:.3f} s; the same runs on 1 "
          f"runs-shard {one_shard_s:.3f} s), "
          f"last_timings {json.dumps(timings)}; peak device memory {e_peak / 2**20:.1f} MiB, "
          f"staging included (the 1-shard runs on the staged corpus "
          f"{one_shard_peak / 2**20:.1f} MiB); topic stack on 4 runs-shards "
          f"vs 1: {'bit for bit the same' if same else 'DIFFERS'}")
    check(tuple(stack4.shape) == (ENSEMBLE["n_starts"] * 20, X.shape[1])
          and stack4.device.type == "cuda", "the sharded stack is (320, n_words) on the card")
    check(same, "the sharded stack is the same at 4 runs-shards and at 1")
    check(ens4.n_components_ >= 2, "the sharded ensemble finds at least two stable topics")
    check_distributions(ens4.components_, "sharded ensemble topics")
    check_distributions(ens4.embedding_, "sharded ensemble embedding")
    print(f"  phase 15 took {time.perf_counter() - t_phase:.1f} s")
    return worst


def coo_inner_loop(coo, zd, wz, w, n_iter, n_iter_per_test, tolerance, refit=False,
                   thresh=1e-32):
    """The reference's inner loop (``plsa_fit_inner``, or with ``refit``
    ``plsa_refit_inner``, whose gate never passes) on the plain COO steps of
    ``ops/coo.py`` on the card, the ``(nnz, k)`` responsibilities
    materialised. Returns ``(zd, wz, tested LLs, steps)``."""
    from enstop_torch.ops import coo as coo_ops

    rows, cols, vals = coo
    n, m = zd.shape[0], wz.shape[1]
    lls = [float(coo_ops.log_likelihood_coo(rows, cols, vals, zd, wz, w))]
    steps = 0
    for i in range(n_iter):
        resp = coo_ops.e_step_coo(rows, cols, vals, zd, wz, thresh)
        zd, new_wz = coo_ops.m_step_coo(rows, cols, vals, resp, n, m)
        wz = wz if refit else new_wz
        steps += 1
        if i % n_iter_per_test == 0:
            lls.append(float(coo_ops.log_likelihood_coo(rows, cols, vals, zd, wz, w)))
            change = abs(lls[-1] - lls[-2])
            if not refit and (change == 0 or change / abs(lls[-1]) < tolerance):
                break
    return zd, wz, lls, steps


def sides_wall(host_coo, n, m, word=True):
    """Seconds ``plsa_fit_inner`` (``word``) or ``plsa_refit_inner`` spends
    shipping the caller's COO and building its sides, to a synchronise."""
    from enstop_torch import plsa

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plsa._sides(*host_coo, n, m, torch.device("cuda"), word=word)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def compat_phase(X, docs, model, sprep, default_stack, cuda_em, em, totals):
    """Phase 16 at 20NG, k = 20: the reference-compatible modules."""
    from enstop_torch import (block_parallel_plsa, cuda_plsa, distributed_plsa, enstop_, plsa,
                              streamed_plsa)
    from enstop_torch.models import ensemble as ens
    from enstop_torch.ops import sell
    from enstop_torch.ops.init import plsa_init

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    k = 20
    coo = X.tocoo()
    host_coo = (coo.row, coo.col, coo.data.astype(np.float32))
    dev_coo = (torch.from_numpy(coo.row.astype(np.int64)).to(dev),
               torch.from_numpy(coo.col.astype(np.int64)).to(dev),
               torch.from_numpy(coo.data.astype(np.float32)).to(dev))
    w = np.ones(X.shape[0], np.float32)
    zd0, wz0 = plsa_init(X, k, rng=np.random.RandomState(0))  # phase 3's init

    tested, real_ll = [], plsa.log_likelihood_sell

    def tested_ll(*args):
        ll = real_ll(*args)
        tested.append(float(ll))
        return ll

    # (a) plsa_fit_inner on the thresholded passes, then the plain COO steps
    plsa.log_likelihood_sell = tested_ll
    try:
        reset_counts(cuda_em, em)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        zd_a, wz_a = plsa.plsa_fit_inner(*host_coo, wz0.copy(), zd0.copy(), w, **INNER)
        inner_s = time.perf_counter() - t0
        launches = read_counts("(a) plsa_fit_inner", ("word_pass_thresh", "doc_pass_thresh",
                                                      "doc_pass"), cuda_em, em, totals)
        lls_a = list(tested)
        t0 = time.perf_counter()
        again = plsa.plsa_fit_inner(*host_coo, wz0.copy(), zd0.copy(), w, **INNER)
        warm_s = time.perf_counter() - t0
    finally:
        plsa.log_likelihood_sell = real_ll
    sides_s = sides_wall(host_coo, *X.shape)
    steps = launches["word_pass_thresh"]
    check(steps == launches["doc_pass_thresh"] == INNER["n_iter"]
          and launches["doc_pass"] == len(lls_a) == 11 and launches["word_pass"] == 0,
          "every step of plsa_fit_inner ran the thresholded passes, the 11 LL tests the doc "
          "pass")
    check(np.array_equal(again[0], zd_a) and np.array_equal(again[1], wz_a),
          "repeat plsa_fit_inner runs are bit for bit the same")
    w_dev = torch.ones(X.shape[0], device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    zd_p, wz_p, lls_p, steps_p = coo_inner_loop(
        dev_coo, torch.from_numpy(zd0).to(dev), torch.from_numpy(wz0).to(dev), w_dev,
        INNER["n_iter"], INNER["n_iter_per_test"], INNER["tolerance"])
    plain_s = time.perf_counter() - t0
    gap = abs(lls_a[-1] - lls_p[-1]) / abs(lls_p[-1])
    factor_gap = float(np.abs(wz_a - wz_p.cpu().numpy()).max())
    print(f"phase 16 (a) plsa_fit_inner at 20NG ({X.nnz} nonzeros), {steps} steps on the "
          f"thresholded passes: {inner_s * 1e3:.2f} ms wall (again {warm_s * 1e3:.2f} ms, of "
          f"which {sides_s * 1e3:.2f} ms ship the COO and build the two sides), "
          f"the same loop on the plain COO steps on the card {plain_s * 1e3:.2f} ms "
          f"({steps_p} steps), {plain_s / warm_s:.2f} times the warm wall; final LL "
          f"{lls_a[-1]:.6f} plain {lls_p[-1]:.6f} rel gap {gap:.3e}; topics max abs gap "
          f"{factor_gap:.3e}; tested LLs {lls_a}")
    check(steps_p == steps and len(lls_p) == len(lls_a) and gap <= COMPAT_LL_RTOL,
          "plsa_fit_inner agrees with the plain COO loop")
    check_distributions(wz_a, "plsa_fit_inner topics")

    # (b) plsa_refit_inner: exactly n_iter thresholded doc passes
    dcoo = docs.tocoo()
    r0 = np.random.RandomState(model.transform_random_seed).rand(docs.shape[0], k)
    r0 = (r0 / r0.sum(axis=1, keepdims=True)).astype(np.float32)
    d_host = (dcoo.row, dcoo.col, dcoo.data.astype(np.float32))
    w_docs = np.ones(docs.shape[0], np.float32)
    reset_counts(cuda_em, em)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    emb = plsa.plsa_refit_inner(*d_host, model.components_, r0.copy(), w_docs)
    refit_s = time.perf_counter() - t0
    launches = read_counts("(b) plsa_refit_inner", ("doc_pass_thresh",), cuda_em, em, totals)
    t0 = time.perf_counter()
    emb_again = plsa.plsa_refit_inner(*d_host, model.components_, r0.copy(), w_docs)
    refit_warm_s = time.perf_counter() - t0
    check(np.array_equal(emb, emb_again), "repeat plsa_refit_inner runs are bit for bit the same")
    d_sides_s = sides_wall(d_host, *docs.shape, word=False)
    d_coo = tuple(torch.from_numpy(a).to(dev) for a in (
        dcoo.row.astype(np.int64), dcoo.col.astype(np.int64), dcoo.data.astype(np.float32)))
    emb_p = coo_inner_loop(d_coo, torch.from_numpy(r0).to(dev),
                           torch.from_numpy(model.components_).to(dev),
                           torch.ones(docs.shape[0], device=dev), 50, 10, 0.005, refit=True)[0]
    embed_err = float(np.abs(emb - emb_p.cpu().numpy()).max())
    print(f"phase 16 (b) plsa_refit_inner on {docs.shape[0]} docs: {refit_s * 1e3:.2f} ms wall "
          f"(again {refit_warm_s * 1e3:.2f} ms, of which {d_sides_s * 1e3:.2f} ms build the doc "
          f"side), "
          f"{launches['doc_pass_thresh']} thresholded doc passes, {launches['doc_pass']} LL "
          f"tests; max abs err vs the plain COO refit {embed_err:.3e}")
    check(launches["doc_pass_thresh"] == 50 and launches["word_pass_thresh"] == 0,
          "plsa_refit_inner ran exactly n_iter = 50 thresholded doc passes")
    check(embed_err <= EMBED_ATOL, "plsa_refit_inner agrees with the plain COO refit")
    check_distributions(emb[np.asarray(docs.sum(1)).ravel() > 0], "plsa_refit_inner rows")

    # (c) the three dense functional fits at their defaults: one fit on one card
    fits, fit_walls = [], []
    for mod in (cuda_plsa, block_parallel_plsa, distributed_plsa):
        reset_counts(cuda_em, em)
        t0 = time.perf_counter()
        fits.append(mod.plsa_fit(X, k, random_state=0))
        fit_walls.append(time.perf_counter() - t0)
        read_counts(f"(c) {mod.__name__.split('.')[-1]}.plsa_fit", ("em", "word_pass"), cuda_em,
                    em, totals)
    same = all(np.array_equal(a, b) for f in fits[1:] for a, b in zip(f, fits[0]))
    print(f"phase 16 (c) cuda_plsa / block_parallel_plsa / distributed_plsa.plsa_fit at their "
          f"defaults: {' / '.join(f'{s:.3f}' for s in fit_walls)} s wall; factors "
          f"{'bit for bit the same' if same else 'DIFFER'}")
    check(same, "the three dense functional fits are one fit on one card")
    check_distributions(fits[0][1], "functional fit topics")

    # (d) the streamed functional fit against the resident sparse fit
    reset_counts(cuda_em, em)
    t0 = time.perf_counter()
    zd_s, wz_s = streamed_plsa.plsa_fit(X, k, block_size=STREAM_DOCS_16, random_state=0)
    stream_s = time.perf_counter() - t0
    read_counts("(d) streamed_plsa.plsa_fit", ("word_pass", "doc_pass"), cuda_em, em, totals)
    zd_r, wz_r = plsa.plsa_fit(X, k, random_state=0, backend="sparse")
    ll_s, ll_r = (float(sell.log_likelihood_sell(sprep, torch.from_numpy(a).to(dev),
                                                 torch.from_numpy(b).to(dev)))
                  for a, b in ((zd_s, wz_s), (zd_r, wz_r)))
    gap = abs(ll_s - ll_r) / abs(ll_r)
    print(f"phase 16 (d) streamed_plsa.plsa_fit(block_size={STREAM_DOCS_16}): "
          f"{-(-X.shape[0] // STREAM_DOCS_16)} blocks, {stream_s:.3f} s wall; LL {ll_s:.6f} "
          f"vs the resident sparse fit {ll_r:.6f}, rel gap {gap:.3e}; topics max abs gap "
          f"{float(np.abs(wz_s - wz_r).max()):.3e}")
    check(gap <= COMPAT_LL_RTOL, "the streamed functional fit agrees with the resident one")

    # (e) the public combiner on the numpy stack: on the card by default
    seen = {}
    embed, merge = ens.umap_embed, ens._merge_topics_by_label

    def keep_layout(**kwargs):
        seen.setdefault("umap", []).append((kwargs, embed(**kwargs)))
        return seen["umap"][-1][1]

    def keep_merge(all_topics, labels, weights=None):
        seen.setdefault("merge", []).append((labels, weights))
        return merge(all_topics, labels, weights)

    ens.umap_embed, ens._merge_topics_by_label = keep_layout, keep_merge
    try:
        kw = dict(min_samples=3, min_cluster_size=5, random_state=0)  # EnsembleTopics'
        t0 = time.perf_counter()
        from_numpy = enstop_.generate_combined_topics_hellinger_umap(
            default_stack.cpu().numpy(), **kw)
        numpy_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        from_tensor = enstop_.generate_combined_topics_hellinger_umap(default_stack, **kw)
        tensor_s = time.perf_counter() - t0
    finally:
        ens.umap_embed, ens._merge_topics_by_label = embed, merge
    (kw_n, emb_n), (kw_t, emb_t) = seen["umap"]
    (labels_n, weights_n), (labels_t, weights_t) = seen["merge"]
    same = (np.array_equal(kw_n["dmat"], kw_t["dmat"]) and np.array_equal(emb_n, emb_t)
            and np.array_equal(labels_n, labels_t) and np.array_equal(weights_n, weights_t))
    merge_err = rel_err(torch.from_numpy(from_numpy), torch.from_numpy(from_tensor))
    print(f"phase 16 (e) generate_combined_topics_hellinger_umap on phase 7's stack "
          f"{tuple(default_stack.shape)}: numpy {numpy_s:.3f} s (layout on "
          f"{kw_n['device']}), CUDA tensor {tensor_s:.3f} s; Hellinger matrix, layout and "
          f"clusters {'bit for bit the same' if same else 'DIFFER'}; {from_numpy.shape[0]} "
          f"stable topics, host merge vs device merge rel err {merge_err:.3e}")
    check(torch.device(kw_n["device"]).type == "cuda", "the numpy stack was combined on the card")
    check(same, "the numpy stack and the tensor give the same matrix, layout and clusters")
    check(merge_err <= MERGE_RTOL, "the host merge agrees with the device merge")
    print(f"  phase 16 took {time.perf_counter() - t_phase:.1f} s")


def ratio_key(kind, mode):
    """The ``LAUNCHES`` key of a ratio mode's ``kind`` ("em" or "word_pass")."""
    return kind if mode == "f32div" else f"{kind}_{mode}"


def ratio_phase(Xd, prep, cprep, totals):
    """Phase 17 at 20NG, kp = 24, bf16 X: the EM step without the LL in the
    seven ratio modes of ``cuda_em._em_accumulators_ratio`` (the port of the
    TPU experiment ``scripts/exp_divide_pipeline.py``). Returns the new rows'
    ``(largest abs errors, (ms, plain ms), bounds)``."""
    from enstop_torch.ops import cuda_em, cuda_sparse, em

    t_phase = time.perf_counter()
    check(cuda_em.RATIO_MODES[1:-1] == EXPERIMENT_RATIOS, "the ratio modes are the experiment's")
    dev = Xd.device
    n_pad, m_pad = Xd.shape
    zd, wz, _ = problem(Xd, 20, False, seed=8)
    kp = zd.shape[1]
    wzT, word = wz.t().contiguous(), prep.word
    w1 = torch.ones(n_pad, device=dev)
    worst = {ratio_key(kind, mode): 0.0 for mode in EXPERIMENT_RATIOS
             for kind in ("em", "word_pass")}
    # (a) each mode's B (dense kernel) and A (word pass) against the mode's plain version
    for weighted in (False, True):
        w = problem(Xd, 20, True, seed=9)[2] if weighted else None
        A32, B32 = em.em_accumulators_ratio(Xd, zd, wz, w, "f32div")
        for mode in cuda_em.RATIO_MODES:
            A, B = cuda_em._em_accumulators_ratio(Xd, zd, wz, w, mode, word=word)
            A0, B0 = (A32, B32) if mode == "f32div" else em.em_accumulators_ratio(Xd, zd, wz, w,
                                                                                   mode)
            torch.cuda.synchronize()
            ea, eb, fa, fb = rel_err(A, A0), rel_err(B, B0), rel_err(A, A32), rel_err(B, B32)
            print(f"  phase 17 {mode} weighted={weighted}: rel err A {ea:.3e} B {eb:.3e}; from "
                  f"the f32div plain A {fa:.3e} B {fb:.3e}")
            lossy = mode in LOSSY_RATIOS
            check(ea <= A_B_RTOL and eb <= (BF16R_B_RTOL if lossy else A_B_RTOL),
                  f"phase 17 {mode} kernels against their plain version")
            check(not lossy or all(far > 0 and far >= BF16R_SEPARATION * near
                                   for near, far in ((ea, fa), (eb, fb))),
                  f"phase 17 {mode} kernels round as their plain version does")
            if mode in ("f32div", "bf16r"):
                A1, B1, _ = cuda_em.em_accumulators_fused(
                    Xd, zd, wz, w, compute_ll=False, word=word,
                    precision="fast" if mode == "bf16r" else "default")
                check(torch.equal(A, A1) and torch.equal(B, B1),
                      f"phase 17 {mode} is the shipped step bit for bit")
            else:
                worst[ratio_key("em", mode)] = max(worst[ratio_key("em", mode)],
                                                   abs_err((A, A0), (B, B0)))
                worst[ratio_key("word_pass", mode)] = max(worst[ratio_key("word_pass", mode)],
                                                          abs_err((A, A0)))
            del A, B, A0, B0

    # (b) the path: the experiment's 20-step EM loop in each mode
    def loop(mode):
        z, v = zd, wz
        for _ in range(RATIO_STEPS):
            a, b = cuda_em._em_accumulators_ratio(Xd, z, v, w1, mode, word=word)
            v = v * a
            v = v / v.sum(1, keepdim=True).clamp_min(1e-30)
            z = z * b
            z = z / z.sum(1, keepdim=True).clamp_min(1e-30)
        return z, v

    reset_counts(cuda_em, em)
    loop_ms, final = {}, {}
    for mode in cuda_em.RATIO_MODES:
        final[mode] = loop(mode)
        float(final[mode][0][0, 0])
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            float(loop(mode)[0][0, 0])  # host readback
            walls.append(time.perf_counter() - t0)
        loop_ms[mode] = min(walls) / RATIO_STEPS * 1e3
    read_counts("phase 17 ratio loops", [ratio_key(kind, mode) for mode in cuda_em.RATIO_MODES
                                         for kind in ("em", "word_pass")], cuda_em, em, totals)
    ll0 = float(em.log_likelihood_dense(Xd, zd, wz))
    lls = {mode: float(em.log_likelihood_dense(Xd, *final[mode])) for mode in final}
    for mode, (z, v) in final.items():
        check_distributions(v[:20].cpu().numpy(), f"phase 17 {mode} topics")
        gap = abs(lls[mode] - lls["f32div"]) / abs(lls["f32div"])
        print(f"  phase 17 {mode}: {RATIO_STEPS}-step loop {loop_ms[mode]:.4f} ms/iter "
              f"(speedup_vs_f32div {loop_ms['f32div'] / loop_ms[mode]:.3f}x); LL after it "
              f"{lls[mode]:.6f} (from {ll0:.6f}), rel gap to f32div's {gap:.3e}")
        check(lls[mode] > ll0 and (mode in LOSSY_RATIOS or gap <= FIT_LL_RTOL),
              f"phase 17 {mode}: the loop raises the LL, as f32div's does")

    # (c) each mode's kernels alone, CUDA events, at 20NG and (word pass) config C
    zd_c, wzT_c, _ = sparse_problem(cprep, 20, False, seed=6)
    w_c = torch.ones(cprep.n, device=dev)
    timing, bounds = {}, {}
    step_bound = dense_bound_ms(Xd, kp, kp * (n_pad + m_pad))
    b_bound = dense_bound_ms(Xd, kp, kp * n_pad)
    word_bound = sparse_bound_ms(word, n_pad, m_pad, kp)
    c_bound = sparse_bound_ms(cprep.word, cprep.n, cprep.m, 20)
    for mode in cuda_em.RATIO_MODES:
        step = cuda_ms(lambda: cuda_em._em_accumulators_ratio(Xd, zd, wz, w1, mode, word=word),
                       50)
        b_ms = cuda_ms(lambda: cuda_em._launch("em", Xd, zd, wz, w1, True, False, mode), 50)
        word_ms = cuda_ms(lambda: cuda_sparse._pass(word, zd, wzT, w1, True, None, False, mode),
                          50)
        c_ms = cuda_ms(lambda: cuda_sparse._pass(cprep.word, zd_c, wzT_c, w_c, True, None,
                                                  False, mode), 20)
        plain = cuda_ms(lambda: em.em_accumulators_ratio(Xd, zd, wz, w1, mode), 5)
        word_plain = cuda_ms(lambda: cuda_sparse._plain_pass(word, zd, wzT, w1, True, None, False,
                                                             mode), 5)
        print(f"  phase 17 {mode} at 20NG (CUDA events): step {step:.4f} ms (bound "
              f"{step_bound[0]:.4f}), plain {plain:.4f} ms; B pass {b_ms:.4f} ms (bound "
              f"{b_bound[0]:.4f}); word pass {word_ms:.4f} ms (bound {word_bound[0]:.4f}), plain "
              f"{word_plain:.4f} ms; word pass at config C {c_ms:.4f} ms (bound "
              f"{c_bound[0]:.4f})")
        if mode in EXPERIMENT_RATIOS:
            timing[ratio_key("em", mode)] = (step, plain)
            timing[ratio_key("word_pass", mode)] = (word_ms, word_plain)
            bounds[ratio_key("em", mode)] = step_bound
            bounds[ratio_key("word_pass", mode)] = word_bound
    print(f"  phase 17 took {time.perf_counter() - t_phase:.1f} s")
    return worst, timing, bounds


def same_fit(a, b):
    """Bit for bit the same topics, embedding and LL trace."""
    return all(np.array_equal(getattr(a, f), getattr(b, f))
               for f in ("components_", "embedding_", "history_"))


def raises(call, error, words=""):
    """True if ``call()`` raises ``error`` with ``words`` in its message; any
    other error propagates."""
    try:
        call()
    except error as err:
        return words in str(err)
    return False


def contract_phase(X, docs, model, fit_wall, smi, cuda_em, em, totals):
    """Phase 18 at 20NG, k = 20: what the estimators' input checks admit
    reaches the kernels unchanged, and what they refuse launches nothing."""
    import scipy.sparse as sp

    import enstop_torch
    from enstop_torch.models.base import validate_corpus
    from enstop_torch.ops import _build

    t_phase = time.perf_counter()
    kw = dict(n_components=20, n_iter=100, n_iter_per_test=10, tolerance=0, random_state=0,
              device="cuda")
    as_bool = X > 0
    walls = {}
    for label, data in (("int64", X), ("bool", as_bool)):
        t0 = time.perf_counter()
        validate_corpus(data)
        walls[label] = time.perf_counter() - t0

    def fit(data, **extra):
        t0 = time.perf_counter()
        fitted = enstop_torch.PLSA(**kw, **extra).fit(data)
        return fitted, time.perf_counter() - t0

    reset_counts(cuda_em, em)
    # (a) a bool matrix is the same 0/1 counts as uint8, dense and sparse
    bool_walls = {}
    for backend in ("auto", "sparse"):
        counts, _ = fit(as_bool.astype(np.uint8), backend=backend)
        bits, bool_walls[backend] = fit(as_bool, backend=backend)
        check(same_fit(bits, counts), f"PLSA(backend={backend!r}) on bool gives the bits of "
              "the same matrix as uint8 counts")
    # (b) the sparse formats give the CSR fit's bits (phase 3's model)
    for convert in (sp.csc_matrix, sp.coo_matrix, sp.csr_array):
        check(same_fit(fit(convert(X))[0], model),
              f"PLSA.fit on a {convert.__name__} gives phase 3's CSR fit bit for bit")
    # (c) transform of an object array of integer counts is that of its float64 cast
    dense = docs.toarray()
    t0 = time.perf_counter()
    objects = dense.astype(object)
    object_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    from_objects = model.transform(objects)
    object_transform_s = time.perf_counter() - t0
    check(np.array_equal(from_objects, model.transform(dense.astype(np.float64))),
          "transform of an object array gives the bits of its float64 cast")
    del objects
    read_counts("phase 18 bool, formats and object transform",
                ("em", "word_pass", "doc_pass", "refit", "ll"), cuda_em, em, totals)

    # (d) each estimator refuses complex, 0-feature, 0-sample and 1-D input in
    # its check, before any launch or device allocation
    bad = {"complex": docs.astype(np.complex128), "0 features": sp.csr_matrix((10, 0)),
           "0 samples": X[:0], "1-D": dense[0]}
    estimators = (enstop_torch.PLSA, enstop_torch.GPUPLSA, enstop_torch.StreamedPLSA,
                  enstop_torch.BlockParallelPLSA, enstop_torch.DistributedPLSA,
                  enstop_torch.EnsembleTopics)
    torch.cuda.synchronize()
    launches, allocated = dict(_build.LAUNCHES), torch.cuda.memory_allocated()
    for cls in estimators:
        for label, data in bad.items():
            check(raises(lambda: cls(n_components=20).fit(data), ValueError),
                  f"{cls.__name__}.fit refuses {label} input with ValueError")
    for label, data in bad.items():
        check(raises(lambda: model.transform(data), ValueError),
              f"PLSA.transform refuses {label} input with ValueError")
    torch.cuda.synchronize()
    check(dict(_build.LAUNCHES) == launches, "the refused inputs launched no kernel")
    check(torch.cuda.memory_allocated() == allocated,
          "the refused inputs allocated no device memory")
    print(f"phase 18 input contract at 20NG on {smi}: validation (host) int64 "
          f"{walls['int64'] * 1e3:.2f} ms, bool {walls['bool'] * 1e3:.2f} ms; PLSA.fit walls: "
          f"int64 CSR (phase 3) {fit_wall:.3f} s, bool dense {bool_walls['auto']:.3f} s, bool "
          f"sparse {bool_walls['sparse']:.3f} s; validation / phase 3 fit wall "
          f"{walls['int64'] / fit_wall:.2%}; object array of {dense.shape[0]} x "
          f"{dense.shape[1]} made in {object_s:.2f} s, transformed in "
          f"{object_transform_s:.2f} s; bool = uint8, csc = coo = csr_array = csr bit for bit; "
          f"{len(estimators)} estimators x {len(bad)} refused inputs, and transform: no "
          f"launch, no allocation; phase 18 took {time.perf_counter() - t_phase:.1f} s")


def loader_routing_phase(X, labels, model, fit_launches, smi, cuda_em, em, totals):
    """Phase 19 at 20NG, k = 20: the loader's ``.npz`` source feeds phase 3's
    fit unchanged, and what needs scikit-learn (the loader's second source,
    metadata routing) raises before any launch or device allocation."""
    import os
    import tempfile

    import enstop_torch
    from enstop_torch import datasets
    from enstop_torch.ops import _build

    t_phase = time.perf_counter()
    os.environ.pop(datasets.NPZ_ENV_VAR, None)  # (b) must find no bundle
    with tempfile.TemporaryDirectory() as tmp:
        # (a) the corpus through the .npz bundle
        path = Path(tmp) / "20ng.npz"
        t0 = time.perf_counter()
        datasets.save_20newsgroups_npz(path, X, labels)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded, loaded_labels, vocabulary = datasets.load_20newsgroups_counts(local_npz=str(path))
        load_s = time.perf_counter() - t0
        check(all(np.array_equal(getattr(loaded, a), getattr(X, a))
                  for a in ("data", "indices", "indptr")) and loaded.shape == X.shape
              and np.array_equal(loaded_labels, labels) and vocabulary is None,
              "the .npz bundle gives back phase 3's corpus and labels")
        reset_counts(cuda_em, em)
        t0 = time.perf_counter()
        fitted = enstop_torch.PLSA(n_components=20, n_iter=100, n_iter_per_test=10,
                                   tolerance=0, random_state=0, device="cuda").fit(loaded)
        fit_s = time.perf_counter() - t0
        launches = read_counts("phase 19 (a) PLSA.fit on the loaded corpus", ("em", "word_pass"),
                               cuda_em, em, totals)
        check(launches == fit_launches, "the loaded corpus's fit launched as phase 3's fit")
        check(same_fit(fitted, model), "the loaded corpus's fit is phase 3's bit for bit")

        # (b) no source, (c) routing: both raise, launching and allocating nothing
        empty = Path(tmp) / "empty"
        empty.mkdir()
        torch.cuda.synchronize()
        before, allocated = dict(_build.LAUNCHES), torch.cuda.memory_allocated()
        check(raises(lambda: datasets.load_20newsgroups_counts(data_home=str(empty)),
                     RuntimeError, "data_home="),
              "load_20newsgroups_counts(data_home=<empty directory>) raises RuntimeError")
        for name, call in (("get_metadata_routing()", model.get_metadata_routing),
                           ("set_fit_request()",
                            lambda: model.set_fit_request(sample_weight=True))):
            check(raises(call, RuntimeError, "scikit-learn is not loaded"),
                  f"{name} raises RuntimeError without scikit-learn loaded")
        torch.cuda.synchronize()
        check(dict(_build.LAUNCHES) == before, "(b) and (c) launched no kernel")
        check(torch.cuda.memory_allocated() == allocated, "(b) and (c) allocated no device memory")
    print(f"phase 19 loader and routing at 20NG on {smi}: .npz bundle written in {save_s:.3f} s, "
          f"read in {load_s:.3f} s; PLSA.fit on it {fit_s:.3f} s wall, phase 3's bits and "
          f"launches; no-source load, get_metadata_routing and set_fit_request raise "
          f"RuntimeError with no launch and no allocation; phase 19 took "
          f"{time.perf_counter() - t_phase:.1f} s")


def ensemble_batch_phase(X, smi, cuda_em, em, totals):
    """Phase 20 at 20NG, k = 20: the ensemble's runs in groups on the batched
    kernel against the same runs one after another, bit for bit, with the
    groups, the walls and the device high-water of each route."""
    import enstop_torch
    from enstop_torch.models import ensemble as ens
    from enstop_torch.ops.data import _Staged
    from enstop_torch.ops.driver import PreparedCounts, _staged

    t_phase = time.perf_counter()
    k, n_runs = ENSEMBLE["n_components"], ENSEMBLE["n_starts"]
    schedule = dict(n_iter=ENSEMBLE["n_iter"], n_iter_per_test=10, tolerance=1e-3)
    dev = torch.device("cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    prep = _staged(X.astype(np.float32), device=dev, counts=True)
    torch.cuda.synchronize()
    staging_peak = torch.cuda.max_memory_allocated() - base
    resident = torch.cuda.memory_allocated() - base
    groups = prep._run_groups(k, n_runs)
    batched_route = PreparedCounts._fit_runs

    def per_run(self, *args):
        return _Staged._fit_runs(self, *args)

    def fan_out():
        """The fan-out's stack (on the host) and steps, its wall and device
        high-water (two calls, the second's, with nothing else held)."""
        for _ in range(2):
            stack = None
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            stack, steps = ens._device_resident_plsa_runs(
                None, k, n_runs, np.random.RandomState(ENSEMBLE["random_state"]),
                prepared=prep, device=dev, **schedule)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        return stack.cpu(), steps, wall, torch.cuda.max_memory_allocated() - base

    def results():
        """Each run's state (on the host), steps, final LL and LL trace."""
        runs = ens.bootstrap_inputs(prep, k, n_runs,
                                    np.random.RandomState(ENSEMBLE["random_state"]))
        return {i: (res.state[0].cpu(), res.state[1].cpu(), *res[1:])
                for i, res in prep._fit_runs(runs, n_runs, k, *schedule.values(),
                                             prep._steps("default", ""))}

    def fit():
        """The estimator's stable topics, embedding, run steps, counters and
        the ``runs`` span in ms."""
        model = enstop_torch.EnsembleTopics(device="cuda", **ENSEMBLE).fit(X)
        info = model.fit_info_
        runs_ms = 1e3 * next(sp_["end"] - sp_["start"] for sp_ in info["trace"]["spans"]
                             if sp_["name"] == "runs")
        return (model.components_, model.embedding_, info["run_steps"],
                info["trace"]["counters"], runs_ms)

    reset_counts(cuda_em, em)
    stack_b, steps_b, wall_b, peak_b = fan_out()
    res_b, fit_b = results(), fit()
    read_counts("phase 20 batched runs", ("batch", "batch_word", "em", "word_pass"), cuda_em,
                em, totals)
    PreparedCounts._fit_runs = per_run
    try:
        stack_s, steps_s, wall_s, peak_s = fan_out()
        res_s, fit_s = results(), fit()
    finally:
        PreparedCounts._fit_runs = batched_route
    same_runs = all(
        torch.equal(res_b[i][0], res_s[i][0]) and torch.equal(res_b[i][1], res_s[i][1])
        and res_b[i][2:4] == res_s[i][2:4] and res_b[i][5] == res_s[i][5]
        and np.array_equal(res_b[i][4], res_s[i][4], equal_nan=True) for i in range(n_runs))
    same_stack = torch.equal(stack_b, stack_s) and steps_b == steps_s
    same_fit = all(np.array_equal(a, b) for a, b in zip(fit_b[:2], fit_s[:2]))
    same_fit &= fit_b[2] == fit_s[2]
    counters = {name: (fit_b[3].get(name), fit_s[3].get(name))
                for name in ("em_steps", "batched_run_steps", "host_syncs")}
    runs_ms = (fit_b[4], fit_s[4])
    print(f"phase 20 batched ensemble runs at 20NG on {smi}: {n_runs} runs in groups {groups}, "
          f"steps {steps_b}; the fan-out batched {wall_b:.4f} s, one after another "
          f"{wall_s:.4f} s ({wall_s / wall_b:.2f} times); device high-water over the staged "
          f"layout ({resident / 2**20:.1f} MiB): staging {(staging_peak - resident) / 2**20:.1f} "
          f"MiB, batched runs {(peak_b - resident) / 2**20:.1f} MiB, one after another "
          f"{(peak_s - resident) / 2**20:.1f} MiB; stack and steps "
          f"{'bit for bit the same' if same_stack else 'DIFFER'}; each run's state, steps, "
          f"final LL and trace {'bit for bit the same' if same_runs else 'DIFFER'}")
    print(f"  EnsembleTopics.fit, batched / one after another: runs span {runs_ms[0]:.2f} / "
          f"{runs_ms[1]:.2f} ms, stable topics and embedding "
          f"{'bit for bit the same' if same_fit else 'DIFFER'}, counters (batched, one after "
          f"another) {json.dumps(counters)}; phase 20 took {time.perf_counter() - t_phase:.1f} s")
    check(same_stack and same_runs, "the batched runs are the per-run runs bit for bit")
    check(same_fit, "the batched ensemble is the per-run ensemble bit for bit")
    check(peak_b <= staging_peak, "the batched runs stay under the staging's high-water")


def wide_phase(XC2, smi, cuda_em, em, totals):
    """Phase 21: the sparse passes past 256 topics (``em_sparse_wide.cu``).
    (a) Each pass at k = 1,000 against its plain version on 5,000 documents
    of config C', each mode; then, LL on, at the corpus of the cell
    ``nytimes-k1000.fit-wide`` against the plain version run over blocks of
    entries (``plain_pass_blocked``), plain and weighted with a threshold
    that drops about half the products, and timed there. (b)
    ``PLSA(n_components=1000, backend="sparse")`` at config C' through its
    normal path, against ``benchmark/reference/plsa_wide.py`` (float64 on the
    card) from the same init, and its ``transform`` of 2,000 documents
    against the reference's refit."""
    import enstop_torch
    from enstop_torch.ops import cuda_sparse

    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "benchmark"))
    import harness
    import inputs
    from reference import compare, plsa_wide

    t_phase = time.perf_counter()
    k = WIDE_FIT["n_components"]
    sub = enstop_torch.prepare_sell(XC2[:5000].astype(np.float32), standardize=False,
                                    device="cuda")
    worst = compare_sparse(f"config C' 5,000 docs k={k}", sub, k, cuda_sparse)
    del sub
    # the main path's shape: the cell's corpus, where a head word's owner
    # spans hundreds of segments in the owner reduction
    cell = harness.find_cell(WIDE_CELL)
    X = inputs.make_corpus(cell, WIDE_CORPUS_SEED, "cuda")["train"]
    prep = enstop_torch.prepare_sell(X, standardize=False, device="cuda")
    del X
    timing, bounds = {}, {}
    for weighted in (False, True):
        zd, wzT, w = card_problem(prep, k, weighted, seed=6)
        w = torch.ones(prep.n, device="cuda") if w is None else w
        thresh = None
        if weighted:
            # at 1,000 topics a product is near 1e-8 and 1e-3 drops them all:
            # the threshold is the median of a sample, so it drops about half
            v = zd[prep.doc.owners()[:200_000]] * wzT[prep.doc.idx[:200_000].long()]
            thresh = float(v.median())
            print(f"  the cell's corpus: threshold {thresh:.3e}, drops "
                  f"{float((v <= thresh).float().mean()):.3f} of the sampled products")
            del v
        for word in (True, False):
            side = prep.word if word else prep.doc
            kernel = cuda_sparse.word_pass if word else cuda_sparse.doc_pass
            key = ("word_pass" if word else "doc_pass") + "_wide" + ("_thresh" if thresh else "")
            out, ll = kernel(side, zd, wzT, w, thresh=thresh, compute_ll=True)
            t0 = time.perf_counter()
            out0, ll0 = plain_pass_blocked(side, zd, wzT, w, word, thresh)
            torch.cuda.synchronize()
            plain_ms = 1e3 * (time.perf_counter() - t0)
            eo, el = rel_err(out, out0), rel_err(ll, ll0)
            worst[key] = max(worst[key], abs_err((out, out0)))
            del out, out0
            timing[key] = (cuda_ms(lambda: kernel(side, zd, wzT, w, thresh=thresh,
                                                  compute_ll=False), 5), plain_ms)
            bounds[key] = sparse_bound_ms(side, prep.n, prep.m, k)
            print(f"  the cell's corpus ({prep.n} x {prep.m}, nnz {prep.nnz}, {side.n_seg} "
                  f"segments), k = {k}: {key} weighted={weighted} thresh={thresh} "
                  f"compute_ll=True: rel err {'A' if word else 'B'} {eo:.3e} ll {el:.3e}; "
                  f"{timing[key][0]:.4f} ms (LL off), plain in blocks {plain_ms:.1f} ms, bound "
                  f"{bounds[key][0]:.4f} ms ({bounds[key][1]})")
            check(eo <= SPARSE_RTOL and el <= SPARSE_RTOL, f"the cell's corpus {key} kernel")
        del zd, wzT, w
    del prep

    limits = json.loads((root / "benchmark" / "traffic" / "fit-wide.json").read_text())["limits"]
    reset_counts(cuda_em, em)
    t0 = time.perf_counter()
    model = enstop_torch.PLSA(**WIDE_FIT).fit(XC2)
    fit_wall = time.perf_counter() - t0
    launches = read_counts("phase 21 wide fit", ("word_pass_wide", "doc_pass_wide"), cuda_em,
                           em, totals)
    n_iter = WIDE_FIT["n_iter"]
    n_ll = 1 + len(range(1, n_iter + 1, WIDE_FIT["n_iter_per_test"]))  # the first and each test
    wide_passes = model.fit_info_["trace"]["counters"].get("wide_passes", 0)
    check(launches["word_pass_wide"] == n_iter and launches["doc_pass_wide"] == n_iter + n_ll
          and wide_passes == 2 * n_iter + n_ll and launches["word_pass"] == 0,
          "the wide fit ran every pass on the wide walk and counted it")
    t0 = time.perf_counter()
    cands = plsa_wide.fit(XC2, k, WIDE_FIT["random_state"], n_iter, WIDE_FIT["n_iter_per_test"],
                          WIDE_FIT["tolerance"], "cuda")
    ref_wall = time.perf_counter() - t0
    gaps = compare.fit_gaps(model.embedding_, model.components_, model.n_iter_, cands)
    print(f"phase 21 wide PLSA at config C' ({XC2.shape[0]} x {XC2.shape[1]}, nnz {XC2.nnz}), "
          f"k = {k}, {n_iter} steps on {smi}: fit {fit_wall:.3f} s wall (EM loop "
          f"{model.fit_info_['wall_time_s']:.3f} s), float64 reference {ref_wall:.3f} s; against "
          f"it {json.dumps({key: gaps[key] for key in sorted(gaps)})}; the cell's limits "
          f"{json.dumps(limits)}")
    check(all(gaps[key] <= limit for key, limit in limits.items()),
          "the wide fit lies within the cell's limits of the float64 reference")
    docs = XC2[:N_TRANSFORM]
    reset_counts(cuda_em, em)
    embedding = model.transform(docs)
    read_counts("phase 21 wide transform", ("doc_pass_wide",), cuda_em, em, totals)
    refit_gap = compare.embedding_gap(embedding, plsa_wide.refit(docs, model.components_,
                                                                  "cuda"))
    print(f"  transform of {N_TRANSFORM} documents against the float64 refit: widest row l1 "
          f"{refit_gap:.3e} (limit {WIDE_TRANSFORM_L1})")
    check(refit_gap <= WIDE_TRANSFORM_L1, "the wide transform lies near the float64 refit")
    del model, cands

    print(f"  phase 21 took {time.perf_counter() - t_phase:.1f} s")
    return worst, timing, bounds


def mt_init_phase(smi, totals):
    """Phase 22: the random init drawn on the card (``mt_uniform.cu``) at the
    cell ``nytimes-k1000.fit-wide``'s shapes: ``plsa_init``'s factors, then
    ``_refit_init``'s, into the sparse layout's (n, k) and (k, m), each bit
    for bit the host's, and the ``RandomState`` after each where the host's
    draw leaves it; a second draw from the same state repeats the bits and
    runs under ``torch.profiler``, which splits the draw between the twist and
    the rows kernels. The draw's wall time (its state read back waits for it)
    against the host's."""
    import scipy.sparse as sp
    from torch.profiler import ProfilerActivity, profile

    from enstop_torch.ops import _build
    from enstop_torch.ops import init as init_ops
    from enstop_torch.ops.driver import _refit_init

    t_phase = time.perf_counter()
    n, m, k = MT_SHAPE
    dev = torch.device("cuda")

    def state(rng):
        st = rng.get_state(legacy=False)
        return (st["state"]["key"].astype(np.uint32).tobytes(), int(st["state"]["pos"]),
                st["has_gauss"], st["gauss"])

    def same(got, want):
        return torch.equal(got.view(torch.int32), torch.from_numpy(want.view(np.int32)).to(dev))

    def draw(rng, targets, guard=True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        init_ops._uniform_rows(rng, targets, guard)
        return 1e3 * (time.perf_counter() - t0)

    host = np.random.RandomState(MT_SEED)
    t0 = time.perf_counter()
    zd_h, wz_h = init_ops.plsa_init(sp.csr_matrix((n, m)), k, rng=host)
    host_ms = 1e3 * (time.perf_counter() - t0)
    host_after_init = state(host)
    t0 = time.perf_counter()
    refit_h = _refit_init(host, n, k)
    host_refit_ms = 1e3 * (time.perf_counter() - t0)

    rng = np.random.RandomState(MT_SEED)
    check(init_ops._draws_on_device(rng, dev, (n + m) * k), "the cell's init is drawn on the card")
    zd = torch.zeros((n, k), device=dev)
    wz = torch.zeros((k, m), device=dev)
    refit = torch.zeros((n, k), device=dev)
    launches = _build.LAUNCHES["mt_uniform"]
    card_ms = draw(rng, [wz, zd])
    chunks = _build.LAUNCHES["mt_uniform"] - launches
    check(same(wz, wz_h) and same(zd, zd_h), "the card's init is plsa_init's bit for bit")
    check(state(rng) == host_after_init, "the rng left where the host's draw leaves it")
    card_refit_ms = draw(rng, [refit], guard=False)
    check(same(refit, refit_h), "the card's refit init is _refit_init's bit for bit")
    check(state(rng) == state(host), "the rng left where the host's refit draw leaves it")

    again = np.random.RandomState(MT_SEED)
    zd.zero_()
    wz.zero_()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        init_ops._uniform_rows(again, [wz, zd])
    check(same(wz, wz_h) and same(zd, zd_h), "a second draw repeats the bits")
    split = {}
    for event in prof.key_averages():
        total = getattr(event, "device_time_total", None) or getattr(event, "cuda_time_total", 0)
        for name in ("mt_twist", "uniform_long_rows", "uniform_rows"):
            if name in event.key and total > 0:
                split[name] = split.get(name, 0) + round(total / 1e3, 3)
                break
    totals["mt_uniform"] += _build.LAUNCHES["mt_uniform"] - launches
    values = (n + m) * k
    print(f"phase 22 init on the card at the cell nytimes-k1000.fit-wide's shapes (n {n}, m {m}, "
          f"k {k}: {values} values, {2 * values} words in {chunks} chunks) on {smi}: bit for bit "
          f"plsa_init's and _refit_init's, the rng's state the host's; the draw {card_ms:.1f} ms "
          f"(host {host_ms:.1f} ms), the refit's {card_refit_ms:.1f} ms (host "
          f"{host_refit_ms:.1f} ms); device ms by kernel (profiler) {json.dumps(split)}")
    print(f"  phase 22 took {time.perf_counter() - t_phase:.1f} s")
    del zd, wz, refit
    # bit-exact: no error; the rows kernel reads 8 B and writes 4 B a value, the
    # twist writes 8 B a value (its serial chain of 3 barriers a twist is not counted)
    return ({"mt_uniform": 0.0}, {"mt_uniform": (card_ms, host_ms)},
            {"mt_uniform": bound(20 * values, 0)})


def nmf_scale_phase(smi, totals):
    """Phase 23: ``EnsembleTopics(n_components=20, model="nmf")`` at the corpus
    of the cell ``nytimes-enstop-nmf-k20.ensemble-nmf`` (the whole UCI NYTimes
    shape, 69.7 M nonzeros) through its normal path: 16 bootstrap runs of 200
    KL updates on the sparse passes, the combine, the 200-update embedding.
    Its launches and its trace's NMF spans and counters; runs 0 and 15 and
    the embedding against ``benchmark/reference/ensemble_nmf.py`` (float64 on
    the card, the same resample and start) by the cell's limits; the
    SHA-256 digests of ``components_`` and ``embedding_``."""
    import hashlib

    import enstop_torch
    from enstop_torch.ops import cuda_em, em

    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "benchmark"))
    import harness
    import inputs
    from reference import compare, ensemble_nmf

    t_phase = time.perf_counter()
    cell = harness.find_cell(NMF_CELL)
    k = int(cell.config["n_components"])
    X = inputs.make_corpus(cell, NMF_CORPUS_SEED, "cuda")["train"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(cuda_em, em)
    t0 = time.perf_counter()
    model = enstop_torch.EnsembleTopics(n_components=k, model="nmf",
                                        random_state=NMF_CALL_SEED, device="cuda").fit(X)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = read_counts("phase 23 NMF ensemble", ("word_pass", "doc_pass"), cuda_em, em,
                           totals)
    trace = model.fit_info_["trace"]
    spans = {}
    for s in trace["spans"]:
        spans[s["name"]] = spans.get(s["name"], 0.0) + s["end"] - s["start"]
    names = [s["name"] for s in trace["spans"]]
    counters = trace["counters"]
    check(launches["word_pass"] == 16 * 200 and launches["doc_pass"] == 16 * 200 + 200,
          "each run's 200 updates ran both passes, the embedding 200 doc passes")
    check(all(names.count(n) == 16 for n in ("runs.resample", "runs.stage", "runs.mu"))
          and names.count("refit.stage") == names.count("refit.mu") == 1
          and counters.get("runs") == 16 and counters.get("mu_steps") == 16 * 200
          and counters.get("refit_mu_steps") == 200,
          "the NMF call's trace holds its spans and counters")
    stack = torch.as_tensor(model.topic_stack_).cpu()
    limits = cell.traffic["limits"]
    gaps = {}
    t0 = time.perf_counter()
    for i in NMF_RUNS:
        H = ensemble_nmf.run(X, k, NMF_CALL_SEED, i, "cuda")[1]
        row = compare.row_l1(stack[i * k:(i + 1) * k].numpy(), ensemble_nmf.topics(H))
        gaps["run_wz_l1_max"] = max(gaps.get("run_wz_l1_max", 0.0), float(row.max()))
        gaps["run_wz_l1_mean"] = max(gaps.get("run_wz_l1_mean", 0.0), float(row.mean()))
    W = ensemble_nmf.embedding(X, model.components_, NMF_CALL_SEED, "cuda")
    row = ensemble_nmf.relative_row_l1(model.embedding_, W)
    gaps.update(refit_zd_l1_max=float(row.max()), refit_zd_l1_mean=float(row.mean()))
    ref_wall = time.perf_counter() - t0
    digests = {name: hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()
               for name, a in (("components_", model.components_),
                               ("embedding_", model.embedding_))}
    print(f"phase 23 NMF ensemble at the cell's corpus ({X.shape[0]} x {X.shape[1]}, nnz "
          f"{X.nnz}), k = {k}, on {smi}: fit {wall:.3f} s wall, n_components_ "
          f"{model.n_components_}, device peak {peak:.3f} GiB; spans (s) "
          f"{json.dumps({n: round(v, 4) for n, v in spans.items()})}; counters "
          f"{json.dumps(counters)}")
    print(f"  runs {list(NMF_RUNS)} and the embedding against the float64 reference "
          f"({ref_wall:.1f} s): {json.dumps(gaps)}; the cell's limits "
          f"{json.dumps({n: limits[n] for n in gaps})}; digests {json.dumps(digests)}")
    check(all(gaps[n] <= limits[n] for n in gaps),
          "the NMF runs and embedding lie within the cell's limits of the float64 reference")
    del model, stack, X
    torch.cuda.empty_cache()
    print(f"  phase 23 took {time.perf_counter() - t_phase:.1f} s")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    only = sys.argv[1:] == ["--phase", "23"]
    if sys.argv[1:] and not only:
        raise SystemExit("usage: python3 chip_smoke.py [--phase 23]")
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
                # word, doc, thresholded, bf16r word, and five ratio modes' word
                check(len(found) == 10 and all(spill == 0 for _, spill in found.values()),
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
    build = _build.BUILD_LOG.get("em_sparse_wide")
    if build is None:
        print("phase 1 build: em_sparse_wide loaded from enstop_torch/_build")
    else:
        found = {wide_instance(key): v for key, v in ptxas_instances(build["report"]).items()
                 if wide_instance(key)}
        print(f"phase 1 build: em_sparse_wide built (nvcc {build['seconds']:.2f} s); the wide "
              f"walk past kp = {cuda_sparse.MAX_NARROW_KP} ({cuda_sparse.WIDE_SHAPES}, one "
              f"entry a warp): registers, spill store bytes by instance {json.dumps(found)}")
        # 3 shapes x 2 chunk widths x 4 modes, and 3 x 2 owner reductions; the
        # main path's (kp = 1000: TPL = 32, 16-byte chunks) must not spill
        main = {key: v for key, v in found.items() if "TPL32_V4" in key}
        check(len(found) == 30 and len(main) == 5
              and all(spill == 0 for _, spill in main.values()),
              "the em_sparse_wide instances are built, those at kp = 1000 without a spill")
    build = _build.BUILD_LOG.get("mt_uniform")
    if build is not None:
        print(f"phase 1 build: mt_uniform built (nvcc {build['seconds']:.2f} s); registers, "
              f"spill store bytes by kernel {json.dumps(ptxas_instances(build['report']))}")
    print(f"  all built and loaded in {time.perf_counter() - t0:.2f} s, in parallel")
    if only:
        nmf_scale_phase(smi, {name: 0 for name in cuda_em.LAUNCHES})
        print(json.dumps({"ok": True, "phases": [1, 23]}))
        return

    # -- phase 2: each dense kernel against its plain version -----------------
    rng = np.random.RandomState(0)
    small = np.zeros((208, 768), np.float32)  # 203 x 650 ragged, padded
    small[:203, :650] = (rng.rand(203, 650) < 0.03) * rng.randint(1, 6, (203, 650))
    compare_kernels("small 203x650 k=20", torch.from_numpy(small).to(dev), 20, cuda_em, em)

    t0 = time.perf_counter()
    X, labels = twenty_newsgroups_shape(seed=0)
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
    from enstop_torch.cluster import umap as umap_mod

    captured = {}
    run_all, merge, embed = (ens._ensemble_of_topics_device, ens._merge_topics_by_label,
                             ens.umap_embed)
    device_layout = umap_mod._optimize_layout_device

    def keep_stack(*args, **kwargs):
        stack, steps = run_all(*args, **kwargs)
        captured["stack"] = stack
        return stack, steps

    def keep_merge(all_topics, labels, weights=None):
        captured["merge"] = (labels, weights, merge(all_topics, labels, weights))
        return captured["merge"][2]

    def keep_layout(**kwargs):
        captured["umap"] = (kwargs, embed(**kwargs))
        return captured["umap"][1]

    def keep_device_layout(emb, W, n_epochs, a, b, seed, **kwargs):
        out = device_layout(emb, W, n_epochs, a, b, seed, **kwargs)
        captured["layout"] = (emb, W, n_epochs, a, b, seed, out)
        return out

    ens._ensemble_of_topics_device, ens._merge_topics_by_label, ens.umap_embed = (
        keep_stack, keep_merge, keep_layout)
    umap_mod._optimize_layout_device = keep_device_layout
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
            needed = (("em_bf16r", "word_pass_bf16r", "refit_bf16r", "ll", "umap_layout")
                      if precision == "fast" else ("em", "word_pass", "refit", "ll", "umap_layout"))
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
            if precision == "fast":
                (worst["umap_layout"], timing["umap_layout"],
                 bounds["umap_layout"]) = check_layout_kernel(device_layout, *captured["layout"])
            check_distributions(ensemble.components_, f"{precision} stable topics")
            check_distributions(ens_embedding, f"{precision} ensemble embedding")
            check_distributions(ens_docs, f"{precision} ensemble transform rows")
            if precision == "fast":
                first_fast = (stack.clone(), ensemble.n_components_, ensemble.components_)
            else:
                default_stack = stack.clone()  # for phase 16 (e)

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
        umap_mod._optimize_layout_device = device_layout
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
    launches = read_counts("sparse ensemble fit", ("word_pass", "doc_pass", "umap_layout"), cuda_em,
                           em, totals)
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
    for name, err in mesh_phase(X, XC, docs, model, sparse_model, resident_peak, thresh_model,
                                walls, cuda_em, em, cuda_sparse, totals).items():
        worst[name] = max(worst[name], err)
    compat_phase(X, docs, model, sprep, default_stack, cuda_em, em, totals)
    for table, part in zip((worst, timing, bounds), ratio_phase(Xd, prep, cprep, totals)):
        table.update(part)
    contract_phase(X, docs, model, fit_wall, smi, cuda_em, em, totals)
    loader_routing_phase(X, labels, model, fit_launches, smi, cuda_em, em, totals)
    ensemble_batch_phase(X, smi, cuda_em, em, totals)
    for table, part in zip((worst, timing, bounds), wide_phase(XC2, smi, cuda_em, em, totals)):
        table.update(part)
    for table, part in zip((worst, timing, bounds), mt_init_phase(smi, totals)):
        table.update(part)
    nmf_scale_phase(smi, totals)

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
