"""The UMAP layout kernel (``enstop_torch/ops/csrc/umap_layout.cu``) and the
counter-based negative samples it shares with the CPU loop.

On the CPU: ``umap._negative_samples`` equals a scalar transcription of the
kernel's 32-bit hash, lies in range, repeats, differs for another seed, epoch,
round or edge and is about uniform; the CPU loop takes its negatives from it
and counts its two copies.

On the card (marked ``cuda``; ``python -m pytest tests/test_torch_umap_layout.py
-q --noconftest``): with b = 1 (powf exact on both sides) the kernel gives the
CPU loop's bits after 1, 5 and 20 epochs, on one block with the positions in
shared memory and on many blocks in device memory, so its negative samples are
the numpy draws; at
the (a, b) that UMAP fits it agrees with the loop to ``LOOP_GAP`` of the
largest coordinate (powf is the card's on one side and the CPU's on the other,
a few units in the last place apart, and the SGD carries such a difference on
from epoch to epoch, most where two points nearly meet and the repulsion's
slope is steep); one block or many, shared or device memory, give the same
bits; a layout repeats bit for bit
and another seed moves it; at 500 epochs its trustworthiness is within 0.05 of
the host layout's (``chip_smoke.py``'s bound); a layout is one launch. This
file imports no JAX.
"""

import numpy as np
import pytest
import torch

from enstop_torch import profiling
from enstop_torch.cluster import umap
from enstop_torch.cluster.distances import all_pairs_hellinger_distance
from enstop_torch.ops import cuda_umap
from enstop_torch.ops._build import LAUNCHES
from plain_ensemble import trustworthiness

torch.set_num_threads(1)  # the CPU loop's small ops: threads only contend

_M = 0xFFFFFFFF
# the largest coordinate gap between the kernel and the CPU loop, over the
# largest coordinate, by epochs run: 5 to 10 times the widest measured on an
# H100 over SHAPES (1.8e-6, 9.4e-5, 7.5e-3); the CPU loop with its powf
# computed in float64 and rounded moves as far from itself (1.1e-7 / 6.6e-7,
# 3.5e-5, 6.2e-3)
LOOP_GAP = {1: 1e-5, 5: 1e-3, 20: 5e-2}
# (groups, copies, dimensions): 50 and 320 points in 5 dimensions (918 and
# 4,800 edges) run on one block, their positions and tables in shared memory;
# 1,500 in 20 (26,982 edges, more than a block's shared memory holds) on many
# blocks in device memory
SHAPES = {"n50_d5": (5, 10, 5), "n320_d5": (20, 16, 5), "n1500_d20": (60, 25, 20)}


def topic_stack(seed, n_groups, copies, n_words=80, noise=0.01):
    """An ensemble's stack: ``n_groups`` topics, ``copies`` noisy repeats each."""
    rng = np.random.RandomState(seed)
    protos = rng.dirichlet(np.full(n_words, 0.15), size=n_groups)
    rows = np.abs(protos[np.arange(n_groups * copies) % n_groups]
                  + rng.randn(n_groups * copies, n_words) * noise)
    return (rows / rows.sum(1, keepdims=True)).astype(np.float32)


def problem(seed, n_groups, copies, dim, n_neighbors=15):
    """``(dmat, emb, W, a, b, layout seed)`` as ``umap_embed`` makes them."""
    dmat = all_pairs_hellinger_distance(topic_stack(seed, n_groups, copies), "cpu")
    rng = np.random.RandomState(seed)
    W = umap.fuzzy_simplicial_set(dmat, n_neighbors)
    emb = umap._spectral_init(W, dim, rng)
    a, b = umap.find_ab_params(1.0, 0.1)
    return dmat, emb, W, a, b, rng.randint(np.iinfo(np.int32).max)


def _mix(x):
    x ^= x >> 16
    x = (x * 0x7FEB352D) & _M
    x ^= x >> 15
    x = (x * 0x846CA68B) & _M
    return x ^ (x >> 16)


def _scalar_draw(seed, epoch, rnd, e, n):
    """``draw`` of umap_layout.cu in Python integers."""
    key = _mix(_mix(_mix((seed & _M) ^ 0x9E3779B9) ^ epoch) ^ rnd)
    return (_mix(key ^ e) * n) >> 32


# -- on the CPU -----------------------------------------------------------------------

@pytest.mark.parametrize("seed,epoch,rnd,n", [(0, 0, 0, 7), (2**31 + 12345, 499, 4, 320),
                                              (4_000_000_000, 17, 2, 6000),
                                              (-5, 3, 1, 2**31 - 1)])
def test_negative_samples_are_the_kernels_hash(seed, epoch, rnd, n):
    got = umap._negative_samples(seed, epoch, rnd, 300, n)
    assert got.dtype == np.int64
    assert got.tolist() == [_scalar_draw(seed, epoch, rnd, e, n) for e in range(300)]


@pytest.mark.parametrize("n", [1, 2, 7, 320, 6000, 2**31 - 1])
def test_negative_samples_are_in_range_and_repeat(n):
    got = umap._negative_samples(123, 7, 3, 20_000, n)
    assert got.shape == (20_000,) and got.min() >= 0 and got.max() < n
    np.testing.assert_array_equal(got, umap._negative_samples(123, 7, 3, 20_000, n))
    # n (1 - exp(-k / n)) distinct points expected among k = 20,000 draws
    assert len(np.unique(got)) > 0.9 * n * -np.expm1(-20_000 / n)


def test_negative_samples_differ_by_key():
    base = umap._negative_samples(11, 5, 2, 4800, 320)
    for other in (umap._negative_samples(12, 5, 2, 4800, 320),
                  umap._negative_samples(11, 6, 2, 4800, 320),
                  umap._negative_samples(11, 5, 3, 4800, 320), base[1:]):
        # two independent draws agree on 1/320 of the edges
        assert np.mean(base[:other.size] == other) < 0.02
    # an edge's draw depends on its index, not on the number of edges, and the
    # low 32 bits of the seed key the draws
    np.testing.assert_array_equal(base, umap._negative_samples(11, 5, 2, 9600, 320)[:4800])
    np.testing.assert_array_equal(base, umap._negative_samples(11 + 2**32, 5, 2, 4800, 320))


def test_negative_samples_are_about_uniform():
    counts = np.bincount(np.concatenate([umap._negative_samples(3, epoch, rnd, 4800, 320)
                                         for epoch in range(40) for rnd in range(5)]),
                         minlength=320)
    # 3,000 a point on average, a standard deviation of about 55
    assert counts.min() > 2700 and counts.max() < 3300


def test_cpu_loop_takes_the_counter_draws(monkeypatch):
    _, emb, W, a, b, seed = problem(0, 5, 10, 5)
    calls, draw = [], umap._negative_samples

    def recorded(*args):
        calls.append(args)
        return draw(*args)

    monkeypatch.setattr(umap, "_negative_samples", recorded)
    launches = dict(LAUNCHES)
    with profiling.request("layout") as req:
        got = umap._optimize_layout_device(emb, W, 3, a, b, seed, device="cpu")
    n_edges = int(np.count_nonzero(W))
    assert calls == [(seed, epoch, rnd, n_edges, 50) for epoch in range(3) for rnd in range(5)]
    assert req.record["counters"] == {"host_syncs": 2}
    assert LAUNCHES == launches
    assert got.dtype == np.float64 and got.shape == (50, 5)


# -- on the card ------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("epochs", sorted(LOOP_GAP))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_kernel_is_the_cpu_loop_where_powf_is_exact(cuda, shape, epochs):
    n_groups, copies, dim = SHAPES[shape]
    _, emb, W, a, _, seed = problem(1, n_groups, copies, dim)
    want = umap._optimize_layout_device(emb, W, epochs, a, 1.0, seed, device="cpu")
    np.testing.assert_array_equal(
        umap._optimize_layout_device(emb, W, epochs, a, 1.0, seed, device=cuda), want)


@pytest.mark.cuda
@pytest.mark.parametrize("epochs", sorted(LOOP_GAP))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_kernel_matches_the_cpu_loop(cuda, shape, epochs):
    n_groups, copies, dim = SHAPES[shape]
    _, emb, W, a, b, seed = problem(1, n_groups, copies, dim)
    assert (cuda_umap.blocks_for(emb.shape[0], np.count_nonzero(W)) == 1) == (dim == 5)
    want = umap._optimize_layout_device(emb, W, epochs, a, b, seed, device="cpu")
    got = umap._optimize_layout_device(emb, W, epochs, a, b, seed, device=cuda)
    assert got.dtype == np.float64 and got.shape == emb.shape
    assert np.abs(got - want).max() <= LOOP_GAP[epochs] * np.abs(want).max()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_memory_variants_give_the_same_bits(cuda, shape):
    _, emb, W, a, b, seed = problem(2, *SHAPES[shape])
    x, heads, tails, eps, a32, b32 = umap._layout_inputs(emb, W, a, b)
    want = umap._optimize_layout_device(emb, W, 100, a, b, seed, device=cuda)
    # one block in shared memory where it fits, one in device memory, and 4,
    # 27 and as many blocks as the card holds at once (the kernel caps 1,024)
    for how in ({"blocks": 1}, {"blocks": 1, "shared": False}, {"blocks": 4}, {"blocks": 27},
                {"blocks": 1024}):
        np.testing.assert_array_equal(cuda_umap.optimize_layout(
            x, heads, tails, eps, 100, a32, b32, seed, cuda, **how), want, err_msg=str(how))


@pytest.mark.cuda
def test_layout_repeats_and_another_seed_moves_it(cuda):
    _, emb, W, a, b, seed = problem(3, 20, 16, 5)
    first, again, other = (umap._optimize_layout_device(emb, W, 500, a, b, s, device=cuda)
                           for s in (seed, seed, seed + 1))
    np.testing.assert_array_equal(first, again)
    assert not np.array_equal(first, other)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_layout_is_as_trustworthy_as_the_host_layout(cuda, seed):
    dmat = problem(seed, 20, 16, 5)[0]
    kernel, host = (umap.umap_embed(dmat=dmat, n_components=5, n_neighbors=15,
                                    random_state=seed, layout=layout, device=cuda)
                    for layout in ("device", "host"))
    assert trustworthiness(dmat, kernel) >= trustworthiness(dmat, host) - 0.05


@pytest.mark.cuda
def test_a_layout_is_one_launch(cuda):
    dmat = problem(4, 20, 16, 5)[0]
    before = LAUNCHES["umap_layout"]
    with profiling.request("layout") as req:
        umap.umap_embed(dmat=dmat, n_components=5, n_neighbors=15, random_state=4, device=cuda)
    assert LAUNCHES["umap_layout"] == before + 1
    assert req.record["counters"] == {"host_syncs": 2, "layout_launches": 1}
