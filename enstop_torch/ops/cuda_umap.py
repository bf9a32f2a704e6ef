"""Wrapper of the hand-written CUDA UMAP layout kernel (``csrc/umap_layout.cu``):
every epoch of the layout's SGD (:func:`enstop_torch.cluster.umap._optimize_layout_device`)
in one launch, counted as ``"umap_layout"``. It replaces no TPU kernel: the JAX
package runs the same epochs as one compiled ``lax.fori_loop``.

The kernel reads one int32 array (:func:`pack`): the edges' heads (sorted),
tails, the edge ids sorted stably by tail and their heads, both segment tables,
the edges' epochs per sample and the start, which it overwrites with the
layout. :func:`optimize_layout` copies it up once and reads the layout back
once.
"""

from __future__ import annotations

import numpy as np
import torch

from ._build import launch, library

__all__ = ["pack", "blocks_for", "launch_layout", "layout_of", "optimize_layout"]

# the edges from which a layout runs on many blocks, about an edge a thread,
# under grid-wide barriers; below, on one block. Measured on an H100, 500
# epochs: at 4,800 edges one block 14.6 ms, 132 blocks 26.2; at 26,982 one
# block 469 ms, 27 blocks 249. One block's 6.1 ns an edge and epoch meets the
# grid's 52 us an epoch near 8,500 edges; up to 16,384 every ensemble graph
# (at most 30 edges a topic) of up to 546 topics stays on one block.
GRID_EDGES = 16_384
_MAX_THREADS = _MAX_BLOCKS = 1024  # kMaxThreads, kMaxBlocks of the kernel


def blocks_for(n, n_edges):
    """The blocks a layout of ``n`` points and ``n_edges`` edges runs on (the
    kernel takes no more than the card holds at once)."""
    return 1 if n_edges < GRID_EDGES else -(-max(n_edges, n) // _MAX_THREADS)


def pack(x, heads, tails, eps):
    """The kernel's input as one int32 array, from the start ``x`` (n, dim)
    float32, the edges ``heads`` (nondecreasing) and ``tails`` and their
    epochs per sample ``eps`` (float32)."""
    n = x.shape[0]
    by_tail = np.argsort(tails, kind="stable")
    tables = [heads, tails, by_tail, heads[by_tail], np.searchsorted(heads, np.arange(n + 1)),
              np.searchsorted(tails[by_tail], np.arange(n + 1))]
    return np.concatenate([np.concatenate(tables).astype(np.int32), eps.view(np.int32),
                           np.ascontiguousarray(x).ravel().view(np.int32)])


def launch_layout(packed, n, dim, n_epochs, a, b, seed, negative_sample_rate=5,
                  initial_alpha=1.0, blocks=None, shared=True):
    """Run ``n_epochs`` epochs on the CUDA tensor ``packed`` (:func:`pack` of
    n points in ``dim`` dimensions), in place: its last ``n * dim`` words hold
    the layout after. ``a``, ``b``: the curve's float32 parameters; ``seed``:
    the negative samples' key, its low 32 bits. ``blocks`` (:func:`blocks_for`
    when None) and ``shared`` (positions and tables in shared memory where one
    block runs and they fit) choose how it runs, never its bits."""
    n_edges = (packed.numel() - 2 * (n + 1) - n * dim) // 5
    if blocks is None:
        blocks = blocks_for(n, n_edges)
    threads = _MAX_THREADS if blocks > 1 else min(_MAX_THREADS, -(-max(n_edges, n) // 32) * 32)
    scratch = torch.empty(4 * n_edges + n * dim + _MAX_BLOCKS, dtype=torch.float32,
                          device=packed.device)
    launch("umap_layout", library("umap_layout").enstop_umap_layout, packed.device,
           packed.data_ptr(), scratch.data_ptr(), n_edges, n, dim, n_epochs,
           negative_sample_rate, float(initial_alpha), a, b, b - 1.0, -2.0 * a * b, 2.0 * b,
           int(seed) & 0xFFFFFFFF, int(shared), blocks, threads)


def layout_of(packed, n, dim):
    """The positions :func:`launch_layout` left in ``packed``, (n, dim) float32."""
    return packed[packed.numel() - n * dim:].view(torch.float32).view(n, dim)


def optimize_layout(x, heads, tails, eps, n_epochs, a, b, seed, dev, negative_sample_rate=5,
                    initial_alpha=1.0, **how):
    """The layout of :func:`launch_layout` on the CUDA device ``dev`` from
    numpy inputs: one copy up, one launch, one read back. ``how``:
    :func:`launch_layout`'s ``blocks`` and ``shared``. Returns (n, dim)
    float32 numpy."""
    n, dim = x.shape
    packed = torch.from_numpy(pack(x, heads, tails, eps)).to(dev)
    launch_layout(packed, n, dim, n_epochs, a, b, seed, negative_sample_rate, initial_alpha,
                  **how)
    return layout_of(packed, n, dim).cpu().numpy()
