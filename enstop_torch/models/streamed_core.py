"""Out-of-core streamed pLSA: host memory O(nnz), device memory O(block)
(counterpart of ``enstop_tpu/models/streamed_core.py``).

* At fit start each block of ``block_docs`` documents is packed once on the
  host into the two sorted sides of :class:`~enstop_torch.ops.cuda_sparse.Side`
  (doc-major: the block's documents own the entries, indexed by word;
  word-major: all ``m`` words own them, indexed by the block's documents),
  held in pinned memory when the fit runs on the card.
* Every EM iteration streams each block to the card once, in a fixed order,
  and runs the sparse passes on it (kernels #8 and #9, ``csrc/em_sparse.cu``):
  the word pass adds the block's share of A (weighted) to a sum over blocks
  taken in block order, reading the block's pre-update ``P(z|d)``; then the
  doc pass gives the block's new ``P(z|d)`` and its log-likelihood. After the
  last block ``P(w|z)`` is finished from A (the prior multiply skipped under
  a firing threshold, whose accumulators already hold it).
* The log-likelihood of the state after iteration T comes from the doc
  passes of iteration T + 1, so testing costs no extra stream; the factors
  are checkpointed (on the device) at test points, and an early stop returns
  the checkpoint, the reference's state. A test that lands on ``n_iter``
  takes one more stream of the doc sides.

The copies: two slots on the card, each as large as the largest block,
take turns. A block's sides go host to device with ``non_blocking=True`` on
a side CUDA stream; the compute stream waits on the copy's event before the
block's kernels, and block b + 1's copy (after the last block, the next
sweep's first) is queued before block b's kernels, so it overlaps them. A
slot is written again only after an event recorded behind the kernels of
the block it held, so at most two blocks are on the card at once and none is
overwritten while it is read. On the CPU the blocks are used where they lie.

Device-resident state: ``P(w|z)``, the A sum, every block's ``P(z|d)`` (as in
the JAX package), their checkpoint and the two slots.

Not ported, each for a reason:

* the uniform block shapes (every side padded to the largest block's
  segment rows and lane): they exist so that XLA compiles each block step
  once; eager PyTorch compiles nothing.
* ``ENSTOP_STREAMED_PALLAS`` and the Pallas chunk layout: the TPU's two
  sparse layouts are one here (``ops/sell.py``).
"""

from __future__ import annotations

import time

import numpy as np
import scipy.sparse as sp
import torch

from ..ops.cuda_sparse import Side, build_side, doc_pass, word_pass
from ..ops.data import _weighted, resolve_device, ship_coo
from ..ops.em import _rownorm
from ..ops.init import plsa_init
from ..ops.sell import _material_thresh, word_side
from ..utils import check_random_state

__all__ = ["streamed_fit_core", "streamed_refit_core"]

_FIELDS = ("idx", "vals", "seg_ptr", "seg_owner", "owner_seg_ptr")


def _tensors(side):
    return [getattr(side, f) for f in _FIELDS]


class _BlockStore:
    """The corpus cut into blocks of ``block_docs`` documents, each packed
    once on the host into its doc-major and word-major sides (pinned when
    ``pin``): O(nnz) host memory, plus ``m + 1`` segment offsets a block."""

    def __init__(self, X, block_docs, pin=False):
        Xcsr = X.tocsr() if sp.issparse(X) else sp.csr_matrix(np.asarray(X))
        self.n, self.m = Xcsr.shape
        self.block_docs = int(block_docs)
        self.block_rows = [(lo, min(lo + self.block_docs, self.n))
                           for lo in range(0, self.n, self.block_docs)]
        self.blocks = []
        for lo, hi in self.block_rows:
            rows, cols, vals = ship_coo(Xcsr[lo:hi], "cpu")
            sides = {"doc": build_side(rows, cols, vals, hi - lo, self.m),
                     "word": word_side(rows, cols, vals, self.m, hi - lo)}
            if pin:
                sides = {name: Side(*(t.pin_memory() for t in _tensors(s)), s.n_owner,
                                    s.n_index) for name, s in sides.items()}
            self.blocks.append(sides)

    @property
    def n_blocks(self):
        return len(self.blocks)

    def side_bytes(self, b, name):
        return sum(t.numel() * t.element_size() for t in _tensors(self.blocks[b][name]))

    def host_bytes(self):
        return sum(self.side_bytes(b, name) for b in range(self.n_blocks)
                   for name in ("doc", "word"))


class _Streamer:
    """Hands out each block's sides on ``device``, in block order, a sweep
    at a time; on the card through two slots on a side stream (see the
    module docstring). ``bytes_shipped`` counts what went host to device; a
    slot that still holds the block asked for is not copied again, so a
    corpus of one or two blocks stays on the card after its first sweep."""

    def __init__(self, store, device):
        self.store, self.device = store, device
        self.cuda = device.type == "cuda"
        self.bytes_shipped = 0
        if not self.cuda:
            return
        self.copy_stream = torch.cuda.Stream(device)
        self.slots = [{name: [torch.empty(max(_tensors(blk[name])[i].numel()
                                              for blk in store.blocks),
                                          dtype=_tensors(store.blocks[0][name])[i].dtype,
                                          device=device)
                              for i in range(len(_FIELDS))]
                       for name in ("doc", "word")} for _ in range(2)]
        self.copied = [None, None]  # event behind the last copy into a slot
        self.freed = [None, None]   # event behind the last kernels that read it
        self.held = [None, None]    # (block, set of sides) a slot holds
        self.slot = 0               # the slot of the next sweep's first block

    def _ship(self, b, s, names):
        """Copy block ``b``'s sides ``names`` into slot ``s`` on the copy
        stream, once the kernels that read the slot last are done."""
        have = self.held[s][1] if self.held[s] and self.held[s][0] == b else set()
        missing = [name for name in names if name not in have]
        if not missing:
            return
        with torch.cuda.stream(self.copy_stream):
            if self.freed[s] is not None:
                self.copy_stream.wait_event(self.freed[s])
            for name in missing:
                for dst, src in zip(self.slots[s][name], _tensors(self.store.blocks[b][name])):
                    dst[:src.numel()].copy_(src, non_blocking=True)
                self.bytes_shipped += self.store.side_bytes(b, name)
            done = torch.cuda.Event()
            done.record(self.copy_stream)
        self.copied[s] = done
        self.held[s] = (b, have | set(missing))

    def _view(self, b, s, name):
        host = self.store.blocks[b][name]
        return Side(*(dst[:src.numel()] for dst, src in zip(self.slots[s][name],
                                                            _tensors(host))),
                    host.n_owner, host.n_index)

    def sweep(self, word=True, then=None):
        """Yield ``(b, doc side, word side or None)`` for every block.
        ``then``: None, or whether the next sweep needs the word sides
        (``True``/``False``), so that the last block's turn starts the next
        sweep's first copy."""
        names = ("doc", "word") if word else ("doc",)
        if not self.cuda:
            for b, blk in enumerate(self.store.blocks):
                yield b, blk["doc"], (blk["word"] if word else None)
            return
        compute = torch.cuda.current_stream(self.device)
        nb, s = self.store.n_blocks, self.slot
        self._ship(0, s, names)
        for b in range(nb):
            compute.wait_event(self.copied[s])
            if b + 1 < nb:
                self._ship(b + 1, 1 - s, names)
            elif then is not None:
                self._ship(0, 1 - s, ("doc", "word") if then else ("doc",))
            yield (b, self._view(b, s, "doc"), self._view(b, s, "word") if word else None)
            # the caller has queued block b's kernels
            freed = torch.cuda.Event()
            freed.record(compute)
            self.freed[s] = freed
            s = 1 - s
        self.slot = s

    def close(self):
        """Order the compute stream behind any copy still in flight, so the
        slots may go back to the allocator."""
        if self.cuda:
            torch.cuda.current_stream(self.device).wait_stream(self.copy_stream)


def _per_block(store, values, device):
    return [torch.from_numpy(np.ascontiguousarray(values[lo:hi], dtype=np.float32)).to(device)
            for lo, hi in store.block_rows]


def _weights(sample_weight, n):
    return (np.asarray(sample_weight, np.float32) if _weighted(sample_weight)
            else np.ones(n, np.float32))


def streamed_fit_core(X, k, sample_weight=None, init="random", block_docs=65536, n_iter=100,
                      n_iter_per_test=10, tolerance=0.001, e_step_thresh=None,
                      random_state=None, device="cuda"):
    """Out-of-core EM fit. Returns ``(zd, wz, n_steps, ll_trace, info)``: the
    factors as numpy, and ``info`` with ``wall_time_s`` (of which ``store_s``
    packed the store and ``loop_s`` ran the EM loop), ``n_sweeps``,
    ``bytes_shipped``, ``bytes_per_sweep`` (both sides of every block),
    ``host_bytes``, ``n_blocks``, ``log_likelihood`` and
    ``nnz_k_updates_per_s``.

    The trajectory is the flat fit's: tests after iterations 1, 1 + npt,
    ...; an early stop returns the factors at the converged test point.
    """
    rng = check_random_state(random_state)
    dev = resolve_device(device)
    t0 = time.perf_counter()
    store = _BlockStore(X, block_docs, pin=dev.type == "cuda")
    n, m = store.n, store.m
    thresh = _material_thresh(e_step_thresh)
    pzd0, pwz0 = plsa_init(X, k, init=init, rng=rng)
    wz = torch.from_numpy(pwz0).to(dev)
    zd_blocks = _per_block(store, pzd0, dev)
    w_blocks = _per_block(store, _weights(sample_weight, n), dev)
    streamer = _Streamer(store, dev)
    t_loop = time.perf_counter()
    n_iter = int(n_iter)
    npt = max(int(n_iter_per_test), 1)
    test_points = {1} | {1 + j * npt for j in range(1, n_iter // npt + 1)}
    final_pass = n_iter in test_points

    ll_trace, prev_ll, saved, saved_at, steps_run, sweeps = [], None, None, None, 0, 0
    result = None
    for t in range(1, n_iter + 1):
        if (t - 1) in test_points:
            # the LL this sweep collects is that of the state after t - 1 steps
            saved, saved_at = ([zb.clone() for zb in zd_blocks], wz.clone()), t - 1
        wzT = wz.t().contiguous()
        a_sum = torch.zeros((m, k), dtype=torch.float32, device=dev)
        ll_acc = torch.zeros((), dtype=torch.float32, device=dev)
        then = True if t < n_iter else (False if final_pass else None)
        for b, doc, word in streamer.sweep(word=True, then=then):
            AT, _ = word_pass(word, zd_blocks[b], wzT, w_blocks[b], thresh, compute_ll=False)
            a_sum += AT
            B, ll_b = doc_pass(doc, zd_blocks[b], wzT, w_blocks[b], thresh)
            zd_blocks[b] = _rownorm(B if thresh is not None else zd_blocks[b] * B)
            ll_acc += ll_b
        sweeps += 1
        wz = _rownorm(a_sum.t() if thresh is not None else wz * a_sum.t())
        steps_run = t

        if (t - 1) in test_points and t - 1 >= 1:
            cur = float(ll_acc)
            ll_trace.append(cur)
            change = abs(cur - prev_ll)
            if change == 0.0 or change / abs(cur) < tolerance:
                result = saved[0], saved[1], saved_at
                break
            prev_ll = cur
        elif t == 1:
            prev_ll = float(ll_acc)  # LL of the initial state, the first value
            ll_trace.append(prev_ll)

    if result is None and final_pass and steps_run == n_iter:
        wzT = wz.t().contiguous()
        ll_acc = torch.zeros((), dtype=torch.float32, device=dev)
        for b, doc, _ in streamer.sweep(word=False):
            ll_acc += doc_pass(doc, zd_blocks[b], wzT, w_blocks[b])[1]
        sweeps += 1
        ll_trace.append(float(ll_acc))
    if result is None:
        result = zd_blocks, wz, steps_run
    streamer.close()
    zd_out = torch.cat(result[0]).cpu().numpy()
    wz_out = result[1].cpu().numpy()  # sync
    wall = time.perf_counter() - t0
    nnz = sum(int(blk["doc"].nnz) for blk in store.blocks)
    info = {
        "n_steps": result[2],
        "log_likelihood": ll_trace[-1] if ll_trace else float("nan"),
        "ll_trace": np.asarray(ll_trace, dtype=np.float64),
        "wall_time_s": wall,
        "store_s": t_loop - t0,
        "loop_s": wall - (t_loop - t0),
        "nnz_k_updates_per_s": result[2] * nnz * k / max(wall, 1e-9),
        "backend": "streamed",
        "n_blocks": store.n_blocks,
        "n_sweeps": sweeps,
        "bytes_shipped": streamer.bytes_shipped,
        "bytes_per_sweep": sum(store.side_bytes(b, s) for b in range(store.n_blocks)
                               for s in ("doc", "word")),
        "host_bytes": store.host_bytes(),
    }
    return zd_out, wz_out, result[2], ll_trace, info


def streamed_refit_core(X, topics, sample_weight=None, block_docs=65536, n_iter=50,
                        n_iter_per_test=10, tolerance=0.005, e_step_thresh=None,
                        random_state=None, device="cuda"):
    """Frozen-topics refit with the dense refit's convergence schedule;
    returns ``P(z|d)`` as numpy.

    Iterations run in chunks, ``[1, 1]``, ``[2, 1 + npt]``, ...: each block's
    doc side is shipped once a chunk and sweeps the chunk's iterations on the
    device, so the copies are O(nnz) a test, not an iteration. The first
    iteration of a chunk gives the LL of the pending test point; on
    convergence the checkpoint at that test point comes back. The start is
    one full-matrix draw from ``random_state``, split by block, as
    ``ops/driver.py:plsa_refit`` draws it. ``sample_weight`` weights the
    log-likelihood only, as in the reference's streamed refit.
    """
    rng = check_random_state(random_state)
    dev = resolve_device(device)
    store = _BlockStore(X, block_docs, pin=dev.type == "cuda")
    n = store.n
    k = topics.shape[0]
    thresh = _material_thresh(e_step_thresh)
    wzT = torch.from_numpy(np.asarray(topics, np.float32)).to(dev).t().contiguous()
    z0 = rng.rand(n, k)
    z0 /= z0.sum(axis=1, keepdims=True)
    n_iter = int(n_iter)
    if n_iter < 1:
        return z0.astype(np.float32)
    zd_blocks = _per_block(store, z0, dev)
    w_blocks = _per_block(store, _weights(sample_weight, n), dev)
    npt = max(int(n_iter_per_test), 1)
    chunks, a = [(1, 1)], 2
    while a <= n_iter:
        chunks.append((a, min(a + npt - 1, n_iter)))
        a = chunks[-1][1] + 1

    streamer = _Streamer(store, dev)
    prev_ll, result = None, None
    for ci, (a, b_end) in enumerate(chunks):
        if a >= 2:
            saved = [zb.clone() for zb in zd_blocks]  # state a - 1, the pending test point
        ll_acc = torch.zeros((), dtype=torch.float32, device=dev)
        then = False if ci + 1 < len(chunks) else None
        for bi, doc, _ in streamer.sweep(word=False, then=then):
            zd_b = zd_blocks[bi]
            for t in range(a, b_end + 1):
                B, ll_b = doc_pass(doc, zd_b, wzT, w_blocks[bi], thresh, compute_ll=t == a)
                zd_b = _rownorm(B if thresh is not None else zd_b * B)
                if t == a:
                    ll_acc += ll_b
            zd_blocks[bi] = zd_b
        cur = float(ll_acc)
        if a == 1:
            prev_ll = cur
            continue
        change = abs(cur - prev_ll)
        if change == 0.0 or change / abs(cur) < tolerance:
            result = saved
            break
        prev_ll = cur
    streamer.close()
    # a test point on n_iter changes no returned state: no extra pass
    return torch.cat(result if result is not None else zd_blocks).cpu().numpy()
