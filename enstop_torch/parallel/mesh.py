"""EM over a grid of tiles of the corpus (counterpart of
``enstop_tpu/parallel/mesh.py``).

JAX runs the mesh as one SPMD program over a ``jax.sharding.Mesh`` with axes
``("docs", "vocab")``. Here a :class:`Mesh` is a grid of ``torch.device``
with the same axes, and the program is Python over its tiles:

* ``X`` is cut into ``R x C`` dense tiles: tile (i, j) holds rows
  ``[i tr, (i + 1) tr)`` and columns ``[j tc, (j + 1) tc)`` of the padded
  rectangle as a contiguous tensor on device (i, j), with its word-major
  nonzeros (:func:`stage_sharded_counts`);
* ``P(z|d)`` and the weights are one block per docs row, ``P(w|z)`` one
  block per vocab column (:func:`shard_factors`), the layouts JAX names
  ``P("docs", None)`` and ``P(None, "vocab")``;
* each tile's raw accumulators come from the single-device wrappers of
  ``ops/cuda_em.py`` (the CUDA kernels on a CUDA tensor, their plain
  versions on a CPU tensor), and :func:`psum` reduces them as JAX's
  ``lax.psum`` does: A over docs, B over vocab, the LL over both, and the row
  norms of ``P(w|z)`` over vocab before any column divides.

A mesh may name one device more than once: the tiles on it then run one after
another on its current stream, so several tiles can share one card. With a
``torch.distributed`` process group (``make_mesh(span_ranks=True)``, which
``DistributedPLSA`` asks for) the docs axis spans the ranks: each rank holds
its own rows of the grid, and every sum over docs ends in an ``all_reduce``.

:func:`psum` adds the partials in shard order, with no atomics, so a fit on a
mesh gives the same bits from run to run, and on a 1 x 1 mesh the bits of the
single-device fit.

The runs mesh (:func:`make_runs_mesh`) splits an ensemble's bootstrap runs
into contiguous blocks, one a device, each block fitted run after run
(:func:`build_ensemble_runs_sharded`).

Not ported, because the port is eager and compiles nothing: the
``lru_cache`` programs and ``aot_cache.maybe_wrap``, ``_TILE_NNZ_BUCKET``
(it pads each tile's nonzeros so that one compiled scatter serves similar
corpora), the ``row_bucket`` padding of a transform's rows, the native
counting sort of the tile keys (a stable sort does it), and ``inner`` (a
tile's step is always ``ops/cuda_em.py``'s). The padding they add is
absorbing, so no result depends on it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..ops import cuda_em
from ..ops.cuda_sparse import Side
from ..ops.data import COL_MULTIPLE, ROW_MULTIPLE, resolve_device, round_up, ship_coo
from ..ops.driver import PreparedCounts, _resolve_x_dtype, fit_padded, kernel_steps
from ..ops.fit import em_fit_loop_folded
from ..ops.sell import word_side

_TINY = 1e-30

__all__ = ["Mesh", "local_devices", "process_ranks", "largest_divisor", "make_mesh",
           "make_runs_mesh", "mesh_layout_multiples", "psum", "stage_sharded_counts",
           "shard_factors", "shard_inputs", "gather_rows", "gather_cols",
           "build_sharded_em_step", "build_sharded_ll", "build_sharded_refit_step",
           "build_sharded_fit",
           "build_ensemble_runs_sharded"]


def local_devices(device="cuda"):
    """This process's devices for ``device``: every CUDA card for ``"cuda"``,
    the one named for ``"cuda:N"``, the CPU for ``"cpu"``. Raises as
    :func:`~..ops.data.resolve_device` does when CUDA is asked for and absent."""
    dev = resolve_device(device)
    if dev.type == "cpu" or dev.index is not None:
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def process_ranks(span_ranks=True):
    """``(world size, rank)`` of the process group a mesh spans: ``(1, 0)``
    unless ``span_ranks`` and a ``torch.distributed`` group is initialised."""
    if span_ranks and dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class Mesh:
    """A grid of devices with named axes, like ``jax.sharding.Mesh``.

    ``devices`` is this process's part of the grid, a numpy object array of
    ``torch.device`` (one device may appear more than once). With ``world``
    ranks, rank ``rank`` holds entries ``first .. first + len - 1`` of the
    first axis of a grid ``world`` times as long; ``shape`` gives the whole
    grid's size by axis name.
    """

    def __init__(self, devices, axis_names, world=1, rank=0):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.world = world
        self.rank = rank

    @property
    def shape(self):
        sizes = (self.devices.shape[0] * self.world,) + self.devices.shape[1:]
        return dict(zip(self.axis_names, sizes))

    @property
    def first(self):
        """The index, along the first axis, of this rank's first entry."""
        return self.rank * self.devices.shape[0]


def _grid(devices, shape):
    """``devices`` as an object array of ``shape``, a bare ``"cuda"`` named
    by its index, so that equal entries are one card."""
    grid = np.empty(len(devices), dtype=object)
    grid[:] = [torch.device("cuda", torch.cuda.current_device())
               if torch.device(d) == torch.device("cuda") else torch.device(d) for d in devices]
    return grid.reshape(shape)


def largest_divisor(n, at_most):
    """The largest divisor of ``n`` that is at most ``at_most`` (1 at least):
    how the estimators clamp a requested mesh to the devices they have."""
    d = max(min(at_most or 1, n), 1)
    while n % d:
        d -= 1
    return d


def make_mesh(n_row_shards=None, n_col_shards=1, devices=None, span_ranks=False):
    """A ``(docs, vocab)`` mesh over ``devices`` (by default
    :func:`local_devices`), ``n_row_shards x n_col_shards`` of them; by
    default every device on the docs axis. ``span_ranks``: under an
    initialised process group, the docs axis continues over the other ranks'
    grids (each rank passes its own devices; the vocab axis stays inside a
    rank)."""
    devices = list(local_devices() if devices is None else devices)
    n_dev = len(devices)
    if n_row_shards is None:
        n_row_shards = n_dev // n_col_shards
    if n_row_shards * n_col_shards != n_dev:
        raise ValueError(f"n_row_shards * n_col_shards = {n_row_shards * n_col_shards} does "
                         f"not match device count {n_dev}")
    world, rank = process_ranks(span_ranks)
    return Mesh(_grid(devices, (n_row_shards, n_col_shards)), ("docs", "vocab"), world, rank)


def make_runs_mesh(n_shards=None, devices=None):
    """A 1-D ``("runs",)`` mesh over the first ``n_shards`` of ``devices``
    (by default :func:`local_devices`, all of them)."""
    devices = list(local_devices() if devices is None else devices)
    n_shards = n_shards or len(devices)
    return Mesh(_grid(devices[:n_shards], (n_shards,)), ("runs",))


def mesh_layout_multiples(mesh):
    """The multiples the padded corpus is rounded to, so that every tile is
    a whole number of the single-device layout's rows (8) and columns (128)."""
    return mesh.shape["docs"] * ROW_MULTIPLE, mesh.shape["vocab"] * COL_MULTIPLE


def psum(parts, dst, across_ranks=False):
    """The sum of ``parts`` on device ``dst``, each copied there and added in
    the order given (one part is returned as it is); with ``across_ranks``,
    then summed over the process group's ranks (``all_reduce``)."""
    out = parts[0].to(dst)
    for part in parts[1:]:
        out = out + part.to(dst)
    if across_ranks:
        out = out.contiguous()
        dist.all_reduce(out)
    return out


def _tile_shape(mesh, n, m):
    rm, cm = mesh_layout_multiples(mesh)
    return (round_up(max(n, 1), rm) // mesh.shape["docs"],
            round_up(max(m, 1), cm) // mesh.shape["vocab"])


def stage_sharded_counts(mesh, X, x_dtype="auto"):
    """Stage this rank's tiles of a (sparse or dense) count matrix: each
    tile's nonzeros ship by themselves (O(nnz) bytes) and are scattered on
    the tile's device into a contiguous ``(tr, tc)`` tensor, with the tile's
    word-major nonzeros in local indices. ``x_dtype`` is resolved once for
    the whole corpus (``"auto"``: bf16 where it holds the counts exactly), so
    every tile has one dtype. Returns ``(tiles, n, m)``: ``tiles[i][j]`` a
    :class:`~..ops.driver.PreparedCounts` of the tile on ``mesh.devices[i,
    j]``."""
    n, m = X.shape
    dtype = _resolve_x_dtype(X, x_dtype)
    tr, tc = _tile_shape(mesh, n, m)
    cols_n = mesh.shape["vocab"]
    rows, cols, vals = ship_coo(X, "cpu")
    key = (rows // tr) * cols_n + cols // tc
    order = torch.sort(key, stable=True).indices  # a tile's entries stay in row-major order
    rows, cols, vals = rows[order], cols[order], vals[order]
    ends = torch.cumsum(torch.bincount(key, minlength=mesh.shape["docs"] * cols_n), 0).tolist()
    tiles = []
    for i, row_devices in enumerate(mesh.devices):
        gi = mesh.first + i
        tiles.append([])
        for j, dev in enumerate(row_devices):
            t = gi * cols_n + j
            lo, hi = (ends[t - 1] if t else 0), ends[t]
            r = (rows[lo:hi] - gi * tr).to(dev)
            c = (cols[lo:hi] - j * tc).to(dev)
            v = vals[lo:hi].to(dev).to(dtype)
            Xt = torch.zeros((tr, tc), dtype=dtype, device=dev)
            Xt[r, c] = v
            backend = "cuda" if dev.type == "cuda" else "torch"
            tiles[-1].append(PreparedCounts(Xt, tr, tc, hi - lo, backend,
                                            word_side(r, c, v, tc, tr)))
    return tiles, n, m


def shard_factors(mesh, zd, wz, w):
    """Padded host factors ``zd`` (n_pad, kp), ``wz`` (kp, m_pad) and weights
    ``w`` (n_pad,) as the mesh holds them: this rank's blocks of ``zd`` and
    ``w`` by docs row, on the row's first device, and ``wz``'s blocks by
    vocab column, on the column's first device."""
    tr, tc = zd.shape[0] // mesh.shape["docs"], wz.shape[1] // mesh.shape["vocab"]

    def put(a, dev):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    rows = [slice((mesh.first + i) * tr, (mesh.first + i + 1) * tr)
            for i in range(mesh.devices.shape[0])]
    return ([put(zd[r], mesh.devices[i, 0]) for i, r in enumerate(rows)],
            [put(wz[:, j * tc:(j + 1) * tc], dev) for j, dev in enumerate(mesh.devices[0])],
            [put(w[r], mesh.devices[i, 0]) for i, r in enumerate(rows)])


def shard_inputs(mesh, X, zd, wz, w):
    """Padded host inputs placed on the mesh: ``(tiles, zd, wz, w)``, the
    tiles of the (n_pad, m_pad) count matrix ``X`` as
    :func:`stage_sharded_counts` stages them and the factor blocks of
    :func:`shard_factors`. ``X`` must be padded to the mesh's multiples
    (:func:`mesh_layout_multiples`) and the factors to ``X``'s shape."""
    n_pad, m_pad = X.shape
    rm, cm = mesh_layout_multiples(mesh)
    if n_pad % rm or m_pad % cm:
        raise ValueError(f"X {X.shape} is not padded to the mesh's multiples ({rm}, {cm})")
    if zd.shape[0] != n_pad or wz.shape[1] != m_pad or w.shape != (n_pad,):
        raise ValueError(f"factors {zd.shape}, {wz.shape} and weights {w.shape} do not match "
                         f"X {X.shape}")
    return (stage_sharded_counts(mesh, X)[0],) + shard_factors(mesh, zd, wz, w)


def gather_rows(mesh, parts):
    """The blocks of a docs-sharded array, every rank's in rank order, as one
    numpy array (each rank's blocks must add up to the same height)."""
    local = torch.cat([p.to(parts[0].device) for p in parts])
    if mesh.world > 1:
        pieces = [torch.empty_like(local) for _ in range(mesh.world)]
        dist.all_gather(pieces, local)
        local = torch.cat(pieces)
    return local.cpu().numpy()


def gather_cols(parts):
    """The blocks of a vocab-sharded array as one numpy array."""
    return np.concatenate([p.cpu().numpy() for p in parts], axis=1)


def _tile_inputs(mesh, tiles, zd, wz, w=None):
    """Each tile's ``(i, j, X, zd, wz, w)`` on its device, in row-major order."""
    for i, row_devices in enumerate(mesh.devices):
        for j, dev in enumerate(row_devices):
            yield (i, j, tiles[i][j], zd[i].to(dev), wz[j].to(dev),
                   None if w is None else w[i].to(dev))


def _normalize_rows(num):
    return num / num.sum(dim=1, keepdim=True).clamp_min(_TINY)


def build_sharded_em_step(mesh, compute_ll=True):
    """``(tiles, zd, wz, w) -> (next_zd, next_wz, ll_of_inputs)`` over the
    mesh: ``tiles`` from :func:`stage_sharded_counts`, ``zd``, ``wz`` and
    ``w`` the blocks of :func:`shard_factors`. With ``compute_ll=False`` the
    LL is 0 and the tiles skip its log sweep."""
    ranks = mesh.world > 1
    n_rows, n_cols = mesh.devices.shape

    def step(tiles, zd, wz, w):
        A = [[] for _ in range(n_cols)]
        B = [[] for _ in range(n_rows)]
        lls = []
        for i, j, tile, zd_t, wz_t, w_t in _tile_inputs(mesh, tiles, zd, wz, w):
            A_t, B_t, ll = cuda_em.em_accumulators_fused(tile.device_array, zd_t, wz_t, w_t,
                                                         compute_ll=compute_ll, word=tile.word)
            A[j].append(A_t)
            B[i].append(B_t)
            lls.append(ll)
        num_wz = [wz[j] * psum(A[j], wz[j].device, ranks) for j in range(n_cols)]
        # the row norms of P(w|z) span the vocab axis: every column's row sums
        # are added before any column divides
        norm = psum([num.sum(dim=1, keepdim=True) for num in num_wz],
                    num_wz[0].device).clamp_min(_TINY)
        next_wz = [num / norm.to(num.device) for num in num_wz]
        next_zd = [_normalize_rows(zd[i] * psum(B[i], zd[i].device)) for i in range(n_rows)]
        return next_zd, next_wz, psum(lls, zd[0].device, ranks)

    return step


def build_sharded_ll(mesh):
    """``(tiles, zd, wz, w) -> ll``: the weighted log-likelihood over the mesh."""
    ranks = mesh.world > 1

    def ll_fn(tiles, zd, wz, w):
        return psum([cuda_em.log_likelihood_fused(tile.device_array, zd_t, wz_t, w_t)
                     for _, _, tile, zd_t, wz_t, w_t in _tile_inputs(mesh, tiles, zd, wz, w)],
                    zd[0].device, ranks)

    return ll_fn


def build_sharded_refit_step(mesh, compute_ll=True):
    """``(tiles, zd, wz) -> (next_zd, ll_of_inputs)``: the frozen-topics step
    over the mesh (unweighted, as in JAX)."""
    ranks = mesh.world > 1
    n_rows = mesh.devices.shape[0]

    def step(tiles, zd, wz):
        B = [[] for _ in range(n_rows)]
        lls = []
        for i, _, tile, zd_t, wz_t, _ in _tile_inputs(mesh, tiles, zd, wz):
            B_t, ll = cuda_em.refit_accumulators_fused(tile.device_array, zd_t, wz_t,
                                                       compute_ll=compute_ll)
            B[i].append(B_t)
            lls.append(ll)
        next_zd = [_normalize_rows(zd[i] * psum(B[i], zd[i].device)) for i in range(n_rows)]
        return next_zd, psum(lls, zd[0].device, ranks)

    return step


def build_sharded_fit(mesh, n_iter, n_iter_per_test, refit=False):
    """``(tiles, zd, wz, w, tolerance) -> FitResult``: the fit (or with
    ``refit`` the frozen-topics refit) over the mesh through
    :func:`~..ops.fit.em_fit_loop_folded`, the test LL folded into the step
    after each test point (the refit's step gives the LL of its input state
    too). JAX's ``_sharded_fit_program`` is this function: it exists there to
    cache a compiled program."""
    ll_fn = build_sharded_ll(mesh)
    if refit:
        steps = [build_sharded_refit_step(mesh, compute_ll=c) for c in (True, False)]
    else:
        steps = [build_sharded_em_step(mesh, compute_ll=c) for c in (True, False)]

    def run(tiles, zd, wz, w, tolerance):
        def state_step(fn):
            def one(state):
                if refit:
                    new_zd, ll = fn(tiles, state[0], state[1])
                    return (new_zd, state[1]), ll
                new_zd, new_wz, ll = fn(tiles, state[0], state[1], w)
                return (new_zd, new_wz), ll
            return one

        return em_fit_loop_folded(state_step(steps[0]), state_step(steps[1]),
                                  lambda s: ll_fn(tiles, s[0], s[1], w), (zd, wz), n_iter,
                                  n_iter_per_test, tolerance)

    return run


def _replica(prepared, device):
    """``prepared`` (a :class:`PreparedCounts`) on ``device``; itself when it
    lies there."""
    if prepared.device_array.device == device:
        return prepared
    s = prepared.word
    word = Side(*(t.to(device) for t in (s.idx, s.vals, s.seg_ptr, s.seg_owner,
                                         s.owner_seg_ptr)), s.n_owner, s.n_index)
    return PreparedCounts(prepared.device_array.to(device), prepared.n, prepared.m,
                          prepared.nnz, prepared.backend, word)


def build_ensemble_runs_sharded(mesh, precision="default"):
    """``(prepared, n_runs, inputs, tolerance, n_iter, n_iter_per_test) ->
    [P(w|z) of each run]``: an ensemble's bootstrap fits over a runs mesh.
    The runs are cut into ``mesh.shape["runs"]`` contiguous blocks; block s
    is fitted run after run on ``mesh.devices[s]`` with
    :func:`~..ops.driver.fit_padded` and ``kernel_steps(precision)``, against
    that device's replica of ``prepared`` (devices named more than once share
    one). ``inputs(i, device)`` gives run i's padded ``(P(z|d), P(w|z),
    weights)`` on ``device``. A run's result does not depend on its block."""
    n_shards = mesh.shape["runs"]

    def run(prepared, n_runs, inputs, tolerance, n_iter, n_iter_per_test):
        if n_runs % n_shards:
            raise ValueError(f"{n_runs} runs do not divide over {n_shards} shards")
        per_shard = n_runs // n_shards
        replicas, out = {}, []
        for s, dev in enumerate(mesh.devices):
            if dev not in replicas:
                replicas[dev] = _replica(prepared, dev)
            rep = replicas[dev]
            steps = kernel_steps(precision, rep.word)
            for i in range(s * per_shard, (s + 1) * per_shard):
                zd, wz, w = inputs(i, dev)
                res = fit_padded(rep.device_array, zd, wz, w, n_iter, n_iter_per_test,
                                 tolerance, steps)
                out.append(res.state[1])
        return out

    return run
