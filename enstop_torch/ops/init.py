"""Factor initialization for pLSA (counterpart of ``enstop_tpu/ops/init.py``).

Host NumPy, drawing from the same ``RandomState`` stream in the same order as
the JAX package, so both start from identical factors for the same seed.
``"nndsvd"`` needs a randomized SVD, which the JAX package takes from
scikit-learn; :func:`randomized_svd` here is a NumPy and SciPy copy of
scikit-learn 1.9's ``randomized_svd(M, k, random_state=rng)`` that makes the
same draws in the same order. ``"nmf"`` runs :func:`~.nmf.nmf_frobenius_init`.

On a card the random init can be drawn there instead (:func:`_uniform_rows`,
``csrc/mt_uniform.cu``): numpy's MT19937 stream from the caller's
``RandomState``, the rows summed in numpy's order, the same float32 bits, and
the ``RandomState`` left where the host's draw leaves it.
:func:`_draws_on_device` says where; the fit and the refit ask it
(``ops/driver.py``).
"""

from __future__ import annotations

import functools

import numpy as np
import scipy.linalg
import scipy.sparse as sp
import torch

from ..profiling import count
from ..utils import check_random_state, normalize
from ._build import launch, library

__all__ = ["plsa_init", "nndsvd_init", "randomized_svd"]


def _svd_flip(u, v, u_based_decision=True):
    """scikit-learn's ``svd_flip``: the largest entry (by magnitude) of each
    column of ``u`` (or row of ``v``) made positive, in place."""
    basis = u.T if u_based_decision else v
    signs = np.sign(basis[np.arange(basis.shape[0]), np.argmax(np.abs(basis), axis=1)])
    u *= signs[np.newaxis, :]
    v *= signs[:, np.newaxis]
    return u, v


def randomized_svd(M, n_components, rng, n_oversamples=10):
    """Rank-``n_components`` randomized SVD ``(U, S, Vt)`` of a dense or
    scipy sparse ``M`` (never densified), as scikit-learn computes it:
    ``n_iter="auto"`` (7 power iterations when ``n_components`` is below a
    tenth of the smaller side, else 4), LU-normalised power iterations, the
    Gaussian test matrix drawn from ``rng`` (float32 for float32 ``M``), the
    transposed problem when ``M`` is wide, and the sign flip."""
    rng = check_random_state(rng)
    if not sp.issparse(M):
        M = np.asarray(M)
    n_random = n_components + n_oversamples
    n_samples, n_features = M.shape
    n_iter = 7 if n_components < 0.1 * min(M.shape) else 4
    transpose = n_samples < n_features
    if transpose:
        M = M.T

    Q = rng.normal(size=(M.shape[1], n_random))
    if M.dtype == np.float32:
        Q = Q.astype(np.float32, copy=False)
    if n_iter > 2:
        def normalizer(a):
            return scipy.linalg.lu(a, permute_l=True, check_finite=False)
    else:
        def normalizer(a):
            return a, None
    for _ in range(n_iter):
        Q, _ = normalizer(M @ Q)
        Q, _ = normalizer(M.T @ Q)
    Q, _ = scipy.linalg.qr(M @ Q, mode="economic", check_finite=False)

    B = Q.T @ M
    Uhat, s, Vt = scipy.linalg.svd(B, full_matrices=False, lapack_driver="gesdd")
    U = Q @ Uhat
    # transposed: the decision rests on the rows of Vt, which are the
    # original problem's left vectors
    U, Vt = _svd_flip(U, Vt, u_based_decision=not transpose)
    if transpose:
        return Vt[:n_components, :].T, s[:n_components], U[:, :n_components].T
    return U[:, :n_components], s[:n_components], Vt[:n_components, :]


def nndsvd_init(X, k, rng):
    """Nonnegative double-SVD initialization (Boutsidis and Gallopoulos
    2008), vectorized over components as the JAX package does: from a
    rank-``k`` randomized SVD keep ``sqrt(s0)`` times the absolute leading
    pair, and for each later component whichever sign half of the
    singular-vector pair carries the larger norm product, as unit vectors
    times ``sqrt(s_j * mass)``. Returns ``(doc_seed (n, k), word_seed (k, m))``."""
    U, S, Vt = randomized_svd(X, k, rng)
    doc_seed = np.empty_like(U)
    word_seed = np.empty_like(Vt)
    doc_seed[:, 0] = np.sqrt(S[0]) * np.abs(U[:, 0])
    word_seed[0, :] = np.sqrt(S[0]) * np.abs(Vt[0, :])

    u_pos, u_neg = np.clip(U[:, 1:], 0, None), np.clip(-U[:, 1:], 0, None)
    v_pos, v_neg = np.clip(Vt[1:], 0, None), np.clip(-Vt[1:], 0, None)
    u_pos_n, u_neg_n = np.linalg.norm(u_pos, axis=0), np.linalg.norm(u_neg, axis=0)
    v_pos_n, v_neg_n = np.linalg.norm(v_pos, axis=1), np.linalg.norm(v_neg, axis=1)
    pos_mass, neg_mass = u_pos_n * v_pos_n, u_neg_n * v_neg_n
    keep_pos = pos_mass > neg_mass  # ties keep the negative half
    u_half = np.where(keep_pos[None, :], u_pos, u_neg)
    v_half = np.where(keep_pos[:, None], v_pos, v_neg)
    u_norm = np.where(keep_pos, u_pos_n, u_neg_n)
    v_norm = np.where(keep_pos, v_pos_n, v_neg_n)
    weight = np.sqrt(S[1:] * np.where(keep_pos, pos_mass, neg_mass))
    # normalise, then scale: the JAX package's order of operations, so both
    # give the same float64 values
    doc_seed[:, 1:] = weight * (u_half / np.maximum(u_norm, 1e-30))
    word_seed[1:, :] = weight[:, None] * (v_half / np.maximum(v_norm, 1e-30)[:, None])
    return doc_seed, word_seed


def plsa_init(X, k, init="random", rng=None):
    """Initialize ``(P(z|d), P(w|z))``: float32 arrays of shapes ``(n, k)``
    and ``(k, m)``, l1-normalized along rows.

    ``init`` is ``"random"``, ``"nndsvd"``, ``"nmf"`` (the last two need the
    count matrix itself) or an explicit ``(P(z|d), P(w|z))`` tuple.
    """
    rng = check_random_state(rng)
    n, m = X.shape

    if init == "random":
        p_w_given_z = rng.rand(k, m)
        p_z_given_d = rng.rand(n, k)
    elif init == "nndsvd":
        p_z_given_d, p_w_given_z = nndsvd_init(X, k, rng)
    elif init == "nmf":
        from .nmf import nmf_frobenius_init

        p_z_given_d, p_w_given_z = nmf_frobenius_init(X, k, rng)
    elif isinstance(init, (tuple, list)):
        p_z_given_d, p_w_given_z = init
        p_z_given_d = np.array(p_z_given_d, dtype=np.float64, copy=True)
        p_w_given_z = np.array(p_w_given_z, dtype=np.float64, copy=True)
    else:
        raise ValueError("Unrecognized init {}".format(init))

    normalize(p_w_given_z, axis=1)
    normalize(p_z_given_d, axis=1)
    return (
        np.ascontiguousarray(p_z_given_d, dtype=np.float32),
        np.ascontiguousarray(p_w_given_z, dtype=np.float32),
    )


# -- the random init drawn on the card -------------------------------------------

# The fewest values a random init draws on the card; a smaller draw (a few
# documents' refit in ``transform``) stays on the host, where it costs less
# than the launches and the state's round trip. Measured on an H100
# (scripts/torch_mt_init.py, a fit's init to the factors on the card): at k =
# 20, 4,080 values 0.55 ms on the host and 0.71 ms on the card, 16,360 values
# 0.86 and 0.83 ms, 65,520 values 1.47 and 0.83 ms.
DEVICE_DRAW_MIN = 1 << 14
# The words of the stream (two a value) that a chunk of rows holds at most,
# and so the scratch of a draw: whole rows, so a longer row is a chunk alone.
CHUNK_WORDS = 1 << 23
_MT_WORDS = 624
_UNIT = 2048  # csrc/mt_uniform.cu kUnit: longer rows take a block each


def _draws_on_device(rng, device, n_values):
    """Whether a random init of ``n_values`` values from ``rng`` is drawn on
    ``device`` by :func:`_uniform_rows`: a CUDA device, an MT19937 stream
    (``RandomState(PCG64())`` stays on the host), at least
    ``DEVICE_DRAW_MIN`` values, and numpy's row sums in an order the kernel
    takes (:func:`_row_sum_piece`). Either way the factors are the same bits."""
    return (device.type == "cuda" and n_values >= DEVICE_DRAW_MIN
            and rng.get_state(legacy=False)["bit_generator"] == "MT19937"
            and _row_sum_piece() is not None)


def _uniform_rows(rng, targets, guard=True):
    """Fill each of ``targets`` (2-D float32 views on one CUDA device, columns
    contiguous), in turn, with the float32 of ``rng.rand(*shape)`` with each
    row divided by its sum: by 1.0 where the sum is 0 and ``guard`` is set, as
    :func:`~..utils.normalize` does in :func:`plsa_init`, by the sum itself
    where it is not, as ``ops/driver.py`` ``_refit_init`` does. The bits are
    the host's: ``csrc/mt_uniform.cu`` continues ``rng``'s MT19937 stream (its
    key is passed to the first launch by value) a chunk of whole rows at a
    time, and ``rng`` is set to the state it ends in, its cached Gaussian
    kept. Counts the values as ``device_init_values``; the state's read back
    waits for the draw (a host sync)."""
    total = sum(t.numel() for t in targets)
    if total == 0:
        return
    state = rng.get_state(legacy=False)
    host_key = np.ascontiguousarray(state["state"]["key"], dtype=np.uint32)
    key_ptr, pos = host_key.ctypes.data, int(state["state"]["pos"])
    dev = targets[0].device
    fn = library("mt_uniform").enstop_mt_uniform
    piece = _row_sum_piece()
    for t in targets:
        if t.dtype != torch.float32 or t.device != dev or t.dim() != 2 or (
                t.shape[1] > 1 and t.stride(1) != 1):
            raise ValueError("targets must be 2-D float32 views on one CUDA device with "
                             "contiguous columns")
    chunks = [(t, max(1, CHUNK_WORDS // (2 * max(t.shape[1], 1)))) for t in targets]
    scratch = torch.empty(min(2 * total, max(2 * per * t.shape[1] for t, per in chunks)),
                          dtype=torch.int32, device=dev)
    # the units' sums of rows longer than a unit (csrc/mt_uniform.cu kUnit):
    # a unit holds at least half a unit's values but the last of a piece
    room = max([per * (2 * t.shape[1] // _UNIT + 1 + -(-t.shape[1] // (piece or t.shape[1])))
                for t, per in chunks if t.shape[1] > _UNIT], default=1)
    sums = torch.empty(room, dtype=torch.float64, device=dev)
    mt = torch.empty(_MT_WORDS + 1, dtype=torch.int32, device=dev)
    for t, per in chunks:
        rows, length = t.shape
        for r0 in range(0, rows if length else 0, per):
            launch("mt_uniform", fn, dev, key_ptr, pos, mt.data_ptr(), scratch.data_ptr(),
                   min(per, rows - r0), length, piece, int(guard), sums.data_ptr(), room,
                   t[r0].data_ptr(), t.stride(0))
            key_ptr = None  # the next chunk starts where this one left the stream
    count("device_init_values", total)
    count("host_syncs")  # the state's read back waits for the draw
    back = mt.cpu().numpy().view(np.uint32)
    rng.set_state({"bit_generator": "MT19937",
                   "state": {"key": back[:_MT_WORDS].copy(), "pos": int(back[_MT_WORDS])},
                   "has_gauss": state["has_gauss"], "gauss": state["gauss"]})


def _row_sum_piece():
    """How numpy sums a row of float64 (``ndarray.sum(axis=1)``), as the
    kernel takes it: the values it adds one piece after another into 0.0,
    each piece pairwise (0: the row in one piece; numpy 2.3 does so, while up
    to 2.2 the reduction's inner loop stops at its buffer size), or None
    where numpy matches neither. Found once for each buffer size by a probe
    (:func:`_probe_row_sums`)."""
    return _probe_row_sums(np.getbufsize())


@functools.lru_cache(maxsize=None)
def _probe_row_sums(bufsize):
    """The piece of :func:`_row_sum_piece` under ``np.getbufsize() ==
    bufsize``: numpy's row sums of 64 rows of ``3 * bufsize + 1001`` uniform
    values against :func:`_row_sums` whole and cut at ``bufsize`` (the two
    orders agree on about half of such rows, so 64 tell them apart)."""
    x = np.random.RandomState(0).rand(64, 3 * bufsize + 1001)
    got = x.sum(axis=1)
    found = [p for p in (0, bufsize) if np.array_equal(got, _row_sums(x, p))]
    return found[0] if len(found) == 1 else None


def _row_sums(x, piece):
    """The rows of the 2-D float64 ``x`` summed as ``csrc/mt_uniform.cu``
    sums them: pieces of ``piece`` values (0: the whole row) added one after
    another into 0.0, each by numpy's pairwise sum (:func:`_pairwise`)."""
    n = x.shape[1]
    piece = piece or max(n, 1)
    acc = np.zeros(x.shape[0])
    for off in range(0, n, piece):
        acc += _pairwise(x, off, min(piece, n - off))
    return acc


def _pairwise(x, off, n):
    """numpy's ``DOUBLE_pairwise_sum`` of ``x[:, off:off + n]``, every row at
    once: below 8 values one running sum from 0.0; up to 128 eight
    accumulators over the multiples of 8, combined pairwise, then the tail;
    above, the halves (the first rounded down to a multiple of 8) added."""
    if n < 8:
        res = np.zeros(x.shape[0])
        for i in range(off, off + n):
            res += x[:, i]
        return res
    if n <= 128:
        r = x[:, off:off + 8].copy()
        end = off + n - n % 8
        for i in range(off + 8, end, 8):
            r += x[:, i:i + 8]
        res = (r[:, 0] + r[:, 1] + (r[:, 2] + r[:, 3])) + (r[:, 4] + r[:, 5] + (r[:, 6] + r[:, 7]))
        for i in range(end, off + n):
            res += x[:, i]
        return res
    h = n // 2 - n // 2 % 8
    return _pairwise(x, off, h) + _pairwise(x, off + h, n - h)
