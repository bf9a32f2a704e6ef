"""The sparse O(nnz) EM passes: layout, plain versions and the wrappers of the
hand-written CUDA kernels (counterpart of ``_word_pass``, ``_doc_pass`` and
``_entry_terms`` in ``enstop_tpu/ops/pallas_sell.py``, and of
``_pass_contrib`` in ``enstop_tpu/ops/sell.py``).

A :class:`Side` is one sort order of a corpus's nonzeros: word-major (the
owner is the word, the index the document) for the word pass that sums A, or
doc-major (owner the document, index the word) for the doc pass that sums B.
Each owner's entries are cut into segments of at most ``SEG_LEN`` entries, an
owner's segments consecutive, so that no warp walks a long row or column
alone (in a Zipf corpus one word may hold nearly every document). It is built
on the device with torch from a COO sorted by owner; nothing loops in Python.

``word_pass`` returns the raw ``(A^T (m, kp), ll)`` and ``doc_pass`` the raw
``(B (n, kp), ll)``, before normalisation; the function is stated in
``csrc/em_sparse.cu``. On a CPU tensor each computes its plain PyTorch
version (``word_pass_plain``, ``doc_pass_plain``: gathers and
``index_add_``, on any device); on a CUDA tensor it launches the kernel or
raises. ``CALLS`` counts calls of the plain versions. :func:`walk_shape`
picks the kernel's lane groups for a topic count: up to ``MAX_NARROW_KP``
(256) the lane-group walk of ``csrc/em_sparse.cu``, which the dense row walk
shares; past it, up to ``MAX_KP`` (2,048), the wide walk of
``csrc/em_sparse_wide.cu`` (one entry a warp, ``WIDE_SHAPES``), in the fp32
ratio mode only. A pass on the wide walk adds 1 to the profiling counter
``wide_passes`` of the open request, on any device (a CPU pass runs the plain
version, and counts what the card would).

The private ``ratio`` argument of ``_pass``, ``_plain_pass`` and
:func:`launch_pass` is the E-step's ratio mode (``em.RATIO_MODES``,
``csrc/lane_walk.cuh``): ``"f32div"`` by default, ``"bf16r"`` for
``bf16r=True``, and for the word pass without threshold at kp 17-32 the
other modes of the divide experiment (``cuda_em._em_accumulators_ratio``).
"""

from __future__ import annotations

import torch

from ..profiling import count
from ._build import LAUNCHES, library
from .em import _TINY, RATIO_MODES, ratio as _ratio

__all__ = ["SEG_LEN", "MAX_NARROW_KP", "MAX_KP", "WALK_SHAPES", "WIDE_SHAPES",
           "SWEEP_SHAPES", "Side", "build_side", "walk_shape",
           "launch_pass", "word_pass", "doc_pass", "word_pass_plain", "doc_pass_plain",
           "LAUNCHES", "CALLS"]

# entries of one segment at most: one warp walks them. Longer segments shorten
# the serial sum of a frequent owner's partial rows (a Zipf head word holds
# nearly every document); 512 measured best on an H100 (scripts/torch_sparse_sweep.py)
SEG_LEN = 512
# topic counts of the lane-group walk (em_sparse.cu, and the dense row walk),
# and of the sparse passes, whose wide walk (em_sparse_wide.cu) takes the rest
MAX_NARROW_KP = 256
MAX_KP = 2048
# (L, TPL): L lanes an entry, TPL topics a lane. The shapes the kernel is built
# at for every topic count (csrc/lane_walk.cuh: kShapes, which the dense row
# walk shares), and those built for kp % 4 == 0 only, which the sweep over L
# times (csrc/em_sparse.cu: kSweepShapes).
WALK_SHAPES = ((1, 4), (1, 8), (2, 8), (4, 8), (8, 8), (16, 8), (32, 8))
SWEEP_SHAPES = ((1, 20), (1, 24), (2, 12), (8, 4), (8, 16), (32, 4))
# the wide walk's shapes past MAX_NARROW_KP: 32 lanes an entry, TPL topics a
# lane (csrc/em_sparse_wide.cu: kWideShapes)
WIDE_SHAPES = ((32, 16), (32, 32), (32, 64))

CALLS = {"word_pass": 0, "doc_pass": 0}


class Side:
    """One sort order of the nonzeros, cut into segments, on one device.

    ``idx`` (nnz,) int32 and ``vals`` (nnz,) float32 in owner order;
    ``seg_ptr`` (n_seg + 1,) int64 entry offsets of the segments;
    ``seg_owner`` (n_seg,) int32; ``owner_seg_ptr`` (n_owner + 1,) int64
    segment offsets of the owners (an owner with no entries has none);
    every index lies in ``0 .. n_index - 1``.
    """

    __slots__ = ("idx", "vals", "seg_ptr", "seg_owner", "owner_seg_ptr", "n_owner",
                 "n_index")

    def __init__(self, idx, vals, seg_ptr, seg_owner, owner_seg_ptr, n_owner, n_index):
        self.idx = idx
        self.vals = vals
        self.seg_ptr = seg_ptr
        self.seg_owner = seg_owner
        self.owner_seg_ptr = owner_seg_ptr
        self.n_owner = n_owner
        self.n_index = n_index

    @property
    def nnz(self):
        return self.idx.numel()

    @property
    def n_seg(self):
        return self.seg_owner.numel()

    @property
    def device(self):
        return self.idx.device

    def owners(self):
        """The owner of each entry, (nnz,) int64 (for the plain version)."""
        return self.seg_owner.long().repeat_interleave(self.seg_ptr.diff(), output_size=self.nnz)


def build_side(owner, idx, vals, n_owner, n_index):
    """A :class:`Side` from entries sorted by ``owner`` (int64 tensors on one
    device, ``vals`` any float type), owners below ``n_owner`` and indices
    below ``n_index``."""
    dev = owner.device
    counts = torch.bincount(owner, minlength=n_owner)
    if owner.numel():
        count("host_syncs", 2)  # bincount reads owner's min and max back
    if counts.numel() != n_owner:
        raise ValueError(f"owner ids reach {counts.numel() - 1}, beyond n_owner = {n_owner}")
    if idx.numel():
        count("host_syncs", 2)
        if not 0 <= int(idx.min()) <= int(idx.max()) < n_index:
            raise ValueError(f"indices must lie in 0..{n_index - 1}")
    segs = (counts + SEG_LEN - 1) // SEG_LEN
    owner_seg_ptr = torch.zeros(n_owner + 1, dtype=torch.int64, device=dev)
    torch.cumsum(segs, 0, out=owner_seg_ptr[1:])
    n_seg = int(owner_seg_ptr[-1])
    count("host_syncs", 2)  # n_seg read back; the end offset below copied up
    seg_owner = torch.arange(n_owner, device=dev).repeat_interleave(segs, output_size=n_seg)
    first_entry = torch.cumsum(counts, 0) - counts
    within = torch.arange(n_seg, device=dev) - owner_seg_ptr[seg_owner]
    seg_ptr = torch.cat([first_entry[seg_owner] + within * SEG_LEN,
                         torch.tensor([owner.numel()], dtype=torch.int64, device=dev)])
    return Side(idx.to(torch.int32).contiguous(), vals.to(torch.float32).contiguous(),
                seg_ptr, seg_owner.to(torch.int32), owner_seg_ptr, n_owner, n_index)


def walk_shape(kp):
    """The kernel's ``(L, TPL)`` for ``kp`` topics: the first of
    ``WALK_SHAPES`` with ``L * TPL >= kp``, or past ``MAX_NARROW_KP`` the first
    of ``WIDE_SHAPES``."""
    if not 0 < kp <= MAX_KP:
        raise ValueError(f"topic count {kp} must be in 1..{MAX_KP}")
    shapes = WALK_SHAPES if kp <= MAX_NARROW_KP else WIDE_SHAPES
    return next((L, tpl) for L, tpl in shapes if L * tpl >= kp)


def _bf16(a):
    """Round to bfloat16 and widen back to float32."""
    return a.to(torch.bfloat16).float()


def _ratio_of(bf16r):
    """The ratio mode of the fp32 (False) or bf16r (True) passes."""
    return "bf16r" if bf16r else "f32div"


def _plain_pass(side, zd, wzT, w, word, thresh, compute_ll, ratio="f32div"):
    """The plain version of both passes; see ``csrc/em_sparse.cu``."""
    _check(side, zd, wzT, w, word)
    CALLS["word_pass" if word else "doc_pass"] += 1
    own_tab, oth_tab = (wzT, zd) if word else (zd, wzT)
    owner, j, x = side.owners(), side.idx.long(), side.vals
    g = oth_tab[j]
    v = own_tab[owner] * g
    s = v.sum(1)
    wd = w[j] if word else w[owner]
    if thresh is not None:
        a = torch.where(v > thresh, v, 0.0)
        s_used = a.sum(1)
    else:
        a, s_used = g, s
    if word:
        a = a * wd[:, None]
    if ratio == "bf16r":
        a = _bf16(a)
    r = _ratio(x, s_used.clamp_min(_TINY), ratio)
    # each owner's terms summed in float64 and rounded once: the plain version
    # is the more exact side of a comparison (a frequent word holds up to
    # 250,000 terms, whose float32 sums differ by order by more than 1e-5)
    out = torch.zeros((side.n_owner, own_tab.shape[1]), dtype=torch.float64, device=x.device)
    out.index_add_(0, owner, (a * r[:, None]).double())
    ll = (x * torch.log(s.clamp_min(_TINY)) * wd).sum() if compute_ll else x.new_zeros(())
    return out.float(), ll


def _check(side, zd, wzT, w, word):
    kp = zd.shape[1]
    if zd.dim() != 2 or wzT.dim() != 2 or wzT.shape[1] != kp:
        raise ValueError(f"factor tables must be (n, kp) and (m, kp): {tuple(zd.shape)}, "
                         f"{tuple(wzT.shape)}")
    own, oth = (wzT, zd) if word else (zd, wzT)
    if (side.n_owner, side.n_index) != (own.shape[0], oth.shape[0]):
        raise ValueError(f"the layout has {side.n_owner} owners and {side.n_index} indices, "
                         f"the factor tables {own.shape[0]} and {oth.shape[0]} rows")
    if w.shape != (zd.shape[0],):
        raise ValueError(f"weights have shape {tuple(w.shape)}, expected ({zd.shape[0]},)")
    devices = {t.device for t in (side.idx, zd, wzT, w)}
    if len(devices) != 1:
        raise ValueError(f"the layout, factors and weights lie on different devices: {devices}")
    dev = side.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the sparse passes run on 'cuda' or 'cpu' tensors, not {dev}")
    return dev.type == "cpu"


def _ones_if_none(w, zd):
    return torch.ones(zd.shape[0], dtype=torch.float32, device=zd.device) if w is None else w


def _pass(side, zd, wzT, w, word, thresh, compute_ll, ratio="f32div"):
    name = "word_pass" if word else "doc_pass"
    w = _ones_if_none(w, zd)
    wide = zd.shape[1] > MAX_NARROW_KP
    if _check(side, zd, wzT, w, word):
        out, ll = _plain_pass(side, zd, wzT, w, word, thresh, compute_ll, ratio)
    else:
        if any(t.dtype != torch.float32 for t in (zd, wzT, w)):
            raise TypeError("factors and weights must be float32")
        out, ll_seg = launch_pass(side, zd.contiguous(), wzT.contiguous(), w.contiguous(),
                                  word, thresh, compute_ll, ratio)
        mode = "_thresh" if thresh is not None else "" if ratio == "f32div" else "_" + ratio
        LAUNCHES[name + ("_wide" if wide else "") + mode] += 1
        ll = ll_seg.sum()  # the per-segment LL partials, summed in a fixed order
    if wide:
        count("wide_passes")
    return out, ll


def launch_pass(side, zd, wzT, w, word, thresh=None, compute_ll=False, ratio="f32div"):
    """Launch one pass over ``side`` for R runs that share it: contiguous
    float32 CUDA tables ``zd`` (R, n, kp) or (n, kp), ``wzT`` (R, m, kp) or
    (m, kp) and ``w`` (R, n) or (n,), shapes checked by the caller; ``ratio``
    one of ``RATIO_MODES`` (``"f32div"`` alone past ``MAX_NARROW_KP``,
    on the wide walk). Returns the raw accumulator (R, n_owner, kp) or
    (n_owner, kp) and the per-segment LL partials (R, n_seg) or (n_seg,),
    empty with ``compute_ll=False``."""
    runs = zd.shape[:-2]  # () for one run, (R,) for R
    R, kp = (runs[0] if runs else 1), zd.shape[-1]
    lanes, tpl = walk_shape(kp)
    wide = kp > MAX_NARROW_KP
    if wide and ratio != "f32div":
        raise ValueError(f"the wide walk (kp = {kp} > {MAX_NARROW_KP}) runs the ratio "
                         f"'f32div' only, not {ratio!r}")
    dev = zd.device
    partial = torch.empty((R, side.n_seg, kp), dtype=torch.float32, device=dev)
    ll_seg = torch.empty((*runs, side.n_seg if compute_ll else 0), dtype=torch.float32,
                         device=dev)
    out = torch.empty((*runs, side.n_owner, kp), dtype=torch.float32, device=dev)
    fn = (library("em_sparse_wide").enstop_em_sparse_wide if wide
          else library("em_sparse").enstop_em_sparse)
    with torch.cuda.device(dev):
        err = fn(int(word), int(thresh is not None), int(compute_ll), RATIO_MODES.index(ratio),
                 lanes, tpl, R, side.seg_ptr.data_ptr(), side.seg_owner.data_ptr(),
                 side.owner_seg_ptr.data_ptr(), side.idx.data_ptr(), side.vals.data_ptr(),
                 zd.data_ptr(), wzT.data_ptr(), w.data_ptr(),
                 0.0 if thresh is None else float(thresh),
                 partial.data_ptr(), ll_seg.data_ptr(), out.data_ptr(),
                 side.n_seg, side.n_owner, side.n_index, kp,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{'em_sparse_wide' if wide else 'em_sparse'} "
                           f"{'word' if word else 'doc'} pass launch failed: "
                           f"cudaError {err}")
    return out, ll_seg


def word_pass(side, zd, wzT, w=None, thresh=None, compute_ll=True, bf16r=False):
    """Raw ``(A^T (n_owner, kp), ll)`` over the word-major ``side``: A weighted
    by ``w``, the LL of the input factors (0 with ``compute_ll=False``).
    ``thresh``: None, or the threshold of the exact E-step. ``bf16r``: the
    rounding of the dense EM step's ``precision="fast"`` (no threshold)."""
    if bf16r and thresh is not None:
        raise ValueError("the bf16r word pass has no threshold")
    return _pass(side, zd, wzT, w, True, thresh, compute_ll, _ratio_of(bf16r))


def doc_pass(side, zd, wzT, w=None, thresh=None, compute_ll=True):
    """Raw ``(B (n_owner, kp), ll)`` over the doc-major ``side``: B never
    weighted, the LL weighted by ``w`` (0 with ``compute_ll=False``)."""
    return _pass(side, zd, wzT, w, False, thresh, compute_ll)


def word_pass_plain(side, zd, wzT, w=None, thresh=None, compute_ll=True, bf16r=False):
    """The plain PyTorch version of :func:`word_pass`, on any device."""
    return _plain_pass(side, zd, wzT, _ones_if_none(w, zd), True, thresh, compute_ll,
                       _ratio_of(bf16r))


def doc_pass_plain(side, zd, wzT, w=None, thresh=None, compute_ll=True):
    """The plain PyTorch version of :func:`doc_pass`, on any device."""
    return _plain_pass(side, zd, wzT, _ones_if_none(w, zd), False, thresh, compute_ll)
