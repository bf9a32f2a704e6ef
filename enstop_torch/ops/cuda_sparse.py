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
raises. ``CALLS`` counts calls of the plain versions.
"""

from __future__ import annotations

import torch

from ._build import LAUNCHES, library

__all__ = ["SEG_LEN", "Side", "build_side", "word_pass", "doc_pass", "word_pass_plain",
           "doc_pass_plain", "LAUNCHES", "CALLS"]

SEG_LEN = 128  # entries of one segment at most: one warp walks them
MAX_KP = 256   # the kernel holds at most 8 topics per lane in registers
_TINY = 1e-30

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
    if counts.numel() != n_owner:
        raise ValueError(f"owner ids reach {counts.numel() - 1}, beyond n_owner = {n_owner}")
    if idx.numel() and not 0 <= int(idx.min()) <= int(idx.max()) < n_index:
        raise ValueError(f"indices must lie in 0..{n_index - 1}")
    segs = (counts + SEG_LEN - 1) // SEG_LEN
    owner_seg_ptr = torch.zeros(n_owner + 1, dtype=torch.int64, device=dev)
    torch.cumsum(segs, 0, out=owner_seg_ptr[1:])
    n_seg = int(owner_seg_ptr[-1])
    seg_owner = torch.arange(n_owner, device=dev).repeat_interleave(segs, output_size=n_seg)
    first_entry = torch.cumsum(counts, 0) - counts
    within = torch.arange(n_seg, device=dev) - owner_seg_ptr[seg_owner]
    seg_ptr = torch.cat([first_entry[seg_owner] + within * SEG_LEN,
                         torch.tensor([owner.numel()], dtype=torch.int64, device=dev)])
    return Side(idx.to(torch.int32).contiguous(), vals.to(torch.float32).contiguous(),
                seg_ptr, seg_owner.to(torch.int32), owner_seg_ptr, n_owner, n_index)


def _bf16(a):
    """Round to bfloat16 and widen back to float32."""
    return a.to(torch.bfloat16).float()


def _plain_pass(side, zd, wzT, w, word, thresh, compute_ll, bf16r=False):
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
    if bf16r:
        a, r = _bf16(a), _bf16(_bf16(x) / _bf16(s_used.clamp_min(_TINY)))
    else:
        r = x / s_used.clamp_min(_TINY)
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


def _pass(side, zd, wzT, w, word, thresh, compute_ll, bf16r=False):
    name = "word_pass" if word else "doc_pass"
    w = _ones_if_none(w, zd)
    if _check(side, zd, wzT, w, word):
        return _plain_pass(side, zd, wzT, w, word, thresh, compute_ll, bf16r)
    kp = zd.shape[1]
    if not 0 < kp <= MAX_KP:
        raise ValueError(f"topic count {kp} must be in 1..{MAX_KP}")
    if any(t.dtype != torch.float32 for t in (zd, wzT, w)):
        raise TypeError("factors and weights must be float32")
    zd, wzT, w = zd.contiguous(), wzT.contiguous(), w.contiguous()
    dev = zd.device
    partial = torch.empty((side.n_seg, kp), dtype=torch.float32, device=dev)
    ll_seg = torch.empty((side.n_seg if compute_ll else 0,), dtype=torch.float32, device=dev)
    out = torch.empty((side.n_owner, kp), dtype=torch.float32, device=dev)
    fn = library("em_sparse").enstop_em_sparse
    with torch.cuda.device(dev):
        err = fn(int(word), int(thresh is not None), int(compute_ll), int(bf16r),
                 side.seg_ptr.data_ptr(), side.seg_owner.data_ptr(),
                 side.owner_seg_ptr.data_ptr(), side.idx.data_ptr(), side.vals.data_ptr(),
                 zd.data_ptr(), wzT.data_ptr(), w.data_ptr(),
                 0.0 if thresh is None else float(thresh),
                 partial.data_ptr(), ll_seg.data_ptr(), out.data_ptr(),
                 side.n_seg, side.n_owner, kp, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"em_sparse {name} launch failed: cudaError {err}")
    LAUNCHES[name + ("_bf16r" if bf16r else "_thresh" if thresh is not None else "")] += 1
    return out, ll_seg.sum()  # the per-segment LL partials, summed in a fixed order


def word_pass(side, zd, wzT, w=None, thresh=None, compute_ll=True, bf16r=False):
    """Raw ``(A^T (n_owner, kp), ll)`` over the word-major ``side``: A weighted
    by ``w``, the LL of the input factors (0 with ``compute_ll=False``).
    ``thresh``: None, or the threshold of the exact E-step. ``bf16r``: the
    rounding of the dense EM step's ``precision="fast"`` (no threshold)."""
    if bf16r and thresh is not None:
        raise ValueError("the bf16r word pass has no threshold")
    return _pass(side, zd, wzT, w, True, thresh, compute_ll, bf16r)


def doc_pass(side, zd, wzT, w=None, thresh=None, compute_ll=True):
    """Raw ``(B (n_owner, kp), ll)`` over the doc-major ``side``: B never
    weighted, the LL weighted by ``w`` (0 with ``compute_ll=False``)."""
    return _pass(side, zd, wzT, w, False, thresh, compute_ll)


def word_pass_plain(side, zd, wzT, w=None, thresh=None, compute_ll=True, bf16r=False):
    """The plain PyTorch version of :func:`word_pass`, on any device."""
    return _plain_pass(side, zd, wzT, _ones_if_none(w, zd), True, thresh, compute_ll, bf16r)


def doc_pass_plain(side, zd, wzT, w=None, thresh=None, compute_ll=True):
    """The plain PyTorch version of :func:`doc_pass`, on any device."""
    return _plain_pass(side, zd, wzT, _ones_if_none(w, zd), False, thresh, compute_ll)
