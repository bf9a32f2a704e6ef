"""pLSA by expectation maximisation at wide topic counts, written out plainly.

The semantics are :mod:`.plsa`'s, whose random inits, test decision and
candidates this module takes from there: per nonzero ``x = X[d, w]`` the
ratio ``x / max(s, 1e-30)`` with ``s = sum_z P(z|d) P(w|z)``; ``P(w|z) ∝ P(w|z)
sum_d x w_d / s P(z|d)`` and ``P(z|d) ∝ P(z|d) sum_w x / s P(w|z)``, each row
normalised; the log-likelihood ``sum x w_d log max(s, 1e-30)``; a test after
step 1 and then every ``n_iter_per_test`` steps.

What differs is how a pass is computed, so that it stays within a check's
time at a thousand topics: :mod:`.plsa` gathers both factor rows of every
nonzero into a block of ``(nonzeros, k)`` float64 arrays, which at k = 1,000
is 8 kB a nonzero. Here a pass is three sparse products over the corpus, held
on the device as a CSR matrix (doc-major) and its transpose (word-major):

* ``s``, the product ``P(z|d) P(w|z)`` sampled at the nonzeros
  (``torch.sparse.sampled_addmm``);
* ``B = R P(w|z)^T`` over the doc-major matrix ``R`` of ratios, and
  ``A^T = R_w^T P(z|d)`` over the word-major one, the ratios times the weight
  of their document (``torch.sparse.mm``).

Each product runs over a block of rows (documents, resp. words) that holds
about ``BLOCK_BYTES / (8 k)`` nonzeros, so that the factor rows one call
reads come to about ``BLOCK_BYTES`` in float64; no ``(nonzeros, k)`` array is
ever formed. Everything is float64 (``mode="exact"``) unless
``mode="bf16r"``, the control: float32 with the ratio ``x / s`` and the
products' operands rounded to bfloat16, as in :mod:`.plsa`. Float32 matrix
products run in full float32: TF32 is switched off on import.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .plsa import TINY, Candidate, _decide, random_init, refit_init

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BLOCK_BYTES = 1 << 30


class Corpus(NamedTuple):
    """The nonzeros of a CSR matrix on a device, doc-major and word-major."""
    crow: torch.Tensor    # (n + 1,) int32: the doc-major rows' offsets
    cols: torch.Tensor    # (nnz,) int32: each entry's word, doc-major
    rows: torch.Tensor    # (nnz,) int64: each entry's document, doc-major
    vals: torch.Tensor    # (nnz,) float64: each entry's count, doc-major
    wcrow: torch.Tensor   # (m + 1,) int32: the word-major rows' offsets
    wcols: torch.Tensor   # (nnz,) int32: each entry's document, word-major
    perm: torch.Tensor    # (nnz,) int64: the doc-major place of each word-major entry
    doc_blocks: list      # (first row, end row, first entry, end entry) of each block
    word_blocks: list     # the same for the word-major rows
    n: int
    m: int


def _blocks(crow, per_block):
    """``(lo, hi, first entry, end entry)`` of blocks of whole rows, each of at
    most ``per_block`` entries unless one row alone holds more."""
    blocks, lo, n = [], 0, crow.size - 1
    while lo < n:
        hi = int(np.searchsorted(crow, crow[lo] + per_block, side="right")) - 1
        hi = min(max(hi, lo + 1), n)
        blocks.append((lo, hi, int(crow[lo]), int(crow[hi])))
        lo = hi
    return blocks


def corpus_of(csr, k, device):
    """The nonzeros of a scipy CSR matrix on ``device``, cut into blocks for
    ``k`` topics; the word-major order is sorted there."""
    csr = csr.tocsr()
    n, m = csr.shape
    to = lambda a, dtype: torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)  # noqa: E731
    crow, cols = to(csr.indptr, np.int64), to(csr.indices, np.int64)
    rows = torch.repeat_interleave(torch.arange(n, device=device), crow.diff(),
                                   output_size=cols.numel())
    perm = torch.sort(cols, stable=True).indices  # word-major, each word's documents in order
    wcrow = torch.zeros(m + 1, dtype=torch.int64, device=device)
    torch.cumsum(torch.bincount(cols, minlength=m), 0, out=wcrow[1:])
    per_block = max(1, BLOCK_BYTES // (8 * k))
    return Corpus(crow.int(), cols.int(), rows, to(csr.data, np.float64), wcrow.int(),
                  rows[perm].int(), perm, _blocks(csr.indptr, per_block),
                  _blocks(wcrow.cpu().numpy(), per_block), n, m)


def _csr(crow, cols, vals, lo, hi, n_cols):
    """Rows ``lo:hi`` of a CSR matrix, with ``vals`` of those rows' entries."""
    return torch.sparse_csr_tensor(crow[lo:hi + 1] - crow[lo], cols, vals,
                                   size=(hi - lo, n_cols), check_invariants=False)


def _bf16(a):
    return a.to(torch.bfloat16).to(a.dtype)


def _rownorm(a):
    return a / a.sum(dim=1, keepdim=True).clamp_min(TINY)


def em_pass(corpus, zd, wz, weight=None, refit=False, mode="exact"):
    """One EM step from ``(zd, wz)``: ``((zd', wz'), LL(zd, wz))``; with
    ``refit`` the topics stay as they are."""
    bf16r = mode == "bf16r"
    c = corpus
    wzT = wz.t().contiguous()
    x = c.vals.to(zd.dtype)
    s = torch.empty_like(x)
    for lo, hi, a, b in c.doc_blocks:
        pattern = _csr(c.crow, c.cols[a:b], x[a:b], lo, hi, c.m)
        s[a:b] = torch.sparse.sampled_addmm(pattern, zd[lo:hi], wzT.t(), beta=0.0).values()
    s.clamp_min_(TINY)
    w = None if weight is None else weight[c.rows]
    ll = (x * torch.log(s) if w is None else w * x * torch.log(s)).sum()
    ratio = _bf16(_bf16(x) / _bf16(s)) if bf16r else x / s
    wc = _bf16(wzT) if bf16r else wzT
    B = torch.empty_like(zd)
    for lo, hi, a, b in c.doc_blocks:
        B[lo:hi] = _csr(c.crow, c.cols[a:b], ratio[a:b], lo, hi, c.m) @ wc
    new_zd = _rownorm(zd * B)
    if refit:
        return (new_zd, wz), ll
    ratio_t = (ratio if w is None else ratio * w)[c.perm]
    zr = _bf16(zd) if bf16r else zd
    A_T = torch.empty_like(wzT)
    for lo, hi, a, b in c.word_blocks:
        A_T[lo:hi] = _csr(c.wcrow, c.wcols[a:b], ratio_t[a:b], lo, hi, c.n) @ zr
    return (new_zd, _rownorm(wz * A_T.t())), ll


def em(corpus, zd0, wz0, n_iter, n_iter_per_test, tolerance, weight=None, refit=False,
       mode="exact"):
    """:func:`.plsa.em`'s schedule on :func:`em_pass`: the list of
    :class:`~.plsa.Candidate` answers, the fit's own stopping point last."""
    dtype = torch.float32 if mode == "bf16r" else torch.float64
    dev = corpus.vals.device
    state = tuple(torch.as_tensor(a).to(device=dev, dtype=dtype) for a in (zd0, wz0))
    w = None if weight is None else torch.as_tensor(weight).to(device=dev, dtype=dtype)
    npt = max(int(n_iter_per_test), 1)
    candidates = []
    if n_iter <= 0:
        return [Candidate(0, *state)]
    nxt, prev = em_pass(corpus, *state, weight=w, refit=refit, mode=mode)
    prev = float(prev)
    steps = 0
    while steps < n_iter:
        state, steps = nxt, steps + 1
        tested = steps == 1 or (steps - 1) % npt == 0
        if steps < n_iter:
            nxt, ll = em_pass(corpus, *state, weight=w, refit=refit, mode=mode)
        elif tested:
            ll = em_pass(corpus, *state, weight=w, refit=True, mode=mode)[1]
        if tested:
            cur = float(ll)
            verdict = _decide(prev, cur, float(tolerance))
            prev = cur
            if verdict == "stop":
                break
            if verdict == "either":
                candidates.append(Candidate(steps, *(a.clone() for a in state)))
    candidates.append(Candidate(steps, *state))
    return candidates


def fit(csr, k, seed, n_iter, n_iter_per_test, tolerance, device, mode="exact"):
    """The candidates of ``PLSA(n_components=k, random_state=seed, ...)
    .fit(csr)``, as :func:`.plsa.fit` gives them: zero rows set aside before
    the init, and back as zero rows of ``P(z|d)``."""
    csr = csr.tocsr()
    good = np.diff(csr.indptr) > 0
    sub = csr[good] if not good.all() else csr
    zd0, wz0 = random_init(sub.shape[0], sub.shape[1], k, seed)
    out = []
    for c in em(corpus_of(sub, k, device), zd0, wz0, n_iter, n_iter_per_test, tolerance,
                mode=mode):
        zd = c.zd
        if not good.all():
            zd = torch.zeros((csr.shape[0], k), dtype=c.zd.dtype, device=c.zd.device)
            zd[torch.from_numpy(good).to(zd.device)] = c.zd
        out.append(Candidate(c.n_steps, zd, c.wz))
    return out


def refit(csr, topics, device, n_iter=50, n_iter_per_test=5, tolerance=1e-3, mode="exact"):
    """The candidates of ``PLSA.transform(csr)`` against ``topics`` (k, n_words)."""
    csr = csr.tocsr()
    zd0 = refit_init(csr.shape[0], topics.shape[0])
    return em(corpus_of(csr, topics.shape[0], device), zd0, np.asarray(topics, np.float32),
              n_iter, n_iter_per_test, tolerance, refit=True, mode=mode)
