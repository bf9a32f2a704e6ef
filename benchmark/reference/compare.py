"""The numbers that decide ``correct``: how far an answer of the program
lies from the reference's.

Rows of ``P(z|d)`` and ``P(w|z)`` are distributions, so each row's gap is
its l1 distance from the reference's row (0 to 2); a matrix's gaps are read
as the mean over its rows, its widest row, and between them. Which of them
a cell judges is in its mix's ``limits``. Against several candidates (a
stopping decision that float32 could take either way) the nearest counts,
by the widest rows.
"""

from __future__ import annotations

import numpy as np
import torch

TOP_SHARE = 1e-3


def row_l1(answer, reference):
    """The l1 distance between each row of ``answer`` and the same row of
    ``reference``, in float64; None where the shapes differ."""
    ref = torch.as_tensor(reference).double()
    ans = torch.as_tensor(np.asarray(answer)).to(device=ref.device, dtype=torch.float64)
    return (ans - ref).abs().sum(1) if ans.shape == ref.shape else None


def row_l1_max(answer, reference):
    """The largest of :func:`row_l1` (inf where the shapes differ)."""
    gaps = row_l1(answer, reference)
    return float("inf") if gaps is None else float(gaps.max()) if gaps.numel() else 0.0


def row_l1_stats(prefix, answer, reference):
    """``<prefix>_l1_{max, top, p99, mean}`` of :func:`row_l1`; ``top`` is
    the mean of the widest ``TOP_SHARE`` of the rows (one at least)."""
    gaps = row_l1(answer, reference)
    if gaps is None:
        return {f"{prefix}_l1_{s}": float("inf") for s in ("max", "top", "p99", "mean")}
    top = max(1, int(gaps.numel() * TOP_SHARE))
    return {f"{prefix}_l1_max": float(gaps.max()),
            f"{prefix}_l1_top": float(torch.topk(gaps, top).values.mean()),
            f"{prefix}_l1_p99": float(torch.quantile(gaps.float(), 0.99)),
            f"{prefix}_l1_mean": float(gaps.mean())}


def fit_gaps(zd, wz, n_steps, candidates):
    """``zd_l1_*`` and ``wz_l1_*`` (:func:`row_l1_stats`) and ``steps_gap`` of one fitted model
    against the candidates of :func:`~.plsa.fit` that stopped at the same
    step; with none, the steps' gap and the last candidate's gaps."""
    same = [c for c in candidates if c.n_steps == n_steps]
    pool = same or candidates[-1:]
    best = min(pool, key=lambda c: row_l1_max(zd, c.zd) + row_l1_max(wz, c.wz))
    return {**row_l1_stats("zd", zd, best.zd), **row_l1_stats("wz", wz, best.wz),
            "steps_gap": float(min(abs(c.n_steps - n_steps) for c in candidates))}


def embedding_gap(zd, candidates):
    """The nearest candidate's :func:`row_l1_max` from a transform's answer."""
    return min(row_l1_max(zd, c.zd) for c in candidates)
