"""EnsTop's ensemble, written out plainly: the bootstrap runs, the Hellinger
distances, the layout's trustworthiness, HDBSCAN, the merge and the refit.

This is the semantics the port has to reproduce, from the reference
library (lmcinnes/enstop v0.2.6 ``enstop_.py``: ``EnsembleTopics`` with its
default combiner ``"hellinger_umap"``), in plain PyTorch and NumPy. It
stands alone: the pLSA EM of ``reference/plsa.py`` is repeated here.

* **Runs.** A call ``EnsembleTopics(random_state=seed)`` draws from
  ``RandomState(seed)`` one ``randint(2**31 - 1)``, the base seed, then for
  each run one ``multinomial(n_docs, [1 / n_docs] * n_docs)``: the run's
  document weights, the row multiset that a bootstrap resample draws. Run
  ``i`` starts from ``rand`` draws of a ``torch.Generator`` on the device
  seeded with ``base * 2**20 + i``: first of ``(n_docs, k)``, then of
  ``(k, n_words)``, each size rounded up to the layout's padding (the dense
  layout pads documents and topics to 8 and words to 128, the sparse one
  nothing); the pad is dropped and each row normalised. Each run is pLSA EM
  with the weights on the topics' accumulation and on the log-likelihood
  (never on ``P(z|d)``), under the schedule below.
* **Distances.** The Hellinger distance between stacked topics,
  ``sqrt(1 - sum_w sqrt(t_i t_j) / sqrt(|t_i| |t_j|))``, in float64.
* **Layout.** UMAP is stochastic gradient descent, so it is not
  reproduced: a layout is judged by its trustworthiness against the
  distances (scikit-learn's ``trustworthiness``, precomputed metric).
* **Clusters.** HDBSCAN of the layout as the hdbscan package computes it:
  euclidean distances as scikit-learn computes them, each point's core
  distance to its ``min_samples``-th nearest point counting itself, mutual
  reachability, Prim's tree recorded as the hdbscan package records it (each
  edge from the point added last), single linkage over the edges sorted by
  weight, the tree condensed at ``min_cluster_size``, and the leaf clusters
  selected (the reference's ``cluster_selection_method="leaf"`` with
  ``allow_single_cluster``, under which a tree with no split selects
  nothing). Each point's label is the selected cluster it falls in (-1:
  noise) and its strength ``min(lambda_p, lambda_max) / lambda_max``. A
  layout in which every topic is noise is one cluster of all of them.
* **Merge.** Each cluster's stable topic is the square of the
  strength-weighted mean of its topics' square roots, renormalised.
* **Refit.** pLSA EM of ``P(z|d)`` alone against the stable topics, from
  ``RandomState(seed).rand(n_docs, k)``, rows normalised; 50 steps, a test
  every 10, tolerance 0.005, no weights.

The EM arithmetic is float64 (``mode="exact"``) unless ``mode="bf16r"``:
float32 with the E step's ratio ``x / sum`` and the products' operands
rounded to bfloat16, the step a faster implementation would take. The
schedule tests after step 1 and then every ``n_iter_per_test`` steps; a test
stops at that step when ``|cur - prev| / |cur|`` is below ``tolerance`` or the
change is 0; a decision within ``DECIDE_MARGIN`` of the threshold can go
either way in float32, so the state of that test point is kept as a
candidate. The corpus is held as COO on a torch device and each pass runs
over it in blocks of ``BLOCK`` nonzeros.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

TINY = 1e-30
BLOCK = 1 << 22
DECIDE_MARGIN = 2e-5  # on |cur - prev| / |cur|: float32 sums agree far closer
REFIT_SCHEDULE = (50, 10, 0.005)  # n_iter, n_iter_per_test, tolerance
TRUST_NEIGHBORS = 10
NO_PAD = (1, 1, 1)
DENSE_PAD = (8, 8, 128)  # documents, topics, words


# -- pLSA EM over the nonzeros ----------------------------------------------------

class Coo(NamedTuple):
    rows: torch.Tensor   # int64
    cols: torch.Tensor   # int64
    vals: torch.Tensor   # float64
    n: int
    m: int


def coo_of(csr, device):
    """The nonzeros of a scipy CSR matrix on ``device``."""
    csr = csr.tocsr()
    rows = np.repeat(np.arange(csr.shape[0], dtype=np.int64), np.diff(csr.indptr))
    return Coo(torch.from_numpy(rows).to(device),
               torch.from_numpy(csr.indices.astype(np.int64)).to(device),
               torch.from_numpy(csr.data.astype(np.float64)).to(device), *csr.shape)


def _bf16(a):
    return a.to(torch.bfloat16).to(a.dtype)


def _rownorm(a):
    return a / a.sum(dim=1, keepdim=True).clamp_min(TINY)


def em_pass(coo, zd, wz, weight=None, refit=False, mode="exact"):
    """One EM step from ``(zd, wz)``: ``((zd', wz'), LL(zd, wz))``; with
    ``refit`` the topics stay as they are."""
    bf16r = mode == "bf16r"
    wzT = wz.t().contiguous()
    B = torch.zeros_like(zd)
    A_T = None if refit else torch.zeros_like(wzT)
    ll = torch.zeros((), dtype=zd.dtype, device=zd.device)
    for lo in range(0, coo.vals.numel(), BLOCK):
        r, c = coo.rows[lo:lo + BLOCK], coo.cols[lo:lo + BLOCK]
        x = coo.vals[lo:lo + BLOCK].to(zd.dtype)
        zr, wc = zd[r], wzT[c]
        s = (zr * wc).sum(1).clamp_min(TINY)
        w = None if weight is None else weight[r]
        ll += (x * torch.log(s) if w is None else w * x * torch.log(s)).sum()
        if bf16r:
            ratio, zr, wc = _bf16(_bf16(x) / _bf16(s)), _bf16(zr), _bf16(wc)
        else:
            ratio = x / s
        B.index_add_(0, r, wc * ratio[:, None])
        if not refit:
            A_T.index_add_(0, c, zr * (ratio if w is None else ratio * w)[:, None])
    new_zd = _rownorm(zd * B)
    new_wz = wz if refit else _rownorm(wz * A_T.t())
    return (new_zd, new_wz), ll


def _decide(prev, cur, tolerance):
    """``"stop"``, ``"go"`` or ``"either"`` for a test of ``cur`` after ``prev``."""
    change = abs(cur - prev)
    ratio = change / abs(cur) if cur != 0.0 else (0.0 if change == 0.0 else np.inf)
    if tolerance > 0.0 and ratio < tolerance - DECIDE_MARGIN:
        return "stop"
    if abs(ratio - tolerance) <= DECIDE_MARGIN:
        return "either"
    return "go"


class Candidate(NamedTuple):
    n_steps: int
    zd: torch.Tensor
    wz: torch.Tensor


def em(coo, zd0, wz0, n_iter, n_iter_per_test, tolerance, weight=None, refit=False,
       mode="exact"):
    """Run the schedule from ``(zd0, wz0)``; the list of :class:`Candidate`
    answers, the fit's own stopping point last."""
    dtype = torch.float32 if mode == "bf16r" else torch.float64
    dev = coo.vals.device
    state = tuple(torch.as_tensor(a).to(device=dev, dtype=dtype) for a in (zd0, wz0))
    w = None if weight is None else torch.as_tensor(weight).to(device=dev, dtype=dtype)
    npt = max(int(n_iter_per_test), 1)
    candidates = []
    if n_iter <= 0:
        return [Candidate(0, *state)]
    nxt, prev = em_pass(coo, *state, weight=w, refit=refit, mode=mode)
    prev = float(prev)
    steps = 0
    while steps < n_iter:
        state, steps = nxt, steps + 1
        tested = steps == 1 or (steps - 1) % npt == 0
        if steps < n_iter:
            nxt, ll = em_pass(coo, *state, weight=w, refit=refit, mode=mode)
        elif tested:
            ll = em_pass(coo, *state, weight=w, refit=True, mode=mode)[1]
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


# -- the runs -------------------------------------------------------------------

def _round_up(x, multiple):
    return -(-int(x) // int(multiple)) * int(multiple)


def run_weights(n_docs, seed, i):
    """``(base seed, document weights of run i)`` of a call seeded ``seed``."""
    rng = np.random.RandomState(seed)
    base = int(rng.randint(np.iinfo(np.int32).max))
    uniform = np.full(n_docs, 1.0 / n_docs)
    for _ in range(i):
        rng.multinomial(n_docs, uniform)
    return base, rng.multinomial(n_docs, uniform).astype(np.float64)


def run_init(n_docs, n_words, k, seed, device, pad=NO_PAD):
    """Run ``(P(z|d), P(w|z))`` drawn from a generator on ``device`` seeded
    ``seed`` at the padded shapes, the pad dropped, rows normalised (float64)."""
    n_pad, kp, m_pad = (_round_up(s, p) for s, p in zip((n_docs, k, n_words), pad))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    zd = torch.rand((n_pad, kp), generator=gen, device=device)[:n_docs, :k]
    wz = torch.rand((kp, m_pad), generator=gen, device=device)[:k, :n_words]
    return _rownorm(zd.double()), _rownorm(wz.double())


def run(csr, k, seed, i, n_iter, n_iter_per_test, tolerance, device, pad=NO_PAD,
        mode="exact", coo=None):
    """The candidates of run ``i`` of ``EnsembleTopics(n_components=k,
    random_state=seed, ...).fit(csr)``: its topics are each candidate's ``wz``."""
    base, weights = run_weights(csr.shape[0], seed, i)
    zd0, wz0 = run_init(*csr.shape, k, base * (1 << 20) + i, device, pad)
    return em(coo_of(csr, device) if coo is None else coo, zd0, wz0, n_iter,
              n_iter_per_test, tolerance, weight=weights, mode=mode)


# -- the combine ------------------------------------------------------------------

def hellinger(stack):
    """The stack's pairwise Hellinger distances, float64 numpy, zero diagonal."""
    t = torch.as_tensor(stack).double()
    sq = t.clamp_min(0.0).sqrt()
    l1 = t.sum(1)
    d = (1.0 - (sq @ sq.t()) / torch.outer(l1, l1).sqrt().clamp_min(TINY)).clamp_min(0.0).sqrt()
    d = d.cpu().numpy()
    np.fill_diagonal(d, 0.0)
    return d


def trustworthiness(dmat, layout, k=TRUST_NEIGHBORS):
    """scikit-learn's ``trustworthiness`` of ``layout`` against the distances ``dmat``."""
    n = dmat.shape[0]
    rows = np.arange(n)[:, None]
    d = np.array(dmat, dtype=np.float64)
    np.fill_diagonal(d, np.inf)
    ranks = np.empty((n, n), np.int64)
    ranks[rows, np.argsort(d, axis=1)] = np.arange(1, n + 1)
    e = euclidean(layout)
    np.fill_diagonal(e, np.inf)
    excess = ranks[rows, np.argsort(e, axis=1)[:, :k]] - k
    return 1.0 - 2.0 / (n * k * (2.0 * n - 3.0 * k - 1.0)) * float(excess[excess > 0].sum())


def euclidean(X):
    """Pairwise euclidean distances as scikit-learn computes them for float64
    input: ``|x|^2 - 2 x.y + |y|^2``, clipped at 0, zero diagonal, square root."""
    X = np.asarray(X, dtype=np.float64)
    sq = np.einsum("ij,ij->i", X, X)[:, None]
    d = -2 * (X @ X.T)
    d += sq
    d += sq.T
    np.maximum(d, 0, out=d)
    np.fill_diagonal(d, 0)
    return np.sqrt(d)


def _prim(mreach):
    """Prim's tree as the hdbscan package records it: ``(previous, added, weight)``."""
    n = mreach.shape[0]
    in_tree = np.zeros(n, dtype=bool)
    best = np.full(n, np.inf)
    edges = np.zeros((n - 1, 3))
    current = 0
    for e in range(n - 1):
        in_tree[current] = True
        best = np.minimum(best, mreach[current])
        open_best = np.where(in_tree, np.inf, best)
        added = int(np.argmin(open_best))
        edges[e] = (current, added, open_best[added])
        current = added
    return edges


def _single_linkage(edges, n):
    """``(left, right, distance, size)`` rows; merge ``j`` makes node ``n + j``."""
    root = np.arange(2 * n - 1)
    size = np.ones(2 * n - 1, dtype=np.int64)

    def find(x):
        while root[x] != x:
            root[x] = root[root[x]]
            x = root[x]
        return x

    out = []
    for a, b, w in edges[np.argsort(edges[:, 2])]:
        ra, rb = find(int(a)), find(int(b))
        node = n + len(out)
        out.append((ra, rb, w, size[ra] + size[rb]))
        root[ra] = root[rb] = node
        size[node] = size[ra] + size[rb]
    return out


def _condense(linkage, n, min_cluster_size):
    """The condensed tree: ``(parent, child, lambda, child size)`` rows; the
    root cluster is ``n``, clusters numbered on from it in breadth-first order."""
    def leaves(node):
        stack, out = [node], []
        while stack:
            x = stack.pop()
            if x < n:
                out.append(x)
            else:
                stack.extend(linkage[x - n][:2])
        return out

    def size(node):
        return 1 if node < n else linkage[node - n][3]

    rows, label, queue, next_label = [], {2 * n - 2: n}, [2 * n - 2], n + 1
    while queue:
        node = queue.pop(0)
        left, right, dist, _ = linkage[node - n]
        left, right = int(left), int(right)
        lam = 1.0 / dist if dist > 0 else np.inf
        big = [c for c in (left, right) if size(c) >= min_cluster_size]
        if len(big) == 2:
            for c in (left, right):
                label[c] = next_label
                rows.append((label[node], next_label, lam, size(c)))
                next_label += 1
                if c >= n:
                    queue.append(c)
            continue
        for c in (left, right):
            if c in big:
                label[c] = label[node]
                if c >= n:
                    queue.append(c)
            else:
                rows.extend((label[node], p, lam, 1) for p in leaves(c))
    return rows


def hdbscan(layout, min_samples, min_cluster_size):
    """``(labels, strengths)`` of HDBSCAN with leaf selection on ``layout``."""
    n = layout.shape[0]
    dist = euclidean(layout)
    core = np.sort(dist, axis=1)[:, min(max(min_samples - 1, 0), n - 1)]
    mreach = np.maximum(np.maximum(dist, core[:, None]), core[None, :])
    rows = _condense(_single_linkage(_prim(mreach), n), n, min_cluster_size)
    splits = {r[0] for r in rows if r[1] >= n}
    clusters = sorted({r[1] for r in rows if r[1] >= n} - splits)  # the leaves
    labels, strengths = np.full(n, -1, dtype=np.int64), np.zeros(n)
    if not clusters:
        return labels, strengths
    up = {r[1]: r[0] for r in rows}
    fell_at = {r[1]: r[2] for r in rows if r[1] < n}
    deaths = {}
    for parent, _, lam, _ in rows:
        deaths[parent] = max(deaths.get(parent, 0.0), lam)
    number = {c: j for j, c in enumerate(clusters)}
    for p in range(n):
        c = up[p]
        while c not in number and c in up:
            c = up[c]
        if c in number:
            labels[p] = number[c]
            top, lam = deaths[c], fell_at[p]
            strengths[p] = 1.0 if top == 0.0 or not np.isfinite(lam) else min(lam, top) / top
    return labels, strengths


def clusters_of(layout, min_samples, min_cluster_size):
    """The labels and strengths the merge uses: all noise is one cluster."""
    labels, strengths = hdbscan(layout, min_samples, min_cluster_size)
    if labels.max() < 0:
        return np.zeros_like(labels), np.ones(labels.shape[0])
    return labels, strengths


def match(labels, ref_labels):
    """``(mismatched topics, {reference cluster: program cluster})``: the
    clusters paired greedily by their shared topics, most first; noise pairs
    with noise only."""
    labels, ref_labels = np.asarray(labels), np.asarray(ref_labels)
    pairs = {}
    for r, p in zip(ref_labels, labels):
        if r >= 0 and p >= 0:
            pairs[r, p] = pairs.get((r, p), 0) + 1
    mapping, used = {-1: -1}, {-1}
    for (r, p), _ in sorted(pairs.items(), key=lambda item: -item[1]):
        if r not in mapping and p not in used:
            mapping[r] = p
            used.add(p)
    wrong = sum(mapping.get(r, None) != p for r, p in zip(ref_labels, labels))
    return int(wrong), mapping


def merge(stack, labels, strengths):
    """The stable topics of the clusters 0, 1, ... in float64 numpy."""
    t = torch.as_tensor(stack).double().clamp_min(0.0).sqrt()
    out = []
    for c in range(int(labels.max()) + 1):
        members = torch.from_numpy(np.flatnonzero(labels == c)).to(t.device)
        w = torch.as_tensor(strengths[labels == c], dtype=torch.float64, device=t.device)
        if float(w.sum()) <= 0.0:
            w = torch.ones_like(w)
        avg = (w[:, None] * t[members]).sum(0) / w.sum()
        out.append(avg * avg / (avg * avg).sum())
    return torch.stack(out).cpu().numpy()


# -- the refit --------------------------------------------------------------------

def refit(csr, topics, seed, device, mode="exact", coo=None):
    """The candidates of the ensemble's refit of ``csr`` against ``topics``
    (k, n_words) for a call seeded ``seed``."""
    init = np.random.RandomState(seed).rand(csr.shape[0], topics.shape[0])
    zd0 = (init / init.sum(axis=1, keepdims=True)).astype(np.float32)
    return em(coo_of(csr, device) if coo is None else coo, zd0,
              np.asarray(topics, np.float32), *REFIT_SCHEDULE, refit=True, mode=mode)
