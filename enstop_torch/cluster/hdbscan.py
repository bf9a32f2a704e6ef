"""Small-scale exact HDBSCAN for stable-topic clustering (a NumPy copy of
``enstop_tpu/cluster/hdbscan.py``, which cannot be imported from here without
JAX; the euclidean distances are written out instead of taken from
scikit-learn).

The reference depends on the hdbscan package (Cython internals ``mst_linkage_core``,
``label``, ``_tree_to_labels`` — enstop_.py:21-23) to cluster the ensemble's topic
vectors.  This is a self-contained reimplementation of the full pipeline for the
sizes that arise there (N = n_runs · k points, typically a few hundred):

    pairwise distances -> core distances -> mutual reachability ->
    MST (dense Prim) -> single-linkage tree -> condensed tree (min_cluster_size) ->
    stability -> cluster selection ("leaf" or "eom", allow_single_cluster) ->
    labels + membership probabilities

Everything is numpy; the O(N^2) steps are trivial at this scale.  Semantics follow
the hdbscan package (condense/stability/leaf selection as in hdbscan's
``condense_tree`` / ``compute_stability`` / ``get_clusters``) so the ensemble
combiners (enstop_.py:266-414) behave like the reference's.
"""

from __future__ import annotations

import numpy as np

__all__ = ["HDBSCAN", "hdbscan_labels", "mutual_reachability", "mst_linkage",
           "single_linkage_tree", "euclidean_distances"]


def euclidean_distances(X):
    """Pairwise euclidean distances computed as scikit-learn's
    ``pairwise_distances(X)`` computes them for float64 input
    (``-2 X X^T + |x|^2 + |y|^2``, clipped at 0, zero diagonal, sqrt), not by
    a broadcast difference: the two differ in last-ulp rounding, and
    equal-weight tie order downstream makes the dendrogram sensitive to
    exactly those ulps."""
    X = np.asarray(X, dtype=np.float64)
    sq = np.einsum("ij,ij->i", X, X)[:, np.newaxis]
    dist = -2 * (X @ X.T)
    dist += sq
    dist += sq.T
    np.maximum(dist, 0, out=dist)
    np.fill_diagonal(dist, 0)
    return np.sqrt(dist, out=dist)


def core_distances(dist, min_samples):
    """Distance to the min_samples-th nearest neighbor COUNTING the point
    itself — the hdbscan package / sklearn.cluster.HDBSCAN convention
    (sklearn _hdbscan/_reachability.pyx partitions at ``min_samples - 1`` on
    rows that include self at distance 0).  NB the reference's hand-built KL
    combiner uses rank ``min_samples`` instead (enstop_.py:288); that variant
    lives inline in models/ensemble.py."""
    k = min(max(min_samples - 1, 0), dist.shape[0] - 1)
    return np.sort(dist, axis=1)[:, k]


def mutual_reachability(dist, min_samples):
    core = core_distances(dist, min_samples)
    return np.maximum(np.maximum(dist, core[:, None]), core[None, :])


def mst_linkage(mreach):
    """Dense Prim's MST over the mutual-reachability graph, replicating the
    hdbscan package / sklearn quirk exactly (``mst_linkage_core`` /
    sklearn ``mst_from_mutual_reachability``): each recorded edge is
    ``(previously-added node, new node, weight)`` — the left endpoint is NOT
    the new node's true nearest in-tree neighbor.  The weight-sorted
    union-find downstream therefore reproduces their dendrogram bit-for-bit,
    including tie cases where a textbook source-tracking Prim differs.
    """
    n = mreach.shape[0]
    in_tree = np.zeros(n, dtype=bool)
    best = np.full(n, np.inf)
    edges = np.zeros((n - 1, 3))
    current = 0
    in_tree[0] = True
    for it in range(n - 1):
        d = mreach[current]
        update = ~in_tree & (d < best)
        best[update] = d[update]
        best_masked = np.where(in_tree, np.inf, best)
        nxt = int(np.argmin(best_masked))
        edges[it] = (current, nxt, best_masked[nxt])
        in_tree[nxt] = True
        current = nxt
    return edges


def single_linkage_tree(mst_edges):
    """Union-find over weight-sorted MST edges -> scipy-style linkage rows
    (left, right, distance, size), node i's cluster id = n + i."""
    n = mst_edges.shape[0] + 1
    # default (introsort) argsort, matching sklearn hdbscan.py:165 — tie order
    # among equal-weight edges follows numpy's unstable sort, and equal-weight
    # tie order changes the dendrogram, so this must mirror theirs exactly
    order = np.argsort(mst_edges[:, 2])
    edges = mst_edges[order]
    parent = np.arange(2 * n - 1)
    size = np.ones(2 * n - 1)
    next_label = n
    out = np.zeros((n - 1, 4))

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    for i in range(n - 1):
        a, b, w = int(edges[i, 0]), int(edges[i, 1]), edges[i, 2]
        ra, rb = find(a), find(b)
        out[i] = (ra, rb, w, size[ra] + size[rb])
        parent[ra] = parent[rb] = next_label
        size[next_label] = size[ra] + size[rb]
        next_label += 1
    return out


def condense_tree(linkage, min_cluster_size):
    """hdbscan-style condensed tree.

    Returns a structured array of rows (parent, child, lambda_val, child_size);
    clusters get labels >= n_points, the root is n_points.
    """
    n = linkage.shape[0] + 1
    root = 2 * n - 2
    rows = []

    def node_members(node):
        # iterative collect of leaves under an internal node
        stack, members = [node], []
        while stack:
            x = stack.pop()
            if x < n:
                members.append(x)
            else:
                stack.append(int(linkage[x - n, 0]))
                stack.append(int(linkage[x - n, 1]))
        return members

    relabel = {root: n}
    next_label = n + 1
    ignore = set()
    # BFS over internal nodes from the root
    bfs = [root]
    idx = 0
    while idx < len(bfs):
        node = bfs[idx]
        idx += 1
        if node in ignore or node < n:
            continue
        left = int(linkage[node - n, 0])
        right = int(linkage[node - n, 1])
        dist = linkage[node - n, 2]
        lam = 1.0 / dist if dist > 0 else np.inf
        lsize = int(linkage[left - n, 3]) if left >= n else 1
        rsize = int(linkage[right - n, 3]) if right >= n else 1
        cur = relabel[node]

        if lsize >= min_cluster_size and rsize >= min_cluster_size:
            relabel[left] = next_label
            rows.append((cur, next_label, lam, lsize))
            next_label += 1
            relabel[right] = next_label
            rows.append((cur, next_label, lam, rsize))
            next_label += 1
            bfs.extend([left, right])
        elif lsize < min_cluster_size and rsize < min_cluster_size:
            for child in (left, right):
                for p in node_members(child):
                    rows.append((cur, p, lam, 1))
                ignore.add(child)
        elif lsize < min_cluster_size:
            relabel[right] = cur
            bfs.append(right)
            for p in node_members(left):
                rows.append((cur, p, lam, 1))
            ignore.add(left)
        else:
            relabel[left] = cur
            bfs.append(left)
            for p in node_members(right):
                rows.append((cur, p, lam, 1))
            ignore.add(right)

    # points that fall out via ignored internal subtrees were emitted directly;
    # single points reached as direct children of surviving nodes:
    ct = np.zeros(len(rows), dtype=[("parent", np.intp), ("child", np.intp),
                                    ("lambda_val", np.float64), ("child_size", np.intp)])
    for i, r in enumerate(rows):
        ct[i] = r
    return ct


def compute_stability(ct):
    """stability[c] = sum over all child rows of c of (lambda - birth(c)) * size.

    Follows hdbscan's ``compute_stability`` exactly: a cluster's birth lambda is
    the lambda of the row that created it (its first appearance as a child);
    the root's birth is 0.  Every row contributes — point fall-outs and cluster
    splits alike.
    """
    births = {}
    for r in ct:
        births.setdefault(int(r["child"]), r["lambda_val"])
    root = int(ct["parent"].min())
    births[root] = 0.0
    stability = {}
    for r in ct:
        c = int(r["parent"])
        birth = births.get(c, 0.0)
        lam = r["lambda_val"]
        # duplicate points give 1/0 = inf lambdas and inf stabilities — the
        # hdbscan package propagates them the same way
        stability[c] = stability.get(c, 0.0) + (lam - birth) * r["child_size"]
    # leaf clusters that never appear as parents still need an entry
    for r in ct:
        if r["child_size"] > 1 and int(r["child"]) not in stability:
            stability[int(r["child"])] = 0.0
    return stability


def _cluster_children(ct):
    kids = {}
    n_points = int(ct["parent"].min())
    for r in ct:
        if r["child"] >= n_points:
            kids.setdefault(int(r["parent"]), []).append(int(r["child"]))
    return kids


def select_clusters(ct, stability, method="leaf", allow_single_cluster=False):
    """Cluster selection following hdbscan's ``_tree_to_labels`` internals.

    ``"leaf"``: the leaves of the cluster tree (hdbscan ``get_cluster_tree_leaves``);
    when the only leaf is the root it is selected only under
    ``allow_single_cluster``.

    ``"eom"``: hdbscan's bottom-up excess-of-mass dynamic program — walk
    clusters from the deepest label upward; a node keeps itself iff its
    stability is at least the sum of its children's (propagated) stabilities,
    and keeping a node deselects its whole subtree.  The root participates in
    the comparison only under ``allow_single_cluster`` (hdbscan's
    ``get_clusters``: ``node_list = sorted(...)[:-1]`` unless
    allow_single_cluster).  The result is the stability-maximizing antichain of
    the cluster tree.
    """
    root = int(ct["parent"].min())
    kids = _cluster_children(ct)
    all_clusters = set([root]) | {c for cs in kids.values() for c in cs}

    if method == "leaf":
        # leaves of the CLUSTER tree only; the root is never a leaf.  With no
        # splits at all sklearn's leaf branch ends up selecting NOTHING (its
        # `is_cluster[root] = True` is immediately overwritten by
        # `selected_clusters = leaves`, _tree.pyx:764-785) — every point is
        # noise, allow_single_cluster notwithstanding.  Mirrored exactly.
        return sorted(c for c in all_clusters if c not in kids and c != root)

    if method != "eom":
        raise ValueError(
            "cluster_selection_method must be 'leaf' or 'eom', got {!r}".format(method)
        )

    stability = dict(stability)  # the DP mutates propagated values
    node_list = sorted(all_clusters, reverse=True)
    if not allow_single_cluster:
        node_list = [c for c in node_list if c != root]
    is_cluster = {c: True for c in node_list}
    for node in node_list:  # deepest labels first = bottom-up
        subtree_stability = sum(stability.get(x, 0.0) for x in kids.get(node, []))
        if subtree_stability > stability.get(node, 0.0):
            is_cluster[node] = False
            stability[node] = subtree_stability
        else:
            for sub in _descendants(kids, node):
                if sub != node:
                    is_cluster[sub] = False
    return sorted(c for c, v in is_cluster.items() if v)


def _descendants(kids, c):
    out, stack = [], list(kids.get(c, []))
    while stack:
        x = stack.pop()
        out.append(x)
        stack.extend(kids.get(x, []))
    return out


def labels_and_probabilities(ct, selected, n_points, allow_single_cluster=False):
    """Point labels + membership strengths following hdbscan's ``do_labelling``
    and ``get_probabilities``.

    Assignment is via union-find over the condensed tree with edges into the
    selected clusters cut: each point resolves to the lowest selected cluster
    containing it, or to the root (noise) otherwise.  Under
    ``allow_single_cluster`` with the root selected, a point hanging directly
    off the root is labeled only if it persists to the maximum lambda among the
    root's direct children — hdbscan's rule; everything below that is noise.
    """
    selected = set(int(c) for c in selected)
    root = n_points
    cluster_ids = {c: i for i, c in enumerate(sorted(selected))}
    labels = np.full(n_points, -1, dtype=np.intp)
    probs = np.zeros(n_points)

    # union-find: merge child into parent for every edge NOT entering a
    # selected cluster (hdbscan TreeUnionFind in do_labelling)
    max_node = max(int(ct["child"].max()), int(ct["parent"].max())) + 1
    uf_parent = np.arange(max_node, dtype=np.intp)

    def find(x):
        r = x
        while uf_parent[r] != r:
            r = uf_parent[r]
        while uf_parent[x] != r:
            uf_parent[x], x = r, uf_parent[x]
        return r

    for r in ct:
        child = int(r["child"])
        if child not in selected:
            uf_parent[find(child)] = find(int(r["parent"]))

    point_lambda = {}
    root_child_max_lambda = -np.inf
    deaths = {}  # per-parent max lambda over ALL its rows (sklearn max_lambdas)
    for r in ct:
        if r["child_size"] == 1:
            point_lambda[int(r["child"])] = r["lambda_val"]
        if int(r["parent"]) == root:
            # every sibling row participates, point or cluster, inf included
            # (sklearn _tree.pyx do_labelling threshold)
            root_child_max_lambda = max(root_child_max_lambda, r["lambda_val"])
        p_ = int(r["parent"])
        deaths[p_] = max(deaths.get(p_, 0.0), r["lambda_val"])

    single_root = len(selected) == 1 and root in selected

    for p in range(n_points):
        c = find(p)
        if c not in selected:
            continue  # noise
        if c == root:
            if not (single_root and allow_single_cluster):
                continue
            # hdbscan: with only the root selected, a point is a member only
            # if its own lambda reaches the largest lambda among the root's
            # direct rows (the lambda of the root's last split / fall-out)
            if point_lambda.get(p, 0.0) < root_child_max_lambda:
                continue
        labels[p] = cluster_ids[c]
        lam_max = deaths.get(c, 0.0)
        lam_p = point_lambda.get(p, np.inf)
        if lam_max == 0.0 or not np.isfinite(lam_p):
            probs[p] = 1.0
        else:
            probs[p] = min(lam_p, lam_max) / lam_max
    return labels, probs


def hdbscan_labels(
    dist=None,
    X=None,
    min_samples=5,
    min_cluster_size=5,
    cluster_selection_method="leaf",
    allow_single_cluster=False,
):
    """Full pipeline from a precomputed distance matrix (or raw euclidean vectors).

    Returns ``(labels, probabilities)`` with -1 for noise.
    """
    if dist is None:
        dist = euclidean_distances(X)
    dist = np.asarray(dist, dtype=np.float64)
    n = dist.shape[0]
    if n <= 2:
        # too small for a dendrogram; sklearn degenerates to noise
        return np.full(n, -1, dtype=np.intp), np.zeros(n)

    mreach = mutual_reachability(dist, min_samples)
    mst = mst_linkage(mreach)
    slt = single_linkage_tree(mst)
    ct = condense_tree(slt, min_cluster_size)
    stability = compute_stability(ct)
    selected = select_clusters(
        ct, stability, method=cluster_selection_method,
        allow_single_cluster=allow_single_cluster,
    )
    if not selected:
        return np.full(n, -1, dtype=np.intp), np.zeros(n)
    return labels_and_probabilities(ct, selected, n, allow_single_cluster)


class HDBSCAN:
    """Minimal sklearn-style facade over :func:`hdbscan_labels` (the subset of the
    hdbscan API the reference uses: enstop_.py:339-345, 388-394)."""

    def __init__(
        self,
        min_samples=5,
        min_cluster_size=5,
        metric="euclidean",
        cluster_selection_method="eom",
        allow_single_cluster=False,
    ):
        self.min_samples = min_samples
        self.min_cluster_size = min_cluster_size
        self.metric = metric
        self.cluster_selection_method = cluster_selection_method
        self.allow_single_cluster = allow_single_cluster

    def fit(self, X):
        if self.metric == "precomputed":
            dist, vecs = np.asarray(X), None
        else:
            dist, vecs = None, X
        self.labels_, self.probabilities_ = hdbscan_labels(
            dist=dist,
            X=vecs,
            min_samples=self.min_samples,
            min_cluster_size=self.min_cluster_size,
            cluster_selection_method=self.cluster_selection_method,
            allow_single_cluster=self.allow_single_cluster,
        )
        return self

    def fit_predict(self, X):
        return self.fit(X).labels_
