"""The 20-Newsgroups count matrix from an offline ``.npz`` bundle
(counterpart of ``enstop_tpu/datasets.py``).

The bundle holds ``data``, ``indices``, ``indptr`` and ``shape`` (CSR counts),
``labels`` and optionally ``vocabulary``; :func:`save_20newsgroups_npz` writes
it on a machine that has the corpus. The loader reads ``local_npz=`` or the
file named by ``$ENSTOP_TPU_20NG_NPZ``, the JAX package's variable, so one
file serves both packages. It fetches nothing. The JAX package's second
source, scikit-learn's download cache, is not read here: it needs
scikit-learn to vectorise the text.
"""

from __future__ import annotations

import os

import numpy as np
import scipy.sparse as sp

__all__ = ["load_20newsgroups_counts", "save_20newsgroups_npz", "NPZ_ENV_VAR"]

NPZ_ENV_VAR = "ENSTOP_TPU_20NG_NPZ"


def save_20newsgroups_npz(path, X, labels, vocabulary=None):
    """Write a vectorised corpus and its labels in the loader's layout."""
    X = sp.csr_matrix(X)
    payload = {
        "data": X.data,
        "indices": X.indices,
        "indptr": X.indptr,
        "shape": np.asarray(X.shape, dtype=np.int64),
        "labels": np.asarray(labels),
    }
    if vocabulary is not None:
        payload["vocabulary"] = np.asarray(vocabulary)
    np.savez_compressed(path, **payload)


def _load_npz(path):
    with np.load(path, allow_pickle=False) as z:
        X = sp.csr_matrix((z["data"], z["indices"], z["indptr"]), shape=tuple(z["shape"]))
        labels = z["labels"]
        vocab = z["vocabulary"] if "vocabulary" in z else None
    return X, labels, vocab


def load_20newsgroups_counts(local_npz=None):
    """``(X_csr, labels, vocabulary or None)`` from ``local_npz``, else from
    ``$ENSTOP_TPU_20NG_NPZ``; raises ``RuntimeError`` saying how to provide
    the file when neither names one that exists."""
    for path in (local_npz, os.environ.get(NPZ_ENV_VAR)):
        if path and os.path.exists(path):
            return _load_npz(path)
    raise RuntimeError(
        "20-Newsgroups data is not available offline. Provide an .npz bundle "
        "(make one with enstop_torch.datasets.save_20newsgroups_npz, or the JAX "
        "package's, on a machine that has the corpus) via local_npz= or "
        f"${NPZ_ENV_VAR}."
    )
