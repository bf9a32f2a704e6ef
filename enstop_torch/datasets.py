"""The 20-Newsgroups count matrix from offline sources (counterpart of
``enstop_tpu/datasets.py``), in the JAX package's order:

1. an ``.npz`` bundle, ``local_npz=`` or the file named by
   ``$ENSTOP_TPU_20NG_NPZ`` (the JAX package's variable, so one file serves
   both packages), holding ``data``, ``indices``, ``indptr`` and ``shape``
   (CSR counts), ``labels`` and optionally ``vocabulary``;
   :func:`save_20newsgroups_npz` writes it;
2. where scikit-learn is installed, its 20-Newsgroups cache (``data_home=``,
   or its default directory) read with ``download_if_missing=False`` and
   vectorised by ``CountVectorizer(min_df=min_df, stop_words=stop_words)``,
   as the reference's notebook does;
3. otherwise a ``RuntimeError`` that names both sources.

It downloads nothing.
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


def _load_sklearn_cache(data_home, min_df, stop_words):
    """The corpus from scikit-learn's cache; ``ImportError`` without
    scikit-learn, ``OSError`` without the cache."""
    from sklearn.datasets import fetch_20newsgroups
    from sklearn.feature_extraction.text import CountVectorizer

    news = fetch_20newsgroups(subset="all", data_home=data_home, download_if_missing=False)
    vectorizer = CountVectorizer(min_df=min_df, stop_words=stop_words)
    X = vectorizer.fit_transform(news.data)
    return (sp.csr_matrix(X), np.asarray(news.target),
            np.asarray(vectorizer.get_feature_names_out()))


def load_20newsgroups_counts(local_npz=None, data_home=None, min_df=5, stop_words="english"):
    """``(X_csr, labels, vocabulary or None)`` from ``local_npz``, else from
    ``$ENSTOP_TPU_20NG_NPZ``, else from scikit-learn's 20-Newsgroups cache in
    ``data_home``; raises ``RuntimeError`` saying how to provide either when
    none is there."""
    for path in (local_npz, os.environ.get(NPZ_ENV_VAR)):
        if path and os.path.exists(path):
            return _load_npz(path)
    try:
        return _load_sklearn_cache(data_home, min_df, stop_words)
    except (ImportError, OSError) as err:
        raise RuntimeError(
            "20-Newsgroups data is not available offline. Provide it either as\n"
            "  (a) an .npz bundle (make one with enstop_torch.datasets.save_20newsgroups_npz, "
            "or the JAX package's, on a machine that has the corpus) passed via local_npz= "
            f"or ${NPZ_ENV_VAR}, or\n"
            "  (b) a scikit-learn 20-Newsgroups cache passed via data_home= (scikit-learn "
            "installed; populate it with sklearn.datasets.fetch_20newsgroups(subset='all'))."
        ) from err
