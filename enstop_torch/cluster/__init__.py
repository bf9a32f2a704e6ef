"""Stable-topic clustering of the PyTorch port: topic distance matrices
(``distances``), UMAP (``umap``) and HDBSCAN (``hdbscan``)."""

from .distances import (all_pairs_hellinger_distance, all_pairs_kl_divergence, hellinger,
                        kl_divergence)
from .hdbscan import HDBSCAN
from .umap import UMAP, umap_embed

__all__ = ["all_pairs_hellinger_distance", "all_pairs_kl_divergence", "hellinger",
           "kl_divergence", "HDBSCAN", "UMAP", "umap_embed"]
