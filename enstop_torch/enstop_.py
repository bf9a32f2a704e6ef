"""The reference's import path ``enstop_`` (counterpart of
``enstop_tpu/enstop_.py``): the ensemble, its topic combiners and the
distances between topics."""

from .cluster.distances import (
    all_pairs_hellinger_distance,
    all_pairs_kl_divergence,
    hellinger,
    kl_divergence,
)
from .models.ensemble import (
    EnsembleTopics,
    ensemble_fit,
    ensemble_of_topics,
    generate_combined_topics_hellinger,
    generate_combined_topics_hellinger_umap,
    generate_combined_topics_kl,
    nmf_topics,
    plsa_topics,
)

__all__ = [
    "EnsembleTopics",
    "ensemble_fit",
    "ensemble_of_topics",
    "plsa_topics",
    "nmf_topics",
    "generate_combined_topics_kl",
    "generate_combined_topics_hellinger",
    "generate_combined_topics_hellinger_umap",
    "all_pairs_kl_divergence",
    "all_pairs_hellinger_distance",
    "hellinger",
    "kl_divergence",
]
