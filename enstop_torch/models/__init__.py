from .ensemble import EnsembleTopics, ensemble_fit, ensemble_of_topics
from .plsa import PLSA

__all__ = ["PLSA", "EnsembleTopics", "ensemble_fit", "ensemble_of_topics"]
