from .plsa import PLSA

__all__ = ["PLSA"]
