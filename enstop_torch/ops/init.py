"""Factor initialization for pLSA (counterpart of ``enstop_tpu/ops/init.py``).

Host NumPy, drawing from the same ``RandomState`` stream in the same order as
the JAX package, so both start from identical factors for the same seed.
"""

from __future__ import annotations

import numpy as np

from ..utils import check_random_state, normalize

__all__ = ["plsa_init"]


def plsa_init(X, k, init="random", rng=None):
    """Initialize ``(P(z|d), P(w|z))``: float32 arrays of shapes ``(n, k)``
    and ``(k, m)``, l1-normalized along rows.

    ``init`` is ``"random"`` or an explicit ``(P(z|d), P(w|z))`` tuple.
    """
    rng = check_random_state(rng)
    n, m = X.shape

    if init == "random":
        p_w_given_z = rng.rand(k, m)
        p_z_given_d = rng.rand(n, k)
    elif init in ("nndsvd", "nmf"):
        raise NotImplementedError(
            f"init={init!r} needs a randomized SVD or the NMF solver, which are "
            "not ported yet (ROADMAP.md, 'nndsvd/nmf init'); use 'random' or a "
            "factor tuple"
        )
    elif isinstance(init, (tuple, list)):
        p_z_given_d, p_w_given_z = init
        p_z_given_d = np.array(p_z_given_d, dtype=np.float64, copy=True)
        p_w_given_z = np.array(p_w_given_z, dtype=np.float64, copy=True)
    else:
        raise ValueError("Unrecognized init {}".format(init))

    normalize(p_w_given_z, axis=1)
    normalize(p_z_given_d, axis=1)
    return (
        np.ascontiguousarray(p_z_given_d, dtype=np.float32),
        np.ascontiguousarray(p_w_given_z, dtype=np.float32),
    )
