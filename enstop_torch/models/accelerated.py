"""``GPUPLSA``: :class:`~enstop_torch.models.plsa.PLSA` pinned to the CUDA
kernels (counterpart of ``enstop_tpu/models/accelerated.py``).

The reference's ``GPUPLSA`` asks its caller for a tile grid
(``n_row_blocks``, ``n_col_blocks``) and runs numba-CUDA kernels. Here every
``PLSA`` on the card already runs hand-written kernels that pick their own
shapes, so this class is ``PLSA(backend="cuda")`` with the reference's
positional order: the two block counts are accepted and kept (``get_params``
returns them) but change nothing. Off the card it raises, as
``backend="cuda"`` does. ``TPUPLSA`` is the same class under the JAX
package's name.
"""

from __future__ import annotations

from .plsa import PLSA

__all__ = ["GPUPLSA", "TPUPLSA"]


class GPUPLSA(PLSA):
    """pLSA on the hand-written CUDA kernels (``backend="cuda"``)."""

    def __init__(
        self,
        n_components=10,
        init="random",
        n_row_blocks=8,
        n_col_blocks=8,
        n_iter=100,
        n_iter_per_test=10,
        tolerance=0.001,
        e_step_thresh=1e-32,
        transform_random_seed=42,
        random_state=None,
        backend="cuda",
        precision="default",
        device="cuda",
    ):
        # the reference's order, so GPUPLSA(10, "random", 4, 4) binds the block
        # counts, not n_iter
        super().__init__(
            n_components=n_components,
            init=init,
            n_iter=n_iter,
            n_iter_per_test=n_iter_per_test,
            tolerance=tolerance,
            e_step_thresh=e_step_thresh,
            transform_random_seed=transform_random_seed,
            random_state=random_state,
            backend=backend,
            precision=precision,
            device=device,
        )
        self.n_row_blocks = n_row_blocks
        self.n_col_blocks = n_col_blocks


TPUPLSA = GPUPLSA
