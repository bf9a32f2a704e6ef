"""The reference's import path ``cuda_plsa`` (counterpart of
``enstop_tpu/cuda_plsa.py``): ``GPUPLSA`` (``TPUPLSA`` is the same class under
the JAX package's name) and the functional fit."""

from .models.accelerated import GPUPLSA, TPUPLSA


def plsa_fit(
    data,
    k,
    n_row_blocks=8,
    n_col_blocks=8,
    init="random",
    n_iter=100,
    n_iter_per_test=10,
    tolerance=0.001,
    e_step_thresh=1e-32,
    random_state=None,
    device="cuda",
):
    """The functional fit at the reference's signature; returns ``(P(z|d),
    P(w|z))``. The reference's CUDA tile grid has no counterpart here: the
    kernels pick their own launch shapes, so ``n_row_blocks`` and
    ``n_col_blocks`` are accepted and change nothing."""
    del n_row_blocks, n_col_blocks
    from .ops.driver import plsa_fit as _fit

    return _fit(
        data, k, init=init, n_iter=n_iter, n_iter_per_test=n_iter_per_test,
        tolerance=tolerance, e_step_thresh=e_step_thresh, random_state=random_state,
        device=device,
    )


__all__ = ["GPUPLSA", "TPUPLSA", "plsa_fit"]
