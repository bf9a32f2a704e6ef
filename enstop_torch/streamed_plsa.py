"""The reference's import path ``streamed_plsa`` (counterpart of
``enstop_tpu/streamed_plsa.py``)."""

from .models.streamed import StreamedPLSA
from .models.streamed_core import (
    streamed_fit_core as streamed_plsa_fit,
    streamed_refit_core as streamed_plsa_refit,
)


def plsa_fit(
    X,
    k,
    sample_weight=None,
    init="random",
    block_size=65536,
    n_iter=100,
    n_iter_per_test=10,
    tolerance=0.001,
    e_step_thresh=1e-32,
    random_state=None,
    device="cuda",
):
    """The functional streamed fit at the reference's signature; returns
    ``(P(z|d), P(w|z))``. ``block_size`` counts documents a block, as in the
    JAX package (the reference counts nonzeros)."""
    zd, wz, _, _, _ = streamed_plsa_fit(
        X, k, sample_weight=sample_weight, init=init, block_docs=block_size, n_iter=n_iter,
        n_iter_per_test=n_iter_per_test, tolerance=tolerance, e_step_thresh=e_step_thresh,
        random_state=random_state, device=device,
    )
    return zd, wz


def plsa_refit(
    X,
    topics,
    sample_weight=None,
    block_size=65536,
    n_iter=50,
    n_iter_per_test=10,
    tolerance=0.001,
    e_step_thresh=1e-32,
    random_state=None,
    device="cuda",
):
    """The functional streamed refit at the reference's signature; returns
    the document vectors. ``sample_weight`` weights only the convergence
    log-likelihood, as in the reference."""
    return streamed_plsa_refit(
        X, topics, sample_weight=sample_weight, block_docs=block_size, n_iter=n_iter,
        n_iter_per_test=n_iter_per_test, tolerance=tolerance, e_step_thresh=e_step_thresh,
        random_state=random_state, device=device,
    )


__all__ = ["StreamedPLSA", "streamed_plsa_fit", "streamed_plsa_refit", "plsa_fit",
           "plsa_refit"]
