"""The reference's import path ``distributed_plsa`` (counterpart of
``enstop_tpu/distributed_plsa.py``)."""

from .models.mesh import DistributedPLSA


def plsa_fit(
    X,
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
    """The functional distributed fit at the reference's signature; returns
    ``(P(z|d), P(w|z))``. The block grid asks for the mesh's shape, clamped
    to the devices; the reference's per-iteration gather of dask results is
    the mesh's reductions. ``e_step_thresh`` is ignored, as in the JAX
    package."""
    del e_step_thresh
    model = DistributedPLSA(
        n_components=k, init=init, n_row_blocks=n_row_blocks, n_col_blocks=n_col_blocks,
        n_iter=n_iter, n_iter_per_test=n_iter_per_test, tolerance=tolerance,
        random_state=random_state, device=device,
    )
    embedding = model.fit_transform(X)
    return embedding, model.components_


__all__ = ["DistributedPLSA", "plsa_fit"]
