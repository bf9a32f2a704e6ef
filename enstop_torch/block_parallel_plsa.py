"""The reference's import path ``block_parallel_plsa`` (counterpart of
``enstop_tpu/block_parallel_plsa.py``): the reference's 2-D tile grid is the
device mesh of :mod:`enstop_torch.parallel.mesh`."""

from .models.mesh import BlockParallelPLSA


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
    """The functional blocked fit at the reference's signature; returns
    ``(P(z|d), P(w|z))``. The ``n_row_blocks x n_col_blocks`` grid asks for
    the mesh's shape and is clamped to the devices (one card: a 1 x 1 mesh,
    ``PLSA``'s fit bit for bit). ``e_step_thresh`` is ignored, as in the JAX
    package: the dense tiles treat the reference's default as the no-op it
    is there."""
    del e_step_thresh
    model = BlockParallelPLSA(
        n_components=k, init=init, n_row_blocks=n_row_blocks, n_col_blocks=n_col_blocks,
        n_iter=n_iter, n_iter_per_test=n_iter_per_test, tolerance=tolerance,
        random_state=random_state, device=device,
    )
    embedding = model.fit_transform(X)
    return embedding, model.components_


__all__ = ["BlockParallelPLSA", "plsa_fit"]
