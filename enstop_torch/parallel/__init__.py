"""The device mesh: EM over a grid of devices (counterpart of
``enstop_tpu/parallel``). :mod:`.mesh` holds the dense ``(docs, vocab)`` tile
grid and the ensemble's runs mesh, :mod:`.sparse_mesh` the O(nnz) layout
sharded by document range."""
