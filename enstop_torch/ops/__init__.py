"""EM ops of the PyTorch port: plain versions (``em``, ``coo``), CUDA kernel
wrappers (``cuda_em``, ``cuda_sparse``, ``cuda_batch``; ``cuda_umap`` for the
UMAP layout), the sparse path (``sell``), fit loops (``fit``) and the
fit/refit drivers (``driver``)."""
