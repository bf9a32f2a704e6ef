"""EM ops of the PyTorch port: plain versions (``em``), CUDA kernel wrappers
(``cuda_em``), fit loops (``fit``) and the fit/refit drivers (``driver``)."""
