"""Set-up: from the start of the process to the opening of the window
(imports, the CUDA context, the corpus on the card and to the host, any
nvcc build, the warm call), by the host's clock."""


def read(rec):
    return rec.setup_s
