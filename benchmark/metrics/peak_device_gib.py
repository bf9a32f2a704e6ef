"""``torch.cuda.max_memory_allocated()`` over the window, in GiB: the
harness frees its own device memory and resets the peak before the window."""


def read(rec):
    return rec.peak_bytes / 2**30 if rec.peak_bytes else None
