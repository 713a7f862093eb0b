"""``torch.cuda.max_memory_allocated()`` over the window (its statistics
reset as the window opens), in GiB."""


def read(rec):
    return rec.peak_bytes / 2**30 if rec.peak_bytes else None
