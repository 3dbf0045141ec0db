"""``torch.cuda.max_memory_reserved()`` after set-up and window, GiB: the
weights, every bucket's graph pool and the caching allocator's blocks."""


def read(record):
    return record["peak_reserved_bytes"] / 2**30 if record["peak_reserved_bytes"] else None
