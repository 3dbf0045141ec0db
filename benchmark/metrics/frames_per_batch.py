"""Styled frames per batch the engine cut in the window: the deltas of
``Engine.stats()``'s ``frames_out`` and ``batches`` (moves frames_per_s)."""


def read(record):
    batches = record["stats"]["batches"]
    return record["stats"]["frames_out"] / batches if batches else None
