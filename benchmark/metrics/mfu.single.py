"""The frame work's share of the bf16 peak over the mean service time, one-stream cells."""

from benchmark.metrics._layers import mfu_single as read  # noqa: F401
