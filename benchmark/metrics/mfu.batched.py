"""The frame work's share of the bf16 peak over the window, batched cells (moves frames_per_s)."""

from benchmark.metrics._layers import mfu_batched as read  # noqa: F401
