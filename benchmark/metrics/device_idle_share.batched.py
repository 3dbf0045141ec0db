"""The card's idle share with frames pending, batched cells (moves frames_per_s)."""

from benchmark.metrics._layers import device_idle_share as read  # noqa: F401
