"""The card's idle share with a frame pending, one-stream cells (moves latency_p50_ms)."""

from benchmark.metrics._layers import device_idle_share as read  # noqa: F401
