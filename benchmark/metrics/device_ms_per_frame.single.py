"""Device ms per delivered frame in the one-stream cells (moves latency_p50_ms)."""

from benchmark.metrics._layers import device_ms_per_frame as read  # noqa: F401
