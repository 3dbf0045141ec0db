"""Device ms per delivered frame in the batched cells (moves frames_per_s)."""

from benchmark.metrics._layers import device_ms_per_frame as read  # noqa: F401
