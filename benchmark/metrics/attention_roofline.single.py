"""The long self-attentions' share of their roofline, one-stream cells (moves latency_p50_ms)."""

from benchmark.metrics import _layers

# the kernels that run a frame's long self-attentions: the port's
# flash-attention kernels (K1, up to d = 256 and above it)
PATTERNS = ("flash_fwd", "flash_wide_fwd")


def read(record):
    return _layers.attention_roofline(record, PATTERNS)
