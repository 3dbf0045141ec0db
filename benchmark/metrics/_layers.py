"""What the per-layer readers share: each reads the traced run's record
(``run.py::layer_record``; its ``trace`` from ``trace.py::reduce_trace``)
and returns None where it finds nothing to read."""

from __future__ import annotations

from benchmark.roofline import PEAK_BF16_FLOPS

def device_ms_per_frame(record):
    """Device busy time (kernels, copies, memsets) over the frames delivered
    in the traced sub-window, ms."""
    tr = record["trace"]
    if not tr or not tr["frames"] or tr["busy_s"] <= 0:
        return None
    return tr["busy_s"] / tr["frames"] * 1e3


def device_idle_share(record):
    """Share of the traced sub-window in which a submitted frame is
    unresolved and nothing runs on the card, %."""
    tr = record["trace"]
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return tr["idle_s"] / tr["window_s"] * 100.0


def attention_roofline(record, patterns):
    """The least time of the batch rows' long self-attentions (their work,
    counted from the configuration's shapes) over the device time of the
    kernels whose names hold one of ``patterns`` in the traced sub-window, %."""
    tr = record["trace"]
    if not tr or not tr["rows"]:
        return None
    t = sum(e - s for n, s, e in tr["device_events"] if any(k in n for k in patterns))
    if t <= 0:
        return None
    return tr["rows"] * record["attention_bound_s_per_frame"] / t * 100.0


def mfu_batched(record):
    """A frame's FLOPs times the styled frames delivered in the window before
    the profiler starts, over that time and the card's bf16 peak, %."""
    if not record["delivered"]:
        return None
    return (record["flops_per_frame"] * record["delivered"]
            / (record["window_s"] * PEAK_BF16_FLOPS) * 100.0)


def mfu_single(record):
    """A frame's FLOPs over its mean submit-to-resolve time (the frames
    resolved before the profiler starts) and the card's bf16 peak, %."""
    if record["mean_service_s"] <= 0 or not record["delivered"]:
        return None
    return record["flops_per_frame"] / (record["mean_service_s"] * PEAK_BF16_FLOPS) * 100.0
