"""The yardstick's peaks and least times of the card (one NVIDIA H100 SXM).

Published rates from NVIDIA's data sheet, dense, at the 700 W limit: bf16
tensor cores 989.4 TFLOP/s, HBM3 3.35 TB/s; the exponential unit does 16
per clock per SM on 132 SMs, taken at the published top boost clock of
1980 MHz, so a least time is never above the card's.  ``bound_s`` is the
least time of some work: the largest of its bytes over the memory rate, its
flops over the tensor-core rate and its exponentials over the exp rate.
"""

from __future__ import annotations

__all__ = ["PEAK_BF16_FLOPS", "PEAK_BYTES", "EXP_RATE", "attention_bound_s", "bound_s"]

PEAK_BF16_FLOPS = 989.4e12
PEAK_BYTES = 3.35e12
NUM_SMS, EXP_PER_CLOCK_PER_SM, TOP_SM_CLOCK_HZ = 132, 16, 1.98e9
EXP_RATE = NUM_SMS * EXP_PER_CLOCK_PER_SM * TOP_SM_CLOCK_HZ


def bound_s(nbytes: float, flops: float, exps: float = 0.0) -> float:
    """Least seconds of work of ``nbytes`` moved, ``flops`` bf16 tensor-core
    operations and ``exps`` exponentials."""
    return max(nbytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS, exps / EXP_RATE)


def attention_bound_s(batch: int, heads: int, sq: int, sk: int, d: int, elem: int = 2) -> float:
    """Least seconds of one attention: 4·Sq·Sk·d flops (Q·Kᵀ and P·V) and
    Sq·Sk exponentials per head; q, k, v read and the output written once
    in ``elem``-byte elements."""
    bh = batch * heads
    return bound_s(elem * bh * d * (2 * sq + 2 * sk), 4.0 * bh * sq * sk * d, 1.0 * bh * sq * sk)
