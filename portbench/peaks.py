"""The card's peaks, against which every roofline share is stated.

NVIDIA H100 SXM5 80GB (data sheet, dense rates, at the 700 W power limit; the
run records the card's own name and limit beside its numbers):

- device memory: 3.35 TB/s of HBM3;
- 32-bit integer multiply-adds: the data sheet gives 67 TFLOP/s of float32,
  which is 33.5 T fused multiply-adds a second on the 128 float32 lanes of an
  SM; 64 of those lanes execute 32-bit integer multiply-adds (IMAD), so
  16.75 T a second (132 SMs x 64 lanes x 1.98 GHz = 16.73 T agrees).

Goldilocks arithmetic is 64-bit, and the card has no 64 x 64 multiplier: a
field product is at least the four 32 x 32 partial products of a 64 x 64
product, four multiply-adds.  The reduction's shifts and adds run on other
pipes and are not counted, so a share stays a lower bound on the time.
"""

PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_MADS_PER_S = 67e12 / 2 / 2
MADS_PER_FIELD_PRODUCT = 4


def least_seconds(nbytes: float, mads: float) -> tuple:
    """The least time the card could take for this work: (seconds, "bytes" or
    "operations", whichever bounds it)."""
    by_bytes = nbytes / PEAK_BYTES_PER_S
    by_ops = mads / PEAK_INT32_MADS_PER_S
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"
