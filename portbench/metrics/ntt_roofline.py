"""The NTT kernel's share of its roofline over the traced window, in %.

Work counted from the circuit's shapes, never from launches.  A proof's
transforms, in the fewest butterflies radix 2 needs:

- the wires: an inverse transform of each of the num_wires columns (size n =
  2^log_n: n / 2 x log_n butterflies) and its coset LDE to n x 2^rate_bits
  points, 2^rate_bits cosets of one size-n transform each (the coset's scaling
  products are not counted);
- Z and the partial products (num_challenges x num_routed_wires / chunk
  polynomials): the same;
- the quotient: a coset inverse transform of each challenge's 2^(log_n +
  rate_bits) values, then the coset LDE of its num_challenges x 2^rate_bits
  chunks of n coefficients;
- FRI's final polynomial: an inverse transform of the last layer's two rows
  of 2^(final_poly_bits + rate_bits) values.

A butterfly is one field product, 4 32-bit multiply-adds (peaks.py).  Bytes:
each transform reads its input once and writes its output once.  The share is
the least time over the device time of the kernels in ``KERNELS`` in the
window.
"""

from portbench import peaks

KERNELS = ("ntt_pass_kernel",)


def _fft(log_size: int, count: int) -> tuple:
    """(butterflies, bytes) of ``count`` transforms of size 2^log_size."""
    size = 1 << log_size
    return count * (size // 2) * log_size, count * 2 * size * 8


def _lde(log_n: int, rate_bits: int, count: int) -> tuple:
    n = 1 << log_n
    return count * (1 << rate_bits) * (n // 2) * log_n, count * (n + (n << rate_bits)) * 8


def proof_work(shapes: dict) -> tuple:
    """(butterflies, bytes) one proof's transforms need."""
    log_n, rate = shapes["log_n"], shapes["rate_bits"]
    wires, zs, quotient = shapes["commit_widths"]
    parts = [
        _fft(log_n, wires), _lde(log_n, rate, wires),
        _fft(log_n, zs), _lde(log_n, rate, zs),
        _fft(log_n + rate, shapes["num_challenges"]), _lde(log_n, rate, quotient),
        _fft(shapes["final_poly_bits"] + rate, 2),
    ]
    return sum(p[0] for p in parts), sum(p[1] for p in parts)


def read(record: dict):
    trace = record.get("trace")
    device_s = sum(trace["kernel_s"].get(k, 0.0) for k in KERNELS) if trace else 0.0
    if device_s <= 0 or not record["proofs"]:
        return None
    butterflies, nbytes = proof_work(record["shapes"])
    least = peaks.least_seconds(nbytes, butterflies * peaks.MADS_PER_FIELD_PRODUCT)[0]
    return 100.0 * least * len(record["proofs"]) / device_s
