"""The hashing kernels' share of their roofline over the traced window, in %.

Work counted from the circuit's shapes and each proof, never from launches:

- each commitment of a proof (wires, Z and partial products, quotient chunks)
  hashes its 2^(log_n + rate_bits) leaves, a leaf of w words taking ceil(w / 8)
  permutations (the sponge's rate is 8), and compresses its tree down to the
  cap: 2^(log_n + rate_bits) - 2^cap_height two-to-one permutations;
- each FRI layer of size s commits s / 2 leaves of 4 words (one permutation
  each) and their tree down to its cap of 2^min(4, log2(s / 2)) digests;
- the grind hashes [challenge, w] for w = 0 .. the proof's PoW witness: at
  least witness + 1 permutations.

A permutation is 6,496 32-bit multiply-adds in the cheapest form known (width
12, 8 full and 22 partial rounds): 118 S-boxes of two squares (3 partial
products of a 64 x 64 square each) and two general products (4 each), 118 x
14; 8 dense MDS layers as two length-6 correlations on four 16-bit limbs, 72 x
4 products and 4 for the one non-zero diagonal entry, 8 x 292; the 22 sparse
partial rounds as one 11 x 11 matrix and 23 products of 64 x 64 bits a round,
(121 + 22 x 23) x 4.  Bytes: each leaf word read once, each digest written
once.  The share is the least time (peaks.py) over the device time of the
kernels listed in ``KERNELS`` in the window.  The transcript's permutations run
on the host and are in neither side.
"""

from portbench import peaks

KERNELS = ("sponge_kernel", "merkle_level_kernel", "merkle_tail_kernel")
MADS_PER_PERMUTATION = 118 * (2 * 3 + 2 * 4) + 8 * (72 * 4 + 4) + (121 + 22 * 23) * 4


def fri_layer_sizes(shapes: dict) -> list:
    size = 1 << (shapes["log_n"] + shapes["rate_bits"])
    stop = 1 << (shapes["final_poly_bits"] + shapes["rate_bits"])
    sizes = []
    while size > stop:
        sizes.append(size)
        size //= 2
    return sizes


def proof_work(shapes: dict, pow_witness: int) -> tuple:
    """(permutations, bytes) one proof's hashing needs."""
    n_lde = 1 << (shapes["log_n"] + shapes["rate_bits"])
    perms = nbytes = 0
    for width in shapes["commit_widths"]:
        nodes = n_lde - (1 << shapes["cap_height"])
        perms += n_lde * -(-width // 8) + nodes
        nbytes += n_lde * width * 8 + (n_lde + nodes) * 32
    for size in fri_layer_sizes(shapes):
        leaves = size // 2
        nodes = leaves - (1 << min(4, leaves.bit_length() - 1))
        perms += leaves + nodes
        nbytes += leaves * 4 * 8 + (leaves + nodes) * 32
    perms += pow_witness + 1
    nbytes += (pow_witness + 1) * (2 + 4) * 8
    return perms, nbytes


def read(record: dict):
    trace = record.get("trace")
    device_s = sum(trace["kernel_s"].get(k, 0.0) for k in KERNELS) if trace else 0.0
    if device_s <= 0 or not record["proofs"]:
        return None
    least = 0.0
    for proof in record["proofs"]:
        perms, nbytes = proof_work(record["shapes"], proof["pow_witness"])
        least += peaks.least_seconds(nbytes, perms * MADS_PER_PERMUTATION)[0]
    return 100.0 * least / device_s
