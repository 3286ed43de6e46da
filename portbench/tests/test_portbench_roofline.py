"""The roofline counts on small known shapes, and the readers' silence where
there is nothing to read."""

from pathlib import Path

import pytest

from portbench import harness, peaks

METRICS = Path(__file__).resolve().parents[1] / "metrics"
HASH = harness.load_module(METRICS / "hash_roofline.py", "hash_roofline")
NTT = harness.load_module(METRICS / "ntt_roofline.py", "ntt_roofline")

# log_n 2, rate 1: 8 LDE points; cap height 1; FRI stops at 2^(0 + 1) = 2
SMALL = {"log_n": 2, "rate_bits": 1, "cap_height": 1, "final_poly_bits": 0,
         "num_challenges": 1, "commit_widths": [8, 9, 2]}


def test_permutation_count():
    assert HASH.MADS_PER_PERMUTATION == 118 * 14 + 8 * 292 + 627 * 4 == 6496


def test_hash_work_small():
    perms, nbytes = HASH.proof_work(SMALL, pow_witness=5)
    # leaves: 8 x (1 + 2 + 1); nodes: 3 x (8 - 2); FRI layers of 8 and 4
    # points: 4 + 2 leaves under caps of 2^2 and 2^1, so no nodes; grind 6
    assert HASH.fri_layer_sizes(SMALL) == [8, 4]
    assert perms == 8 * 4 + 3 * 6 + (4 + 2) + 6
    assert nbytes == (8 * 19 * 8 + 3 * (8 + 6) * 32 + (4 + 2) * 4 * 8 + (4 + 2) * 32
                      + 6 * 6 * 8)


def test_ntt_work_small():
    butterflies, nbytes = NTT.proof_work(SMALL)
    # wires 8 and Z 9 polys: IFFT 2 x 2 butterflies each, LDE 2 cosets x 2 x 2;
    # quotient: one coset IFFT of 8 (4 x 3), LDE of 2 polys; final: 2 of 2 (1 x 1)
    assert butterflies == 8 * (4 + 8) + 9 * (4 + 8) + 12 + 2 * 8 + 2 * 1
    assert nbytes == 8 * (8 * (8 + 12) + 9 * (8 + 12) + 16 + 2 * 12 + 2 * 4)


def test_least_seconds_takes_the_larger_bound():
    assert peaks.least_seconds(3.35e12, 0) == (1.0, "bytes")
    assert peaks.least_seconds(0, peaks.PEAK_INT32_MADS_PER_S * 2) == (2.0, "operations")


@pytest.mark.parametrize("module", [HASH, NTT], ids=["hash", "ntt"])
def test_reader_silent_without_device_time(module):
    record = {"shapes": SMALL, "proofs": [{"pow_witness": 0}], "trace": {"kernel_s": {}}}
    assert module.read(record) is None
    assert module.read({**record, "trace": None}) is None


@pytest.mark.parametrize("module", [HASH, NTT], ids=["hash", "ntt"])
def test_share_is_least_time_over_device_time(module):
    perms, nbytes = HASH.proof_work(SMALL, 0)
    butterflies, nbytes_ntt = NTT.proof_work(SMALL)
    least = (peaks.least_seconds(nbytes, perms * HASH.MADS_PER_PERMUTATION)[0] if module is HASH
             else peaks.least_seconds(nbytes_ntt, butterflies * 4)[0])
    kernel_s = {module.KERNELS[0]: 4 * least, "other_kernel": 1.0}
    record = {"shapes": SMALL, "proofs": [{"pow_witness": 0}, {"pow_witness": 0}],
              "trace": {"kernel_s": kernel_s}}
    assert module.read(record) == pytest.approx(50.0)
