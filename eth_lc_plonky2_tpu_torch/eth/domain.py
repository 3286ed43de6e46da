"""Beacon-chain domains and the mainnet fork schedule.

Copy of ``eth_lc_plonky2_tpu/eth/domain.py`` (the port keeps its own).
The counterpart of eth2-utility's `compute_domain(DOMAIN_SYNC_COMMITTEE,
fork_version, genesis_validators_root)` and lighthouse's fork lookup
(upstream main.rs:81-88).
"""

from __future__ import annotations

from . import ssz

DOMAIN_SYNC_COMMITTEE = bytes.fromhex("07000000")

MAINNET_GENESIS_VALIDATORS_ROOT = bytes.fromhex(
    "4b363db94e286120d76eb905340fdd4e54bfe9f06bf33ff6cf5ad27f511bfe95"
)

SLOTS_PER_EPOCH = 32
EPOCHS_PER_SYNC_COMMITTEE_PERIOD = 256
SLOTS_PER_PERIOD = SLOTS_PER_EPOCH * EPOCHS_PER_SYNC_COMMITTEE_PERIOD  # 8192

# (fork epoch, version) — mainnet schedule, ascending
MAINNET_FORKS = [
    (0, bytes.fromhex("00000000")),  # phase0
    (74240, bytes.fromhex("01000000")),  # altair
    (144896, bytes.fromhex("02000000")),  # bellatrix
    (194048, bytes.fromhex("03000000")),  # capella
    (269568, bytes.fromhex("04000000")),  # deneb
    (364032, bytes.fromhex("05000000")),  # electra
]


def fork_version_at_slot(slot: int, forks=None) -> bytes:
    epoch = slot // SLOTS_PER_EPOCH
    version = MAINNET_FORKS[0][1]
    for fork_epoch, v in forks or MAINNET_FORKS:
        if epoch >= fork_epoch:
            version = v
    return version


def compute_fork_data_root(current_version: bytes, genesis_validators_root: bytes) -> bytes:
    """hash_tree_root(ForkData{current_version, genesis_validators_root})."""
    return ssz.hash_pair(current_version + b"\x00" * 28, genesis_validators_root)


def compute_domain(domain_type: bytes, fork_version: bytes,
                   genesis_validators_root: bytes = MAINNET_GENESIS_VALIDATORS_ROOT) -> bytes:
    fdr = compute_fork_data_root(fork_version, genesis_validators_root)
    return domain_type + fdr[:28]


def compute_signing_root(object_root: bytes, domain: bytes) -> bytes:
    """Native signing root (must bit-match the SigningRoot subcircuit;
    utils.rs:229-237)."""
    return ssz.signing_data_root(object_root, domain)
