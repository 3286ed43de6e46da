"""Light-client-update ingestion: JSON -> typed update objects.

Copy of ``eth_lc_plonky2_tpu/eth/lc_update.py`` (the port keeps its
own).  The counterpart of upstream's RPC/JSON parsing layer (utils.rs:
115-237 and the fixture schema of light_client_update_period_63{3,4}.json).
Update files are loaded by path.
"""

from __future__ import annotations

import dataclasses
import json

from . import ssz
from .domain import (
    DOMAIN_SYNC_COMMITTEE,
    SLOTS_PER_PERIOD,
    compute_domain,
    compute_signing_root,
    fork_version_at_slot,
)

SYNC_COMMITTEE_SIZE = 512


def _b(hexstr: str) -> bytes:
    return bytes.fromhex(hexstr[2:] if hexstr.startswith("0x") else hexstr)


@dataclasses.dataclass
class BeaconHeader:
    slot: int
    proposer_index: int
    parent_root: bytes
    state_root: bytes
    body_root: bytes

    @classmethod
    def from_json(cls, d: dict) -> "BeaconHeader":
        return cls(
            slot=int(d["slot"]),
            proposer_index=int(d["proposer_index"]),
            parent_root=_b(d["parent_root"]),
            state_root=_b(d["state_root"]),
            body_root=_b(d["body_root"]),
        )

    def tree_hash_root(self) -> bytes:
        return ssz.beacon_block_header_root(
            self.slot, self.proposer_index, self.parent_root, self.state_root, self.body_root
        )


@dataclasses.dataclass
class SyncCommittee:
    pubkeys: list  # 512 x 48-byte
    aggregate_pubkey: bytes

    @classmethod
    def from_json(cls, d: dict) -> "SyncCommittee":
        return cls(
            pubkeys=[_b(p) for p in d["pubkeys"]],
            aggregate_pubkey=_b(d["aggregate_pubkey"]),
        )

    def tree_hash_root(self) -> bytes:
        return ssz.sync_committee_root(self.pubkeys, self.aggregate_pubkey)


@dataclasses.dataclass
class LightClientUpdate:
    attested_header: BeaconHeader
    sync_committee_bits: list  # 512 ints (LSB-first per byte; utils.rs:115-126)
    sync_committee_signature: bytes
    signature_slot: int
    finalized_header: BeaconHeader
    finality_branch: list  # 6 x 32B
    next_sync_committee: SyncCommittee
    next_sync_committee_branch: list  # 5 x 32B

    @classmethod
    def from_json(cls, d: dict) -> "LightClientUpdate":
        agg = d["sync_aggregate"]
        fin = d["finality_update"]
        scu = d["sync_committee_update"]
        return cls(
            attested_header=BeaconHeader.from_json(d["attested_beacon_header"]),
            sync_committee_bits=bits_from_hex(agg["sync_committee_bits"]),
            sync_committee_signature=_b(agg["sync_committee_signature"]),
            signature_slot=int(d["signature_slot"]),
            finalized_header=BeaconHeader.from_json(fin["header_update"]["beacon_header"]),
            finality_branch=[_b(x) for x in fin["finality_branch"]],
            next_sync_committee=SyncCommittee.from_json(scu["next_sync_committee"]),
            next_sync_committee_branch=[_b(x) for x in scu["next_sync_committee_branch"]],
        )

    @property
    def attested_period(self) -> int:
        return self.attested_header.slot // SLOTS_PER_PERIOD

    @property
    def participation(self) -> int:
        return sum(self.sync_committee_bits)

    def signing_root(self, forks=None, genesis_validators_root=None) -> bytes:
        version = fork_version_at_slot(self.attested_header.slot, forks)
        kwargs = {}
        if genesis_validators_root is not None:
            kwargs["genesis_validators_root"] = genesis_validators_root
        domain = compute_domain(DOMAIN_SYNC_COMMITTEE, version, **kwargs)
        return compute_signing_root(self.attested_header.tree_hash_root(), domain)


def bits_from_hex(hexstr: str) -> list:
    """LSB-first bit unpacking of the sync-committee bitfield
    (parity with utils.rs:115-126 bits_from_hex)."""
    raw = _b(hexstr)
    bits = []
    for byte in raw:
        for i in range(8):
            bits.append((byte >> i) & 1)
    return bits[:SYNC_COMMITTEE_SIZE]


def load_update(path: str) -> LightClientUpdate:
    with open(path) as f:
        return LightClientUpdate.from_json(json.load(f))
