"""Live beacon-RPC ingestion: fetch a consecutive light-client update
pair from a beacon-chain API node.

Copy of ``eth_lc_plonky2_tpu/eth/rpc.py`` (the port keeps its own;
standard library only).  It follows upstream's fetch path (main.rs:34-56):

  1. read the two endpoint URLs from rpc.yaml,
  2. GET the latest finality update, take its attested slot,
  3. period = slot / (256*32); fetch 2 updates from period-1,
  4. parse into typed LightClientUpdate objects.

and with the version-switched parsers of utils.rs:25-41 (the
BeaconRPCVersion enum): the standard beacon API (Altair v1) nests
headers as {"beacon": {...}} while older/nimbus variants return the
flat header object — `_header_json` accepts both, which is exactly
the V1_1/V1_5 difference the reference switches on.

Transport is stdlib urllib (no extra deps); everything network-facing
takes a `fetch` callable so tests inject canned responses / local
servers.
"""

from __future__ import annotations

import dataclasses
import json
import urllib.request

from .lc_update import BeaconHeader, LightClientUpdate, SyncCommittee, bits_from_hex

SLOTS_PER_PERIOD = 256 * 32  # main.rs:47


@dataclasses.dataclass
class BeaconRpcConfig:
    finality_update_rpc: str
    light_client_rpc: str


def load_rpc_config(path: str) -> BeaconRpcConfig:
    """Parse the 2-key rpc.yaml (main.rs:34-38).  The file is plain
    `key: value` lines; parsed directly so no yaml dependency."""
    values = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or ":" not in line:
                continue
            key, _, val = line.partition(":")
            values[key.strip()] = val.strip()
    return BeaconRpcConfig(
        finality_update_rpc=values["finality_update_rpc"],
        light_client_rpc=values["light_client_rpc"],
    )


def fetch_json(url: str, timeout: float = 30.0):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def _unwrap(obj):
    """Beacon API responses wrap payloads as {"version":..,"data":{..}}."""
    if isinstance(obj, dict) and "data" in obj:
        return obj["data"]
    return obj


def _header_json(d: dict) -> dict:
    """Accept both the nested v1 form {"beacon": {...}} and the flat
    header object (the utils.rs:25-41 version switch)."""
    return d["beacon"] if "beacon" in d else d


def update_from_beacon_api(obj: dict) -> LightClientUpdate:
    """Standard beacon-API light-client update -> typed update (the
    role of the reference's get_*_from_light_client_update_json_str
    family, utils.rs:128-227)."""
    d = _unwrap(obj)
    agg = d["sync_aggregate"]
    return LightClientUpdate(
        attested_header=BeaconHeader.from_json(_header_json(d["attested_header"])),
        sync_committee_bits=bits_from_hex(agg["sync_committee_bits"]),
        sync_committee_signature=bytes.fromhex(
            agg["sync_committee_signature"].removeprefix("0x")
        ),
        signature_slot=int(d["signature_slot"]),
        finalized_header=BeaconHeader.from_json(_header_json(d["finalized_header"])),
        finality_branch=[bytes.fromhex(x.removeprefix("0x")) for x in d["finality_branch"]],
        next_sync_committee=SyncCommittee.from_json(d["next_sync_committee"]),
        next_sync_committee_branch=[
            bytes.fromhex(x.removeprefix("0x")) for x in d["next_sync_committee_branch"]
        ],
    )


def latest_attested_slot(cfg: BeaconRpcConfig, fetch=fetch_json) -> int:
    """GET the latest finality update and return its attested slot
    (main.rs:40-46)."""
    fin = _unwrap(fetch(cfg.finality_update_rpc))
    return int(_header_json(fin["attested_header"])["slot"])


def fetch_update_pair(cfg: BeaconRpcConfig, fetch=fetch_json):
    """The main.rs:40-56 flow: latest slot -> period -> fetch the
    (period-1, period) update pair.  Returns (cur_update, new_update)."""
    slot = latest_attested_slot(cfg, fetch)
    period = slot // SLOTS_PER_PERIOD
    url = f"{cfg.light_client_rpc}?start_period={period - 1}&count=2"
    arr = fetch(url)
    if isinstance(arr, dict) and "data" in arr and isinstance(arr["data"], list):
        arr = arr["data"]
    if len(arr) < 2:
        raise ValueError(f"beacon RPC returned {len(arr)} updates, need 2 ({url})")
    return update_from_beacon_api(arr[0]), update_from_beacon_api(arr[1])
