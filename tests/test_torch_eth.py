"""The port's ``eth/`` modules against the JAX package's: the synthetic update
pairs, the SSZ roots, the domains and signing roots, the update loaders and
the beacon-API ingestion (fed JSON that this file writes, with ``fetch=``
injected: no socket is opened).  Seeds go through numpy; every comparison is
exact."""

import dataclasses
import json

import numpy as np
import pytest

from eth_lc_plonky2_tpu import cli as jcli
from eth_lc_plonky2_tpu.eth import domain as jdomain
from eth_lc_plonky2_tpu.eth import lc_update as jlcu
from eth_lc_plonky2_tpu.eth import rpc as jrpc
from eth_lc_plonky2_tpu.eth import ssz as jssz
from eth_lc_plonky2_tpu.eth import synthetic as jsyn
from eth_lc_plonky2_tpu_torch import cli
from eth_lc_plonky2_tpu_torch.eth import domain, lc_update, rpc, ssz, synthetic


def _plain(x):
    """A dataclass tree as plain dicts and lists, for comparison across packages."""
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


@pytest.mark.parametrize("seed", [0, 1, 5])
@pytest.mark.parametrize("size", [2, 4, 8])
def test_synthetic_pairs_equal_the_jax_packages(size, seed):
    got = synthetic.make_synthetic_update_pair(size, seed=seed)
    want = jsyn.make_synthetic_update_pair(size, seed=seed)
    assert _plain(got) == _plain(want)
    kw = got.witness_kwargs
    assert len(kw["sync_committee_pubkeys"]) == size and got.threshold == want.threshold
    # the roots the circuit's public inputs must equal
    assert got.cur_state == ssz.contract_state_root(
        kw["cur_slot"], kw["cur_header"], kw["cur_sync_committee_i"], kw["cur_sync_committee_ii"])
    header = ssz.beacon_block_header_root(
        kw["attested_slot"], kw["attested_proposer_index"], kw["attested_parent_root"],
        kw["attested_state_root"], kw["attested_body_root"])
    assert kw["signing_root"] == domain.compute_signing_root(header, kw["domain"])
    assert kw["signing_root"] == jdomain.compute_signing_root(header, kw["domain"])


@pytest.mark.parametrize("kwargs", [dict(rollover=False), dict(participation=5),
                                    dict(valid_pubkeys=True)])
def test_synthetic_options_equal_the_jax_packages(kwargs):
    got = synthetic.make_synthetic_update_pair(8, seed=3, **kwargs)
    want = jsyn.make_synthetic_update_pair(8, seed=3, **kwargs)
    assert _plain(got) == _plain(want)


def test_valid_pubkeys_equal_the_jax_packages():
    a, b = np.random.default_rng(11), np.random.default_rng(11)
    assert [synthetic.make_valid_pubkey(a) for _ in range(4)] == [
        jsyn.make_valid_pubkey(b) for _ in range(4)]


def _rand(rng, n):
    return bytes(rng.integers(0, 256, n, dtype=np.uint8))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_ssz_roots_equal_the_jax_packages(seed):
    rng = np.random.default_rng(seed)
    r32 = [_rand(rng, 32) for _ in range(5)]
    pks = [_rand(rng, 48) for _ in range(1 << (seed + 1))]
    agg = _rand(rng, 48)
    slot, proposer = int(rng.integers(0, 1 << 40)), int(rng.integers(0, 1 << 20))
    assert ssz.hash_pair(r32[0], r32[1]) == jssz.hash_pair(r32[0], r32[1])
    assert ssz.uint64_leaf(slot) == jssz.uint64_leaf(slot)
    assert ssz.uint256_leaf(slot << 100) == jssz.uint256_leaf(slot << 100)
    assert ssz.merkleize(r32) == jssz.merkleize(r32)
    assert ssz.beacon_block_header_root(slot, proposer, *r32[:3]) == \
        jssz.beacon_block_header_root(slot, proposer, *r32[:3])
    assert ssz.pubkey_leaves(pks[0]) == jssz.pubkey_leaves(pks[0])
    assert ssz.pubkey_root(agg) == jssz.pubkey_root(agg)
    assert ssz.sync_committee_root(pks, agg) == jssz.sync_committee_root(pks, agg)
    assert ssz.signing_data_root(r32[0], r32[1]) == jssz.signing_data_root(r32[0], r32[1])
    assert ssz.contract_state_root(slot, *r32[:3]) == jssz.contract_state_root(slot, *r32[:3])


@pytest.mark.parametrize("slot", [0, 74240 * 32, 5188822, 269568 * 32 + 5, 364032 * 32 + 7,
                                  1 << 40])
def test_domains_and_signing_roots_equal_the_jax_packages(slot):
    version = domain.fork_version_at_slot(slot)
    assert version == jdomain.fork_version_at_slot(slot)
    d = domain.compute_domain(domain.DOMAIN_SYNC_COMMITTEE, version)
    assert d == jdomain.compute_domain(jdomain.DOMAIN_SYNC_COMMITTEE, version)
    root = ssz.sha256(slot.to_bytes(8, "little"))
    assert domain.compute_signing_root(root, d) == jdomain.compute_signing_root(root, d)
    other = bytes(range(32))
    assert domain.compute_domain(domain.DOMAIN_SYNC_COMMITTEE, version, other) == \
        jdomain.compute_domain(jdomain.DOMAIN_SYNC_COMMITTEE, version, other)


# ---------------------------------------------------------------------------
# Update files and the beacon API, written here from a synthetic pair
# ---------------------------------------------------------------------------


def _hex(b: bytes) -> str:
    return "0x" + b.hex()


def _bits_hex(bits) -> str:
    out = bytearray((len(bits) + 7) // 8)
    for i, bit in enumerate(bits):
        out[i // 8] |= int(bit) << (i % 8)
    return _hex(bytes(out))


def _header(slot, proposer, parent, state, body) -> dict:
    return {"slot": str(slot), "proposer_index": str(proposer), "parent_root": _hex(parent),
            "state_root": _hex(state), "body_root": _hex(body)}


def _updates(size: int, seed: int) -> tuple:
    """A (cur, new) pair of updates in the fixture schema, consistent as the
    CLI reads them: the signing committee is the cur update's next committee."""
    kw = synthetic.make_synthetic_update_pair(size, seed=seed).witness_kwargs
    rng = np.random.default_rng(seed + 100)
    committee = {"pubkeys": [_hex(p) for p in kw["sync_committee_pubkeys"]],
                 "aggregate_pubkey": _hex(kw["sync_committee_aggregate"])}
    new = {
        "attested_beacon_header": _header(kw["attested_slot"], kw["attested_proposer_index"],
                                          kw["attested_parent_root"], kw["attested_state_root"],
                                          kw["attested_body_root"]),
        "sync_aggregate": {"sync_committee_bits": _bits_hex(kw["sync_committee_bits"]),
                           "sync_committee_signature": _hex(kw["signature"])},
        "signature_slot": str(kw["attested_slot"] + 1),
        "finality_update": {
            "header_update": {"beacon_header": _header(
                kw["finalized_slot"], kw["finalized_proposer_index"], kw["finalized_parent_root"],
                kw["finalized_state_root"], kw["finalized_body_root"])},
            "finality_branch": [_hex(b) for b in kw["finality_branch"]]},
        "sync_committee_update": {
            "next_sync_committee": {"pubkeys": [_hex(_rand(rng, 48)) for _ in range(size)],
                                    "aggregate_pubkey": _hex(_rand(rng, 48))},
            "next_sync_committee_branch": [_hex(b) for b in kw["new_sync_committee_ii_branch"]]},
    }
    cur = json.loads(json.dumps(new))
    cur["attested_beacon_header"]["slot"] = str(kw["cur_slot"] + 64)
    cur["finality_update"]["header_update"]["beacon_header"]["slot"] = str(kw["cur_slot"])
    cur["sync_committee_update"]["next_sync_committee"] = committee
    return cur, new


def _beacon_api(update: dict, flat: bool) -> dict:
    """The fixture schema -> the standard beacon-API schema."""
    header = (lambda h: h) if flat else (lambda h: {"beacon": h})
    return {"version": "deneb", "data": {
        "attested_header": header(update["attested_beacon_header"]),
        "next_sync_committee": update["sync_committee_update"]["next_sync_committee"],
        "next_sync_committee_branch": update["sync_committee_update"]["next_sync_committee_branch"],
        "finalized_header": header(update["finality_update"]["header_update"]["beacon_header"]),
        "finality_branch": update["finality_update"]["finality_branch"],
        "sync_aggregate": update["sync_aggregate"],
        "signature_slot": update["signature_slot"]}}


@pytest.fixture(scope="module", params=[(4, 0), (8, 1)])
def update_files(request, tmp_path_factory):
    size, seed = request.param
    cur, new = _updates(size, seed)
    d = tmp_path_factory.mktemp(f"updates_{size}")
    paths = []
    for name, u in (("cur", cur), ("new", new)):
        path = d / f"{name}.json"
        path.write_text(json.dumps(u))
        paths.append(str(path))
    return size, cur, new, paths


def test_load_update_equals_the_jax_packages(update_files):
    size, _, _, paths = update_files
    for path in paths:
        got, want = lc_update.load_update(path), jlcu.load_update(path)
        assert _plain(got) == _plain(want)
        assert got.signing_root() == want.signing_root()
        assert got.attested_period == want.attested_period
        assert got.participation == want.participation
        assert got.next_sync_committee.tree_hash_root() == want.next_sync_committee.tree_hash_root()
        assert got.attested_header.tree_hash_root() == want.attested_header.tree_hash_root()


def test_witness_from_updates_equals_the_jax_packages(update_files):
    size, _, _, paths = update_files
    got = cli.witness_from_updates(*(lc_update.load_update(p) for p in paths))
    want = jcli.witness_from_updates(*(jlcu.load_update(p) for p in paths))
    assert _plain(got) == _plain(want)
    kw, cur_state, new_state = got
    assert (kw["cur_state"], kw["new_state"]) == (cur_state, new_state)
    assert len(kw["sync_committee_pubkeys"]) == size


@pytest.mark.parametrize("flat", [False, True])
def test_update_from_beacon_api_equals_the_file_loader(update_files, flat):
    _, cur, new, paths = update_files
    for update, path in ((cur, paths[0]), (new, paths[1])):
        obj = _beacon_api(update, flat)
        got = rpc.update_from_beacon_api(obj)
        assert _plain(got) == _plain(jrpc.update_from_beacon_api(obj))
        assert _plain(got) == _plain(lc_update.load_update(path))


def test_fetch_update_pair_with_an_injected_fetch(update_files, tmp_path):
    _, cur, new, paths = update_files
    yaml = tmp_path / "rpc.yaml"
    yaml.write_text("# endpoints\nfinality_update_rpc: http://beacon.invalid/finality\n"
                    "light_client_rpc: http://beacon.invalid/updates\n")
    cfg = rpc.load_rpc_config(str(yaml))
    assert _plain(cfg) == _plain(jrpc.load_rpc_config(str(yaml)))
    attested = int(new["attested_beacon_header"]["slot"])
    period = attested // rpc.SLOTS_PER_PERIOD
    asked = []

    def fetch(url):
        asked.append(url)
        if url == cfg.finality_update_rpc:
            return {"data": {"attested_header": {"beacon": new["attested_beacon_header"]}}}
        return {"data": [_beacon_api(cur, False), _beacon_api(new, True)]}

    got = rpc.fetch_update_pair(cfg, fetch=fetch)
    want = jrpc.fetch_update_pair(jrpc.load_rpc_config(str(yaml)), fetch=fetch)
    assert asked[1] == f"http://beacon.invalid/updates?start_period={period - 1}&count=2"
    assert asked[:2] == asked[2:]
    assert _plain(got) == _plain(want)
    assert [_plain(u) for u in got] == [_plain(lc_update.load_update(p)) for p in paths]
    with pytest.raises(ValueError):
        rpc.fetch_update_pair(cfg, fetch=lambda url: {"data": [] if "updates" in url else
                                                      fetch(url)["data"]})
