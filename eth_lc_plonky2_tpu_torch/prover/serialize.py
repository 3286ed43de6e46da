"""Circuit / proving-key / proof serialization and preprocess caching.

Port of ``eth_lc_plonky2_tpu/prover/serialize.py``: the dicts, caches and
bundles it writes equal the JAX package's key for key.

* Proofs are non-executable JSON with hex-string field elements
  (``proof_to_dict``, ``save_proof``, ``load_proof``).
* The circuit cache (one directory per circuit): ``circuit.pkl``, a
  cloudpickle of (extras, CircuitData) with its witness generators, and
  ``pre.npz``, the preprocessed commitment's values, coefficients and Merkle
  levels as uint64 arrays, so a cache hit skips the IFFT and every Poseidon
  hash of the preprocess.  The cache holds only what this program wrote
  itself (never operator-supplied input), which is the only reason
  cloudpickle is acceptable there: witness generators are closures.
  ``load_circuit`` puts the tensors on the device it is given (the card by
  default).
* Common data (the recursion-facing half of a circuit) round-trips through
  ``common_data_to_dict`` / ``common_data_from_dict`` with gates as
  (type, params) specs.
* ``export_proof_bundle`` writes the portable JSON bundle
  (docs/proof_format.md) that ``tools/verify_standalone.py`` checks without
  this package.

Cache keys capture everything that shapes the circuit and are salted with
FORMAT_VERSION, so stale formats self-invalidate.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from ..circuit.builder import CircuitData
from ..ops import goldilocks as gl
from ..ops import ntt as nttm
from .fri import TAGS, FriProof, FriQueryProof
from .merkle import MerkleTree
from .prove import SHIFT, CommitmentBatch, OpeningSet, Proof, ProverData, VerifierKey, prover_data

FORMAT_VERSION = 3  # v3: extras = (target, bls_targets); PI-hash absorption


def cache_key(*parts) -> str:
    h = hashlib.sha256()
    h.update(f"v{FORMAT_VERSION}".encode())
    for p in parts:
        h.update(repr(p).encode())
    return h.hexdigest()[:16]


# ---------------------------------------------------------------------------
# Circuit + preprocess cache
# ---------------------------------------------------------------------------


def save_circuit(dirpath: str, data: CircuitData, pd: ProverData, extras=None):
    """Persist built circuit tables + witness generators + preprocess."""
    import cloudpickle

    os.makedirs(dirpath, exist_ok=True)
    with open(os.path.join(dirpath, "circuit.pkl"), "wb") as f:
        cloudpickle.dump((extras, data), f)
    levels = [gl.to_u64(level) for level in pd.pre_batch.tree.levels]
    np.savez_compressed(
        os.path.join(dirpath, "pre.npz"),
        pre_values=pd.pre_values,
        pre_coeffs=gl.to_u64(pd.pre_batch.coeffs),
        num_levels=np.array([len(levels)]),
        **{f"level_{i}": level for i, level in enumerate(levels)},
    )


def load_circuit(dirpath: str, device="cuda"):
    """Load a cached circuit: returns (extras, CircuitData, ProverData,
    VerifierKey) with the preprocess on ``device``, reconstructed WITHOUT
    re-hashing (only the coefficient->LDE NTT is recomputed)."""
    import cloudpickle

    with open(os.path.join(dirpath, "circuit.pkl"), "rb") as f:
        extras, data = cloudpickle.load(f)
    z = np.load(os.path.join(dirpath, "pre.npz"))
    coeffs = gl.from_u64(z["pre_coeffs"], device)
    lde = nttm.coset_lde(coeffs, data.config.rate_bits, SHIFT)
    levels = [gl.from_u64(z[f"level_{i}"], device) for i in range(int(z["num_levels"][0]))]
    tree = MerkleTree(leaves=lde, levels=levels, cap_height=data.config.cap_height, leaf_axis=1)
    batch = CommitmentBatch(coeffs=coeffs, lde=lde, tree=tree)
    pd = prover_data(data, z["pre_values"], batch)
    return extras, data, pd, VerifierKey(pre_cap=batch.cap)


def cache_dir_for(root: str, key: str) -> str:
    return os.path.join(root, f"circuit_{key}")


def has_cached_circuit(root: str, key: str) -> bool:
    d = cache_dir_for(root, key)
    return os.path.exists(os.path.join(d, "circuit.pkl")) and os.path.exists(
        os.path.join(d, "pre.npz")
    )


# ---------------------------------------------------------------------------
# Proofs (non-executable JSON — hex-string field elements)
# ---------------------------------------------------------------------------


def save_proof(path: str, proof: Proof):
    with open(path, "w") as f:
        json.dump(proof_to_dict(proof, include_indices=True), f)


def load_proof(path: str) -> Proof:
    with open(path) as f:
        return proof_from_dict(json.load(f))


def _hx(v) -> str:
    return hex(int(v))


def _hx_rows(arr) -> list:
    return [[_hx(v) for v in row] for row in np.asarray(arr)]


def proof_to_dict(proof: Proof, include_indices: bool = False) -> dict:
    """Proof -> plain JSON-serializable dict (hex-string field elements)."""
    d = {
        "public_inputs": [_hx(v) for v in proof.public_inputs],
        "wires_cap": _hx_rows(proof.wires_cap),
        "zs_cap": _hx_rows(proof.zs_cap),
        "quotient_cap": _hx_rows(proof.quotient_cap),
        "openings": {
            f"{tag}:{off}": _hx_rows(vals)
            for (tag, off), vals in proof.openings.values.items()
        },
        "fri": {
            "layer_caps": [_hx_rows(c) for c in proof.fri_proof.layer_caps],
            "final_poly": _hx_rows(proof.fri_proof.final_poly),
            "pow_witness": _hx(proof.fri_proof.pow_witness),
            "query_proofs": [
                {
                    "batch_leaves": {t: [_hx(v) for v in qp.batch_leaves[t]] for t in TAGS},
                    "batch_paths": {t: _hx_rows(np.asarray(qp.batch_paths[t])) for t in TAGS},
                    "layer_leaves": [[_hx(v) for v in leaf] for leaf in qp.layer_leaves],
                    "layer_paths": [_hx_rows(np.asarray(p)) for p in qp.layer_paths],
                }
                for qp in proof.fri_proof.query_proofs
            ],
        },
    }
    if include_indices:
        d["fri"]["query_indices"] = [int(i) for i in proof.fri_proof.query_indices]
    return d


def proof_from_dict(d: dict) -> Proof:
    """Inverse of proof_to_dict (requires query_indices present)."""

    def iv(h):
        return int(h, 16)

    def vec(vals):
        return np.array([iv(v) for v in vals], dtype=np.uint64)

    def arr(rows):
        return np.array([[iv(v) for v in row] for row in rows], dtype=np.uint64)

    openings = {}
    for key, rows in d["openings"].items():
        tag, off = key.split(":")
        openings[(tag, int(off))] = arr(rows)
    fri = d["fri"]
    qps = [
        FriQueryProof(
            batch_leaves={t: vec(qp["batch_leaves"][t]) for t in TAGS},
            batch_paths={t: list(arr(qp["batch_paths"][t])) for t in TAGS},
            layer_leaves=[vec(leaf) for leaf in qp["layer_leaves"]],
            layer_paths=[list(arr(p)) for p in qp["layer_paths"]],
        )
        for qp in fri["query_proofs"]
    ]
    return Proof(
        public_inputs=vec(d["public_inputs"]),
        wires_cap=arr(d["wires_cap"]),
        zs_cap=arr(d["zs_cap"]),
        quotient_cap=arr(d["quotient_cap"]),
        openings=OpeningSet(values=openings),
        fri_proof=FriProof(
            layer_caps=[arr(c) for c in fri["layer_caps"]],
            final_poly=arr(fri["final_poly"]),
            pow_witness=iv(fri["pow_witness"]),
            query_indices=list(fri["query_indices"]),
            query_proofs=qps,
        ),
    )


# ---------------------------------------------------------------------------
# Common data (the recursion-facing half of CircuitData) — plain JSON
# ---------------------------------------------------------------------------
#
# The in-circuit verifier (circuit/recursion.py) shapes itself from the
# inner circuit's config / log_n / gate set / public-input rows /
# k_shifts — the counterpart of plonky2's CommonCircuitData.  Encoding
# gates as (type, params) specs (circuit.gates.gate_to_spec) makes the
# artifact non-executable: nothing in it is unpickled or eval'd.


def _config_dict(cfg) -> dict:
    return {
        "num_wires": cfg.num_wires,
        "num_routed_wires": cfg.num_routed_wires,
        "num_constants": cfg.num_constants,
        "num_challenges": cfg.num_challenges,
        "permutation_chunk_size": cfg.permutation_chunk_size,
        "fri": {
            "rate_bits": cfg.fri.rate_bits,
            "cap_height": cfg.fri.cap_height,
            "proof_of_work_bits": cfg.fri.proof_of_work_bits,
            "num_query_rounds": cfg.fri.num_query_rounds,
            "final_poly_bits": cfg.fri.final_poly_bits,
        },
    }


def common_data_to_dict(data: CircuitData) -> dict:
    from ..circuit.gates import gate_to_spec

    return {
        "format": "eth-lc-plonky2-tpu/common-data/v1",
        "config": _config_dict(data.config),
        "log_n": data.log_n,
        "num_rows_used": data.num_rows_used,
        "gate_names": list(data.gate_names),
        "gates": [gate_to_spec(g) for g in data.gates],
        "public_input_targets": [[int(r), int(c)] for (r, c) in data.public_input_targets],
        "k_shifts": [_hx(v) for v in data.k_shifts],
    }


def common_data_from_dict(d: dict) -> CircuitData:
    """Rebuild a shape-only CircuitData (tables/generators absent): all
    the recursive verifier and witness setters need, nothing more."""
    from ..circuit.builder import Target
    from ..circuit.gates import gate_from_spec
    from .config import CircuitConfig, FriConfig

    c = d["config"]
    cfg = CircuitConfig(
        num_wires=c["num_wires"],
        num_routed_wires=c["num_routed_wires"],
        num_constants=c["num_constants"],
        num_challenges=c["num_challenges"],
        permutation_chunk_size=c["permutation_chunk_size"],
        fri=FriConfig(**c["fri"]),
    )
    gates = [gate_from_spec(s) for s in d["gates"]]
    assert [g.name for g in gates] == list(d["gate_names"]), "gate spec/name mismatch"
    return CircuitData(
        config=cfg,
        log_n=int(d["log_n"]),
        num_rows_used=int(d["num_rows_used"]),
        gate_names=list(d["gate_names"]),
        gates=gates,
        selectors=None,
        constants=None,
        sigma=None,
        rep=None,
        generators=[],
        public_input_targets=[Target(int(r), int(c2)) for r, c2 in d["public_input_targets"]],
        k_shifts=np.array([int(v, 16) for v in d["k_shifts"]], dtype=np.uint64),
    )


# ---------------------------------------------------------------------------
# Portable proof bundle (docs/proof_format.md)
# ---------------------------------------------------------------------------
#
# A self-contained JSON artifact: circuit description (incl. gate
# constraint polynomials as expression DAGs), verifier key, proof.
# Non-executable (no pickle) and verifiable WITHOUT this package by
# tools/verify_standalone.py — the second-implementation verifier.

BUNDLE_FORMAT = "eth-lc-plonky2-tpu/proof-bundle/v1"


def export_proof_bundle(path: str, data: CircuitData, vk, proof: Proof):
    """Write the portable JSON bundle for (circuit, vk, proof)."""
    from ..circuit.algebra import gate_expression

    bundle = {
        "format": BUNDLE_FORMAT,
        "config": _config_dict(data.config),
        "circuit": {
            "log_n": data.log_n,
            "gate_names": list(data.gate_names),
            "gates": [gate_expression(g) for g in data.gates],
            "wire_offsets": sorted(
                {off for g in data.gates for off in g.wire_offsets} | {0}
            ),
            "public_input_rows": [[int(r), int(c)] for (r, c) in data.public_input_targets],
        },
        "vk": {"pre_cap": _hx_rows(vk.pre_cap)},
        "proof": proof_to_dict(proof),
    }
    with open(path, "w") as f:
        json.dump(bundle, f)
