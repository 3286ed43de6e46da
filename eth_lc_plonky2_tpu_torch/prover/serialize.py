"""Proof serialization: non-executable JSON with hex-string field elements.

Port of the proof half of ``eth_lc_plonky2_tpu/prover/serialize.py``
(``proof_to_dict``, ``proof_from_dict``, ``save_proof``, ``load_proof``); the
dict of a proof equals the JAX package's key for key.  The circuit cache
and the portable proof bundle are not ported.
"""

from __future__ import annotations

import json

import numpy as np

from .fri import TAGS, FriProof, FriQueryProof
from .prove import OpeningSet, Proof


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
