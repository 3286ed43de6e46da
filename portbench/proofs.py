"""The program's proofs as the judge reads them.

``to_plain`` writes a proof in the proof format of ``docs/proof_format.md``
(hex strings of field elements), which the frozen verifier reads;
``digest`` is a SHA-256 of every field of a proof, so that proofs of one
witness can be compared byte for byte.  Both read only the proof object's
public fields.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

TAGS = ("P", "W", "Z", "Q")


def _hx(v) -> str:
    return hex(int(v))


def _rows(arr) -> list:
    return [[_hx(v) for v in row] for row in np.asarray(arr)]


def to_plain(proof) -> dict:
    fri = proof.fri_proof
    return {
        "public_inputs": [_hx(v) for v in proof.public_inputs],
        "wires_cap": _rows(proof.wires_cap),
        "zs_cap": _rows(proof.zs_cap),
        "quotient_cap": _rows(proof.quotient_cap),
        "openings": {f"{tag}:{off}": _rows(vals) for (tag, off), vals in proof.openings.values.items()},
        "fri": {
            "layer_caps": [_rows(c) for c in fri.layer_caps],
            "final_poly": _rows(fri.final_poly),
            "pow_witness": _hx(fri.pow_witness),
            "query_proofs": [
                {
                    "batch_leaves": {t: [_hx(v) for v in qp.batch_leaves[t]] for t in TAGS},
                    "batch_paths": {t: _rows(np.asarray(qp.batch_paths[t])) for t in TAGS},
                    "layer_leaves": [[_hx(v) for v in leaf] for leaf in qp.layer_leaves],
                    "layer_paths": [_rows(np.asarray(p)) for p in qp.layer_paths],
                }
                for qp in fri.query_proofs
            ],
        },
    }


def _feed(h, obj) -> None:
    if isinstance(obj, np.ndarray):
        h.update(f"a{obj.dtype.str}{obj.shape}".encode())
        h.update(np.ascontiguousarray(obj).tobytes())
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            h.update(f.name.encode())
            _feed(h, getattr(obj, f.name))
    elif isinstance(obj, dict):
        h.update(b"d%d" % len(obj))
        for key in sorted(obj, key=repr):
            h.update(repr(key).encode())
            _feed(h, obj[key])
    elif isinstance(obj, (list, tuple)):
        h.update(b"l%d" % len(obj))
        for item in obj:
            _feed(h, item)
    elif isinstance(obj, (int, np.integer)):
        h.update(b"i%d" % int(obj))
    else:
        raise TypeError(f"cannot digest a {type(obj).__name__} in a proof")


def digest(proof) -> str:
    h = hashlib.sha256()
    _feed(h, proof)
    return h.hexdigest()
