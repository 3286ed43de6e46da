"""The judge of a run's proofs: the frozen verifier with the configuration's
frozen circuit and verification key, and the statement worked out again from
the inputs.  Standard library only; it reads the program's proofs only in the
proof format (``docs/proof_format.md``) and never imports the program.
"""

from __future__ import annotations

import json
from pathlib import Path

from portbench.reference.verifier import VerificationError, verify_bundle

HERE = Path(__file__).resolve().parent


def frozen_circuit(name: str, root: Path = HERE) -> dict:
    """The configuration's frozen format tag, config, circuit and vk."""
    with open(root / "circuits" / f"{name}.json") as f:
        return json.load(f)


def verify_proof(frozen: dict, proof: dict) -> str | None:
    """None when the proof verifies against the frozen circuit and key, else
    why not (a malformed proof is rejected, not raised)."""
    bundle = {key: frozen[key] for key in ("format", "config", "circuit", "vk")}
    bundle["proof"] = proof
    try:
        verify_bundle(bundle)
    except (VerificationError, KeyError, IndexError, ValueError, TypeError, ZeroDivisionError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def public_inputs(proof: dict) -> list:
    return [int(v, 16) for v in proof["public_inputs"]]
