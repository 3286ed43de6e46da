"""The control of the judge, and the faults its tests plant.

The configuration states no precision: it states guarantees (the FRI query
count, the PoW bits, the rate, the statement).  The control breaks one of them,
the one a later change to the FRI phase would be tempted to trade for time: the
program proves with one FRI query fewer than the configuration states.  The
judge has to find every such proof wrong.

Each fault is a ``prove`` that the harness can run in the program's place.
"""

from __future__ import annotations

import copy
import dataclasses


def fewer_queries(pd, less: int = 1):
    """A shallow copy of ``pd`` whose circuit asks for ``less`` FRI queries
    fewer; every table and kernel of ``pd`` is shared."""
    cfg = pd.data.config
    data = copy.copy(pd.data)
    data.config = dataclasses.replace(
        cfg, fri=dataclasses.replace(cfg.fri, num_query_rounds=cfg.fri.num_query_rounds - less))
    weak = copy.copy(pd)
    weak.data = data
    return weak


def control_prove(pd, witness, prof=None):
    from eth_lc_plonky2_tpu_torch.prover import prove as pr

    return pr.prove(fewer_queries(pd), witness, prof=prof)


def stale_prove():
    """A prove that returns the state it was first given: every call after the
    first hands back the first proof."""
    from eth_lc_plonky2_tpu_torch.prover import prove as pr

    first = []

    def prove(pd, witness, prof=None):
        if not first:
            first.append(pr.prove(pd, witness, prof=prof))
        return first[0]

    return prove


def altered_prove(pd, witness, prof=None):
    """An answer altered where it is produced: one opened value of the wires
    off by one."""
    from eth_lc_plonky2_tpu_torch.prover import prove as pr

    proof = pr.prove(pd, witness, prof=prof)
    key = next(k for k in proof.openings.values if k[0] == "W")
    vals = proof.openings.values[key].copy()
    vals[0, 0] = (int(vals[0, 0]) + 1) % ((1 << 64) - (1 << 32) + 1)
    proof.openings.values[key] = vals
    return proof


def half_queries_prove(pd, witness, prof=None):
    """Half of the batch left out: the proof keeps the first half of its FRI
    query proofs."""
    from eth_lc_plonky2_tpu_torch.prover import prove as pr

    proof = pr.prove(pd, witness, prof=prof)
    half = len(proof.fri_proof.query_proofs) // 2
    proof.fri_proof.query_proofs = proof.fri_proof.query_proofs[:half]
    proof.fri_proof.query_indices = proof.fri_proof.query_indices[:half]
    return proof
