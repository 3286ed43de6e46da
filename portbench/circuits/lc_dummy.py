"""Set-up of the light-client update circuit with the dummy BLS inner proof
(``cli.run --synthetic N --bls dummy``'s circuit): the inner circuit and the
outer circuit, each built (or loaded from the circuit cache) and preprocessed,
and a witness for each of the traffic's distinct update pairs, each with its
own inner proof made on the card."""

from __future__ import annotations

import time

from portbench import program, updates


def circuit(config: dict, ctx) -> dict:
    """The inner circuit and the outer circuit that pins its key, each with its
    preprocess."""
    from eth_lc_plonky2_tpu_torch.circuit.builder import CircuitBuilder
    from eth_lc_plonky2_tpu_torch.models import bls as blsm
    from eth_lc_plonky2_tpu_torch.models import lc_circuit as lc
    from eth_lc_plonky2_tpu_torch.prover import prove as pr
    from eth_lc_plonky2_tpu_torch.prover.config import FriConfig

    size = config["committee_size"]
    inner_config = {**config, "name": config["name"] + ".inner"}
    inner, inner_pd, _, inner_s = program.cached_circuit(
        ctx, inner_config,
        lambda: (blsm.build_dummy_bls_circuit(size, fri=FriConfig(**config["inner_fri"])), None))
    inner_vk = pr.VerifierKey(pre_cap=inner_pd.pre_batch.cap)

    def build():
        b = CircuitBuilder(program.circuit_config(config))
        target = lc.add_virtual_proof_target(b, size, config["threshold"])
        bls_targets = blsm.absorb_bls_proofs(b, target, [inner], pin_vks=[inner_vk])
        b.register_public_inputs(target.cur_state)
        b.register_public_inputs(target.new_state)
        return b.build(), (target, bls_targets)

    data, pd, extras, outer_s = program.cached_circuit(ctx, config, build)
    return {"data": data, "pd": pd, "extras": extras, "inner": (inner, inner_pd, inner_vk),
            "seconds": inner_s + outer_s}


def setup(config: dict, traffic: dict, seed: int, ctx) -> dict:
    from eth_lc_plonky2_tpu_torch import cli
    from eth_lc_plonky2_tpu_torch.models import bls as blsm
    from eth_lc_plonky2_tpu_torch.prover import prove as pr

    pairs = [updates.make_update(updates.rng_for(seed, k), config["committee_size"],
                                 config["participation"])
             for k in range(traffic["distinct_witnesses"])]
    c = circuit(config, ctx)
    (target, bls_targets), (inner, inner_pd, inner_vk) = c["extras"], c["inner"]
    witnesses, raws = [], []
    t0 = time.perf_counter()
    for kwargs, raw in pairs:
        inner_witness = blsm.dummy_bls_witness(inner, kwargs["signing_root"], kwargs["signature"],
                                               kwargs["sync_committee_pubkeys"],
                                               kwargs["sync_committee_bits"])
        inner_proof = pr.prove(inner_pd, inner_witness)
        witnesses.append(cli.light_client_witness(c["data"], target, kwargs, bls_targets,
                                                  [(inner, inner_proof, inner_vk)]))
        raws.append(raw)
    witness_s = (time.perf_counter() - t0) / len(pairs)
    ctx.log(f"{len(pairs)} witnesses {witness_s:.3f} s each")
    return {"pd": c["pd"], "witnesses": witnesses, "raws": raws,
            "circuit_s": c["seconds"], "witness_gen_s": witness_s}
