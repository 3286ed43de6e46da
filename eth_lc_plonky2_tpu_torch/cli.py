"""End-to-end entry point (layers L7/L8): upstream's `main.rs` flow.

  load update pair -> compute domain + signing root -> build the full
  light-client circuit -> register cur/new ContractState roots as
  public inputs -> set witness -> build -> prove -> verify -> report
  gate counts / degree / timings.

Port of ``eth_lc_plonky2_tpu/cli.py``, which follows upstream's main.rs:
31-234.  Input comes from light-client-update JSON files of the fixture
schema, a beacon RPC node, or the synthetic generator.  The BLS sub-proof
(main.rs:172, starky_bls12_381::aggregate_proof) is a pluggable inner-proof
provider; with `--bls dummy` a stand-in inner circuit with the exact
targets.rs:471-482 PI layout is proven and absorbed in-circuit through the
recursion layer (verify_proof_circuit), binding signing root / signature /
pubkeys / participation bits index-for-index.  With `--bls aggregate`
the inner circuit also proves the BLS12-381 aggregate public key of the
participating members (models/bls_aggregate.py); `aggregate:slices=N`
splits the committee into N slices, proved with one shared preprocess
and all absorbed by the outer circuit.

The proofs run on the card (`--device cuda`, the default); `--device cpu`
runs the plain PyTorch versions of every kernel.  Verification runs on the
host.  ELP_PROFILE=1 prints each proof's phase times as one ``ELP_PROFILE``
JSON line on stdout, and ELP_PHASE_LOG=1 as well each phase's start on stderr
(prover/profiler.py).

Usage:
  python -m eth_lc_plonky2_tpu_torch.cli --synthetic 512 --bls dummy
  python -m eth_lc_plonky2_tpu_torch.cli --synthetic 512 --bls aggregate:slices=8
  python -m eth_lc_plonky2_tpu_torch.cli --synthetic 8 --bls dummy --device cpu
  ELP_PROFILE=1 ELP_PHASE_LOG=1 python -m eth_lc_plonky2_tpu_torch.cli --synthetic 512 --bls dummy
  python -m eth_lc_plonky2_tpu_torch.cli --cur-update PATH --new-update PATH
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def aggregate_slices(bls_mode: str | None) -> int | None:
    """The slice count of an aggregate --bls mode (1 for plain
    'aggregate'), None for any other mode; ValueError for a bad count."""
    if bls_mode == "aggregate":
        return 1
    if not (bls_mode and bls_mode.startswith("aggregate:slices=")):
        return None
    text = bls_mode.split("=", 1)[1]
    if not text.isdigit() or int(text) < 1:
        raise ValueError(f"--bls {bls_mode}: the slice count must be a positive integer")
    return int(text)


def _gate_counts(data) -> dict:
    counts = data.selectors.sum(axis=1)
    return {name: int(c) for name, c in zip(data.gate_names, counts)}


def _public_inputs_hex(pi_values: np.ndarray) -> tuple[str, str]:
    """16 u32 limbs -> (cur_state, new_state) 32-byte hex roots."""
    limbs = [int(v) for v in pi_values]
    cur = b"".join(int(l).to_bytes(4, "big") for l in limbs[:8])
    new = b"".join(int(l).to_bytes(4, "big") for l in limbs[8:16])
    return cur.hex(), new.hex()


def witness_from_updates(cur_update, new_update):
    """Map a (cur, new) light-client update pair to set_proof_target
    kwargs — the exact assembly of main.rs:84-169 (cur_* from the prev
    update's finality/committee data, signing committee = prev update's
    next_sync_committee, rollover roots from the new update's branch)."""
    from .eth import ssz
    from .eth.domain import (
        DOMAIN_SYNC_COMMITTEE,
        compute_domain,
        compute_signing_root,
        fork_version_at_slot,
    )

    att = new_update.attested_header
    fin = new_update.finalized_header
    domain = compute_domain(DOMAIN_SYNC_COMMITTEE, fork_version_at_slot(att.slot))
    signing_root = compute_signing_root(att.tree_hash_root(), domain)

    cur_slot = cur_update.finalized_header.slot
    cur_header = cur_update.finalized_header.tree_hash_root()
    cur_sync_committee_i = cur_update.next_sync_committee_branch[0]
    cur_sync_committee_ii = cur_update.next_sync_committee.tree_hash_root()
    new_sync_committee_i = new_update.next_sync_committee_branch[0]
    new_sync_committee_ii = new_update.next_sync_committee.tree_hash_root()

    cur_state = ssz.contract_state_root(cur_slot, cur_header, cur_sync_committee_i, cur_sync_committee_ii)
    new_state = ssz.contract_state_root(
        fin.slot, fin.tree_hash_root(), new_sync_committee_i, new_sync_committee_ii
    )
    return dict(
        signing_root=signing_root,
        domain=domain,
        attested_slot=att.slot,
        attested_proposer_index=att.proposer_index,
        attested_parent_root=att.parent_root,
        attested_state_root=att.state_root,
        attested_body_root=att.body_root,
        finalized_slot=fin.slot,
        finalized_proposer_index=fin.proposer_index,
        finalized_parent_root=fin.parent_root,
        finalized_state_root=fin.state_root,
        finalized_body_root=fin.body_root,
        finality_branch=new_update.finality_branch,
        cur_state=cur_state,
        new_state=new_state,
        cur_slot=cur_slot,
        cur_header=cur_header,
        cur_sync_committee_i=cur_sync_committee_i,
        cur_sync_committee_ii=cur_sync_committee_ii,
        new_sync_committee_i=new_sync_committee_i,
        new_sync_committee_ii=new_sync_committee_ii,
        sync_committee_bits=new_update.sync_committee_bits,
        new_sync_committee_ii_branch=new_update.next_sync_committee_branch,
        sync_committee_pubkeys=cur_update.next_sync_committee.pubkeys,
        sync_committee_aggregate=cur_update.next_sync_committee.aggregate_pubkey,
        signature=new_update.sync_committee_signature,
    ), cur_state, new_state


def light_client_witness(data, target, witness_kwargs: dict, bls_targets=None,
                         bls_inners=None):
    """The generated witness of the light-client circuit for one update pair,
    with the inner BLS proofs (one a slice) set on their absorbing targets.
    Host work only: no tensor is made."""
    from .models import bls as blsm
    from .models import lc_circuit as lc

    w = data.new_witness()
    lc.set_proof_target(w, target, **witness_kwargs)
    if bls_targets is not None:
        for (pt_t, vd_t), (_, inner_proof, inner_vk) in zip(bls_targets, bls_inners):
            blsm.set_bls_proof_target(w, pt_t, vd_t, inner_proof, inner_vk)
    w.generate()
    return w


def run(
    witness_kwargs: dict,
    committee_size: int,
    threshold: int | None = None,
    pow_bits: int = 16,
    query_rounds: int = 28,
    skip_prove: bool = False,
    cache_dir: str | None = None,
    save_proof_path: str | None = None,
    export_bundle_path: str | None = None,
    bls_mode: str | None = None,
    bls_save_dir: str | None = None,
    out=sys.stdout,
    device: str = "cuda",
    keep: dict | None = None,
) -> dict:
    """Build, witness, prove and verify the light-client circuit; returns the
    report.  The proofs run on ``device``: the card by default, where a
    missing card raises before any work; ``"cpu"`` runs the plain versions.
    When ``keep`` is a dict, the objects made are put into it (``data``,
    ``witness``, ``target``, ``bls_targets``, ``pd``, ``vk``, ``proof``,
    ``bls_inners``) so that a caller can make witnesses and prove again; with
    ``skip_prove``, ``pd`` and ``vk`` are there only when the circuit came
    from ``cache_dir``."""
    import torch

    from .circuit.builder import CircuitBuilder
    from .models import bls as blsm
    from .models import lc_circuit as lc
    from .prover import prove as pr
    from .prover import serialize as ser
    from .prover.config import CircuitConfig, FriConfig
    from .prover.verify import verify

    num_slices = aggregate_slices(bls_mode)
    if num_slices is not None and committee_size % num_slices:
        raise ValueError(f"--bls {bls_mode}: {num_slices} slices do not divide the "
                         f"committee of {committee_size}")
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "cli.run proves on the card by default and this machine has no CUDA "
            "device; pass device='cpu' (--device cpu) for the plain versions"
        )
    if keep is None:
        keep = {}
    report: dict = {"committee_size": committee_size}

    # num_wires=184: wide enough for the batched SHA-256 segment gate
    cfg = CircuitConfig(
        num_wires=184,
        fri=FriConfig(proof_of_work_bits=pow_bits, num_query_rounds=query_rounds),
    )

    # BLS sub-proof (main.rs:172): with --bls dummy, prove a stand-in
    # inner circuit with the exact targets.rs:471-482 PI layout and
    # absorb it in-circuit via the recursion layer; with
    # --bls artifacts=DIR, load offline-produced inner artifacts from
    # files (the affordance upstream's README documents).
    bls_inners = None  # list of (CircuitData, proof, VerifierKey), one per slice
    if bls_mode == "dummy" or num_slices is not None:
        t0 = time.time()
        inner_fri = FriConfig(proof_of_work_bits=min(pow_bits, 8),
                              num_query_rounds=min(query_rounds, 12))
        inner_args = [witness_kwargs[k] for k in ("signing_root", "signature",
                                                  "sync_committee_pubkeys",
                                                  "sync_committee_bits")]
        if num_slices is not None:
            # in-circuit aggregate-pubkey: the ec_aggregate_pk half of
            # starky_bls12_381 (main.rs:172-176), same digest layout.  ONE
            # circuit (the slice identity is a witness wire pinned by the
            # outer digest), so one build / preprocess / vk serves every slice
            from .models import bls_aggregate as blsa

            bls_data = blsa.build_aggregate_bls_circuit(
                committee_size, fri=inner_fri,
                num_slices=num_slices,
                slice_size=committee_size // num_slices,
                num_wires=cfg.num_wires,  # share kernel shapes with the app circuit
            )
            print(f"BLS aggregate circuit built: {bls_data.num_rows_used} rows, "
                  f"2^{bls_data.log_n} (+{time.time() - t0:.1f}s)", file=out)
            bls_inners = []
            bls_pd = bls_vk = None
            for si in range(num_slices):
                bls_proof, bls_vk, bls_pd = blsa.prove_aggregate_bls(
                    bls_data, *inner_args, slice_index=si, pd=bls_pd, vk=bls_vk,
                    device=device,
                )
                bls_inners.append((bls_data, bls_proof, bls_vk))
                print(f"BLS aggregate slice {si + 1}/{num_slices} proven "
                      f"(+{time.time() - t0:.1f}s)", file=out)
        else:
            bls_data = blsm.build_dummy_bls_circuit(committee_size, fri=inner_fri)
            bls_proof, bls_vk = blsm.prove_dummy_bls(bls_data, *inner_args, device=device)
            bls_inners = [(bls_data, bls_proof, bls_vk)]
        report["bls_inner_prove_s"] = round(time.time() - t0, 3)
        print(f"BLS inner proof(s) ({bls_mode} wrapper) in {report['bls_inner_prove_s']}s", file=out)
        if bls_save_dir:
            if len(bls_inners) == 1:
                blsm.save_bls_artifacts(bls_save_dir, *bls_inners[0])
            else:
                for si, triple in enumerate(bls_inners):
                    blsm.save_bls_artifacts(os.path.join(bls_save_dir, f"slice_{si}"), *triple)
            print(f"BLS inner artifacts saved to {bls_save_dir}", file=out)
    elif bls_mode and bls_mode.startswith("artifacts="):
        t0 = time.time()
        adir = bls_mode.split("=", 1)[1]
        slice_dirs = sorted(
            d for d in (os.listdir(adir) if os.path.isdir(adir) else [])
            if d.startswith("slice_")
        )
        if slice_dirs:
            bls_inners = [blsm.load_bls_artifacts(os.path.join(adir, d)) for d in slice_dirs]
        else:
            bls_inners = [blsm.load_bls_artifacts(adir)]
        report["bls_artifacts_load_s"] = round(time.time() - t0, 3)
        print(f"BLS inner artifacts loaded in {report['bls_artifacts_load_s']}s", file=out)

    pd = vk = target = data = None
    bls_targets = None
    # BLS-absorbing circuits are cached too, keyed on a digest of the
    # inner circuits' identity (vk cap + shape) — a different inner
    # artifact set gets its own cache entry.
    inner_digest = None
    if bls_inners is not None:
        inner_digest = ser.cache_key(
            "bls_inner",
            *[
                part
                for (inner_data, _, inner_vk) in bls_inners
                for part in (
                    inner_vk.pre_cap.tobytes(),
                    inner_data.config,
                    inner_data.log_n,
                    tuple(inner_data.gate_names),
                    len(inner_data.public_input_targets),
                )
            ],
        )
    key = ser.cache_key("lc_circuit", committee_size, threshold, cfg, inner_digest)
    if cache_dir and ser.has_cached_circuit(cache_dir, key):
        t0 = time.time()
        extras, data, pd, vk = ser.load_circuit(ser.cache_dir_for(cache_dir, key), device=device)
        target, bls_targets = extras
        report["build_s"] = report["preprocess_s"] = 0.0
        report["cache_load_s"] = round(time.time() - t0, 3)
        report["cache"] = "hit"
        print(f"circuit cache hit ({report['cache_load_s']}s)", file=out)
    else:
        t0 = time.time()
        b = CircuitBuilder(cfg)
        target = lc.add_virtual_proof_target(b, committee_size, threshold)
        if bls_inners is not None:
            bls_targets = blsm.absorb_bls_proofs(
                b, target,
                [d for (d, _, _) in bls_inners],
                pin_vks=[v for (_, _, v) in bls_inners],
            )
        b.register_public_inputs(target.cur_state)
        b.register_public_inputs(target.new_state)
        data = b.build()
        report["build_s"] = round(time.time() - t0, 3)
    report["gate_counts"] = _gate_counts(data)
    report["rows_used"] = data.num_rows_used
    report["degree_bits"] = data.log_n  # main.rs:228 "degree - {}"
    print(f"gate counts: {report['gate_counts']}", file=out)
    print(f"degree - {data.log_n} ({data.num_rows_used} rows used)", file=out)

    t0 = time.time()
    w = light_client_witness(data, target, witness_kwargs, bls_targets, bls_inners)
    report["witness_s"] = round(time.time() - t0, 3)
    print(f"witness generated in {report['witness_s']}s", file=out)
    if cache_dir:
        # a valid witness for this circuit (a bench's full-circuit steady
        # prove can load it; NOT keyed by update inputs)
        t0 = time.time()
        os.makedirs(ser.cache_dir_for(cache_dir, key), exist_ok=True)
        np.savez_compressed(
            os.path.join(ser.cache_dir_for(cache_dir, key), "witness.npz"),
            values=w.values, known=w.known,
        )
        print(f"witness cached in {round(time.time() - t0, 1)}s", file=out)

    keep.update(data=data, witness=w, target=target, bls_targets=bls_targets,
                bls_inners=bls_inners)
    if pd is not None:  # loaded from cache_dir
        keep.update(pd=pd, vk=vk)
    if skip_prove:
        return report

    if pd is None:
        t0 = time.time()
        pd, vk = pr.preprocess(data, device=device)
        report["preprocess_s"] = round(time.time() - t0, 3)
        if cache_dir:
            t0 = time.time()
            ser.save_circuit(
                ser.cache_dir_for(cache_dir, key), data, pd,
                extras=(target, bls_targets),
            )
            report["cache_save_s"] = round(time.time() - t0, 3)
            print(f"circuit cached in {report['cache_save_s']}s", file=out)

    t0 = time.time()
    proof = pr.prove(pd, w)
    report["prove_s"] = round(time.time() - t0, 3)
    keep.update(pd=pd, vk=vk, proof=proof)
    print(f"proved in {int(report['prove_s'] * 1000)}ms", file=out)  # main.rs:232

    if save_proof_path:
        ser.save_proof(save_proof_path, proof)
        proof = ser.load_proof(save_proof_path)  # verify the round-tripped proof
        print(f"proof saved to {save_proof_path}", file=out)

    if export_bundle_path:
        t0 = time.time()
        ser.export_proof_bundle(export_bundle_path, data, vk, proof)
        report["bundle_export_s"] = round(time.time() - t0, 3)
        print(f"proof bundle exported to {export_bundle_path} "
              f"(verify: python tools/verify_standalone.py {export_bundle_path})",
              file=out)

    t0 = time.time()
    verify(data, vk, proof)
    report["verify_s"] = round(time.time() - t0, 3)
    print(f"verified in {int(report['verify_s'] * 1000)}ms", file=out)

    cur_hex, new_hex = _public_inputs_hex(proof.public_inputs)
    report["cur_state"] = cur_hex
    report["new_state"] = new_hex
    if cur_hex != witness_kwargs["cur_state"].hex():
        raise SystemExit(
            f"public-input mismatch: proof cur_state 0x{cur_hex} != host SSZ "
            f"0x{witness_kwargs['cur_state'].hex()}"
        )
    if new_hex != witness_kwargs["new_state"].hex():
        raise SystemExit(
            f"public-input mismatch: proof new_state 0x{new_hex} != host SSZ "
            f"0x{witness_kwargs['new_state'].hex()}"
        )
    print(f"public inputs: cur_state=0x{cur_hex} new_state=0x{new_hex}", file=out)
    return report


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--cur-update", help="light-client update JSON for the current period")
    p.add_argument("--new-update", help="light-client update JSON for the next period")
    p.add_argument("--rpc", metavar="RPC_YAML",
                   help="fetch the update pair live from a beacon RPC node "
                        "(2-key yaml: finality_update_rpc, light_client_rpc; "
                        "main.rs:34-56 parity)")
    p.add_argument("--synthetic", type=int, metavar="N",
                   help="prove a synthetic consistent update pair with an N-member committee")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--pow-bits", type=int, default=16)
    p.add_argument("--query-rounds", type=int, default=28)
    p.add_argument("--skip-prove", action="store_true", help="build circuit + witness only")
    p.add_argument("--json", action="store_true", help="emit the report as one JSON line")
    p.add_argument("--cache-dir", help="directory for built-circuit/preprocess caching")
    p.add_argument("--save-proof",
                   help="write the proof here as non-executable hex-JSON "
                        "(and verify the reloaded copy)")
    p.add_argument("--export-bundle", dest="export_bundle",
                   help="write the portable JSON proof bundle here "
                        "(docs/proof_format.md; verifiable by "
                        "tools/verify_standalone.py with zero dependencies)")
    p.add_argument("--bls", dest="bls_mode", metavar="dummy|aggregate|artifacts=DIR",
                   help="absorb a BLS sub-proof in-circuit via the recursion layer: "
                        "'dummy' proves a stand-in inner circuit with the "
                        "targets.rs:471-482 bound-value layout in-process; "
                        "'aggregate[:slices=N]' proves the in-circuit BLS12-381 "
                        "aggregate public key of the participating members "
                        "(the ec_aggregate_pk half of starky_bls12_381; needs real "
                        "curve points), optionally as N slices of the committee; "
                        "'artifacts=DIR' loads offline-produced inner artifacts "
                        "(circuit.json + proof.json + vk.json, all non-executable)")
    p.add_argument("--bls-save", dest="bls_save_dir", metavar="DIR",
                   help="with --bls dummy or aggregate: also write the inner "
                        "artifacts to DIR (one slice_<i> directory a slice when "
                        "there are several)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the proofs run: the card (default) or the plain "
                        "PyTorch versions on the CPU")
    args = p.parse_args(argv)
    if args.bls_mode and args.bls_mode not in ("dummy", "aggregate") and not (
        args.bls_mode.startswith("artifacts=") or args.bls_mode.startswith("aggregate:slices=")
    ):
        p.error("--bls must be 'dummy', 'aggregate[:slices=N]', or 'artifacts=DIR'")
    try:
        aggregate = aggregate_slices(args.bls_mode) is not None
    except ValueError as e:
        p.error(str(e))

    if args.synthetic is not None:
        if args.synthetic < 2:
            p.error("--synthetic N requires N >= 2 (power of two)")
        from .eth.synthetic import make_synthetic_update_pair

        # every aggregate mode needs committee keys on the curve (the JAX
        # package's CLI asks for them only for the unsliced 'aggregate')
        syn = make_synthetic_update_pair(args.synthetic, seed=args.seed,
                                         valid_pubkeys=aggregate)
        witness_kwargs = syn.witness_kwargs
        committee_size, threshold = syn.committee_size, syn.threshold
    elif args.rpc:
        from .eth.rpc import fetch_update_pair, load_rpc_config

        cur_u, new_u = fetch_update_pair(load_rpc_config(args.rpc))
        witness_kwargs, _, _ = witness_from_updates(cur_u, new_u)
        committee_size, threshold = 512, None
    elif args.cur_update and args.new_update:
        from .eth.lc_update import load_update

        cur_u = load_update(args.cur_update)
        new_u = load_update(args.new_update)
        witness_kwargs, _, _ = witness_from_updates(cur_u, new_u)
        committee_size, threshold = 512, None
    else:
        p.error("provide --synthetic N, --rpc RPC_YAML, or both --cur-update and --new-update")

    report = run(
        witness_kwargs,
        committee_size,
        threshold,
        pow_bits=args.pow_bits,
        query_rounds=args.query_rounds,
        skip_prove=args.skip_prove,
        cache_dir=args.cache_dir,
        save_proof_path=args.save_proof,
        export_bundle_path=args.export_bundle,
        bls_mode=args.bls_mode,
        bls_save_dir=args.bls_save_dir,
        device=args.device,
    )
    if args.json:
        print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
