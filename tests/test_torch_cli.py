"""The port's CLI (``cli.py``) against the JAX package's: ``run`` at
``--synthetic 4 --bls dummy`` with a reduced FRI and ``skip_prove`` on the
CPU gives the JAX package's gate counts, rows, degree and public inputs;
``--bls artifacts=DIR`` reloads the inner proof the dummy run saved; ``main``
prints the JAX package's report; ``--bls aggregate`` raises the error that
names ROADMAP A5; and without ``--device`` the CLI asks for the card, raising
where there is none."""

import io
import json
from contextlib import redirect_stdout

import pytest
import torch

from eth_lc_plonky2_tpu import cli as jcli
from eth_lc_plonky2_tpu.eth import synthetic as jsyn
from eth_lc_plonky2_tpu_torch import cli
from eth_lc_plonky2_tpu_torch.eth import synthetic

torch.set_num_threads(1)

SIZE = 4
REDUCED = dict(pow_bits=4, query_rounds=4, skip_prove=True)
SAME = ("gate_counts", "rows_used", "degree_bits")


def _pi_states(keep) -> tuple:
    """(cur_state, new_state) hex from the generated witness's public inputs."""
    w, data = keep["witness"], keep["data"]
    return cli._public_inputs_hex([w.get(t) for t in data.public_input_targets])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    saved = str(tmp_path_factory.mktemp("bls"))
    syn = synthetic.make_synthetic_update_pair(SIZE, seed=3)
    keep = {}
    report = cli.run(syn.witness_kwargs, SIZE, syn.threshold, bls_mode="dummy", bls_save_dir=saved,
                     out=io.StringIO(), device="cpu", keep=keep, **REDUCED)
    jsy = jsyn.make_synthetic_update_pair(SIZE, seed=3)
    jreport = jcli.run(jsy.witness_kwargs, SIZE, jsy.threshold, bls_mode="dummy",
                       out=io.StringIO(), **REDUCED)
    return syn, report, keep, jsy, jreport, saved


def test_run_reports_equal_the_jax_packages(runs):
    syn, report, keep, jsy, jreport, _ = runs
    assert {k: report[k] for k in SAME} == {k: jreport[k] for k in SAME}
    assert (report["rows_used"], report["degree_bits"]) == (9341, 14)
    cur, new = _pi_states(keep)
    assert (cur, new) == (jsy.cur_state.hex(), jsy.new_state.hex())
    assert (cur, new) == (syn.cur_state.hex(), syn.new_state.hex())
    assert set(keep) == {"data", "witness", "bls_inners"}  # skip_prove: no key, no proof


def test_artifacts_mode_reloads_the_dummy_inner_proof(runs):
    syn, report, keep, _, _, saved = runs
    again = {}
    got = cli.run(syn.witness_kwargs, SIZE, syn.threshold, bls_mode=f"artifacts={saved}",
                  out=io.StringIO(), device="cpu", keep=again, **REDUCED)
    assert {k: got[k] for k in SAME} == {k: report[k] for k in SAME}
    assert (again["witness"].full_matrix() == keep["witness"].full_matrix()).all()


ARGS = ["--pow-bits", "4", "--query-rounds", "4", "--skip-prove", "--json"]


def test_main_prints_the_jax_packages_report():
    outs = []
    for main, extra in ((cli.main, ["--device", "cpu"]), (jcli.main, [])):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert main(["--synthetic", "4", "--seed", "1"] + ARGS + extra) == 0
        outs.append(json.loads(buf.getvalue().strip().splitlines()[-1]))
    keys = SAME + ("committee_size", "witness_s")
    assert set(outs[0]) == set(outs[1]) and set(keys) <= set(outs[0])
    assert {k: outs[0][k] for k in SAME} == {k: outs[1][k] for k in SAME}


def test_committee_two_fails_witness_generation_in_both_packages():
    """The JAX package's CLI takes --synthetic 2 but its witness conflicts
    (the port keeps that behaviour; ROADMAP C)."""
    for main, extra in ((cli.main, ["--device", "cpu"]), (jcli.main, [])):
        with redirect_stdout(io.StringIO()), pytest.raises(ValueError, match="conflicting"):
            main(["--synthetic", "2"] + ARGS + extra)


@pytest.mark.parametrize("mode", ["aggregate", "aggregate:slices=2"])
def test_bls_aggregate_raises_the_roadmap_error(mode):
    syn = synthetic.make_synthetic_update_pair(2, seed=0)
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        cli.run(syn.witness_kwargs, 2, syn.threshold, bls_mode=mode, device="cpu", **REDUCED)
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        cli.main(["--synthetic", "2", "--bls", mode, "--device", "cpu", "--skip-prove"])


def test_without_a_device_the_cli_asks_for_the_card(monkeypatch):
    """The default device is the card: with none, run() and main() raise a
    clear error before any work instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    syn = synthetic.make_synthetic_update_pair(2, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.run(syn.witness_kwargs, 2, syn.threshold, out=io.StringIO(), **REDUCED)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--synthetic", "2", "--skip-prove"])


@pytest.mark.parametrize("argv", [["--synthetic", "1"], ["--synthetic", "2", "--bls", "bogus"],
                                  ["--synthetic", "2", "--device", "tpu"], []])
def test_bad_arguments_exit(argv):
    with pytest.raises(SystemExit):
        cli.main(argv)
