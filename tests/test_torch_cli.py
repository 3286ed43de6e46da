"""The port's CLI (``cli.py``) against the JAX package's: ``run`` at
``--synthetic 4 --bls dummy`` with a reduced FRI and ``skip_prove`` on the
CPU gives the JAX package's gate counts, rows, degree and public inputs;
``--bls artifacts=DIR`` reloads the inner proof the dummy run saved; ``main``
prints the JAX package's report; ``main`` takes ``--bls aggregate`` and
``--bls aggregate:slices=N`` and asks the synthetic generator for keys on the
curve in both (the JAX package's CLI does only for the unsliced mode, so its
sliced mode draws random bytes that the aggregate circuit refuses); a bad
slice count is refused; and without ``--device`` the CLI asks for the card,
raising where there is none, before any work."""

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
    # skip_prove: no key, no proof
    assert set(keep) == {"data", "witness", "target", "bls_targets", "bls_inners"}


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


class _Stop(Exception):
    pass


def _asked(monkeypatch, module, main, mode: str, extra: list) -> dict:
    """The keyword arguments ``main`` gives ``make_synthetic_update_pair`` of
    ``module`` for ``--bls mode``, stopping there."""
    asked = {}

    def record(size, **kw):
        asked.update(kw)
        raise _Stop

    monkeypatch.setattr(module, "make_synthetic_update_pair", record)
    with pytest.raises(_Stop):
        main(["--synthetic", "4", "--bls", mode] + extra)
    return asked


@pytest.mark.parametrize("mode,on_curve", [("aggregate", True), ("aggregate:slices=2", True),
                                           ("aggregate:slices=4", True), ("dummy", False)])
def test_main_asks_for_keys_on_the_curve_in_every_aggregate_mode(monkeypatch, mode, on_curve):
    assert _asked(monkeypatch, synthetic, cli.main, mode, ["--device", "cpu"]) == {
        "seed": 0, "valid_pubkeys": on_curve}


def test_the_jax_clis_sliced_mode_draws_keys_off_the_curve(monkeypatch):
    """The JAX package's fault, kept out of the port: its ``main`` asks for keys
    on the curve only for the unsliced mode, so ``--bls aggregate:slices=2``
    gets random bytes, which ``decompress_g1`` refuses; the port asks for keys
    on the curve."""
    assert _asked(monkeypatch, jsyn, jcli.main, "aggregate:slices=2", [])["valid_pubkeys"] is False
    assert _asked(monkeypatch, jsyn, jcli.main, "aggregate", [])["valid_pubkeys"] is True
    assert _asked(monkeypatch, synthetic, cli.main, "aggregate:slices=2",
                  ["--device", "cpu"])["valid_pubkeys"] is True
    monkeypatch.undo()
    from eth_lc_plonky2_tpu.models import bls_aggregate as jagg
    from eth_lc_plonky2_tpu_torch.models import bls_aggregate as agg

    random_keys = jsyn.make_synthetic_update_pair(4, seed=0).witness_kwargs["sync_committee_pubkeys"]
    refused = 0
    for pk in random_keys:
        try:
            jagg.decompress_g1(bytes(pk))
        except ValueError:
            refused += 1
    assert refused > 0
    for pk in synthetic.make_synthetic_update_pair(4, seed=0, valid_pubkeys=True).witness_kwargs[
            "sync_committee_pubkeys"]:
        agg.decompress_g1(bytes(pk))


@pytest.mark.parametrize("mode", ["aggregate:slices=0", "aggregate:slices=x",
                                  "aggregate:slices=-2", "aggregate:slices="])
def test_main_refuses_a_bad_slice_count(mode):
    with redirect_stdout(io.StringIO()), pytest.raises(SystemExit):
        cli.main(["--synthetic", "4", "--bls", mode, "--device", "cpu", "--skip-prove"])


def test_run_refuses_slices_that_do_not_divide_the_committee(monkeypatch):
    from eth_lc_plonky2_tpu_torch.models import bls_aggregate

    def no_work(*args, **kw):
        raise AssertionError("the aggregate circuit was built")

    monkeypatch.setattr(bls_aggregate, "build_aggregate_bls_circuit", no_work)
    syn = synthetic.make_synthetic_update_pair(4, seed=0, valid_pubkeys=True)
    with pytest.raises(ValueError, match="3 slices do not divide the committee of 4"):
        cli.run(syn.witness_kwargs, 4, syn.threshold, bls_mode="aggregate:slices=3",
                device="cpu", out=io.StringIO(), **REDUCED)


def test_without_a_device_the_cli_asks_for_the_card(monkeypatch):
    """The default device is the card: with none, run() and main() raise a
    clear error before any work instead of running on the CPU."""
    from eth_lc_plonky2_tpu_torch.models import bls, bls_aggregate

    def no_work(*args, **kw):
        raise AssertionError("an inner circuit was built")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bls_aggregate, "build_aggregate_bls_circuit", no_work)
    monkeypatch.setattr(bls, "build_dummy_bls_circuit", no_work)
    syn = synthetic.make_synthetic_update_pair(2, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.run(syn.witness_kwargs, 2, syn.threshold, out=io.StringIO(), **REDUCED)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--synthetic", "2", "--skip-prove"])
    syn = synthetic.make_synthetic_update_pair(8, seed=0, valid_pubkeys=True)
    for mode in ("dummy", "aggregate:slices=8"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.run(syn.witness_kwargs, 8, syn.threshold, bls_mode=mode, out=io.StringIO(),
                    **REDUCED)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["--synthetic", "8", "--bls", mode])


@pytest.mark.parametrize("argv", [["--synthetic", "1"], ["--synthetic", "2", "--bls", "bogus"],
                                  ["--synthetic", "2", "--device", "tpu"], []])
def test_bad_arguments_exit(argv):
    with pytest.raises(SystemExit):
        cli.main(argv)
