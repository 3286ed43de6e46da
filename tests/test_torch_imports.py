"""The port imports neither jax nor the JAX package: the card it runs on has no jax."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import eth_lc_plonky2_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "eth_lc_plonky2_tpu"
             or m.startswith("eth_lc_plonky2_tpu."))
want = {"circuit.algebra", "circuit.builder", "circuit.gates", "convert", "ops.goldilocks",
        "ops.goldilocks_ext", "ops.host_field", "ops.kernels", "ops.ntt", "ops.poseidon",
        "prover.config", "prover.fri", "prover.merkle", "prover.profiler", "prover.prove",
        "prover.serialize", "prover.transcript", "ops.sha256", "circuit.gadgets_u32",
        "circuit.gadgets_sha256", "circuit.gadgets_merkle", "circuit.gates_sha256",
        "circuit.gates_poseidon", "prover.verify"}
missing = sorted(want - {n.split(".", 1)[1] for n in names})
print(len(names), bad, missing)
sys.exit(1 if bad or missing else 0)
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_port_sources_name_no_jax_import():
    """No module of the port, and not chip_smoke.py, has an import statement for
    jax or for the JAX package (the probe above shows that none happens)."""
    import re

    pattern = re.compile(r"^\s*(from|import)\s+(jax|eth_lc_plonky2_tpu)(\.|\s|$)", re.M)
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "eth_lc_plonky2_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(paths) >= 28
    for path in paths:
        with open(path) as f:
            assert not pattern.search(f.read()), path
