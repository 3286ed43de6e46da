"""Nothing the benchmark runs imports JAX or the JAX package, and the reference
imports nothing of the program.  Module names are compared whole by their top
level: the port's name begins with the JAX package's."""

import ast
import subprocess
import sys

import pytest

from portbench.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "eth_lc_plonky2_tpu"}
PROGRAM = "eth_lc_plonky2_tpu_torch"


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _files(*dirs):
    for d in dirs:
        yield from sorted(p for p in d.rglob("*.py") if "tests" not in p.relative_to(ROOT).parts[1:])


@pytest.mark.parametrize("tree", ["portbench", PROGRAM])
def test_no_jax_in_what_a_run_imports(tree):
    """Every source a run can import: the benchmark's and the program's."""
    bad = [(str(p.relative_to(ROOT)), name) for p in _files(ROOT / tree)
           for name in _imports(p) if name in FORBIDDEN]
    assert bad == []


def test_reference_imports_nothing_of_the_program():
    allowed_local = {"portbench"}
    for p in _files(ROOT / "portbench" / "reference"):
        for name in _imports(p):
            assert name not in FORBIDDEN | {PROGRAM}, (p, name)
            if name in allowed_local:
                text = p.read_text()
                assert "portbench.reference" in text and "portbench import" not in text, p


def test_reference_loads_alone():
    """Importing every module of the reference (the judge and each statement
    module) loads no module of the program, of JAX or of the JAX package,
    compared by whole top-level name."""
    modules = sorted(p.stem for p in (ROOT / "portbench" / "reference").glob("*.py"))
    code = (
        "import sys, importlib\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for m in {modules!r}: importlib.import_module('portbench.reference.' + m)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True).stdout
    loaded = set(eval(out))
    assert not loaded & (FORBIDDEN | {PROGRAM, "torch", "numpy"})


def test_a_run_checks_sys_modules(monkeypatch):
    from portbench import harness

    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert harness.forbidden_modules() == ["jaxlib.xla_client"]
    monkeypatch.delitem(sys.modules, "jaxlib.xla_client")
    assert all(n.split(".")[0] not in harness.FORBIDDEN for n in harness.forbidden_modules())
