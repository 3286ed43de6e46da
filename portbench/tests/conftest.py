"""The benchmark's own tests, run from the repository's root:

    python -m pytest portbench/tests -q

The one test that needs the card carries the ``cuda`` marker and skips
elsewhere; it runs on the card with the same command."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def toy_root(tmp_path):
    """A checkout-like directory: a BENCHMARK.json of one toy cell, and a copy
    of the benchmark's directory with the toy's configuration, set-up module,
    statement and frozen circuit added as files."""
    from portbench.tests import toy_bench

    return toy_bench.make(tmp_path)
