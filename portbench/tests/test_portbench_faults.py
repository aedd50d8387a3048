"""The check catches the timed path broken underneath: a whole run at the
tiny size with each fault of ``portbench/faults.py`` in place of the solve
reads ``correct`` false, and so does the control, the reference in TF32
in the program's place; the sound solve reads it true."""
import tempfile
import time

import pytest

from portbench import faults, harness, system
from portbench.manifest import Manifest
from portbench.tests.tiny import tiny_root


@pytest.fixture(scope="module")
def manifest():
    return Manifest.load(tiny_root(tempfile.mkdtemp()))


def _run(manifest, solve, control=False):
    return harness.run(manifest, "random41.gappy.b16", 2**31 + 55, 0.5, False, "cpu",
                       time.perf_counter(), lambda s: None, solve=solve, control=control)


def test_the_sound_solve_is_correct(manifest):
    assert _run(manifest, system.solve)["correct"] is True


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_each_fault_is_not_correct(manifest, fault):
    r = _run(manifest, faults.FAULTS[fault])
    assert r["correct"] is False and r["failed"] >= 1
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


def test_the_tf32_control_is_not_correct(manifest):
    r = _run(manifest, system.solve, control=True)
    assert r["correct"] is False and r["failed"] >= 1
    assert r["checks"]["score_gap"]["value"] > r["checks"]["score_gap"]["limit"]
