"""A whole run of the harness on the CPU at a tiny size, in a fresh process:
the result line's keys, ``correct`` true, and no JAX, flax or JAX package
loaded.  The command itself fails without a card, and the reference imports
nothing of the program."""
import ast
import json
import os
import subprocess
import sys

from portbench import harness
from portbench.tests.tiny import REPO

_RUN = """
import json, sys, tempfile, time
sys.path.insert(0, {repo!r})
t = time.perf_counter()
from portbench import harness
from portbench.manifest import Manifest
from portbench.tests.tiny import tiny_root
root = tiny_root(tempfile.mkdtemp(), pool_batches={pool})
r = harness.run(Manifest.load(root), "random41.gappy.b16", 2**31 + 101, 0.5, {trace}, "cpu", t,
                lambda s: None)
print(json.dumps({{"result": r, "forbidden": harness.forbidden_loaded(),
                   "modules": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def _fresh(trace: bool):
    env = dict(os.environ, OMP_WAIT_POLICY="PASSIVE")
    proc = subprocess.run([sys.executable, "-c", _RUN.format(repo=REPO, trace=trace,
                                                             pool=3 if trace else 2)],
                          capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_a_tiny_run_on_the_cpu_is_correct_and_loads_no_jax():
    out = _fresh(trace=False)
    r = out["result"]
    assert out["forbidden"] == [] and "uuo_mocap_tpu_torch" in out["modules"]
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 2
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(r["metrics"]) == {"frames_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert set(r["checks"]) == {"structure", "score_gap", "residual_mm", "label_gap_mm",
                                "pick_gap_mm"}
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())


def test_a_tiny_traced_run_reports_the_per_layer_metrics_it_can_read():
    r = _fresh(trace=True)["result"]
    assert r["correct"] is True and list(r)[-1] == "checks"
    # the CPU has no device trace: those metrics are left out, not zero
    assert {"part_fit_s_per_solve", "chamfer_s_per_solve", "marker_s_per_solve",
            "orchestration_s_per_solve", "device_evals_per_solve",
            "ride_along_pct"} <= set(r["metrics"])
    assert not {"device_idle_pct", "nearest_roofline", "launches_per_solve",
                "peak_mem_gib"} & set(r["metrics"])
    assert r["device"]["window_s"] > 0 and r["breakdown"] == {"device_ops": [], "idle_gaps": []}


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "uuo_mocap_tpu_torch_extra", sys)
    assert "uuo_mocap_tpu" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
    assert "jaxlib" in harness.forbidden_loaded()


def test_the_command_fails_without_a_card_and_prints_no_result(tmp_path):
    proc = subprocess.run([sys.executable, os.path.join(REPO, "portbench", "run.py"), "--workload",
                           "random41.gappy.b16", "--seed", "3000000000", "--seconds", "1",
                           "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
                          timeout=300)
    if proc.returncode == 0:  # only on a machine with a card
        assert json.loads(proc.stdout.splitlines()[-1])["device"]["platform"] == "gpu"
        return
    assert proc.stdout.strip() == ""


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_reference_imports_nothing_of_the_program_or_jax():
    ref = os.path.join(REPO, "portbench", "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            tops = {m.split(".")[0] for m in _imports(os.path.join(ref, name))}
            assert not tops & {"uuo_mocap_tpu_torch", "uuo_mocap_tpu", "jax", "jaxlib", "flax"}, name


def test_only_the_adapter_imports_the_program():
    pb = os.path.join(REPO, "portbench")
    for dirpath, _, files in os.walk(pb):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                tops = {m.split(".")[0] for m in _imports(path)}
                assert not tops & {"uuo_mocap_tpu", "jax", "jaxlib", "flax"}, path
                if "uuo_mocap_tpu_torch" in tops:
                    assert os.path.relpath(path, pb) == "system.py", path


def test_calibration_reads_the_sound_solve_the_control_and_the_faults(tmp_path, capsys):
    from portbench import calibrate
    from portbench.tests.tiny import tiny_root

    root = tiny_root(str(tmp_path))
    assert calibrate.main(["--workload", "random41.gappy.b16", "--seeds", "5", "--faults", "1",
                           "--device", "cpu", "--root", root]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["lower"]["score_gap"] < summary["control_upper"]["score_gap"]
    assert summary["lower"]["residual_mm"] < summary["fault_upper"]["unchanged"]["residual_mm"]
    assert summary["fault_upper"]["altered_score"]["score_gap"] > 1e-3
