"""A new configuration, traffic mix or metric is picked up from its file,
found by the name an entry gives it, with no edit to the harness."""
import json
import os

from portbench.manifest import Manifest, reader
from portbench.tests.tiny import tiny_root


def test_a_new_cell_with_new_configuration_and_traffic_files(tmp_path):
    root = tiny_root(str(tmp_path))
    pb = os.path.join(root, "portbench")
    with open(os.path.join(pb, "configs", "video_mocap.random41.json")) as f:
        config = json.load(f)
    config["name"] = "video_mocap.random41x"
    with open(os.path.join(pb, "configs", "video_mocap.random41x.json"), "w") as f:
        json.dump(config, f)
    with open(os.path.join(pb, "traffic", "gappy.b16.json")) as f:
        traffic = json.load(f)
    traffic.update(name="gappy.b3", sequences_per_solve=3)
    with open(os.path.join(pb, "traffic", "gappy.b3.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(pb, "limits", "random41x.gappy.b3.json"), "w") as f:
        json.dump({"structure": {"limit": 0}, "score_gap": {"limit": 1}, "residual_mm": {"limit": 1}},
                  f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append(dict(bench["configs"][0], name="video_mocap.random41x",
                                 file="portbench/configs/video_mocap.random41x.json"))
    bench["workloads"].append({"name": "random41x.gappy.b3", "config": "video_mocap.random41x",
                               "traffic": "gappy.b3", "chips": 1, "why": "a test cell"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    man = Manifest.load(root)
    cell = man.cell("random41x.gappy.b3")
    assert man.config(cell["config"])["name"] == "video_mocap.random41x"
    assert man.traffic(cell["traffic"])["sequences_per_solve"] == 3
    assert man.limits("random41x.gappy.b3")["score_gap"]["limit"] == 1
    names = [m["name"] for m in man.metrics_for("random41x.gappy.b3", "per_layer")]
    assert names == []  # the existing per-layer metrics list their cells


def test_a_new_metric_reader_file(tmp_path):
    (tmp_path / "solves_per_window.py").write_text(
        "def read(record):\n    return float(len(record['solves'])) or None\n")
    read = reader("solves_per_window", str(tmp_path))
    assert read({"solves": [{}, {}]}) == 2.0
    assert read({"solves": []}) is None


def test_metrics_without_workloads_reach_every_cell(tmp_path):
    root = tiny_root(str(tmp_path))
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["per_layer"].append({"name": "x", "unit": "s", "better": "lower", "source": "host_clock",
                               "layer": "device", "moves": "frames_per_s"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    man = Manifest.load(root)
    for w in bench["workloads"]:
        assert "x" in [m["name"] for m in man.metrics_for(w["name"], "per_layer")]
