"""Configurations, traffic mixes, limits and per-layer metrics are found
by the names in BENCHMARK.json: a new one is a new file and a new entry."""

import json
import shutil

import pytest

from benchmark import spec
from benchmark.reference import config as ref_config
from benchmark.reference.eskf.pipeline import EskfConfig


def test_the_configurations_are_the_port_s_unreduced():
    doc = spec.benchmark_doc()
    for c in doc["configs"]:
        conf = spec.load_json(spec.ROOT / c["file"])
        assert conf["reduced"] == c["reduced"] == []
        assert spec.vio_config(ref_config, conf) == ref_config.euroc_config()
    eskf = spec.load_json(spec.ROOT / "benchmark/configs/eskf_euroc.json")
    assert spec.build_dataclass(EskfConfig, eskf["eskf"]) == EskfConfig()


def test_every_cell_resolves(tmp_path):
    doc = spec.benchmark_doc()
    for w in doc["workloads"]:
        c = spec.cell(w["name"])
        assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
        assert len(c.end_to_end) >= 2 and c.per_layer
        for m in c.per_layer:
            assert callable(spec.metric_reader(m["name"]))
        assert set(c.limits) >= {"start_gap", "pos_gap_m"}


def test_a_cell_mix_and_metric_added_as_files_are_found(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests", "reference"))
    doc = spec.benchmark_doc()
    conf = spec.load_json(root / "benchmark/configs/msckf_euroc.json")
    conf["vio"]["filter"]["max_cam_state_size"] = 30
    (root / "benchmark/configs/msckf_euroc_w30.json").write_text(json.dumps(conf))
    mix = spec.load_json(root / "benchmark/traffic/offline_b16.json")
    mix["sequences"] = 8
    (root / "benchmark/traffic/offline_b8.json").write_text(json.dumps(mix))
    (root / "benchmark/limits/w30.offline.b8.json").write_text(
        json.dumps({"start_gap": 0.0, "pos_gap_m": 1e-3}))
    (root / "benchmark/metrics/answer.py").write_text("def read(ctx):\n    return 42.0\n")
    doc["configs"].append(dict(name="msckf_euroc_w30", source="x",
                               file="benchmark/configs/msckf_euroc_w30.json",
                               reduced=[], why="x"))
    doc["workloads"].append(dict(name="w30.offline.b8", config="msckf_euroc_w30",
                                 traffic="offline_b8", chips=1, why="x"))
    doc["per_layer"].append(dict(name="answer.fps", unit="%", better="higher",
                                 source="program_counter", layer="x", moves="agg_fps",
                                 workloads=["w30.offline.b8"]))
    doc["end_to_end"][0]["workloads"].append("w30.offline.b8")
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    c = spec.cell("w30.offline.b8", here=root / "benchmark")
    assert c.config["vio"]["filter"]["max_cam_state_size"] == 30
    assert c.traffic["sequences"] == 8
    assert [m["name"] for m in c.end_to_end] == ["agg_fps", "setup_s"]
    assert [m["name"] for m in c.per_layer] == ["answer.fps"]
    assert spec.metric_reader("answer.fps", here=root / "benchmark")({}) == 42.0
    with pytest.raises(KeyError):
        spec.cell("no.such.cell", here=root / "benchmark")
    with pytest.raises(KeyError):
        spec.metric_reader("no_such_metric.fps", here=root / "benchmark")
