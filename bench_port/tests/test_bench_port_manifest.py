"""BENCHMARK.json and the files it names: every cell, configuration, traffic, limit and
metric file exists, loads and names only files that exist, within the contract's limits."""
import importlib
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench_port"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def test_manifest_shape():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["command"][:2] == ["python3", "bench_port/run.py"]
    assert MANIFEST["paths"] == ["bench_port"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    names = [x["name"] for x in MANIFEST["configs"] + MANIFEST["workloads"] + METRICS]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in METRICS)
    assert {m["name"] for m in MANIFEST["end_to_end"]} >= {"setup_s"}
    assert all(0.01 <= m["bound"] <= 0.25 for m in MANIFEST["end_to_end"])
    assert len(json.dumps(MANIFEST)) < 64 * 1024


@pytest.mark.parametrize("cell", MANIFEST["workloads"], ids=lambda c: c["name"])
def test_cell_files(cell):
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    assert cell["config"] in configs and cell["chips"] in (1, 4)
    assert (ROOT / configs[cell["config"]]["file"]).is_file()
    traffic = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    assert (BENCH / "modes" / f"{traffic['mode']}.py").is_file()
    limits = json.loads((BENCH / "limits" / f"{cell['name']}.json").read_text())
    mode = importlib.import_module(f"bench_port.modes.{traffic['mode']}")
    assert set(limits) == set(mode.NUMBERS)
    assert all(v > 0 for v in limits.values())
    assert (BENCH / "roofline" / f"{cell['config']}.json").is_file()
    assert len(cell["why"]) <= 200


@pytest.mark.parametrize("config", MANIFEST["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    data = json.loads((ROOT / config["file"]).read_text())
    assert data["name"] == config["name"] and data["source"] and data["assumed"]
    assert {"system", "dbas", "environment", "cost_nominal", "cost_auxiliary",
            "adaptation"} <= set(data["values"])
    assert config["file"].startswith("bench_port/")


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_readers(metric):
    reader = importlib.import_module(f"bench_port.metrics.{metric['name']}")
    assert reader.read({}) is None
    if "moves" in metric:
        assert metric["moves"] in {m["name"] for m in MANIFEST["end_to_end"]}
        assert metric["layer"] and "\n" not in metric["layer"]
