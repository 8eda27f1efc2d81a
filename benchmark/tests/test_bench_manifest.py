"""BENCHMARK.json against the benchmark's rules, and every file it names
found by name."""

import copy
import json
import shutil

import pytest

from benchmark import manifest


@pytest.fixture
def bench():
    return manifest.load()


def test_manifest_is_valid(bench, tiny_root):
    assert manifest.validate(bench) == []
    assert manifest.validate(manifest.load(tiny_root), tiny_root) == []
    assert len(json.dumps(bench)) < 64 * 1024
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= bench["run_seconds"] <= 51


def test_every_file_is_found_by_name(bench):
    for w in bench["workloads"]:
        cell = manifest.Cell(bench, w["name"])
        assert cell.config["kind"]
        manifest.module("systems", cell.config["kind"])
        manifest.module("reference", cell.config["kind"])
        assert callable(manifest.module("reference", cell.traffic["reference"]).solve)
        assert cell.traffic["entry"] and cell.limits
        for m in cell.end_to_end + cell.per_layer:
            assert callable(manifest.module("metrics", m["name"]).read)


def test_each_moved_metric_is_reported_where_listed(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        for w in m.get("workloads", [c["name"] for c in bench["workloads"]]):
            assert w in e2e[m["moves"]].get("workloads", [w])


@pytest.mark.parametrize("edit, breach", [
    (lambda b: b["workloads"][0].update(name="has space"), "workload name"),
    (lambda b: b["end_to_end"][0].update(unit="s per solve"), "unit"),
    (lambda b: b["end_to_end"][0].update(unit="µs"), "unit"),
    (lambda b: b["per_layer"][0].update(moves="nothing"), "moves unknown"),
    (lambda b: b["per_layer"][0].update(name="no_reader"), "no reader"),
    (lambda b: b["workloads"][0].update(traffic="missing"), "no traffic file"),
    (lambda b: b["end_to_end"][0].update(bound=0.5), "bound"),
    (lambda b: b["end_to_end"][0].update(source="program_counter"), "source"),
    (lambda b: b["configs"][0].update(file="benchmark/configs/none.json"), "missing"),
    (lambda b: b["workloads"].append(dict(b["workloads"][0])), "duplicate"),
    (lambda b: b["workloads"][0].update(traffic="eigsh_plain_missing"), "no plain reference"),
])
def test_breaches_are_found(bench, edit, breach, tmp_path):
    bad = copy.deepcopy(bench)
    edit(bad)
    root = manifest.ROOT
    if breach == "no plain reference":  # a traffic file naming no reference module
        root = tmp_path
        shutil.copytree(manifest.ROOT / "benchmark" / "configs", tmp_path / "benchmark" / "configs")
        shutil.copytree(manifest.ROOT / "benchmark" / "limits", tmp_path / "benchmark" / "limits")
        (tmp_path / "benchmark" / "traffic").mkdir()
        (tmp_path / "benchmark" / "traffic" / "eigsh_plain_missing.json").write_text(
            json.dumps({"entry": "eigsh", "kwargs": {}, "reference": "no_such_algorithm"}))
    assert any(breach in e for e in manifest.validate(bad, root)), manifest.validate(bad, root)
