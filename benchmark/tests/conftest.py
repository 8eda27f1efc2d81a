"""A tiny copy of the benchmark's manifest, for running whole cells on the
CPU: the same cells, traffic and limits by name, with the configurations
cut to a size the CPU solves in seconds (N=16) and the traffic cut to
match."""

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]

TINY_CONFIGS = {"deuteron_regular_n160": {"n": 16}}
TINY_TRAFFIC = {"eigsh_k20": {"kwargs": {"k": 4, "n": 60, "which": "SA"}}}


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiny")
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    (root / "benchmark").mkdir()
    shutil.copytree(REPO / "benchmark" / "limits", root / "benchmark" / "limits")
    (root / "benchmark" / "configs").mkdir()
    (root / "benchmark" / "traffic").mkdir()
    for c in manifest["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        cfg.update(TINY_CONFIGS[c["name"]])
        (root / c["file"]).write_text(json.dumps(cfg))
    for w in manifest["workloads"]:
        path = REPO / "benchmark" / "traffic" / f"{w['traffic']}.json"
        traffic = json.loads(path.read_text())
        traffic.update(TINY_TRAFFIC[w["traffic"]])
        (root / "benchmark" / "traffic" / path.name).write_text(json.dumps(traffic))
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return root
