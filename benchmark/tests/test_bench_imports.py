"""Nothing the benchmark loads is JAX or the JAX package: a walk of its
sources' imports, the run-time check by whole top-level names, and the
command's refusals without a card and without the program."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from benchmark import core

HERE = Path(__file__).resolve().parents[1]


def imported_top_levels(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_jax_or_the_jax_package():
    sources = sorted(HERE.rglob("*.py"))
    assert len(sources) > 20
    for path in sources:
        assert not imported_top_levels(path) & set(core.FORBIDDEN), path


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "lanczos_tpu_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert core.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "lanczos_tpu.solver", sys)
    assert "lanczos_tpu" in core.forbidden_modules()


def run_command(cwd, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "regular_n160.eigsh_k20", "--seed", "3000000000", "--seconds", "1",
                           "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_refuses_without_a_card():
    out = run_command(HERE.parent, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_refuses_without_the_program(tmp_path):
    shutil.copy(HERE.parent / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "benchmark", ignore=shutil.ignore_patterns("_traces"))
    out = run_command(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
    assert json.loads((tmp_path / "BENCHMARK.json").read_text())["paths"] == ["benchmark"]
