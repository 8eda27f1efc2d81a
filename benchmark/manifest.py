"""``BENCHMARK.json`` and the files it names, found by name.

* a configuration: ``benchmark/configs/<config>.json`` (the ``file`` entry);
* a traffic mix: ``benchmark/traffic/<traffic>.json``, the parameters that
  ``core.py``'s one generator reads;
* a cell's limits on the numbers that decide ``correct``:
  ``benchmark/limits/<cell>.json``;
* a system kind (how a configuration becomes the program's operator):
  ``benchmark/systems/<kind>.py``; its plain reference:
  ``benchmark/reference/<kind>.py``;
* the plain float64 form of a traffic's algorithm, named by the traffic's
  ``reference`` key: ``benchmark/reference/<name>.py``;
* a metric: ``benchmark/metrics/<metric>.py``, with ``read(record)`` and,
  for a metric that measures something of its own after the window,
  ``probe(context)``.

:func:`validate` checks the manifest against the benchmark's rules on
names, units and cross references; the tests run it.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

__all__ = ["HERE", "ROOT", "load", "Cell", "module", "validate"]

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}


def load(root=ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path):
    with open(path) as f:
        return json.load(f)


def module(kind: str, name: str):
    """The module ``benchmark/<kind>/<name>.py``, loaded from its file (a
    metric's name may hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(f"benchmark.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of the manifest with everything its files hold."""

    def __init__(self, manifest: dict, name: str, root=ROOT):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
        self.name = name
        self.entry = cells[name]
        cfg = {c["name"]: c for c in manifest["configs"]}[self.entry["config"]]
        self.config = _json(Path(root) / cfg["file"])
        base = Path(root) / "benchmark"
        self.traffic = _json(base / "traffic" / f"{self.entry['traffic']}.json")
        self.limits = _json(base / "limits" / f"{name}.json")
        self.chips = int(self.entry["chips"])
        self.end_to_end = [m for m in manifest["end_to_end"] if self._has(m)]
        self.per_layer = [m for m in manifest["per_layer"] if self._has(m)]

    def _has(self, metric) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]


def validate(manifest: dict, root=ROOT) -> list:
    """Every breach of the manifest's rules found, as strings."""
    errs = []
    names = set()
    e2e = {m["name"]: m for m in manifest.get("end_to_end", [])}
    cells = {w["name"]: w for w in manifest.get("workloads", [])}
    configs = {c["name"]: c for c in manifest.get("configs", [])}
    for kind, items in (("config", manifest.get("configs", [])),
                        ("workload", manifest.get("workloads", [])),
                        ("metric", [*manifest.get("end_to_end", []),
                                    *manifest.get("per_layer", [])])):
        for it in items:
            if not NAME.match(it["name"]):
                errs.append(f"{kind} name {it['name']!r}")
            if (kind, it["name"]) in names:
                errs.append(f"duplicate {kind} {it['name']!r}")
            names.add((kind, it["name"]))
    for c in configs.values():
        if not (Path(root) / c["file"]).is_file():
            errs.append(f"config file {c['file']} missing")
        if not all(NAME.match(k) for k in c["reduced"]):
            errs.append(f"reduced keys of {c['name']}")
    for w in cells.values():
        if w["config"] not in configs:
            errs.append(f"{w['name']}: no config {w['config']!r}")
        if not NAME.match(w["traffic"]):
            errs.append(f"{w['name']}: traffic name")
        for kind, stem in (("traffic", w["traffic"]), ("limits", w["name"])):
            if not (Path(root) / "benchmark" / kind / f"{stem}.json").is_file():
                errs.append(f"{w['name']}: no {kind} file {stem}.json")
        traffic = Path(root) / "benchmark" / "traffic" / f"{w['traffic']}.json"
        if traffic.is_file() and not (HERE / "reference" / f"{_json(traffic)['reference']}.py").is_file():
            errs.append(f"{w['name']}: no plain reference of its traffic's algorithm")
        if w["chips"] not in (1, 4):
            errs.append(f"{w['name']}: chips")
        if not 1 <= len(w["why"]) <= 200:
            errs.append(f"{w['name']}: why")
        reported = [m for m in e2e.values() if w["name"] in m.get("workloads", [w["name"]])]
        if "setup_s" not in [m["name"] for m in reported] or len(reported) < 2:
            errs.append(f"{w['name']}: needs setup_s and another end-to-end metric")
        if not any(w["name"] in m.get("workloads", [w["name"]])
                   for m in manifest.get("per_layer", [])):
            errs.append(f"{w['name']}: no per-layer metric")
    for m in [*e2e.values(), *manifest.get("per_layer", [])]:
        if not UNIT.match(m["unit"]) or m["better"] not in ("lower", "higher"):
            errs.append(f"{m['name']}: unit or better")
        if m["source"] not in (SOURCES_E2E if m["name"] in e2e else SOURCES):
            errs.append(f"{m['name']}: source {m['source']}")
        if not (HERE / "metrics" / f"{m['name']}.py").is_file():
            errs.append(f"{m['name']}: no reader metrics/{m['name']}.py")
        for w in m.get("workloads", []):
            if w not in cells:
                errs.append(f"{m['name']}: unknown workload {w}")
    for m in e2e.values():
        if not 0.01 <= m["bound"] <= 0.25:
            errs.append(f"{m['name']}: bound {m['bound']}")
    for m in manifest.get("per_layer", []):
        moved = e2e.get(m["moves"])
        if moved is None:
            errs.append(f"{m['name']}: moves unknown {m['moves']!r}")
            continue
        for w in m.get("workloads", list(cells)):
            if w not in moved.get("workloads", [w]):
                errs.append(f"{m['name']}: {w} does not report {m['moves']}")
        if "\n" in m["layer"] or not 1 <= len(m["layer"]) <= 200:
            errs.append(f"{m['name']}: layer")
    return errs
