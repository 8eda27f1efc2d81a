"""A cell added by data alone: another traffic of the same entry on the
regular configuration, made of a traffic file, a limits file and a
workload entry, runs through the unchanged harness."""

import json
import shutil

from benchmark import core, manifest


def test_a_new_cell_needs_only_files_and_entries(tiny_root, tmp_path):
    root = tmp_path / "extended"
    shutil.copytree(tiny_root, root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "regular_n160.eigsh_k6_n40", "config": "deuteron_regular_n160",
                               "traffic": "eigsh_k6_n40", "chips": 1, "why": "a shallower solve"})
    idle = next(m for m in bench["per_layer"] if m["name"] == "device.idle_pct")
    idle["workloads"].append("regular_n160.eigsh_k6_n40")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "benchmark" / "traffic" / "eigsh_k6_n40.json").write_text(json.dumps({
        "entry": "eigsh", "kwargs": {"k": 6, "n": 40, "which": "SA"}, "reference": "lanczos",
        "check_solves": 2, "trace_solves": 1}))
    shutil.copy(root / "benchmark" / "limits" / "regular_n160.eigsh_k20.json",
                root / "benchmark" / "limits" / "regular_n160.eigsh_k6_n40.json")
    assert manifest.validate(bench, root) == []
    line, code = core.run("regular_n160.eigsh_k6_n40", 2**33 + 5, 0.2, False, root=root,
                          device="cpu", log=lambda msg: None)
    assert code == 0 and line["correct"], line["checks"]
    assert set(line["metrics"]) == {"solve_s", "solve_p95_s", "setup_s"}
