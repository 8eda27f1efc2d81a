"""The SciPy race of the port's north star: ``scripts/northstar_scipy_torch.py``
(SciPy's run) and ``scripts/merge_race_torch.py`` (the pairing).

* The race's L at n_fine=24 is the JAX package's (``scripts/northstar.py:
  build_graph_laplacian_rows``, assembled as ``scripts/northstar_scipy.py``
  assembles it): the same sparse matrix, exactly.
* A run ends ``done`` with its true residuals; SIGTERM ends one ``killed``
  with the lower bound the process measured itself.
* The merge claims ``speedup_vs_scipy`` only for a finished SciPy run of the
  same problem (``num_points``, ``k``, ``tol``) beside a port run whose
  refinement completed; otherwise a lower bound from SciPy's own record, or
  nothing.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import scipy.sparse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import merge_race_torch  # noqa: E402
import northstar_scipy_torch  # noqa: E402


def jax_laplacian(n_fine):
    from northstar import build_graph_laplacian_rows

    lat, nbrs, _, _, deg, _ = build_graph_laplacian_rows(n_fine, 3)
    p = lat.num_points
    rows = np.repeat(np.arange(p, dtype=np.int64), nbrs.shape[1])
    cols = nbrs.reshape(-1)
    valid = cols >= 0
    A = scipy.sparse.csr_matrix(
        (np.ones(valid.sum(), dtype=np.float64), (rows[valid], cols[valid])), shape=(p, p))
    return scipy.sparse.diags(deg) - A


def test_laplacian_is_the_jax_scripts():
    L = northstar_scipy_torch.laplacian(24)
    ref = jax_laplacian(24)
    assert L.shape == ref.shape and L.shape[0] == 2176
    assert abs(L - ref).max() == 0.0
    assert abs(L - L.T).max() == 0.0


def test_run_ends_done_with_true_residuals(tmp_path):
    out = tmp_path / "scipy24.json"
    info = northstar_scipy_torch.run(n_fine=24, k=20, tol=1e-10, out=str(out))
    with open(out) as f:
        rec = json.load(f)
    assert rec == json.loads(json.dumps(info))
    assert rec["status"] == "done" and rec["num_points"] == 2176 and rec["k"] == 20
    assert rec["scipy_eigsh_s"] > 0 and rec["started_unix"] > 0
    assert rec["host_cores"]["cpu_count"] >= rec["host_cores"]["sched_affinity"] >= 1
    assert rec["host_ram_gib"] > 0
    assert abs(rec["eigenvalues_head"][0]) < 1e-10  # L's null vector
    assert rec["true_residual_max"] < 1e-8 and rec["pairs_below_1e-8"] == 20
    vals = np.linalg.eigvalsh(jax_laplacian(24).toarray())[:10]
    np.testing.assert_allclose(rec["eigenvalues_head"], vals, rtol=0, atol=1e-10)


def test_killed_writer_records_a_lower_bound(tmp_path):
    out = tmp_path / "killed.json"
    started = time.monotonic() - 5.0
    rec = northstar_scipy_torch.write_killed(str(out), {"num_points": 7, "k": 3, "tol": 1e-8},
                                             started, signal.SIGTERM)
    with open(out) as f:
        assert json.load(f) == rec
    assert rec["status"] == "killed" and rec["signal"] == "SIGTERM"
    assert 5.0 <= rec["elapsed_lower_bound_s"] < 60.0
    assert rec["num_points"] == 7


def test_sigterm_ends_a_run_killed(tmp_path):
    """A real run stopped by SIGTERM once it reports ``running``: it exits
    non-zero and leaves a ``killed`` record with its own elapsed time."""
    out = tmp_path / "race.json"
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "scripts", "northstar_scipy_torch.py"),
         "--n-fine", "96", "--out", str(out)],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and proc.poll() is None:
            if out.exists():
                with open(out) as f:
                    if json.load(f)["status"] == "running":
                        break
            time.sleep(0.2)
        time.sleep(1.0)
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=120)
    finally:
        proc.kill()
    assert proc.returncode == 128 + signal.SIGTERM, err
    with open(out) as f:
        rec = json.load(f)
    assert rec["status"] == "killed" and rec["signal"] == "SIGTERM"
    assert rec["elapsed_lower_bound_s"] >= 1.0 and rec["num_points"] == 139264


PORT = {"num_points": 1000, "k": 100, "tol": 1e-8, "t_solve_s": 10.0, "refine_completed": True,
        "card": "NVIDIA H100 80GB HBM3, 700.00 W", "true_residual_max": 5e-9,
        "pairs_below_1e-8": 100}
SCIPY_DONE = {"num_points": 1000, "k": 100, "tol": 1e-8, "status": "done",
              "scipy_eigsh_s": 95.0, "host_cores": {"cpu_count": 8, "sched_affinity": 8},
              "pairs_below_1e-8": 100}


def test_merge_claims_a_speedup_for_the_same_finished_problem():
    e = merge_race_torch.compare(PORT, SCIPY_DONE)
    assert e["speedup_vs_scipy"] == pytest.approx(9.5)
    assert e["port_total_s"] == 10.0 and e["port_card"] == PORT["card"]
    assert e["port_pairs_below_1e-8"] == 100 and e["scipy_pairs_below_1e-8"] == 100
    assert "k=100" in e["note"] and "speedup_lower_bound" not in e
    e = merge_race_torch.compare({**PORT, "k": 20}, {**SCIPY_DONE, "k": 20})
    assert "k=20" in e["note"] and "k=100" not in e["note"]


@pytest.mark.parametrize("status,field", [("killed", "elapsed_lower_bound_s"),
                                          ("running", "elapsed_s")])
def test_merge_gives_only_a_lower_bound_for_an_unfinished_run(status, field):
    sc = {key: v for key, v in SCIPY_DONE.items() if key != "scipy_eigsh_s"}
    sc.update(status=status, started_unix=1.0, **{field: 40.0})
    e = merge_race_torch.compare(PORT, sc)
    assert "speedup_vs_scipy" not in e
    assert e["scipy_elapsed_lower_bound_s"] == 40.0
    assert e["speedup_lower_bound"] == pytest.approx(4.0)  # from the record, not the clock


@pytest.mark.parametrize("key,value", [("k", 20), ("num_points", 999), ("tol", 1e-6)])
def test_merge_refuses_different_problems(key, value):
    e = merge_race_torch.compare(PORT, {**SCIPY_DONE, key: value})
    assert "speedup_vs_scipy" not in e and "speedup_lower_bound" not in e
    assert key in e["not_compared"]


def test_merge_refuses_an_unrefined_port_run():
    e = merge_race_torch.compare({**PORT, "refine_completed": False}, SCIPY_DONE)
    assert "speedup_vs_scipy" not in e and "refinement" in e["not_compared"]


def test_merge_cli_writes_both_entries(tmp_path):
    paths = {}
    for name, rec in (("port", PORT), ("scipy", SCIPY_DONE),
                      ("big", {**SCIPY_DONE, "status": "killed", "scipy_eigsh_s": None,
                               "elapsed_lower_bound_s": 500.0})):
        paths[name] = tmp_path / f"{name}.json"
        paths[name].write_text(json.dumps(rec))
    art = tmp_path / "artifact.json"
    art.write_text(json.dumps(PORT))  # the port's large run is the artifact
    merge_race_torch.main([str(art), "--same-size", str(paths["port"]), str(paths["scipy"]),
                           "--big-scipy", str(paths["big"])])
    info = json.loads(art.read_text())
    assert info["same_size_race"]["speedup_vs_scipy"] == pytest.approx(9.5)
    big = info["scipy_baseline_large"]
    assert big["status"] == "killed" and big["race"]["speedup_lower_bound"] == pytest.approx(50.0)
    new = tmp_path / "new.json"
    small = tmp_path / "small.json"
    small.write_text(json.dumps({**SCIPY_DONE, "num_points": 10, "n_fine": 24}))
    merge_race_torch.main([str(new), "--same-size", str(paths["port"]), str(paths["scipy"]),
                           "--same-size", str(paths["port"]), str(small)])
    info = json.loads(new.read_text())
    assert set(info) == {"same_size_race", "same_size_race_n24"}
    assert "num_points" in info["same_size_race_n24"]["not_compared"]
