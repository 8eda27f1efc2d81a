"""Pair the port's north-star runs with SciPy's into one artifact.

The port's counterpart of ``scripts/merge_race.py``.  The port's run
(``scripts/northstar_torch.py``) and SciPy's (``scripts/northstar_scipy_torch.py``)
are separate processes, run one after the other on one host, so that
neither's failure loses the other's result and neither competes for the
host's cores.  This script stitches their JSON files together:

  python scripts/merge_race_torch.py NORTHSTAR_torch.json \\
      --same-size port216.json scipy216.json --big-scipy scipy432.json

- ``--same-size PORT SCIPY``: runs meant to be of the same problem; adds
  ``same_size_race``.  Given again, each further pair goes under
  ``same_size_race_n<n_fine>``.
- ``--big-scipy SCIPY``: a larger SciPy run, finished or not; adds
  ``scipy_baseline_large``, compared with the artifact's own port run when
  that is a run of the same problem.

A pair gets ``speedup_vs_scipy`` only when SciPy's run is ``done``, both
runs solved the same problem (``num_points``, ``k`` and ``tol`` agree) and
the port's refinement completed.  A SciPy run that did not finish gives
``speedup_lower_bound`` from the seconds it recorded itself
(``elapsed_lower_bound_s``, else its last ``elapsed_s``); the merge never
reads the clock.  The port's wall, ``port_total_s``, is its fp32 solve plus
its refinement, SciPy's is its eigsh call: neither counts building the
graph or the operator.  The artifact is created when it does not exist.
"""

import argparse
import json
import os
import sys


def compare(port, sc):
    """The race entry of a port run and a SciPy run."""
    k = sc.get("k")
    entry = {
        "num_points": sc.get("num_points"), "n_fine": sc.get("n_fine"), "k": k,
        "tol": sc.get("tol"),
        "port_total_s": port.get("t_solve_s"),
        "port_card": port.get("card"),
        "port_stages_s": {s: port.get(f"t_{s}_s") for s in (
            "neighbors", "reciprocity", "build_composite", "solve_fp32", "refine")},
        "port_refine_completed": port.get("refine_completed"),
        "port_true_residual_max": port.get("true_residual_max"),
        "port_pairs_below_1e-8": port.get("pairs_below_1e-8"),
        "port_eigenvalues_head": port.get("eigenvalues_head"),
        "scipy_status": sc.get("status"),
        "scipy_eigsh_s": sc.get("scipy_eigsh_s"),
        "scipy_host_cores": sc.get("host_cores"),
        "scipy_host_ram_gib": sc.get("host_ram_gib"),
        "scipy_true_residual_max": sc.get("true_residual_max"),
        "scipy_pairs_below_1e-8": sc.get("pairs_below_1e-8"),
        "scipy_eigenvalues_head": sc.get("eigenvalues_head"),
    }
    mismatch = [key for key in ("num_points", "k", "tol") if port.get(key) != sc.get(key)]
    if mismatch:
        entry["not_compared"] = "different problems: " + ", ".join(
            f"{key} {port.get(key)} (port) vs {sc.get(key)} (scipy)" for key in mismatch)
        return entry
    if not port.get("refine_completed"):
        entry["not_compared"] = "the port's refinement did not complete"
        return entry
    wall = port["t_solve_s"]
    cores = sc.get("host_cores") or {}
    if sc.get("status") == "done":
        entry["speedup_vs_scipy"] = sc["scipy_eigsh_s"] / wall
        entry["note"] = (f"same graph Laplacian, k={k}, tol={sc['tol']:g}, both runs completed; "
                         f"the port on {port.get('card')}, scipy on {cores.get('sched_affinity')} "
                         f"of the host's {cores.get('cpu_count')} cores")
        return entry
    lower = sc.get("elapsed_lower_bound_s", sc.get("elapsed_s"))
    if lower is None:
        entry["not_compared"] = f"scipy's run ({sc.get('status')}) recorded no elapsed time"
        return entry
    entry["scipy_elapsed_lower_bound_s"] = lower
    entry["speedup_lower_bound"] = lower / wall
    how = ("its last record says running: the process ended without a final record "
           "(SIGKILL or a crash)" if sc.get("status") == "running" else sc.get("status"))
    entry["note"] = (f"same graph Laplacian, k={k}, tol={sc['tol']:g}; scipy did not finish "
                     f"in the {lower:.1f} s it recorded itself ({how}), so the speedup is a "
                     "lower bound")
    return entry


def _load(path):
    with open(path) as f:
        return json.load(f)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("artifact")
    ap.add_argument("--same-size", nargs=2, action="append", default=[],
                    metavar=("PORT_JSON", "SCIPY_JSON"))
    ap.add_argument("--big-scipy", metavar="SCIPY_JSON")
    args = ap.parse_args(argv)

    info = _load(args.artifact) if os.path.exists(args.artifact) else {}
    for i, (port, sc) in enumerate(args.same_size):
        entry = compare(_load(port), _load(sc))
        info["same_size_race" if i == 0 else f"same_size_race_n{entry['n_fine']}"] = entry
    if args.big_scipy:
        sc = _load(args.big_scipy)
        info["scipy_baseline_large"] = {**sc, "race": compare(info, sc)}

    with open(args.artifact, "w") as f:
        json.dump(info, f, indent=1)
    print(json.dumps({key: v for key, v in info.items()
                      if key.startswith("same_size_race") or key == "scipy_baseline_large"},
                     indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
