"""SciPy's side of the north-star race: ``scipy.sparse.linalg.eigsh`` on
the same graph Laplacian that ``scripts/northstar_torch.py`` solves.

The port's counterpart of ``scripts/northstar_scipy.py``.  L = D - A
(unshifted) comes from ``northstar_torch.build_graph_laplacian_rows`` and
``host_laplacian``; only ``eigsh(L, k, which="SA", tol)`` is timed.  When it
finishes, the true residuals of its vectors are measured as
``northstar_torch.py`` measures the port's (||L x - lam x|| / ||x||,
relative to max(|lam|, 1)), so the race compares equal accuracy: ARPACK's
``tol`` bounds the Ritz values, not the residuals.

The JSON at ``--out`` is written at the start (``status: "running"``,
``started_unix``), every HEARTBEAT_S seconds (``elapsed_s``, the process's
own clock), and at the end (``status: "done"``).  SIGTERM or SIGINT (as
``timeout`` sends) writes ``status: "killed"`` with
``elapsed_lower_bound_s`` and exits non-zero; a run killed harder, or one
that crashes (``faulthandler`` prints where), keeps its last
``elapsed_s``.  ``basis_elements`` is n x ncv: SciPy's ARPACK indexes its
basis with 32-bit integers, and a basis whose last column starts past
2**31 - 1 may crash it (``scripts/arpack_limit.py``).  Run it after the port's run, not beside it: both use
the host's cores.  ``scripts/merge_race_torch.py`` pairs the two files.

Usage: python scripts/northstar_scipy_torch.py [--n-fine 432] [--k 100]
       [--tol 1e-8] [--out northstar_scipy.json]
"""

import argparse
import faulthandler
import json
import os
import signal
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

HEARTBEAT_S = 30.0
_WRITE_LOCK = threading.RLock()  # the heartbeat thread and the main thread both write


def write_record(path, record):
    """Write ``record`` as JSON to ``path`` through a temporary file, so a
    kill during the write leaves the previous record whole."""
    with _WRITE_LOCK:
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(record, f, indent=1)
        os.replace(tmp, path)


def write_killed(path, info, started, signum):
    """The record of a run stopped by signal ``signum``: ``status:
    "killed"`` and ``elapsed_lower_bound_s``, the seconds since
    ``started`` (a ``time.monotonic()`` reading of this process) that eigsh
    ran without finishing.  Writes it to ``path`` and returns it."""
    record = {**info, "status": "killed", "signal": signal.Signals(signum).name,
              "elapsed_lower_bound_s": time.monotonic() - started}
    write_record(path, record)
    return record


def host_info():
    """The host's cores (all, and those this process may run on) and RAM."""
    return {"host_cores": {"cpu_count": os.cpu_count(),
                           "sched_affinity": len(os.sched_getaffinity(0))},
            "host_ram_gib": os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES") / 2**30}


def true_residuals(L, vals, vecs, col_chunk=8):
    """||L x - lam x|| / ||x|| / max(|lam|, 1) per pair (the measure of
    ``scripts/northstar_torch.py``), column chunk by chunk."""
    rel = np.empty(len(vals))
    for lo in range(0, len(vals), col_chunk):
        X = vecs[:, lo:lo + col_chunk]
        lam = vals[lo:lo + col_chunk]
        r = np.linalg.norm(L @ X - X * lam[None, :], axis=0) / np.linalg.norm(X, axis=0)
        rel[lo:lo + col_chunk] = r / np.maximum(np.abs(lam), 1.0)
    return rel


def laplacian(n_fine, box_depth=3):
    """L = D - A of the north-star lattice (unshifted), scipy CSR in
    lattice order, as ``scripts/northstar_torch.py`` builds it."""
    from northstar_torch import build_graph_laplacian_rows, host_laplacian

    _, nbrs, _, _, deg, _ = build_graph_laplacian_rows(n_fine, box_depth)
    return host_laplacian(nbrs, deg)


def run(n_fine=432, box_depth=3, k=100, tol=1e-8, out="northstar_scipy.json"):
    import scipy
    import scipy.sparse.linalg

    print(f"[scipy-race] building the n_fine={n_fine} graph Laplacian ...", flush=True)
    t0 = time.perf_counter()
    L = laplacian(n_fine, box_depth)
    p = L.shape[0]
    info = {"problem": "irregular lattice graph Laplacian, k smallest (scipy eigsh)",
            "n_fine": n_fine, "box_depth": box_depth, "num_points": int(p), "k": k, "tol": tol,
            "nnz": int(L.nnz), "ncv": min(p, max(2 * k + 1, 20)),
            "basis_elements": p * min(p, max(2 * k + 1, 20)),
            "scipy_version": scipy.__version__, "t_build_s": time.perf_counter() - t0,
            **host_info()}
    started = time.monotonic()
    info["started_unix"] = time.time()
    write_record(out, {**info, "status": "running", "elapsed_s": 0.0})

    def on_signal(signum, frame):
        write_killed(out, info, started, signum)
        raise SystemExit(128 + signum)

    done = threading.Event()

    def heartbeat():
        while not done.wait(HEARTBEAT_S):
            write_record(out, {**info, "status": "running",
                               "elapsed_s": time.monotonic() - started})

    faulthandler.enable()
    beat = threading.Thread(target=heartbeat, daemon=True)
    handlers = {s: signal.signal(s, on_signal) for s in (signal.SIGTERM, signal.SIGINT)}
    beat.start()
    print(f"[scipy-race] P={p}, nnz={info['nnz']}, ncv={info['ncv']}; starting eigsh "
          f"(k={k}, tol={tol:g}) on {info['host_cores']} cores ...", flush=True)
    try:
        vals, vecs = scipy.sparse.linalg.eigsh(L, k=k, which="SA", tol=tol)
        elapsed = time.monotonic() - started
    finally:
        done.set()
        beat.join()  # no heartbeat may land after the final record
        for s, h in handlers.items():
            signal.signal(s, h)
    order = np.argsort(vals)
    vals, vecs = vals[order], vecs[:, order]
    t0 = time.perf_counter()
    rel = true_residuals(L, vals, vecs)
    info.update(status="done", scipy_eigsh_s=elapsed, t_true_residuals_s=time.perf_counter() - t0,
                eigenvalues_head=[float(v) for v in vals[:10]],
                true_residual_max=float(rel.max()), true_residual_median=float(np.median(rel)),
                **{f"pairs_below_1e-{e}": int((rel < 10.0**-e).sum()) for e in (6, 7, 8)})
    write_record(out, info)
    print(f"[scipy-race] done: eigsh {elapsed:.1f} s; true residual max "
          f"{info['true_residual_max']:.2e}, pairs below 1e-8: {info['pairs_below_1e-8']}",
          flush=True)
    return info


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-fine", type=int, default=432)
    ap.add_argument("--box-depth", type=int, default=3)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--tol", type=float, default=1e-8)
    ap.add_argument("--out", default="northstar_scipy.json")
    args = ap.parse_args(argv)
    run(args.n_fine, args.box_depth, args.k, args.tol, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
