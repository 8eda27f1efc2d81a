"""Where SciPy's ``eigsh`` (ARPACK) stops working: the start of its Lanczos
basis's last column against 2**31 - 1.

ARPACK's index arithmetic is 32-bit in SciPy (``ipntr`` is int32), and the
basis V is one n x ncv array whose column j starts at element j x n, so a
basis whose last column starts past 2**31 - 1, (ncv - 1) x n, may be
indexed out of bounds.  This script runs ``eigsh(diag(1..n), k,
which="SA", maxiter=1)`` (one fill of the basis and one restart) in a child
process for an n 2% below that limit and one 2% above it, and reports how
each child ended: ``survived`` (ARPACK returned or reported no
convergence after its one restart) or the signal that killed it.  k = 10
(ncv = 21) keeps the basis fill short: the limit is n = 107,374,182, an
18 GB basis.  The north star at n_fine=432 (12,690,432 points, k = 100,
ncv = 201) puts its last column at 2.54e9, past the limit.

Usage: python scripts/arpack_limit.py [--k 10]     # needs ~25 GB of host RAM
"""

import argparse
import json
import subprocess
import sys
import time

LIMIT = 2**31 - 1


def child(n, k):
    import numpy as np
    import scipy.sparse
    import scipy.sparse.linalg as spla

    A = scipy.sparse.diags(np.arange(1.0, n + 1.0))
    try:
        spla.eigsh(A, k=k, which="SA", maxiter=1, v0=np.ones(n))
    except spla.ArpackNoConvergence:
        pass
    print("survived", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--child", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        child(args.child, args.k)
        return 0
    ncv = max(2 * args.k + 1, 20)
    n_max = LIMIT // (ncv - 1)
    out = {"k": args.k, "ncv": ncv, "n_limit": n_max}
    for label, n in (("below", n_max - n_max // 50), ("above", n_max + n_max // 50)):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, __file__, "--k", str(args.k), "--child", str(n)],
                              capture_output=True, text=True, timeout=1800)
        ended = "survived" if proc.returncode == 0 and "survived" in proc.stdout else (
            f"signal {-proc.returncode}" if proc.returncode < 0 else f"exit {proc.returncode}")
        out[label] = {"n": n, "last_column_start": n * (ncv - 1), "ended": ended,
                      "seconds": time.perf_counter() - t0, "stderr_tail": proc.stderr[-300:]}
        print(json.dumps({label: out[label]}), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
