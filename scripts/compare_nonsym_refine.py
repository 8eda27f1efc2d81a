"""Compare the two packages' ``refine_eigenpairs_dd_nonsym`` on the CPU, on
the same float32 pairs of the N=60 deuteron lattice.

The JAX package builds the N=60, L=25 fm, box-depth-3 lattice, assembles the
raw non-symmetric Hamiltonian as padded ELL in float32, and solves it with
``eigs_nonsym(compensated=True, max_basis=120, tol=1e-4)`` from the
lattice-order start ``np.random.default_rng(99).uniform(-1, 1, P)`` (the
configuration of ``chip_smoke.py``'s non-symmetric refinement phase).  Both
packages then refine the same pairs on the same stored operator
(``tol=1e-9, max_rounds=8, cg_steps=60``), and the relative residuals are
printed pair by pair, once for each k.  The default k's are 5 (the phase's)
and 8, which holds the whole 2.514/2.524 cluster.

    python scripts/compare_nonsym_refine.py [--k 5 8]     # ~minutes on a CPU

It imports both packages (the port on the CPU), as the tests do.
"""

import argparse
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import lanczos_tpu as lt  # noqa: E402
from lanczos_tpu.solver.refine import refine_eigenpairs_dd_nonsym as jax_refine  # noqa: E402

from lanczos_tpu_torch.convert import from_jax  # noqa: E402
from lanczos_tpu_torch.solver.refine import refine_eigenpairs_dd_nonsym as port_refine  # noqa: E402


def clusters(lam):
    """Cluster index of each pair: sorted neighbours within 1% of
    max(|lam|, 1), as chip_smoke.py groups them."""
    order = np.argsort(lam)
    s = lam[order]
    gaps = np.abs(np.diff(s)) > 1e-2 * np.maximum(np.abs(s[1:]), 1.0)
    out = np.empty(len(lam), dtype=int)
    out[order] = np.concatenate([[0], np.cumsum(gaps)])
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, nargs="+", default=[5, 8])
    ap.add_argument("--n", type=int, default=60)
    args = ap.parse_args()
    torch.set_num_threads(max(1, min(4, os.cpu_count() or 1)))

    lat = lt.build_lattice(args.n, 25.0, 3, potential=lt.deuteron_potential_3d)
    H = lt.assemble_irregular_hamiltonian(lat, lt.deuteron_potential_3d, dtype=np.float32)
    P = from_jax(H, device="cpu")
    v0 = np.random.default_rng(99).uniform(-1.0, 1.0, lat.num_points)
    print(f"N={args.n}: {lat.num_points} points")
    for k in args.k:
        t0 = time.perf_counter()
        res = lt.eigs_nonsym(H, k=k, max_basis=120, tol=1e-4, v0=v0, dtype="float32",
                             compensated=True)
        lam0 = np.asarray(res.eigenvalues, np.float64)
        X0 = np.asarray(res.eigenvectors, np.float32)
        print(f"k={k}: fp32 eigs_nonsym {time.perf_counter() - t0:.1f} s, values "
              f"{np.round(lam0, 6).tolist()}, residuals "
              f"{np.array2string(np.asarray(res.residuals), precision=2)}")
        t0 = time.perf_counter()
        lam_j, _, _, rel_j = jax_refine(H, lam0, X0, tol=1e-9, max_rounds=8, cg_steps=60)
        t_j = time.perf_counter() - t0
        t0 = time.perf_counter()
        lam_p, _, _, rel_p = port_refine(P, lam0, torch.from_numpy(X0), tol=1e-9,
                                         max_rounds=8, cg_steps=60)
        t_p = time.perf_counter() - t0
        cj = clusters(np.asarray(lam_j))
        print(f"  refined: JAX {t_j:.1f} s, port {t_p:.1f} s; pair, JAX value, rel, "
              f"port value, rel, cluster (the highest pair's cluster last)")
        for i in range(k):
            print(f"    {i:2d} {lam_j[i]:14.8f} {rel_j[i]:.3e}  {lam_p[i]:14.8f} {rel_p[i]:.3e}  "
                  f"{cj[i]}{' (highest)' if cj[i] == cj.max() else ''}")
        print(f"  max rel over complete clusters: JAX "
              f"{np.max(np.asarray(rel_j)[cj != cj.max()]):.3e}, port "
              f"{np.max(np.asarray(rel_p)[cj != cj.max()]):.3e}", flush=True)


if __name__ == "__main__":
    main()
