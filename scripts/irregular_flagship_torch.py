"""Irregular flagship on the PyTorch port: the reference's production
irregular run (Irr3Ddeuteron.py: N=120 fine grid, box depth 3) through the
v1 composite operator and Krylov-Schur on one NVIDIA GPU, then a float64
host refinement, with true residuals written to a JSON artifact.

The port's counterpart of ``scripts/irregular_flagship.py``, with the same
flags and JSON keys, plus the card (``device``: its name and power limit),
``peak_device_gib`` and ``v0_seed``.  The start vector is drawn in lattice
order from ``numpy.random.default_rng(v0_seed)`` and taken to the
operator's order through ``perm``, so the JAX package can start from the
same vector.

Usage: python scripts/irregular_flagship_torch.py [--n-fine 120] [--k 8]
       [--basis 300] [--tol 1e-4] [--[no-]compensated] [--device cuda]
       [--out IRREGULAR_torch.json]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

V0_SEED = 99


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-fine", type=int, default=120)
    ap.add_argument("--box-depth", type=int, default=3)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--basis", type=int, default=300)
    ap.add_argument("--tol", type=float, default=1e-4)
    ap.add_argument(
        "--compensated", action=argparse.BooleanOptionalAction, default=True,
        help="compensated fp32 norms in the solver (--no-compensated to disable; the JSON "
        "records the setting)",
    )
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default="IRREGULAR_torch.json")
    args = ap.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is visible; pass --device cpu")

    import lanczos_tpu_torch as lt
    from lanczos_tpu_torch.solver.refine import refine_eigenpairs_fp64_host
    from lanczos_tpu_torch.utils.timing import card_label

    def sync():
        if args.device == "cuda":
            torch.cuda.synchronize()

    info = {
        "problem": "3D deuteron, multi-resolution lattice "
                   "(Irr3Ddeuteron.py parity at production size)",
        "n_fine": args.n_fine,
        "box_depth": args.box_depth,
        "k": args.k,
        "max_basis": args.basis,
        "dtype": "float32",
        "compensated": bool(args.compensated),
        "solver": "krylov-schur (composite operator)",
        "backend": args.device,
        "device": card_label(args.device),
        "v0_seed": V0_SEED,
    }
    t0 = time.time()
    lat = lt.build_lattice(args.n_fine, 25.0, args.box_depth, potential=lt.deuteron_potential_3d)
    info["num_points"] = int(lat.num_points)
    info["spacings"] = sorted(set(lat.spacings.tolist()))
    info["t_lattice_s"] = time.time() - t0
    print(f"[irr] lattice P={lat.num_points} spacings {info['spacings']} "
          f"({info['t_lattice_s']:.1f}s)", flush=True)

    t0 = time.time()
    op, perm = lt.assemble_irregular_hamiltonian_composite(
        lat, lt.deuteron_potential_3d, dtype=torch.float32, device=args.device)
    sync()
    info["t_assemble_s"] = time.time() - t0
    print(f"[irr] composite built ({info['t_assemble_s']:.1f}s) on {info['device']}", flush=True)

    # perm maps lattice order -> operator order: v_op = v_lat[perm].
    perm = np.asarray(perm)
    v0 = np.random.default_rng(V0_SEED).uniform(-1.0, 1.0, lat.num_points)[perm]
    if args.device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    res = lt.eigs_nonsym(
        op, k=args.k, max_basis=args.basis, tol=args.tol, v0=v0,
        dtype=torch.float32, compensated=args.compensated, verbose=True,
    )
    sync()
    info["t_solve_s"] = time.time() - t0
    if args.device == "cuda":
        info["peak_device_gib"] = torch.cuda.max_memory_allocated() / 2**30
    else:
        info["peak_device_gib"] = None
    vals = res.eigenvalues.cpu().numpy()
    resid = res.residuals.cpu().numpy()
    order = np.argsort(np.real(vals))
    info["eigenvalues_fp32"] = [float(np.real(v)) for v in vals[order]]
    info["fp32_rel_residuals"] = [float(r) for r in resid[order]]
    info["fp32_residual_max"] = float(resid.max())
    # Reference acceptance: <(Hx/||Hx||), x>^2 within 0.01 of 1
    # (Regular/Lanczos.py:166-185).
    ip = res.inner_prod.cpu().numpy()
    info["acceptance_inner_prod"] = [float(v) for v in ip[order]]
    info["all_accepted_ref_tol"] = bool((np.abs(ip - 1.0) < 0.01).all())
    print(f"[irr] solve {info['t_solve_s']:.1f}s; eigenvalues "
          f"{info['eigenvalues_fp32'][:4]} ...; fp32 resid max {resid.max():.2e}", flush=True)

    # float64 host refinement against the float64 ELL operator: the float32
    # solve stalls near eps32 ||A|| / |lam|, the storage floor of both the
    # vectors and the float32 weights (the deuteron LSQ weights are not
    # float32-representable), so plain float64 on the host is the cure at
    # this size (oblique Rayleigh-Ritz + deflated BiCGStab).
    t0 = time.time()
    H64 = lt.assemble_irregular_hamiltonian(
        lat, lt.deuteron_potential_3d, symmetrize=None, dtype=torch.float64, device="cpu")
    A64 = H64.to_scipy()
    info["t_assemble64_s"] = time.time() - t0
    X_op = res.eigenvectors.double().cpu().numpy()[:, order]
    X_lat = np.empty_like(X_op)
    X_lat[perm] = X_op
    del res, op
    t0 = time.time()
    lam_r, _, rel_r = refine_eigenpairs_fp64_host(
        A64, np.real(vals[order]), X_lat, tol=1e-10, max_rounds=6, cg_steps=300, verbose=True,
    )
    info["t_refine_s"] = time.time() - t0
    info["eigenvalues"] = [float(v) for v in lam_r]
    info["true_rel_residuals"] = [float(r) for r in rel_r]
    info["residual_max"] = float(rel_r.max())
    info["residual_min"] = float(rel_r.min())
    print(f"[irr] fp64 refine {info['t_refine_s']:.1f}s; resid max {rel_r.max():.2e}; "
          f"eigenvalues {info['eigenvalues'][:4]} ...", flush=True)

    with open(args.out, "w") as f:
        json.dump(info, f, indent=1)
    print(json.dumps({k: info[k] for k in (
        "num_points", "t_solve_s", "residual_max", "all_accepted_ref_tol", "device")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
