"""Command-line interface (counterpart of ``lanczos_tpu/cli.py``).

  python -m lanczos_tpu_torch solve-regular -N 64 -L 25 -n 150 -k 8

``solve-regular`` builds the regular-grid 3D deuteron Hamiltonian and solves
it with ``eigsh`` on ``--device`` (``cuda`` by default; there the stencil
SpMV/SpMM run as CUDA kernels).  ``--restart`` and ``--block-size > 1`` name
solvers that are not yet ported and exit with an error.
"""

from __future__ import annotations

import argparse
import time


def _add_common(p):
    p.add_argument("-L", type=float, default=25.0, help="box length [fm]")
    p.add_argument("-n", type=int, default=150, help="Krylov iterations")
    p.add_argument("-k", type=int, default=8, help="eigenpairs to report")
    p.add_argument("--seed", type=int, default=99)
    p.add_argument(
        "--dtype", default="float32", choices=["float32", "float64"]
    )
    p.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="where to solve; cuda fails when no card is visible",
    )
    p.add_argument("--out", default=None, help="prefix for .npy eigenpair dump")


def cmd_solve_regular(args):
    import torch

    import lanczos_tpu_torch as lt

    if args.restart:
        raise SystemExit(
            "--restart (eigsh_restarted) is not yet ported (ROADMAP Queue 1 #8)"
        )
    if args.block_size > 1:
        raise SystemExit(
            "--block-size > 1 (eigsh_block_restarted) is not yet ported "
            "(ROADMAP Queue 1 #11)"
        )
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "--device cuda: no CUDA device is visible "
            "(torch.cuda.is_available() is False); pass --device cpu to "
            "solve on the CPU"
        )

    t0 = time.perf_counter()
    h = lt.build_regular_hamiltonian(
        args.N, args.L, lt.deuteron_potential_3d, stencil=args.stencil,
        dtype=args.dtype, device=args.device,
    )
    res = lt.eigsh(
        h, k=args.k, n=args.n, which="SA", seed=args.seed, reorth=args.reorth,
    )
    if args.device == "cuda":
        torch.cuda.synchronize()
    where = torch.cuda.get_device_name() if args.device == "cuda" else "cpu"
    print(f"# regular {args.N}^3 grid, {args.stencil}-pt stencil, "
          f"{time.perf_counter() - t0:.1f}s on {where}")
    print(res.summary(print_nr=args.k))
    if args.out:
        from lanczos_tpu_torch.utils.io import save_eigpairs

        save_eigpairs(args.out, res.eigenvalues, res.eigenvectors)
        print(f"# saved {args.out}_eigvals.npy / _eigvecs.npy")
    return res


def main(argv=None):
    parser = argparse.ArgumentParser(prog="lanczos_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("solve-regular", help="3D deuteron on a regular grid")
    p.add_argument("-N", type=int, default=64, help="grid points per dim")
    p.add_argument("--stencil", default="27", choices=["7", "27"])
    p.add_argument("--reorth", default="full",
                   choices=["full", "selective", "periodic", "none"])
    p.add_argument("--restart", action="store_true",
                   help="memory-bounded thick-restart solver (not yet ported)")
    p.add_argument("--max-basis", type=int, default=0,
                   help="restart basis bound (default 2k+30)")
    p.add_argument("--block-size", type=int, default=1,
                   help=">1: restarted BLOCK solver (not yet ported)")
    p.add_argument("--tol", type=float, default=1e-6,
                   help="restart/block convergence tolerance")
    _add_common(p)
    p.set_defaults(fn=cmd_solve_regular)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
