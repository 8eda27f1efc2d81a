"""Command-line interface (counterpart of ``lanczos_tpu/cli.py``).

  python -m lanczos_tpu_torch solve-regular   -N 64 -L 25 -n 150 -k 8
  python -m lanczos_tpu_torch solve-irregular -N 60 -L 25 --box-depth 3 -n 250 -k 5
  python -m lanczos_tpu_torch export-matrix   -d 3 -L 25 -N 30 -p Deuteron
  python -m lanczos_tpu_torch bench

``solve-regular`` builds the regular-grid 3D deuteron Hamiltonian and solves
it on ``--device`` (``cuda`` by default; there the stencil SpMV/SpMM run as
CUDA kernels) with ``eigsh``; with the memory-bounded thick-restart
``eigsh_restarted`` under ``--restart`` (``--max-basis``, ``--tol``); else,
with ``--block-size > 1``, with the restarted block solver
``eigsh_block_restarted`` (``--tol``), which resolves degenerate multiplets
up to the block size.  ``--restart`` takes precedence, as in the JAX
package.

``solve-irregular`` builds the multi-resolution lattice and solves the raw
non-symmetric Hamiltonian with Krylov–Schur (``eigs_nonsym``, default) or
two-sided Lanczos.  On ``--device cuda`` both run on the CompositeV2
operator with the interface kernel (two-sided with its transpose);
on ``--device cpu`` on the padded-ELL assembly, as the JAX package does on
its CPU backend.  Two-sided runs in float64 whatever ``--dtype`` says: in
float32 its recurrence collapses within ~15 iterations.  Start vectors are
drawn in lattice order from ``--seed`` (the same on both devices) and
scattered into the CompositeV2 layout, dead slots zero.  ``--compensated``
runs either solver's scalar reductions through the error-free-transform
dot (``ops/compensated.py``).

``export-matrix`` writes the irregular H (the reference's MatrixWrite.py
lattice: spacing 2, 1 in the centre box) in Mathematica syntax, assembled
in float64 on ``--device``.  ``bench`` prints the flagship SpMV
benchmark's JSON line (``utils/bench_impl.py``).
"""

from __future__ import annotations

import argparse
import time

import torch


def _add_device(p):
    p.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="where to run; cuda fails when no card is visible",
    )


def _add_common(p):
    p.add_argument("-L", type=float, default=25.0, help="box length [fm]")
    p.add_argument("-n", type=int, default=150, help="Krylov iterations")
    p.add_argument("-k", type=int, default=8, help="eigenpairs to report")
    p.add_argument("--seed", type=int, default=99)
    p.add_argument(
        "--dtype", default="float32", choices=["float32", "float64"]
    )
    _add_device(p)
    p.add_argument("--out", default=None, help="prefix for .npy eigenpair dump")


def _require_device(device):
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "--device cuda: no CUDA device is visible "
            "(torch.cuda.is_available() is False); pass --device cpu to "
            "run on the CPU"
        )


def _sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


def _where(device):
    return torch.cuda.get_device_name() if device == "cuda" else "cpu"


def cmd_solve_regular(args):
    import lanczos_tpu_torch as lt

    _require_device(args.device)

    t0 = time.perf_counter()
    h = lt.build_regular_hamiltonian(
        args.N, args.L, lt.deuteron_potential_3d, stencil=args.stencil,
        dtype=args.dtype, device=args.device,
    )
    if args.restart:
        res = lt.eigsh_restarted(
            h, k=args.k, max_basis=args.max_basis, tol=args.tol, seed=args.seed,
        )
    elif args.block_size > 1:
        res = lt.eigsh_block_restarted(
            h, k=args.k, block_size=args.block_size, tol=args.tol, seed=args.seed,
        )
    else:
        res = lt.eigsh(
            h, k=args.k, n=args.n, which="SA", seed=args.seed, reorth=args.reorth,
        )
    _sync(args.device)
    print(f"# regular {args.N}^3 grid, {args.stencil}-pt stencil, "
          f"{time.perf_counter() - t0:.1f}s on {_where(args.device)}")
    print(res.summary(print_nr=args.k))
    if args.out:
        from lanczos_tpu_torch.utils.io import save_eigpairs

        save_eigpairs(args.out, res.eigenvalues, res.eigenvectors)
        print(f"# saved {args.out}_eigvals.npy / _eigvecs.npy")
    return res


def _lattice_start(gen, p, op, idx_map):
    """Uniform(-1, 1) start vector drawn in lattice order; on a CompositeV2
    scattered into its region layout, so it is zero on the dead slots."""
    v = torch.rand(p, generator=gen, dtype=torch.float64) * 2.0 - 1.0
    if idx_map is None:
        return v
    out = torch.zeros(op.shape[0], dtype=torch.float64)
    out[torch.as_tensor(idx_map)] = v
    return out


def cmd_solve_irregular(args):
    import lanczos_tpu_torch as lt

    _require_device(args.device)
    t0 = time.perf_counter()
    lat = lt.build_lattice(
        args.N, args.L, args.box_depth, potential=lt.deuteron_potential_3d,
        overwrite_spacing=args.overwrite_spacing,
    )
    print(f"# lattice: {lat.num_points} points "
          f"(fine grid {args.N}^3 = {args.N**3}), spacings "
          f"{sorted(set(lat.spacings.tolist()))}")
    pot = lt.deuteron_potential_3d
    gen = torch.Generator().manual_seed(args.seed)
    idx_map = None
    if args.symmetrize != "none":
        h = lt.assemble_irregular_hamiltonian(
            lat, pot, symmetrize=args.symmetrize, dtype=args.dtype, device=args.device,
        )
        res = lt.eigsh(h, k=args.k, n=args.n, which="SA", seed=args.seed)
        print(f"# symmetrize={args.symmetrize}, {time.perf_counter() - t0:.1f}s "
              "(NOTE: symmetrized irregular operators carry spurious "
              "interface modes; prefer --symmetrize none)")
    elif args.solver == "krylov-schur":
        if args.device == "cuda":
            op, idx_map = lt.assemble_irregular_hamiltonian_composite2(
                lat, pot, dtype=args.dtype, device="cuda",
            )
        else:
            op = lt.assemble_irregular_hamiltonian(
                lat, pot, dtype=args.dtype, device="cpu"
            )
        res = lt.eigs_nonsym(
            op, k=args.k, max_basis=args.n, tol=args.tol,
            v0=_lattice_start(gen, lat.num_points, op, idx_map), verbose=args.verbose,
            compensated=args.compensated,
        )
        _sync(args.device)
        print(f"# Krylov-Schur (Arnoldi), basis {args.n}, "
              f"{time.perf_counter() - t0:.1f}s on {_where(args.device)}")
    else:
        print("# two-sided Lanczos runs in float64")
        if args.device == "cuda":
            h, idx_map = lt.assemble_irregular_hamiltonian_composite2(
                lat, pot, dtype=torch.float64, build_transpose=True, device="cuda",
            )
        else:
            h = lt.assemble_irregular_hamiltonian(
                lat, pot, dtype=torch.float64, device="cpu"
            )
        v0 = _lattice_start(gen, lat.num_points, h, idx_map)
        w0 = _lattice_start(gen, lat.num_points, h, idx_map)
        fac = lt.two_sided_lanczos(h, args.n, v0=v0, w0=w0, op_transpose=h.transpose(),
                                   compensated=args.compensated)
        res = lt.two_sided_eigs(fac, k=args.k, op=h, residual_tol=args.tol)
        _sync(args.device)
        print(f"# two-sided Lanczos, breakdown at "
              f"{int(fac.breakdown_iter)}/{args.n}, max biorth drift "
              f"{float(fac.biorth_drift.max()):.2e}, "
              f"{time.perf_counter() - t0:.1f}s on {_where(args.device)}")
    print(res.summary(print_nr=args.k))
    if args.out:
        from lanczos_tpu_torch.utils.io import save_eigpairs

        vecs = res.eigenvectors
        if idx_map is not None:
            vecs = vecs[torch.as_tensor(idx_map, device=vecs.device)]  # -> lattice order
        save_eigpairs(args.out, res.eigenvalues, vecs)
        print(f"# saved {args.out}_eigvals.npy / _eigvecs.npy")
    return res


def cmd_export_matrix(args):
    # MatrixWrite.py parity: -d -L -N -p on the overwrite_spacing lattice.
    # Its doubled T_factor (MatrixWrite.py:30) is the Laplacian
    # normalization the weights already carry, so it is not doubled here.
    import lanczos_tpu_torch as lt
    from lanczos_tpu_torch.utils.io import export_mathematica

    if args.p != "Deuteron":
        raise SystemExit(f"unsupported potential {args.p!r}")
    if args.d != 3:
        raise SystemExit("only 3 dimensions supported")
    _require_device(args.device)
    lat = lt.build_lattice(args.N, args.L, 3, overwrite_spacing=True)
    h = lt.assemble_irregular_hamiltonian(
        lat, lt.deuteron_potential_3d, dtype=torch.float64, device=args.device
    )
    out = args.out or f"matrix_d={args.d}_N={args.N}_L={args.L:g}_p={args.p}.dat"
    export_mathematica(out, h, ndim=args.d, length=args.L, potential_name=args.p)
    print(f"# wrote {out} ({lat.num_points} points)")
    return out


def cmd_bench(args):
    from lanczos_tpu_torch.utils.bench_impl import main as bench_main

    _require_device(args.device)
    return bench_main(device=args.device)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="lanczos_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("solve-regular", help="3D deuteron on a regular grid")
    p.add_argument("-N", type=int, default=64, help="grid points per dim")
    p.add_argument("--stencil", default="27", choices=["7", "27"])
    p.add_argument("--reorth", default="full",
                   choices=["full", "selective", "periodic", "none"])
    p.add_argument("--restart", action="store_true",
                   help="memory-bounded thick-restart solver (eigsh_restarted)")
    p.add_argument("--max-basis", type=int, default=0,
                   help="restart basis bound (default 2k+30)")
    p.add_argument("--block-size", type=int, default=1,
                   help=">1: restarted BLOCK solver (degenerate multiplets)")
    p.add_argument("--tol", type=float, default=1e-6,
                   help="restart/block convergence tolerance")
    _add_common(p)
    p.set_defaults(fn=cmd_solve_regular)

    p = sub.add_parser("solve-irregular",
                       help="3D deuteron on a multi-resolution lattice")
    p.add_argument("-N", type=int, default=60, help="fine grid points per dim")
    p.add_argument("--box-depth", type=int, default=3)
    p.add_argument("--overwrite-spacing", action="store_true",
                   help="debug spacings: 2 everywhere, 1 in center box")
    p.add_argument("--symmetrize", default="none",
                   choices=["none", "average", "volume", "normal"])
    p.add_argument("--solver", default="krylov-schur",
                   choices=["krylov-schur", "two-sided"],
                   help="krylov-schur (fp32-safe) or the reference-parity "
                        "two-sided biorthogonal Lanczos (runs in float64)")
    p.add_argument("--tol", type=float, default=1e-4,
                   help="true relative residual acceptance threshold")
    p.add_argument("--compensated", action="store_true",
                   help="error-free-transform scalar reductions")
    p.add_argument("--verbose", action="store_true")
    _add_common(p)
    p.set_defaults(fn=cmd_solve_irregular)

    p = sub.add_parser("export-matrix",
                       help="export irregular H as Mathematica .dat "
                            "(MatrixWrite parity)")
    p.add_argument("-d", type=int, default=3)
    p.add_argument("-L", type=float, default=25.0)
    p.add_argument("-N", type=int, default=30)
    p.add_argument("-p", type=str, default="Deuteron")
    p.add_argument("--out", default=None)
    _add_device(p)
    p.set_defaults(fn=cmd_export_matrix)

    p = sub.add_parser("bench", help="flagship SpMV benchmark (JSON line)")
    _add_device(p)
    p.set_defaults(fn=cmd_bench)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
