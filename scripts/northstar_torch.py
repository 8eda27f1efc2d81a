"""North-star run on the PyTorch port: k=100 eigenpairs of the irregular
lattice's graph Laplacian to a 1e-8 residual on one NVIDIA GPU.

The port's counterpart of ``scripts/northstar.py``.  The graph is the
irregular multi-resolution lattice's neighbor graph (box depth 3, the
centre box at spacing 1, the others at 2), made undirected by edge
reciprocity (keep (i, j) iff both ends list each other), so L = D - A is
exactly symmetric.  Pipeline:

1. CompositeV2 (``ops/composite2.py``) of L + 1 (a +1 shift keeps the
   relative-residual criterion defined at the lambda = 0 end; it is taken
   off before reporting): integer coefficients, so the float32 operator is
   exact.  Level stencils and interface classes run as CUDA kernels.
2. float32 compensated thick-restart Lanczos (``solver/restart.py``) for
   k + buffer pairs down to the float32 floor, from a start vector that is
   zero on the dead slots, with per-cycle checkpoints (``--checkpoint``).
   With ``run(mesh=...)`` this solve runs row-sharded over the ranks of a
   ``parallel/mesh.py:RowMesh`` (the sharded CompositeV2); its vectors are
   gathered back for the refinement, which every rank runs whole.
3. Double-word refinement (``solver/refine.py:refine_eigenpairs_dd_hosted``):
   float64 residuals through the float32 operator's float64 copy, deflated
   CG on the float32 operator's SpMM.
4. True float64 residuals of the first k pairs on the host scipy matrix.

Usage: python scripts/northstar_torch.py [--n-fine 432] [--k 100]
       [--tol 1e-8] [--device cuda] [--checkpoint PATH] [--save-vectors PATH]
       [--out northstar_torch.json]

``--save-vectors`` keeps (lam, X64, idx_map) after the refinement and, when
the file exists, refines from it instead of solving again.  The JSON
records ``refine_completed`` and the best verified true residual (never
NaN): a refinement that raises leaves the float32 pairs, whose residuals
are measured and recorded.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_graph_laplacian_rows(n_fine: int, box_depth: int = 3):
    """Lattice -> symmetric graph-Laplacian rows (nbrs, rels, weights, deg),
    and the walls of the neighbor search and of the reciprocity pass."""
    from lanczos_tpu_torch.models.lattice import build_lattice, find_neighbors
    from lanczos_tpu_torch.native import reciprocal_mask_native

    nb = box_depth**3
    sp = np.full(nb, 2, dtype=np.int64)
    sp[nb // 2] = 1  # the reference's overwrite_spacing debug lattice shape
    t0 = time.perf_counter()
    lat = build_lattice(n_fine, 25.0, box_depth, spacings=sp, ndim=3)
    nbrs, rels = find_neighbors(lat, 1)
    t_nbrs = time.perf_counter() - t0

    # Edge reciprocity: keep (i -> j) only if (j -> i) exists.  The native
    # row scan when the C++ engine is available; a sorted-key membership
    # pass in numpy otherwise.
    t0 = time.perf_counter()
    keep = reciprocal_mask_native(nbrs)
    if keep is None:
        p, k = nbrs.shape
        rows = np.repeat(np.arange(p, dtype=np.int64), k)
        cols = nbrs.reshape(-1)
        valid = cols >= 0
        fwd = rows[valid] * p + cols[valid]
        bwd = np.sort(cols[valid] * p + rows[valid])
        pos = np.minimum(np.searchsorted(bwd, fwd), len(bwd) - 1)
        keep = np.zeros(p * k, dtype=bool)
        keep[valid] = bwd[pos] == fwd
        keep = keep.reshape(p, k)
    nbrs = np.where(keep, nbrs, -1)
    weights = np.where(keep, -1.0, 0.0)
    deg = keep.sum(axis=1).astype(np.float64)
    t_recip = time.perf_counter() - t0
    return lat, nbrs, rels, weights, deg, {"t_neighbors_s": t_nbrs, "t_reciprocity_s": t_recip}


def host_laplacian(nbrs, deg):
    """L = D - A (unshifted) as a scipy CSR matrix in lattice order."""
    import scipy.sparse

    p = nbrs.shape[0]
    rows = np.repeat(np.arange(p, dtype=np.int64), nbrs.shape[1])
    cols = nbrs.reshape(-1)
    valid = cols >= 0
    A = scipy.sparse.csr_matrix((np.ones(valid.sum()), (rows[valid], cols[valid])), shape=(p, p))
    return (scipy.sparse.diags(deg) - A).tocsr()


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def kernel_launches():
    """Each kernel wrapper's launch count so far, by dtype."""
    from lanczos_tpu_torch.ops import interface_kernel as ik
    from lanczos_tpu_torch.ops import stencil_kernels as sk

    return {w.__name__: {str(dt)[6:]: n for dt, n in w.launches_by_dtype.items()}
            for w in (sk.stencil_spmv, sk.stencil_spmm, ik.apply_fused_interface)}


def default_max_basis(kk):
    """The restart basis when ``--max-basis`` is 0: 2 kk + 30, the rule of
    ``eigsh_restarted`` itself (250 for k = 100 and the 10 buffer pairs, a
    13 GB float32 basis at n_fine=432 on an 80 GB card)."""
    return 2 * kk + 30


def run(n_fine=432, box_depth=3, k=100, k_buffer=10, tol=1e-8, fp32_tol=3e-7, max_basis=0,
        n_locked=0, max_cycles=400, refine_rounds=4, col_chunk=8, min_grid_rows=4096,
        cg_steps=200, checkpoint="", checkpoint_every=10, save_vectors="", device="cuda",
        verbose=True, mesh=None):
    """The whole pipeline (the fp32 solve row-sharded over ``mesh`` when
    given).  Returns (info, extra): ``info`` the JSON record,
    ``extra`` the reported (unshifted) eigenvalues ``lam`` (k,), their true
    residuals relative to the shifted eigenvalue ``rel_shifted`` (k,), the
    host matrix ``L``, the operator ``op`` (L + 1), and the refined pairs
    of L + 1 (``lam_shifted`` (k + k_buffer,), ``X64`` (M, k + k_buffer))
    with ``idx_map``."""
    import torch

    from lanczos_tpu_torch.ops.composite2 import build_composite_v2
    from lanczos_tpu_torch.solver.refine import refine_eigenpairs_dd_hosted
    from lanczos_tpu_torch.solver.restart import eigsh_restarted
    from lanczos_tpu_torch.utils.timing import card_label

    def log(msg):
        if verbose:
            print(f"[northstar_torch] {msg}", flush=True)

    kk = k + k_buffer
    info = {"problem": "irregular lattice graph Laplacian, k smallest", "n_fine": n_fine,
            "box_depth": box_depth, "k": k, "k_buffer": k_buffer, "tol": tol,
            "dtype": "float32 solve + float64 refinement", "compensated": True,
            "device": torch.cuda.get_device_name() if torch.device(device).type == "cuda"
            else "cpu", "card": card_label(device)}
    log(f"building lattice N={n_fine} ...")
    lat, nbrs, rels, weights, deg, times = build_graph_laplacian_rows(n_fine, box_depth)
    p = lat.num_points
    info.update(times, num_points=p, nnz=int((nbrs >= 0).sum() + p))
    log(f"P={p} nnz={info['nnz']} (neighbors {times['t_neighbors_s']:.2f} s, "
        f"reciprocity {times['t_reciprocity_s']:.2f} s)")

    shift = 1.0
    t0 = time.perf_counter()
    comp, idx_map = build_composite_v2(
        lat, nbrs, rels, weights, deg + shift, scale=1.0, dtype=torch.float32,
        interior_weights=lambda a: np.full(26, -1.0), symmetric=True,
        min_grid_rows=min_grid_rows, device=device,
    )
    _sync(device)
    info["t_build_composite_s"] = time.perf_counter() - t0
    info["m_operator"] = int(comp.shape[0])
    info["n_interface_classes"] = len(comp.grid_meta)
    log(f"composite v2 built in {info['t_build_composite_s']:.2f} s (M={comp.shape[0]}, "
        f"{len(comp.grid_meta)} classes)")

    max_basis = max_basis or default_max_basis(kk)
    n_locked = n_locked or min(kk + 4, max_basis - 2)
    info["max_basis"], info["n_locked"] = max_basis, n_locked
    if save_vectors and os.path.exists(save_vectors):
        log(f"refining from {save_vectors}")
        with np.load(save_vectors) as z:
            lam32 = np.asarray(z["lam"], np.float64)
            X64 = np.asarray(z["X64"], np.float64)
        info["refine_resumed_from_vectors"] = True
        info["t_solve_fp32_s"] = 0.0
    else:
        v0 = np.zeros(comp.shape[0], dtype=np.float32)
        v0[idx_map] = np.random.default_rng(99).uniform(-1, 1, size=p).astype(np.float32)
        solve_op = comp
        if mesh is not None:
            from lanczos_tpu_torch.parallel import shard_operator

            solve_op = shard_operator(comp, mesh)
            v0 = solve_op.host.to_sharded(v0)
            info["sharded_ranks"] = mesh.size
        before = kernel_launches()
        t0 = time.perf_counter()
        res = eigsh_restarted(
            solve_op, k=kk, tol=fp32_tol, which="SA", v0=v0, compensated=True,
            max_basis=max_basis, n_locked=n_locked, max_cycles=max_cycles, rr_verify=False,
            verbose=verbose, checkpoint_path=checkpoint or None,
            checkpoint_every=checkpoint_every,
        )
        _sync(device)
        info["t_solve_fp32_s"] = time.perf_counter() - t0
        info["launches_solve"] = {
            name: {dt: n - before[name][dt] for dt, n in by_dt.items()}
            for name, by_dt in kernel_launches().items()}
        info["cycles"] = res.cycles
        lam32 = res.eigenvalues.cpu().numpy().astype(np.float64)
        if mesh is None:
            X64 = res.eigenvectors.double().cpu().numpy()
        else:  # every rank's rows, back in the level-major layout
            X64 = solve_op.host.from_sharded(
                mesh.all_gather(res.eigenvectors.double()).cpu().numpy())
        del res, solve_op
    log(f"fp32 solve {info['t_solve_fp32_s']:.2f} s, {info.get('cycles')} cycles, "
        f"lam[0]={lam32[0]:.9g}")

    t0 = time.perf_counter()
    lam = lam32
    try:
        lam, X64, _ = refine_eigenpairs_dd_hosted(
            comp, lam32, X64, tol=tol, max_rounds=refine_rounds, cg_steps=cg_steps,
            col_chunk=col_chunk, k_report=k, verbose=verbose,
        )
        _sync(device)
        info["refine_completed"] = True
    except Exception as e:  # keep the float32 pairs and measure them
        info["refine_completed"] = False
        info["refine_error"] = f"{type(e).__name__}: {e}"[:400]
        log(f"refinement FAILED ({info['refine_error']}); the float32 pairs are kept")
    info["t_refine_s"] = time.perf_counter() - t0
    if torch.device(device).type == "cuda":
        info["peak_device_gib"] = torch.cuda.max_memory_allocated() / 2**30
    info["t_solve_s"] = info["t_solve_fp32_s"] + info["t_refine_s"]
    log(f"refinement {info['t_refine_s']:.2f} s")
    if save_vectors:
        np.savez(save_vectors, lam=lam, X64=X64, idx_map=idx_map)

    # True residuals in float64 on the host matrix, for the first k pairs
    # (the buffer pairs guard the deflation window), column chunk by chunk.
    t0 = time.perf_counter()
    order = np.argsort(lam)[:k]
    lam_rep = lam[order] - shift
    L = host_laplacian(nbrs, deg)
    info["matrix_asymmetry"] = float(abs(L - L.T).max())
    rnorm, xn = np.empty(k), np.empty(k)
    for lo in range(0, k, col_chunk):
        hi = min(lo + col_chunk, k)
        Xc = X64[:, order[lo:hi]][idx_map, :]  # lattice-order columns
        xn[lo:hi] = np.linalg.norm(Xc, axis=0)
        rnorm[lo:hi] = np.linalg.norm(L @ Xc - Xc * lam_rep[None, lo:hi], axis=0)
    rnorm = rnorm / np.maximum(xn, 1e-300)
    true_res = rnorm / np.maximum(np.abs(lam_rep), 1.0)  # as scripts/northstar.py
    rel_shifted = rnorm / np.abs(lam_rep + shift)
    info["t_true_residuals_s"] = time.perf_counter() - t0
    info["eigenvalues_head"] = [float(v) for v in lam_rep[:10]]
    info["true_residual_max"] = float(true_res.max())
    info["true_residual_median"] = float(np.median(true_res))
    info["true_residual_shifted_max"] = float(rel_shifted.max())
    info["best_verified_residual"] = float(true_res.max())
    for e in (6, 7, 8):
        info[f"pairs_below_1e-{e}"] = int((true_res < 10.0**-e).sum())
    l_norm = float(abs(L).sum(axis=1).max())  # inf-norm bound
    info["operator_norm_bound"] = l_norm
    info["resid_over_opnorm_max"] = float((rnorm / l_norm).max())
    log(f"true residuals (k={k}): max {true_res.max():.2e} median {np.median(true_res):.2e} "
        f"(relative to the shifted eigenvalue: max {rel_shifted.max():.2e}; "
        f"/||L||: {info['resid_over_opnorm_max']:.2e}); pairs below 1e-8: "
        f"{info['pairs_below_1e-8']}")
    return info, {"lam": lam_rep, "rel_shifted": rel_shifted, "L": L, "op": comp,
                  "lam_shifted": lam, "X64": X64, "idx_map": idx_map}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-fine", type=int, default=432)
    ap.add_argument("--box-depth", type=int, default=3)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--k-buffer", type=int, default=10)
    ap.add_argument("--tol", type=float, default=1e-8)
    ap.add_argument("--fp32-tol", type=float, default=3e-7)
    ap.add_argument("--max-basis", type=int, default=0)
    ap.add_argument("--n-locked", type=int, default=0)
    ap.add_argument("--max-cycles", type=int, default=400)
    ap.add_argument("--refine-rounds", type=int, default=4)
    ap.add_argument("--col-chunk", type=int, default=8)
    ap.add_argument("--min-grid-rows", type=int, default=4096,
                    help="interface pieces below this go to the block-ELL tail")
    ap.add_argument("--cg-steps", type=int, default=200)
    ap.add_argument("--checkpoint", default="",
                    help="npz path for per-cycle solver checkpoints (locked block + restart "
                         "vector); the solve resumes from it when it exists")
    ap.add_argument("--checkpoint-every", type=int, default=10)
    ap.add_argument("--save-vectors", default="",
                    help="npz path for (lam, X64 region layout, idx_map); refines from it "
                         "when it exists")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default="northstar_torch.json")
    args = ap.parse_args()
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is visible; pass --device cpu")
    info, _ = run(
        n_fine=args.n_fine, box_depth=args.box_depth, k=args.k, k_buffer=args.k_buffer,
        tol=args.tol, fp32_tol=args.fp32_tol, max_basis=args.max_basis, n_locked=args.n_locked,
        max_cycles=args.max_cycles, refine_rounds=args.refine_rounds, col_chunk=args.col_chunk,
        min_grid_rows=args.min_grid_rows, cg_steps=args.cg_steps, checkpoint=args.checkpoint,
        checkpoint_every=args.checkpoint_every, save_vectors=args.save_vectors,
        device=args.device,
    )
    with open(args.out, "w") as f:
        json.dump(info, f, indent=1)
    print(json.dumps({key: info[key] for key in (
        "num_points", "nnz", "t_solve_s", "refine_completed", "true_residual_max",
        "pairs_below_1e-8")}))
    print(info["card"])
    return 0 if info["refine_completed"] else 1


if __name__ == "__main__":
    sys.exit(main())
