"""A multi-rank dry run of every sharded path on tiny shapes.

    python -m lanczos_tpu_torch.parallel.dryrun 4                 # 4 NCCL ranks, 4 cards
    python -m lanczos_tpu_torch.parallel.dryrun 4 --device cpu    # 4 gloo ranks

Counterpart of ``__graft_entry__.py:dryrun_multichip``, with the same steps
and shapes: row-sharded Lanczos on the z-slab stencil (halo exchange,
all-reduced reductions, Ritz extraction), the all-gather ELL, the sharded
v1 composite through ``eigs_nonsym`` and ``eigsh_restarted``, the sharded
CompositeV2 through ``eigsh_restarted``, and the exchange volume of each
format.  The ranks are local processes: NCCL ranks, one card each, unless
the caller asks for gloo ranks on the CPU (``device="cpu"``).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .._util import DEFAULT_DEVICE
from .launch import run_ranks

__all__ = ["dryrun_multichip", "graph_laplacian_v2"]


def graph_laplacian_v2(n_fine, dtype=torch.float32, device=DEFAULT_DEVICE):
    """The symmetric graph Laplacian + 1 of the mixed lattice (box depth 3,
    the centre box at spacing 1, the rest at 2) as a CompositeV2, with its
    idx_map and point count: the JAX dry run's and ``tests/
    test_distributed.py``'s operator.  Its level regions are n_fine/3 (fine)
    and n_fine/2 (coarse) planes deep."""
    import lanczos_tpu_torch as lt
    from ..models.lattice import find_neighbors
    from ..ops.composite2 import build_composite_v2

    bd = 3
    sp = np.full(bd**3, 2, dtype=np.int64)
    sp[bd**3 // 2] = 1
    lat = lt.build_lattice(n_fine, 25.0, bd, spacings=sp)
    nbrs, rels = find_neighbors(lat, 1)
    p, kk = nbrs.shape
    rows = np.repeat(np.arange(p, dtype=np.int64), kk)
    cols = nbrs.reshape(-1)
    valid = cols >= 0
    fwd = rows[valid] * p + cols[valid]
    bwd = np.sort(cols[valid] * p + rows[valid])
    pos = np.minimum(np.searchsorted(bwd, fwd), len(bwd) - 1)
    keep = np.zeros(len(rows), dtype=bool)
    keep[valid] = bwd[pos] == fwd
    keep = keep.reshape(p, kk)
    comp, idx_map = build_composite_v2(
        lat, np.where(keep, nbrs, -1), rels, np.where(keep, -1.0, 0.0),
        keep.sum(axis=1).astype(np.float64) + 1.0, scale=1.0, dtype=dtype,
        interior_weights=lambda a: np.full(26, -1.0), symmetric=True, min_grid_rows=4,
        device=device,
    )
    return comp, idx_map, p


def _dryrun_rank(mesh, n_devices):
    """One rank's dry run; returns what rank 0 reports."""
    import lanczos_tpu_torch as lt
    from ..solver.restart import eigsh_restarted
    from ..solver.tridiag import ritz_from_factorization
    from ..utils.metrics import exchange_stats
    from .distributed import lanczos_sharded, shard_operator

    dev = mesh.device
    n_grid = max(2 * n_devices, 8)
    H = lt.build_regular_hamiltonian(n_grid, 25.0, lt.deuteron_potential_3d, stencil="27",
                                     dtype=torch.float32, device=dev)
    Hs = shard_operator(H, mesh)
    fac = lanczos_sharded(Hs, 8)
    theta, _, _ = ritz_from_factorization(fac)

    # The row-sharded ELL (all-gather SpMV).
    ell = shard_operator(H.to_ell(), mesh)
    fac2 = lanczos_sharded(ell, 4)
    assert bool(torch.isfinite(theta).all()) and bool(torch.isfinite(fac2.alpha).all())
    np.testing.assert_allclose(fac.alpha[:4].cpu().numpy(), fac2.alpha.cpu().numpy(),
                               rtol=2e-4, atol=2e-4)

    # The sharded v1 composite: boxes split over ranks, face-table halos,
    # per-rank interface rows, through Krylov-Schur and the restarted solver.
    lat = lt.build_lattice(24, 25.0, 3, overwrite_spacing=True)
    comp, _ = lt.assemble_irregular_hamiltonian_composite(
        lat, lt.deuteron_potential_3d, dtype=torch.float32, device=dev)
    comp_s = shard_operator(comp, mesh)
    res = lt.eigs_nonsym(comp_s, k=2, tol=1e-3, max_basis=20, max_cycles=3, which="SR")
    res_r = eigsh_restarted(comp_s, k=2, tol=1e-2, max_basis=16, max_cycles=3,
                            rr_verify=False)
    assert np.isfinite(res.eigenvalues.cpu().numpy()).all()
    assert np.isfinite(res_r.eigenvalues.cpu().numpy()).all()

    # The sharded CompositeV2 (the north-star operator) through the
    # restarted symmetric solver.
    # Every level's z-extent divides the mesh: fine 2n, coarse 3n planes.
    comp2, idx_map2, p2 = graph_laplacian_v2(6 * n_devices, device=dev)
    comp2_s = shard_operator(comp2, mesh)
    v0 = np.zeros(comp2.shape[0], dtype=np.float32)
    v0[idx_map2] = np.random.default_rng(0).uniform(-1, 1, p2)
    res_v2 = eigsh_restarted(comp2_s, k=2, tol=1e-2, max_basis=16, max_cycles=3,
                             rr_verify=False, v0=comp2_s.host.to_sharded(v0))
    assert np.isfinite(res_v2.eigenvalues.cpu().numpy()).all()

    exchange = {label: exchange_stats(op, n_devices)
                for label, op in (("stencil", Hs), ("ell-allgather", ell),
                                  ("composite-v2", comp2_s))}
    return {
        "rank": mesh.rank, "n_grid": n_grid, "lowest_ritz": float(theta.min()),
        "composite_p": int(comp.shape[0]), "composite_lowest": float(res.eigenvalues[0]),
        "restarted_lowest": float(res_r.eigenvalues[0]),
        "composite_v2_m": int(comp2.shape[0]),
        "composite_v2_lowest": float(res_v2.eigenvalues[0]),
        "alpha": fac.alpha.cpu().numpy(), "exchange": exchange,
    }


def dryrun_multichip(n_devices: int, device: str = DEFAULT_DEVICE,
                     timeout: float = 600.0) -> dict:
    """Run every sharded path once on ``n_devices`` local ranks and print
    the exchange volumes.  ``device`` defaults to ``"cuda"``: NCCL ranks,
    one card each; a host with fewer than ``n_devices`` cards raises
    ValueError unless the caller passes ``device="cpu"`` (gloo ranks).
    Returns rank 0's report; raises if any rank fails or the ranks disagree
    on alpha."""
    if torch.device(device).type == "cuda":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < n_devices:
            raise ValueError(f"dryrun_multichip({n_devices}) needs {n_devices} cards for its "
                             f"NCCL ranks and this host has {cards}; pass device=\"cpu\" "
                             "for gloo ranks on the CPU")
    reports = run_ranks(_dryrun_rank, n_devices, n_devices, device=device, timeout=timeout)
    for rep in reports[1:]:
        np.testing.assert_array_equal(rep["alpha"], reports[0]["alpha"])
    rep = reports[0]
    for label, ex in rep["exchange"].items():
        print(f"  exchange[{label}]: {ex['per_device_recv_elements']} elems "
              f"({ex['per_device_recv_bytes'] / 1e6:.3f} MB) per device per matvec = "
              f"{100 * ex['fraction_of_m']:.2f}% of M [{ex['kind']}]")
    print(f"dryrun_multichip({n_devices}, {device}): ok — grid {rep['n_grid']}^3, lowest Ritz "
          f"{rep['lowest_ritz']:.4f}; sharded composite (P={rep['composite_p']}) lowest "
          f"{rep['composite_lowest']:.4f}; sharded eigsh_restarted lowest "
          f"{rep['restarted_lowest']:.4f}; sharded CompositeV2 (M={rep['composite_v2_m']}) "
          f"lowest {rep['composite_v2_lowest']:.4f}")
    return rep


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="a multi-rank dry run of every sharded path")
    ap.add_argument("n_devices", type=int, nargs="?", default=4)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: NCCL ranks, one card each; cpu: gloo ranks")
    args = ap.parse_args()
    dryrun_multichip(args.n_devices, device=args.device)
