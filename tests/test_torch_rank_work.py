"""What each rank of the port's multi-process tests runs (no tests here).

The tests start their ranks with ``lanczos_tpu_torch.parallel.launch.
run_ranks``, which imports these functions by name in fresh processes; so
this module imports torch and the port only, never JAX.  Each function
takes the rank's RowMesh and numpy inputs made by the test, and returns
numpy results: a rank's rows of a vector, which the test concatenates in
rank order, or values that every rank holds.
"""

import contextlib
import os

import scipy.sparse
import torch

import lanczos_tpu_torch as pt
from lanczos_tpu_torch.ops.assemble import ell_from_scipy
from lanczos_tpu_torch.parallel import (
    lanczos_sharded,
    shard_ell_halo,
    shard_operator,
)
from lanczos_tpu_torch.parallel.composite2 import shard_composite_v2
from lanczos_tpu_torch.parallel.dryrun import graph_laplacian_v2
from lanczos_tpu_torch.solver.restart import eigsh_restarted
from lanczos_tpu_torch.utils import checkpoint as ck
from lanczos_tpu_torch.utils.metrics import exchange_stats


def _np(t):
    return t.detach().cpu().numpy()


def _rows(op, x):
    """This rank's rows of a global numpy vector, as a tensor."""
    return torch.as_tensor(x[op.row_offset:op.row_offset + op.local_rows])


def _fac(fac):
    return {"alpha": _np(fac.alpha), "beta": _np(fac.beta), "V": _np(fac.V)}


def _regular(n):
    return pt.build_regular_hamiltonian(n, 25.0, pt.deuteron_potential_3d, stencil="27",
                                        dtype=torch.float64, device="cpu")


def distributed(mesh, case):
    """The sharded stencil, ELL and halo ELL: matvecs, Lanczos, exchange
    stats; then the sharded restarted solve and its checkpoint resume."""
    out = {}
    h16 = shard_operator(_regular(16), mesh)
    out["stencil_y"] = _np(h16.matvec(_rows(h16, case["x16"])))
    out["stencil"] = _fac(lanczos_sharded(h16, case["n16"], v0=case["v0_16"]))
    out["stencil_seeded"] = _fac(lanczos_sharded(h16, 8, seed=3))

    a = scipy.sparse.csr_matrix(case["ell"])
    ell = shard_operator(ell_from_scipy(a, dtype=torch.float64, device="cpu"), mesh)
    out["ell_y"] = _np(ell.matvec(_rows(ell, case["x_ell"])))
    out["ell"] = _fac(lanczos_sharded(ell, case["n_ell"], v0=case["v0_ell"]))

    hop = shard_ell_halo(_regular(32).to_ell(), mesh)
    out["halo_cols"] = _np(hop.cols)
    out["halo_export_ids"] = _np(hop.export_ids)
    out["halo_y"] = _np(hop.matvec(_rows(hop, case["x32"])))
    out["halo"] = _fac(lanczos_sharded(hop, case["n32"], v0=case["v0_32"]))
    out["exchange"] = {"stencil": exchange_stats(h16, mesh.size),
                       "ell": exchange_stats(ell, mesh.size),
                       "halo": exchange_stats(hop, mesh.size)}

    # Restarted solve, whole and stopped after 2 cycles then resumed from
    # this rank's own checkpoint file.
    kw = dict(k=3, tol=1e-9, max_cycles=60, v0=case["v0_16"])
    full = eigsh_restarted(h16, **kw)
    path = os.path.join(case["tmp"], "ck.npz")
    eigsh_restarted(h16, **{**kw, "max_cycles": 2}, checkpoint_path=path)
    real_load = ck.load_restart_state
    mine = f"ck.rank{mesh.rank}of{mesh.size}.npz"
    V_locked, u, _, _, cycle = real_load(os.path.join(case["tmp"], mine))
    read = []

    def spy(p):
        read.append(os.path.basename(p))
        return real_load(p)

    ck.load_restart_state = spy
    try:
        resumed = eigsh_restarted(h16, **{**kw, "v0": None}, checkpoint_path=path)
    finally:
        ck.load_restart_state = real_load
    out["restarted"] = {
        "full": _np(full.eigenvalues), "full_resid": _np(full.residuals),
        "vecs": _np(full.eigenvectors), "resumed": _np(resumed.eigenvalues),
        "resumed_cycles": resumed.cycles, "read": read, "mine": mine,
        "file_rows": V_locked.shape, "file_u": u.shape, "file_cycle": cycle,
    }
    return out


def composite_v2(mesh, case):
    """The sharded CompositeV2: matvecs on the n=24 (thin runs forced) and
    n=48 lattices, exchange counts, and the restarted solve at n=24."""
    out = {}
    for n, frac in ((24, 10.0), (48, 0.6)):
        comp, _, _ = graph_laplacian_v2(n, dtype=torch.float64, device="cpu")
        op = shard_composite_v2(comp, mesh, degenerate_frac=frac)
        x = _rows(op, op.host.to_sharded(case[f"x{n}"]))
        out[n] = {"y": _np(op.matvec(x)), "runs": op.support_runs,
                  "exchange": exchange_stats(op, mesh.size), "live": _np(op.live)}
        if n == 24:
            res = eigsh_restarted(op, k=4, tol=1e-9, max_cycles=80,
                                  v0=op.host.to_sharded(case["v0_24"]))
            out["restarted"] = {"vals": _np(res.eigenvalues), "resid": _np(res.residuals),
                                "vecs": _np(res.eigenvectors)}
    return out


def composite_v1(mesh, case):
    """The sharded v1 composite: its host arrays' rows, a matvec, and the
    sharded eigs_nonsym on the lattice of tests/test_distributed.py."""
    lat = pt.build_lattice(12, 25.0, 3, overwrite_spacing=True)
    comp, _ = pt.assemble_irregular_hamiltonian_composite(
        lat, pt.deuteron_potential_3d, dtype=torch.float64, device="cpu")
    op = shard_operator(comp, mesh)
    res = pt.eigs_nonsym(op, k=3, tol=1e-9, which="SR")
    x = _rows(op, op.host.to_sharded(case["x"]))
    return {"y": _np(op.matvec(x)), "vals": _np(res.eigenvalues),
            "resid": _np(res.residuals), "live": _np(op.live)}


def sharded_graphs(mesh, case):
    """The sharded solves through CycleGraphs' card path with stub graphs
    (``torch_graph_stub``), each beside the same solve under
    ``graphs.eager()``: eigsh_restarted on the z-slab stencil (plain and
    compensated), eigs_nonsym on the sharded CompositeV2 and on the v1
    composite.  Also whether ``capturable`` takes this (gloo) mesh."""
    import types

    from lanczos_tpu_torch.solver import graphs
    from torch_graph_stub import install

    out = {"backend": mesh.backend, "capturable": graphs.capturable(
        types.SimpleNamespace(device=torch.device("cuda"), mesh=mesh))}
    install()
    h16 = shard_operator(_regular(16), mesh)
    comp, _, _ = graph_laplacian_v2(24, dtype=torch.float64, device="cpu")
    v2 = shard_composite_v2(comp, mesh, degenerate_frac=10.0)
    lat = pt.build_lattice(12, 25.0, 3, overwrite_spacing=True)
    v1 = shard_operator(pt.assemble_irregular_hamiltonian_composite(
        lat, pt.deuteron_potential_3d, dtype=torch.float64, device="cpu")[0], mesh)
    solves = {
        name: (lambda op=op, kw=kw: solver(op, **kw))
        for name, solver, op, kw in (
            ("restarted", eigsh_restarted, h16, case["restarted"]),
            ("restarted_compensated", eigsh_restarted, h16,
             dict(case["restarted"], compensated=True)),
            ("nonsym_v2", pt.eigs_nonsym, v2,
             dict(case["nonsym_v2"], v0=v2.host.to_sharded(case["v0_24"]))),
            ("nonsym_v1", pt.eigs_nonsym, v1, case["nonsym_v1"]),
        )
    }
    for name, solve in solves.items():
        runs = {}
        for mode in ("captured", "eager"):
            graphs.reset_stats()
            with graphs.eager() if mode == "eager" else contextlib.nullcontext():
                res = solve()
            runs[mode] = {"vals": _np(res.eigenvalues), "vecs": _np(res.eigenvectors),
                          "resid": _np(res.residuals), "inner": _np(res.inner_prod),
                          "stats": {k: v for k, v in graphs.stats.items()}}
        out[name] = runs
    return out


def row_sum(mesh):
    """Each rank's rows of arange(8 D); the all-reduced sum."""
    local = torch.arange(8.0, dtype=torch.float64) + 8 * mesh.rank
    return float(mesh.all_reduce(local.sum())), mesh.rank, mesh.size


def two_rank_lanczos(mesh, v0, n):
    """Lanczos of the 16^3 Hamiltonian over the two ranks and in one."""
    H = _regular(16)
    fac = lanczos_sharded(shard_operator(H, mesh), n, v0=v0)
    ref = pt.lanczos(H, n, v0=v0)
    return _np(fac.alpha), _np(fac.beta), _np(ref.alpha), _np(ref.beta)


def collectives(mesh, a, b):
    """The RowMesh collectives on this rank's rows of a and b: the halo
    exchange of the first and last rows, an all-gather, and the sharded
    compensated dots in float32 and float64."""
    rows = len(a) // mesh.size
    mine = slice(mesh.rank * rows, (mesh.rank + 1) * rows)
    x = torch.as_tensor(a[mine]).reshape(rows, -1)
    from_prev, from_next = mesh.halo_exchange(x[0], x[-1])
    dots = {dt: float(mesh.dot2_rounded(torch.as_tensor(a[mine].ravel(), dtype=dt),
                                        torch.as_tensor(b[mine].ravel(), dtype=dt)))
            for dt in (torch.float32, torch.float64)}
    return {"from_prev": _np(from_prev), "from_next": _np(from_next),
            "gathered": _np(mesh.all_gather(x)), "dots": dots}


def fail_on_rank_one(mesh):
    if mesh.rank == 1:
        raise ValueError("rank one fails")
    return mesh.all_reduce(torch.ones(1))  # rank 0 waits here until it is stopped


def hang(mesh):
    import time

    time.sleep(600)
