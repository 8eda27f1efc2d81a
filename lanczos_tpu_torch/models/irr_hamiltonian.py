"""Irregular-lattice Hamiltonian assembly: H = -T + V as padded ELL, as a
CompositeV2 or as the v1 CompositeOperator.

Counterpart of ``lanczos_tpu/models/irr_hamiltonian.py``.  The row assembly
(neighbor search, least-squares weights solved once per unique stencil
class with the same hash seed, radius escalation) is the same host numpy,
so both packages give bit-identical rows; the potential is the port's own,
evaluated on CPU float64 tensors.  The operators are placed on ``device``.

The assembled operator is generally NON-symmetric (the least-squares weights
of point i's cloud need not match point j's).  Solve it with
``solver.arnoldi.eigs_nonsym`` (Krylov–Schur) or, in float64,
``solver.two_sided.two_sided_lanczos``; a Ritz value whose true residual
``||Hx - lambda x||`` is not small is a ghost and is discarded.
Symmetrizing instead introduces spurious interface-localized negative
eigenmodes (O(10 MeV) deep at 2:1 spacing contrast) because the one-sided
LSQ stencils are consistent but not symmetric at refinement boundaries.
``assemble_irregular_hamiltonian`` offers it all the same, with that caveat:
  "normal"  : H^T H (the reference's escape hatch, IrrHamiltonian.py:23-24)
  "average" : (H + H^T)/2
  "volume"  : (S + S^T)/2 with S = D^{1/2} H D^{-1/2}, D = diag(cell
              volumes a_i^3).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .._util import DEFAULT_DEVICE, as_torch_dtype
from ..ops.assemble import ell_from_coo, ell_from_scipy
from ..ops.operators import EllOperator
from .irrlap import laplacian_weights_batch
from .lattice import IrregularLattice, find_neighbors
from .potentials import DEUTERON_REDUCED_REST_ENERGY_MEV, kinetic_prefactor

__all__ = [
    "assemble_irregular_hamiltonian",
    "assemble_irregular_hamiltonian_composite",
    "assemble_irregular_hamiltonian_composite2",
    "irregular_laplacian_rows",
]


def _solve_weights_dedup(nbrs, rels):
    """LSQ weights, solved once per UNIQUE stencil class (canonical key = the
    offset cloud + its mask; clouds arrive in deterministic scan order, so
    equal clouds have equal keys — the array form of the reference's hash
    memoization, IrrLap.py:42-45 / Stencils.py:39-55).

    Grouping uses two independent 64-bit random-projection hashes of each
    row's (offsets, mask) record instead of np.unique(axis=0) — the latter
    sorts the full (P, ~4K) byte matrix (tens of seconds at P~1e5); hashing
    is one chunked pass.  Collision probability over 128 bits is
    negligible (and the reference's own memoization, HashList, accepted far
    weaker hashing, IrrLap.py:20-34).
    """
    p, k = nbrs.shape
    nd = rels.shape[-1]
    mask = nbrs >= 0
    rng = np.random.default_rng(0xC0FFEE)
    proj = rng.integers(1, 2**63, size=(2, (nd + 1) * k), dtype=np.uint64)
    proj |= 1  # odd multipliers mix better under wraparound

    h = np.empty((2, p), dtype=np.uint64)
    chunk = max(1, (1 << 24) // ((nd + 1) * k))
    for lo in range(0, p, chunk):
        hi = min(p, lo + chunk)
        rec = np.concatenate(
            [
                (rels[lo:hi].reshape(hi - lo, -1) + (1 << 20)).astype(np.uint64),
                mask[lo:hi].astype(np.uint64),
            ],
            axis=1,
        )
        # Wrapping multiply-accumulate; position-dependent by projection.
        with np.errstate(over="ignore"):
            h[0, lo:hi] = (rec * proj[0]).sum(axis=1, dtype=np.uint64)
            h[1, lo:hi] = (rec * proj[1]).sum(axis=1, dtype=np.uint64)

    key = h[0] ^ (h[1] << np.uint64(1))
    order = np.argsort(key, kind="stable")
    ks = key[order]
    first = np.empty(p, dtype=bool)
    first[:1] = True
    first[1:] = ks[1:] != ks[:-1]
    group_of_sorted = np.cumsum(first) - 1
    inverse = np.empty(p, dtype=np.int64)
    inverse[order] = group_of_sorted
    reps = order[first]  # one representative row per class

    uniq_w = laplacian_weights_batch(rels[reps], mask[reps])
    weights = uniq_w[inverse]
    weights[~mask] = 0.0
    return weights


def _moment_violation(rels, weights):
    """Per-row deviation from the Laplacian moment conditions
    sum w x_a = 0, sum w x_a x_b = 2 delta_ab."""
    x = rels.astype(np.float64)
    nd = rels.shape[-1]
    err = np.zeros(len(weights))
    for a in range(nd):
        err = np.maximum(err, np.abs(np.einsum("pk,pk->p", weights, x[..., a])))
        for b in range(a, nd):
            target = 2.0 if a == b else 0.0
            err = np.maximum(
                err,
                np.abs(
                    np.einsum("pk,pk->p", weights, x[..., a] * x[..., b])
                    - target
                ),
            )
    return err


def irregular_laplacian_rows(
    lat: IrregularLattice,
    *,
    min_neighbors: Optional[int] = None,
    max_d: int = 3,
    moment_tol: float = 1e-6,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Neighbor indices, offsets, and LSQ Laplacian weights for every point.

    Returns (nbrs (P, K) padded with -1, rels (P, K, 3), weights (P, K) with
    0 on padding).  Starts from the D=1 search and ESCALATES the search
    radius per row until that row's weights satisfy the Laplacian moment
    conditions to ``moment_tol``.  This subsumes the reference's
    count-based widening rule (<26 neighbors -> D=2, IrrHamiltonian.py:49-53)
    and additionally repairs rows whose mirror-filtered cloud is large but
    DEGENERATE (e.g. nearly planar at fine/coarse corners) — those pass the
    reference's count test yet yield a singular moment matrix and a
    non-Laplacian row (an unvalidated failure mode of the reference).
    """
    p = lat.num_points
    if min_neighbors is None:
        min_neighbors = 3**lat.ndim - 1  # the reference's 26 in 3D
    nbrs, rels = find_neighbors(lat, 1)
    weights = _solve_weights_dedup(nbrs, rels)
    counts = (nbrs >= 0).sum(axis=1)
    bad = (counts < min_neighbors) | (_moment_violation(rels, weights) > moment_tol)

    d = 2
    while bad.any() and d <= max_d:
        wi = np.nonzero(bad)[0]
        nbrs_w, rels_w = find_neighbors(lat, d, wi)
        w_w = _solve_weights_dedup(nbrs_w, rels_w)
        k = max(nbrs.shape[1], nbrs_w.shape[1])

        def pad(a, k, fill):
            if a.shape[1] >= k:
                return a
            pw = [(0, 0), (0, k - a.shape[1])] + [(0, 0)] * (a.ndim - 2)
            return np.pad(a, pw, constant_values=fill)

        nbrs, rels, weights = pad(nbrs, k, -1), pad(rels, k, 0), pad(weights, k, 0)
        nbrs[wi] = pad(nbrs_w, k, -1)
        rels[wi] = pad(rels_w, k, 0)
        weights[wi] = pad(w_w, k, 0)
        bad = np.zeros(p, dtype=bool)
        bad[wi] = _moment_violation(rels[wi], weights[wi]) > moment_tol
        d += 1

    if bad.any():
        raise ValueError(
            f"{int(bad.sum())} lattice points have no consistent Laplacian "
            f"stencil within search depth {max_d}; lattice spacing contrast "
            "is too harsh"
        )
    return nbrs, rels, weights


def _diagonal(lat, weights, t_factor, potential) -> np.ndarray:
    """+T_factor * sum(w) (from -T, whose diagonal is -sum(w),
    IrrHamiltonian.py:62-64) plus the potential at each point, evaluated on
    CPU float64 tensors."""
    diag = t_factor * weights.sum(axis=1)
    if potential is not None:
        phys = lat.physical_coords()
        v = potential(*(torch.from_numpy(phys[:, a]) for a in range(lat.ndim)))
        diag = diag + np.asarray(v, dtype=np.float64)
    return diag


def assemble_irregular_hamiltonian_composite(
    lat: IrregularLattice,
    potential: Optional[Callable] = None,
    *,
    t_factor: Optional[float] = None,
    rest_energy: float = DEUTERON_REDUCED_REST_ENERGY_MEV,
    dtype=torch.float32,
    device=DEFAULT_DEVICE,
):
    """H = -T + V as a v1 CompositeOperator (``ops/composite.py``).

    Returns (op, perm): ``perm`` maps lattice point order -> the operator's
    level-major order (operator vectors are lattice vectors indexed by
    perm).  Numerically the padded-ELL assembly's operator.
    """
    from ..ops.composite import build_composite

    if t_factor is None:
        t_factor = kinetic_prefactor(lat.s, rest_energy)
    nbrs, rels, weights = irregular_laplacian_rows(lat)
    diag = _diagonal(lat, weights, t_factor, potential)
    return build_composite(
        lat, nbrs, rels, weights, diag, scale=-t_factor, dtype=dtype, device=device,
    )


def assemble_irregular_hamiltonian_composite2(
    lat: IrregularLattice,
    potential: Optional[Callable] = None,
    *,
    t_factor: Optional[float] = None,
    rest_energy: float = DEUTERON_REDUCED_REST_ENERGY_MEV,
    dtype=torch.float32,
    min_grid_rows: int = 16,
    build_transpose: bool = False,
    device=DEFAULT_DEVICE,
):
    """H = -T + V as a CompositeV2 (region-native strided irregular format).

    Returns (op, idx_map): scatter lattice-order vectors into the operator's
    region-native layout with ``v_op[idx_map] = v_lat`` and gather back with
    ``v_op[idx_map]`` (see ops.composite2).  Numerically the padded-ELL
    assembly's operator.  A Krylov start vector must be multiplied by
    ``op.live``: the dead slots carry an exact eigenvalue 0.

    ``build_transpose=True`` materializes H^T in the same format (the
    two-sided recurrence needs H^T p every step).  The interface classes
    are applied by the CUDA kernel of ops.interface_kernel (its plain
    version on the CPU).
    """
    from ..ops.composite2 import build_composite_v2

    if t_factor is None:
        t_factor = kinetic_prefactor(lat.s, rest_energy)
    nbrs, rels, weights = irregular_laplacian_rows(lat)
    diag = _diagonal(lat, weights, t_factor, potential)
    return build_composite_v2(
        lat, nbrs, rels, weights, diag, scale=-t_factor, dtype=dtype,
        min_grid_rows=min_grid_rows, build_transpose=build_transpose,
        device=device,
    )


def assemble_irregular_hamiltonian(
    lat: IrregularLattice,
    potential: Optional[Callable] = None,
    *,
    t_factor: Optional[float] = None,
    rest_energy: float = DEUTERON_REDUCED_REST_ENERGY_MEV,
    symmetrize: Optional[str] = None,
    dtype=torch.float32,
    device=DEFAULT_DEVICE,
) -> EllOperator:
    """H = -T + V on the irregular lattice, as a padded-ELL operator.

    t_factor defaults to the physical kinetic prefactor with dx = the FINE
    grid spacing s = L/(N-1) (the LSQ weights are in fine-grid units).
    """
    p = lat.num_points
    if t_factor is None:
        t_factor = kinetic_prefactor(lat.s, rest_energy)
    dtype = as_torch_dtype(dtype)

    nbrs, rels, weights = irregular_laplacian_rows(lat)
    k = nbrs.shape[1]
    mask = nbrs >= 0
    diag = _diagonal(lat, weights, t_factor, potential)

    rows = np.repeat(np.arange(p, dtype=np.int64), k)[mask.reshape(-1)]
    cols = nbrs.reshape(-1)[mask.reshape(-1)]
    vals = (-t_factor * weights).reshape(-1)[mask.reshape(-1)]
    rows = np.concatenate([rows, np.arange(p, dtype=np.int64)])
    cols = np.concatenate([cols, np.arange(p, dtype=np.int64)])
    vals = np.concatenate([vals, diag])

    if symmetrize is None or symmetrize == "none":
        return ell_from_coo(rows, cols, vals, p, dtype=dtype, device=device)

    import scipy.sparse

    h = scipy.sparse.coo_matrix((vals, (rows, cols)), shape=(p, p)).tocsr()
    if symmetrize == "normal":
        # Normal equations H^T H (IrrHamiltonian.py:23-24): symmetric positive
        # semidefinite; eigenvalues are the squared singular values of H.
        h = (h.T @ h).tocoo()
    elif symmetrize == "average":
        h = (0.5 * (h + h.T)).tocoo()
    elif symmetrize == "volume":
        vol = (lat.spacings[lat.box_of_point] ** lat.ndim).astype(np.float64)
        d = np.sqrt(vol)
        s = scipy.sparse.diags(d) @ h @ scipy.sparse.diags(1.0 / d)
        h = (0.5 * (s + s.T)).tocoo()
    else:
        raise ValueError(f"unknown symmetrize={symmetrize!r}")
    return ell_from_scipy(h, dtype=dtype, device=device)
