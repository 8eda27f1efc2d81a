"""CGS2 reorthogonalization on the CPU: the solver's dispatch and counters,
its plain path against the JAX package's CGS2, and the CUDA kernel's index
math (``lanczos_tpu_torch/csrc/cgs2.cu``) emulated in numpy.

The kernel itself runs only on a card (``tests/test_torch_cuda.py``); here
its tile width, loader, swizzle, step A's row groups, step B's (row,
segment) pairs and the block and grid sums are replayed with the source's
own constants, and the result is held to the plain loop.  Change the
emulation with the kernel.
"""

import re
from pathlib import Path

import jax  # noqa: F401  (kept on the CPU by conftest)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import lanczos_tpu as lt  # noqa: E402
from lanczos_tpu.solver.lanczos import _default_basis_dot as jax_basis_dot  # noqa: E402
from lanczos_tpu.solver.lanczos import _orthogonalize as jax_orthogonalize  # noqa: E402
from lanczos_tpu.solver.lanczos import lanczos_kernel as jax_lanczos_kernel  # noqa: E402

import lanczos_tpu_torch as pt  # noqa: E402
from lanczos_tpu_torch._util import COUNTERS  # noqa: E402
from lanczos_tpu_torch.ops import cgs2_kernels  # noqa: E402
from lanczos_tpu_torch.ops.cgs2_kernels import local_basis_dot, orthogonalize  # noqa: E402

SOURCE = Path(pt.__file__).resolve().parent / "csrc" / "cgs2.cu"
K = {name: int(value) for name, value in
     re.findall(r"constexpr int (k\w+) = (\d+);", SOURCE.read_text())}
THREADS = K["kThreads"]
MAX_ROWS = K["kTileBytes"] // K["kRowBytes"] - 1


def _basis(j, m, dtype=torch.float64, seed=0):
    q, _ = torch.linalg.qr(torch.from_numpy(np.random.default_rng(seed).standard_normal((m, j))))
    return q.T.contiguous().to(dtype)


@pytest.mark.parametrize("passes", [1, 2])
def test_cpu_tensors_run_the_plain_path_and_count_the_call(passes):
    V = _basis(12, 200)
    v = torch.from_numpy(np.random.default_rng(1).standard_normal(200))
    calls, fused = COUNTERS["lt.cgs2.calls"], COUNTERS["lt.cgs2.fused"]
    got = orthogonalize(V, v, passes, local_basis_dot)
    assert COUNTERS["lt.cgs2.calls"] - calls == 1 and COUNTERS["lt.cgs2.fused"] == fused
    want = v
    for _ in range(passes):
        want = want - (V @ want) @ V
    assert torch.equal(got, want)  # the same loop, the same sums
    assert torch.equal(cgs2_kernels.cgs2(V, v, passes), want)  # the wrapper's CPU branch
    # A custom basis_dot (a mesh's, say) takes the loop with it.
    seen = []
    mesh_dot = lambda A, x: seen.append(1) or A @ x  # noqa: E731
    assert torch.equal(orthogonalize(V, v, passes, mesh_dot), want)
    assert len(seen) == passes
    assert COUNTERS["lt.cgs2.calls"] - calls == 2 and COUNTERS["lt.cgs2.fused"] == fused


@pytest.mark.parametrize("passes", [1, 2])
def test_plain_path_matches_jax_cgs2_on_a_stencil_basis(passes):
    # The Lanczos basis of the N=8 deuteron (fp64) and the next step's w,
    # orthogonalized by both packages' CGS.
    H = lt.build_regular_hamiltonian(8, 25.0, lt.deuteron_potential_3d, stencil="27",
                                     dtype="float64")
    v0 = np.random.default_rng(3).uniform(-1, 1, H.shape[0])
    fac = jax_lanczos_kernel(H.matvec, v0, 30)
    V = np.array(fac.V)
    w = np.array(H.matvec(jnp.asarray(V[-1])))
    want = np.asarray(jax_orthogonalize(jnp.asarray(V), jnp.asarray(w), jax_basis_dot, passes))
    got = orthogonalize(torch.from_numpy(V), torch.from_numpy(w), passes, local_basis_dot)
    scale = float(np.abs(w).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12 * scale)
    assert float(np.abs(V @ got.numpy()).max()) < 1e-12 * scale


# ---- the kernel's index math, emulated ---------------------------------


def tile_cols(j, elem):
    unit = K["kRowBytes"] // elem
    c = K["kTileBytes"] // ((j + 1) * elem) // unit * unit
    return min(c, K["kMaxColBytes"] // elem)


def swz(r, c, C, kv):
    return r * C + (((c // kv) ^ (r & 7)) * kv) + (c & (kv - 1))


def smem_elems(j, C, kv):
    return 2 * (j + 1) * C + (j + kv - 1) // kv * kv + C


def load_tile(V, v, j, C, c0, kload, kv):
    """One stage as the loader fills it: every thread's copies in lockstep,
    with the kernel's incremental (row, chunk) walk."""
    M = V.shape[1]
    per_row = C // kload
    dr, dk = THREADS // per_row, THREADS - (THREADS // per_row) * per_row
    t = np.arange(THREADS)
    r, k = t // per_row, t - (t // per_row) * per_row
    rows, cols = [], []
    while (r <= j).any():
        live = r <= j
        rows.append(r[live])
        cols.append(k[live] * kload)
        k, r = k + dk, r + dr
        wrap = k >= per_row
        k, r = np.where(wrap, k - per_row, k), np.where(wrap, r + 1, r)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    # Every (row, copy) of the tile exactly once.
    pairs = rows * C + cols
    assert len(pairs) == (j + 1) * per_row and len(np.unique(pairs)) == len(pairs)
    src = np.vstack([V, v[None]])
    stage = np.full((j + 1) * C, np.nan)
    for e in range(kload):
        g = c0 + cols + e
        stage[swz(rows, cols + e, C, kv)] = np.where(
            g < M, src[rows, np.minimum(g, M - 1)], 0.0)
    assert not np.isnan(stage).any()
    return stage


def sweep(mode, V, v, h, blocks, elem, kload):
    """One launch of cgs2_sweep (mode "project", "fused", "update", "finish"
    or "fusednorm") and, but for "update", the block sums added in block
    order (cgs2_reduce; cgs2_reduce_norm's scaling is left to the caller):
    (out or None, sums or None).  "finish" updates row j - 1 of V by the
    rows before it (written back to the tile, and to out) and projects v;
    "fusednorm" is "fused" with the new vector written to the tile's row j,
    so that one more step-B row gives its squared norm."""
    j, M = V.shape
    ja = j - 1 if mode == "finish" else j  # step A: rows [0, ja) update row ja
    jb = j + 1 if mode == "fusednorm" else j  # step B: rows [0, jb)
    kv = 16 // elem
    C = tile_cols(j, elem)
    assert C >= K["kRowBytes"] // elem and C % (8 * kv) == 0  # whole swizzle periods
    assert smem_elems(j, C, kv) * elem <= K["kSmemMax"]
    ntiles = -(-M // C)
    nchunks = C // kv
    lanes = 1  # lanes_per_chunk: a chunk's row groups, adjacent lanes of one warp
    while lanes < 32 and 2 * lanes * nchunks <= THREADS:
        lanes *= 2
    assert 32 % lanes == 0 and THREADS % 32 == 0
    nseg = max(1, min(THREADS // jb, nchunks))
    seg_len = -(-nchunks // nseg)
    npairs = jb * nseg
    assert npairs <= K["kMaxPairs"] * THREADS and npairs <= 2 * (j + 1) * C
    q = np.arange(npairs)
    prow, pseg = q % jb, q // jb
    k0, k1 = pseg * seg_len, np.minimum(pseg * seg_len + seg_len, nchunks)
    covered = np.zeros((jb, nchunks), int)
    for r, a, b in zip(prow, k0, k1):
        covered[r, a:b] += 1
    assert (covered == 1).all()  # each (row, chunk) in one pair

    out = np.full(M, np.nan) if mode != "project" else None
    partial = np.zeros((blocks, jb))
    for b in range(blocks):
        acc = np.zeros(npairs)
        for tile in range(b, ntiles, blocks):
            c0 = tile * C
            stage = load_tile(V, v, j, C, c0, kload, kv)
            cols = np.arange(C)
            vrow = stage[swz(j, cols, C, kv)]
            if mode == "project":
                vnew = vrow
            else:
                # Item p = (chunk p // lanes, rows p % lanes :: lanes),
                # read as whole chunks at their swizzled place.
                sums = np.zeros((lanes, C))
                seen = np.zeros((ja, nchunks), int)
                for p in range(nchunks * lanes):
                    k, g = divmod(p, lanes)
                    rows = np.arange(g, ja, lanes)
                    seen[rows, k] += 1
                    phys = rows[:, None] * C + ((k ^ (rows[:, None] & 7)) * kv + np.arange(kv))
                    sums[g, k * kv:(k + 1) * kv] = h[rows] @ stage[phys]
                assert (seen == 1).all()  # each (row, chunk) in one item
                x = stage[swz(ja, cols, C, kv)] - sums.sum(axis=0)
                live = c0 + cols < M
                assert np.isnan(out[c0 + cols[live]]).all()  # one writer a column
                out[c0 + cols[live]] = x[live]
                if mode in ("finish", "fusednorm"):
                    stage[swz(ja, cols, C, kv)] = x
                vnew = vrow if mode == "finish" else x
            if mode != "update":
                for i in range(npairs):
                    r, sw = prow[i], prow[i] & 7
                    for k in range(k0[i], k1[i]):
                        phys = r * C + (k ^ sw) * kv + np.arange(kv)
                        acc[i] += stage[phys] @ vnew[k * kv:(k + 1) * kv]
        partial[b] = acc.reshape(nseg, jb).sum(axis=0)
    if mode == "update":
        assert not np.isnan(out).any()
        return out, None
    return out, partial.sum(axis=0)


def emulate(V, v, passes, blocks, elem, kload):
    j = V.shape[0]
    if j > MAX_ROWS:  # run()'s row blocks: each pass projects, then updates, block by block
        nb = -(-j // MAX_ROWS)
        R = -(-j // nb)
        src = v
        for _ in range(passes):
            h = np.concatenate([sweep("project", V[r0:r0 + R], src, None, blocks, elem, kload)[1]
                                for r0 in range(0, j, R)])
            for r0 in range(0, j, R):
                src, _ = sweep("update", V[r0:r0 + R], src, h[r0:r0 + R], blocks, elem, kload)
        return src
    _, h = sweep("project", V, v, None, blocks, elem, kload)
    src = v
    for _ in range(passes - 1):
        src, h = sweep("fused", V, src, h, blocks, elem, kload)
    out, _ = sweep("update", V, src, h, blocks, elem, kload)
    return out


def emulate_step(V, j, v, hp, passes, blocks, elem, kload):
    """run_step: "finish" (or "project" without a pending row), passes - 2
    "fused", then "fusednorm": (the finished row or None, v_{p-1}, h_p,
    |v_{p-1}|^2) before cgs2_reduce_norm's scaling."""
    V = V.copy()
    finished = None
    if hp is not None:
        finished, h = sweep("finish", V[:j], v, hp, blocks, elem, kload)
        V[j - 1] = finished
    else:
        _, h = sweep("project", V[:j], v, None, blocks, elem, kload)
    src = v
    for _ in range(passes - 2):
        src, h = sweep("fused", V[:j], src, h, blocks, elem, kload)
    x, hn = sweep("fusednorm", V[:j], src, h, blocks, elem, kload)
    return finished, x, hn[:j], hn[j]


# (element bytes, j, M, blocks, 16-byte copies): C capped at 8 KB a row
# (j=1), wide tiles with several column segments a row (j=37), the
# unaligned element copies (j=150, M odd), 32 lanes a chunk in step A
# (j=200, fp64), two pairs a thread in step B (j=600), the largest j of
# one tile, and two row blocks past it.
CASES = [(8, 1, 3000, 2, True), (4, 37, 1000, 3, True), (4, 150, 997, 4, False),
         (8, 200, 500, 3, True), (4, 600, 100, 2, True), (4, MAX_ROWS, 64, 1, True),
         (4, MAX_ROWS + 40, 872, 2, True)]


@pytest.mark.parametrize("elem, j, m, blocks, aligned", CASES)
def test_kernel_index_math_emulated(elem, j, m, blocks, aligned):
    V = _basis(min(j, m), m).numpy()
    if j > m:  # more rows than columns: any rows will do for the index math
        V = np.random.default_rng(5).standard_normal((j, m)) / np.sqrt(m)
    v = np.random.default_rng(2).standard_normal(m)
    kload = 16 // elem if aligned else 1
    for passes in (1, 2, 3):
        got = emulate(V, v, passes, blocks, elem, kload)
        want = cgs2_kernels.cgs2_reference(torch.from_numpy(V), torch.from_numpy(v), passes)
        np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-11 * np.abs(v).max())


@pytest.mark.parametrize("elem, j, m, blocks, aligned", [c for c in CASES if c[1] <= MAX_ROWS])
def test_lagged_step_index_math_emulated(elem, j, m, blocks, aligned):
    """The lagged step's sweeps (kFinish with a pending row, kFusedNorm),
    emulated, against the plain step: the finished row, v_{p-1}, h_p and
    |v_{p-1}|^2 before the scaling; where the rows are orthonormal also
    cgs2_lagged's scaled v~ and h~ against the emulation scaled as
    cgs2_reduce_norm scales it."""
    rng = np.random.default_rng(j)
    V = _basis(j + 1, m).numpy() if j + 1 <= m else rng.standard_normal((j + 1, m)) / np.sqrt(m)
    hp = rng.uniform(-1e-3, 1e-3, j - 1) if j >= 2 else None
    if hp is not None:
        V[j - 1] += hp @ V[: j - 1]
    v = rng.standard_normal(m)
    kload = 16 // elem if aligned else 1
    for passes in (2, 3):
        finished, x, h, n2 = emulate_step(V, j, v, hp, passes, blocks, elem, kload)
        W = V.copy()
        if hp is not None:
            W[j - 1] -= hp @ W[: j - 1]
            np.testing.assert_allclose(finished, W[j - 1], rtol=0, atol=1e-12)
        want_h = W[:j] @ v
        want_x = v
        for _ in range(passes - 1):
            want_x = want_x - want_h @ W[:j]
            want_h = W[:j] @ want_x
        scale = np.abs(v).max() * max(1.0, np.abs(want_h).max())
        np.testing.assert_allclose(x, want_x, rtol=0, atol=1e-11 * scale)
        np.testing.assert_allclose(h, want_h, rtol=0, atol=1e-11 * scale * np.sqrt(m))
        np.testing.assert_allclose(n2, want_x @ want_x, rtol=1e-11)
        if j + 1 <= m:
            s = 1 / np.sqrt(n2 - h @ h)
            Vt = torch.from_numpy(V.copy())
            got_h = ck_lagged(Vt, j, v, hp, passes)
            np.testing.assert_allclose(Vt[j].numpy(), s * x, rtol=0, atol=1e-11 * np.abs(s * x).max())
            np.testing.assert_allclose(got_h, s * h, rtol=0, atol=1e-11 * scale * np.sqrt(m))


def ck_lagged(V, j, v, hp, passes):
    return cgs2_kernels.cgs2_lagged(V, j, torch.from_numpy(v),
                                    None if hp is None else torch.from_numpy(hp), passes).numpy()


def test_max_rows_is_the_tile_capacity():
    # j + 1 rows of 128 bytes fill a stage; one more row does not fit.
    for elem in (4, 8):
        assert tile_cols(MAX_ROWS, elem) * elem == K["kRowBytes"]
        assert tile_cols(MAX_ROWS + 1, elem) == 0


def test_the_wrappers_row_capacity_is_the_kernels():
    assert cgs2_kernels.MAX_ROWS == MAX_ROWS
    assert K["kNormThreads"] > MAX_ROWS  # cgs2_reduce_norm: a row a thread, j + 1 rows
