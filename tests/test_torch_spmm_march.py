"""The stencil SpMM kernel's z-march, emulated in numpy.

``csrc/stencil.cu``'s SpMM runs only on a card.  Here its index math is
repeated step for step: the tile of ``spmm_tile`` (ty x tx points with all
b columns, or column chunks of cb when b is wide), each block's copy slots
(runs of 16-byte copies per point where b, the chunk and the operand's
alignment allow, element copies otherwise; the periodic wrap of the halo
worked out per slot), the ring of shared-memory stages filled kStages - 1
planes ahead, and each thread's kSpmmOutputs outputs (consecutive rows of
one point and column, fed by the kSpmmOutputs + 2 rows of neighbours it
reads once a plane) with three accumulators apiece that rotate along z.
Shared memory starts as NaN, so a read of a cell no copy filled shows up in
Y, and every output element must be written exactly once.  The emulation must equal the plain version
(``stencil_spmm_reference``) in fp64 for b in {1, 3, 5, 8, 20} and for
widths that take column chunks, on grids that are not multiples of the
tile, down to nz = 1, with and without a diagonal, for every z-chunk the
host may pick, for both copy widths (4- and 8-byte elements) and for an
operand whose start is not 16-byte aligned.  The plain version itself is
held against the JAX package's Pallas kernel in tests/test_torch_kernels.py.
"""

import itertools

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from lanczos_tpu_torch.ops import make_stencil_operator  # noqa: E402
from lanczos_tpu_torch.ops import stencil_kernels as sk  # noqa: E402

STAGES = 4  # kStages in csrc/stencil.cu
MAX_THREADS = 512  # kSpmmMaxThreads
R = sk.SPMM_OUTPUTS  # kSpmmOutputs


def _wrap(v, n):
    """The kernel's wrap() on arrays of v >= -1."""
    return np.where(v < 0, v + n, np.where(v >= n, v % n, v))


def _threads(tile, r=R):
    ty, tx, cb = tile
    return (tx * cb * (ty // r) + 31) // 32 * 32


def _x_slots(kv, r=R):
    return (5 * r // 2 + kv - 1) // kv + 1  # spmm_x_slots


def _stage_elems(tile, diag, elem_bytes):
    ty, tx, cb = tile
    v = 16 // elem_bytes
    return -(-((ty + 2) * (tx + 2) * cb + (ty * tx if diag else 0)) // v) * v


def _vec(b, cb, elem_bytes, aligned):
    return b * elem_bytes % 16 == 0 and cb * elem_bytes % 16 == 0 and aligned


def _launch_accepts(tile, vec, elem_bytes, r=R):
    """launch_spmm_as's checks on the block it would start."""
    ty, tx, cb = tile
    kv = 16 // elem_bytes if vec else 1
    threads = _threads(tile, r)
    return (ty % r == 0 and threads <= MAX_THREADS
            and -(-(ty + 2) * (tx + 2) * (cb // kv) // threads) <= _x_slots(kv, r))


def _emulate(op, X, zc, elem_bytes, aligned, tile=None):
    """Y = op X the way the kernel computes it, for a z-chunk of zc planes,
    elements of ``elem_bytes`` (the 16-byte copy width and the tile follow
    from it) and an operand that starts 16-byte aligned or not.  Returns Y
    and how many times each of its elements was written."""
    nz, ny, nx = op.grid_shape
    m, b = X.shape
    ty, tx, cb = tile or sk.spmm_tile(b, elem_bytes)
    vec = _vec(b, cb, elem_bytes, aligned)
    kv = 16 // elem_bytes if vec else 1
    assert _launch_accepts((ty, tx, cb), vec, elem_bytes)
    threads = _threads((ty, tx, cb))
    diag = op.diag is not None
    stage_elems = _stage_elems((ty, tx, cb), diag, elem_bytes)
    W = np.zeros(27)
    for (dz, dy, dx), w in zip(op.offsets, op.weights.numpy()):
        W[(dz + 1) * 9 + (dy + 1) * 3 + dx + 1] += w
    # A misaligned operand starts one element into its buffer.
    base = 0 if aligned else 1
    xbuf = np.concatenate([np.full(base, np.nan), X.ravel()])
    df = op.diag.numpy() if diag else None
    plane = ny * nx
    y = np.full(m * b, np.nan)
    writes = np.zeros(m * b, dtype=np.int64)
    tiles_x = -(-nx // tx)
    tid = np.arange(threads)[:, None]
    for bz, by, bx in itertools.product(range(-(-nz // zc)), range(-(-ny // ty)),
                                        range(tiles_x * -(-b // cb))):
        chunk = bx // tiles_x
        tx0, ty0, z0 = (bx - chunk * tiles_x) * tx, by * ty, bz * zc
        c0 = chunk * cb
        cw = min(cb, b - c0)
        pts = tx + 2
        stride, row_out = pts * cw, tx * cw
        x_cells = (ty + 2) * pts * cw
        n_planes = min(zc, nz - z0) + 2
        runs = cw // kv
        n_xc = (ty + 2) * pts * runs
        j = tid + np.arange(_x_slots(kv)) * threads
        rp = j // runs
        row, p = rp // pts, rp % pts
        xg = np.where(j < n_xc, (_wrap(ty0 + row - 1, ny) * nx + _wrap(tx0 + p - 1, nx)) * b
                      + c0 + (j - rp * runs) * kv, -1)
        jd = tid + np.arange(R) * threads
        rowd = jd // tx
        dg = np.where(diag & (jd < ty * tx),
                      _wrap(ty0 + rowd, ny) * nx + _wrap(tx0 + jd - rowd * tx, nx), -1)
        tid1 = tid[:, 0]
        active = tid1 < row_out * (ty // R)
        g = np.where(active, tid1 // row_out, 0)
        e = np.where(active, tid1 - g * row_out, 0)
        px, row0 = e // cw, g * R
        cen = (row0 + 1) * stride + cw + e
        dcen = x_cells + row0 * tx + px
        out0 = ((ty0 + row0) * nx + tx0 + px) * b + c0 + e - px * cw
        valid = [active & (tx0 + px < nx) & (ty0 + row0 + k < ny) for k in range(R)]
        smem = np.full(STAGES * stage_elems, np.nan)

        def load(i):
            zp = int(_wrap(np.int64(z0 - 1 + i), nz))
            st = (i % STAGES) * stage_elems
            ok = xg >= 0
            for k in range(kv):
                smem[st + j[ok] * kv + k] = xbuf[base + zp * plane * b + xg[ok] + k]
            if diag:
                ok = dg >= 0
                smem[st + x_cells + jd[ok]] = df[zp * plane + dg[ok]]

        for i in range(min(STAGES - 1, n_planes)):
            load(i)
        am, a0, ap = ([np.zeros(threads) for _ in range(R)] for _ in range(3))
        for i in range(n_planes):
            st = (i % STAGES) * stage_elems
            for k in range(R + 2):
                c = st + cen + (k - 1) * stride
                v = [smem[c - cw], smem[c], smem[c + cw]]
                for r in range(max(k - 2, 0), min(k, R - 1) + 1):
                    dy = k - r
                    for dx in range(3):
                        am[r] = am[r] + W[18 + dy * 3 + dx] * v[dx]
                        a0[r] = a0[r] + W[9 + dy * 3 + dx] * v[dx]
                        ap[r] = ap[r] + W[dy * 3 + dx] * v[dx]
                if diag and 1 <= k <= R:
                    a0[k - 1] = a0[k - 1] + smem[st + dcen + (k - 1) * tx] * v[1]
            if i >= 2:
                for r in range(R):
                    dst = (z0 + i - 2) * plane * b + out0[valid[r]] + r * nx * b
                    y[dst] = am[r][valid[r]]
                    np.add.at(writes, dst, 1)
            am, a0, ap = a0, ap, [np.zeros(threads) for _ in range(R)]
            if i + STAGES - 1 < n_planes:
                load(i + STAGES - 1)
    return y.reshape(m, b), writes


def _operator(shape, n_taps, diag, seed):
    rng = np.random.default_rng(seed)
    offs = list(itertools.product((-1, 0, 1), repeat=3))
    pick = sorted(rng.choice(27, size=n_taps, replace=False))
    d = rng.standard_normal(int(np.prod(shape))) if diag else None
    return make_stencil_operator(
        shape, [offs[i] for i in pick], rng.standard_normal(n_taps), diag=d,
        dtype=torch.float64, device="cpu",
    )


def _check(op, b, elem_bytes, zcs, seed=1):
    X = np.random.default_rng(seed).standard_normal((op.shape[0], b))
    want = sk.stencil_spmm_reference(op, torch.from_numpy(X)).numpy()
    nz = op.grid_shape[0]
    # A misaligned start matters only where 16-byte copies would be taken.
    alignments = (True, False) if b * elem_bytes % 16 == 0 else (True,)
    for zc, aligned in itertools.product(sorted(z for z in set(zcs) if z <= nz), alignments):
        got, writes = _emulate(op, X, zc, elem_bytes, aligned)
        assert (writes == 1).all(), f"zc={zc} aligned={aligned}: elements written {set(writes)}"
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max(),
                                   err_msg=f"zc={zc} aligned={aligned}")


def _host_chunks(shape, b, elem_bytes):
    """1, 2, nz and the chunks spmm_z_chunk picks for a large and a small card."""
    tile = sk.spmm_tile(b, elem_bytes)
    return {1, 2, shape[0], sk.spmm_z_chunk(shape, b, tile, 528),
            sk.spmm_z_chunk(shape, b, tile, 4)}


# (grid, taps, diag): odd grids that are no multiple of any tile, nz down
# to 1, a grid of several tiles along y and x.
SHAPES = [
    ((3, 5, 7), 27, True),
    ((1, 9, 13), 27, True),
    ((2, 8, 12), 10, False),
    ((4, 17, 21), 27, True),
    ((5, 3, 9), 7, False),
]


@pytest.mark.parametrize("elem_bytes", [4, 8])
@pytest.mark.parametrize("b", [1, 3, 5, 8, 20])
@pytest.mark.parametrize("shape,n_taps,diag", SHAPES)
def test_emulated_spmm_matches_reference(shape, n_taps, diag, b, elem_bytes):
    op = _operator(shape, n_taps, diag, seed=sum(shape))
    _check(op, b, elem_bytes, _host_chunks(shape, b, elem_bytes))


# Widths that take column chunks: 40 + 4 and 40 + 1 columns in fp32,
# 20 + 4 and 20 + 3 in fp64 (16-byte copies for 44 and 24 only).
@pytest.mark.parametrize("b,elem_bytes", [(44, 4), (41, 4), (24, 8), (23, 8)])
@pytest.mark.parametrize("shape,n_taps,diag", [SHAPES[0], SHAPES[3]])
def test_emulated_column_chunks(shape, n_taps, diag, b, elem_bytes):
    ty, tx, cb = sk.spmm_tile(b, elem_bytes)
    assert cb < b and tx == sk.SPMM_MIN_TILE_X
    op = _operator(shape, n_taps, diag, seed=b)
    _check(op, b, elem_bytes, _host_chunks(shape, b, elem_bytes))


def test_emulated_spmm_27_point_hamiltonian():
    """The regular deuteron Hamiltonian at N=12 (27-point, graded weights,
    diagonal) at b=20 in fp32, in the chunk the flagship's card would give
    it."""
    import lanczos_tpu_torch as pt

    op = pt.build_regular_hamiltonian(12, 25.0, pt.deuteron_potential_3d, stencil="27",
                                      dtype=torch.float64, device="cpu")
    X = np.random.default_rng(2).standard_normal((op.shape[0], 20))
    want = sk.stencil_spmm_reference(op, torch.from_numpy(X)).numpy()
    zc = sk.spmm_z_chunk(op.grid_shape, 20, sk.spmm_tile(20, 4), 396)
    got, writes = _emulate(op, X, zc, 4, True)
    assert (writes == 1).all()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("elem_bytes", [4, 8])
def test_spmm_tile_fits_the_launch(elem_bytes):
    """For every width up to 300 columns the host's tile is one the launch
    takes, with 16-byte and with element copies; its ring stays under the
    48 KB a block gets without opting in; a tile row holds at most
    SPMM_ROW_BYTES of outputs unless it is at its least width; column
    chunks are whole sectors."""
    row = sk.SPMM_ROW_BYTES // elem_bytes
    for b in range(1, 301):
        ty, tx, cb = tile = sk.spmm_tile(b, elem_bytes)
        assert ty == sk.SPMM_TILE_Y
        assert sk.SPMM_MIN_TILE_X <= tx <= sk.SPMM_MAX_TILE_X and 1 <= cb <= b
        for vec in (True, False):
            assert _launch_accepts(tile, vec, elem_bytes), (b, tile, vec)
        assert STAGES * _stage_elems(tile, True, elem_bytes) * elem_bytes <= 48 * 1024
        if cb < b:
            assert cb * elem_bytes % sk.SECTOR_BYTES == 0 and tx == sk.SPMM_MIN_TILE_X
        else:
            assert tx * b <= row or tx == sk.SPMM_MIN_TILE_X or tx == 1
    # The widths the solvers use: b=20 (acceptance) and b=8 (Arnoldi's
    # residual block).
    assert sk.spmm_tile(20, 4) == (8, 8, 20)
    assert sk.spmm_tile(8, 4) == (8, 20, 8)


@pytest.mark.parametrize("resident", [1, 396, 528, 792])
def test_spmm_z_chunk_fills_the_card(resident):
    for shape, b in itertools.product(((160, 160, 160), (60, 60, 60), (40, 40, 40),
                                       (3, 5, 7), (1, 9, 13)), (1, 8, 20, 44)):
        tile = sk.spmm_tile(b, 4)
        ty, tx, cb = tile
        nz, ny, nx = shape
        zc = sk.spmm_z_chunk(shape, b, tile, resident)
        assert 1 <= zc <= nz
        per_plane = -(-nx // tx) * -(-ny // ty) * -(-b // cb)
        cost = -(-per_plane * -(-nz // zc) // resident) * (zc + 2)
        for z in range(1, nz + 1):
            assert cost <= -(-per_plane * -(-nz // z) // resident) * (z + 2)
        if per_plane * nz <= resident:
            assert zc == 1
    # The SpMV's chunk is the same model on its 32 x 8 tile.
    assert sk.spmv_z_chunk((160, 160, 160), 792) == sk.z_chunk(160, 5 * 20, 792)
