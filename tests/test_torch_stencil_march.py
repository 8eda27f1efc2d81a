"""The stencil SpMV kernel's z-march, emulated in numpy.

``csrc/stencil.cu``'s SpMV runs only on a card.  Here its index math is
repeated step for step: the 32 x 8 tiles of the (y, x) plane, each block's
copy slots (16-byte copies along x where nx allows, element copies for the
halo columns and other grids, the periodic wrap worked out per slot), the
ring of shared-memory stages filled kStages - 1 planes ahead, and the three
accumulators that rotate along z.  Shared memory starts as NaN, so a read
of a cell no copy filled shows up in y.  The emulation must equal the plain
version (``stencil_spmv_reference``) in fp64 on grids that are not
multiples of the tile, down to nz = 1, with and without a diagonal, for
every z-chunk the host may pick.  The plain version itself is held against
the JAX package's Pallas kernel in tests/test_torch_kernels.py.
"""

import itertools

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from lanczos_tpu_torch.ops import make_stencil_operator  # noqa: E402
from lanczos_tpu_torch.ops import stencil_kernels as sk  # noqa: E402

TX, TY = sk.TILE_X, sk.TILE_Y
STAGES = 4  # kStages in csrc/stencil.cu
THREADS = TX * TY


def _wrap(v, n):
    return v + n if v < 0 else (v % n if v >= n else v)


def _x_copy(j, ty0, tx0, ny, nx, vec, V):
    chunks = TX // V if vec else 0
    per_row = chunks + 2 if vec else TX + 2
    if j >= (TY + 2) * per_row:
        return None
    row, e = divmod(j, per_row)
    wide = vec and e < chunks
    h = e * V if wide else ((-1 if e == chunks else TX) if vec else e - 1)
    return (row * (TX + 2 * V) + V + h, _wrap(ty0 + row - 1, ny) * nx + _wrap(tx0 + h, nx),
            V if wide else 1)


def _diag_copy(j, ty0, tx0, ny, nx, vec, V):
    per_row = TX // V if vec else TX
    if j >= TY * per_row:
        return None
    row = j // per_row
    h = (j % per_row) * (V if vec else 1)
    return ((TY + 2) * (TX + 2 * V) + row * TX + h,
            _wrap(ty0 + row, ny) * nx + _wrap(tx0 + h, nx), V if vec else 1)


def _emulate(op, x, zc, elem_bytes):
    """y = op x the way the kernel computes it, for a z-chunk of zc planes
    and elements of ``elem_bytes`` (8 or 4: the 16-byte copy width)."""
    nz, ny, nx = op.grid_shape
    V = 16 // elem_bytes
    vec = nx % V == 0
    stride, plane_cells = TX + 2 * V, (TY + 2) * (TX + 2 * V)
    stage_cells = plane_cells + TY * TX
    W = np.zeros(27)
    for (dz, dy, dx), w in zip(op.offsets, op.weights.numpy()):
        W[(dz + 1) * 9 + (dy + 1) * 3 + dx + 1] += w
    xf = x.numpy()
    df = None if op.diag is None else op.diag.numpy()
    y = np.full(nz * ny * nx, np.nan)
    ty, tx = np.meshgrid(np.arange(TY), np.arange(TX), indexing="ij")
    for z0, ty0, tx0 in itertools.product(range(0, nz, zc), range(0, ny, TY), range(0, nx, TX)):
        n_planes = min(zc, nz - z0) + 2
        xc = [c for j in range(2 * THREADS)
              if (c := _x_copy(j, ty0, tx0, ny, nx, vec, V)) is not None]
        dc = [] if df is None else [c for j in range(THREADS)
                                    if (c := _diag_copy(j, ty0, tx0, ny, nx, vec, V)) is not None]
        smem = np.full(STAGES * stage_cells, np.nan)

        def load(i):
            off = _wrap(z0 - 1 + i, nz) * ny * nx
            st = (i % STAGES) * stage_cells
            for src, copies in ((xf, xc), (df, dc)):
                for s, g, n in copies:
                    smem[st + s:st + s + n] = src[off + g:off + g + n]

        for i in range(min(STAGES - 1, n_planes)):
            load(i)
        valid = (tx0 + tx < nx) & (ty0 + ty < ny)
        out = (ty0 + ty) * nx + tx0 + tx
        am, a0, ap = (np.zeros((TY, TX)) for _ in range(3))
        x_prev = d_prev = np.zeros((TY, TX))
        for i in range(n_planes):
            st = (i % STAGES) * stage_cells
            centre = st + (ty + 1) * stride + V + tx
            for dy, dx in itertools.product(range(3), range(3)):
                v = smem[centre + (dy - 1) * stride + dx - 1]
                am = am + W[18 + dy * 3 + dx] * v
                a0 = a0 + W[9 + dy * 3 + dx] * v
                ap = ap + W[dy * 3 + dx] * v
            if i >= 2:
                res = am if df is None else am + d_prev * x_prev
                y[(z0 + i - 2) * ny * nx + out[valid]] = res[valid]
            am, a0, ap = a0, ap, np.zeros((TY, TX))
            x_prev = smem[centre]
            d_prev = None if df is None else smem[st + plane_cells + ty * TX + tx]
            if i + STAGES - 1 < n_planes:
                load(i + STAGES - 1)
    return y


def _operator(shape, n_taps, diag, seed):
    rng = np.random.default_rng(seed)
    offs = list(itertools.product((-1, 0, 1), repeat=3))
    pick = sorted(rng.choice(27, size=n_taps, replace=False))
    d = rng.standard_normal(int(np.prod(shape))) if diag else None
    return make_stencil_operator(
        shape, [offs[i] for i in pick], rng.standard_normal(n_taps), diag=d,
        dtype=torch.float64, device="cpu",
    )


# (grid, taps, diag): odd grids, nz down to 1, nx that takes 16-byte
# copies in fp32 and fp64 (40, 32), in fp64 only (14, 130) or neither (7, 9).
SHAPES = [
    ((3, 5, 7), 27, True),
    ((1, 9, 130), 27, True),
    ((2, 8, 32), 10, False),
    ((6, 10, 14), 5, False),
    ((5, 17, 40), 27, True),
    ((4, 3, 9), 7, True),
]


@pytest.mark.parametrize("elem_bytes", [4, 8])
@pytest.mark.parametrize("shape,n_taps,diag", SHAPES)
def test_emulated_march_matches_reference(shape, n_taps, diag, elem_bytes):
    op = _operator(shape, n_taps, diag, seed=sum(shape))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(op.shape[0]))
    want = sk.stencil_spmv_reference(op, x).numpy()
    nz = shape[0]
    for zc in sorted({1, 2, nz, sk.spmv_z_chunk(shape, 528), sk.spmv_z_chunk(shape, 4)}):
        if zc > nz:
            continue
        got = _emulate(op, x, zc, elem_bytes)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max(),
                                   err_msg=f"zc={zc}")


def test_emulated_march_27_point_hamiltonian():
    """The regular deuteron Hamiltonian at N=12 (27-point, graded weights),
    in the chunk the flagship's card would give it."""
    import lanczos_tpu_torch as pt

    op = pt.build_regular_hamiltonian(12, 25.0, pt.deuteron_potential_3d, stencil="27",
                                      dtype=torch.float64, device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(op.shape[0]))
    want = sk.stencil_spmv_reference(op, x).numpy()
    got = _emulate(op, x, sk.spmv_z_chunk(op.grid_shape, 792), 4)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("resident", [1, 396, 528, 792, 1056])
def test_z_chunk_fills_the_card(resident):
    for shape in ((160, 160, 160), (60, 60, 60), (40, 40, 40), (20, 20, 20),
                  (3, 5, 7), (1, 9, 130)):
        nz, ny, nx = shape
        zc = sk.spmv_z_chunk(shape, resident)
        assert 1 <= zc <= nz
        tiles = -(-nx // TX) * -(-ny // TY)
        blocks = tiles * -(-nz // zc)
        # No shorter chunk finishes in fewer planes per resident slot.
        cost = -(-blocks // resident) * (zc + 2)
        for z in range(1, nz + 1):
            assert cost <= -(-tiles * -(-nz // z) // resident) * (z + 2)
        if tiles * nz <= resident:
            assert zc == 1  # a small grid gets one plane a block: the most blocks
    # The flagship keeps chunks long enough to amortise the two halo planes.
    assert sk.spmv_z_chunk((160, 160, 160), 792) >= 16


def test_cached_weights_follow_the_operator():
    """The SpMV's dense host weights are read when the operator is built and
    renewed whenever its weights or diag are replaced or changed in place,
    even twice with no launch in between."""
    op = _operator((3, 5, 7), 10, True, seed=4)

    def dense(w):
        want = np.zeros(27)
        for (dz, dy, dx), wk in zip(op.offsets, w):
            want[(dz + 1) * 9 + (dy + 1) * 3 + dx + 1] += wk
        return want

    assert "_stencil_kernel_cache" in op.__dict__
    w0 = op.weights.numpy().copy()
    np.testing.assert_array_equal(np.asarray(sk._cache(op).w27), dense(w0))
    op.weights = op.weights * 2
    op.weights = op.weights * 2
    np.testing.assert_array_equal(np.asarray(sk._cache(op).w27), dense(4 * w0))
    op.weights.mul_(0.5)
    np.testing.assert_array_equal(np.asarray(sk._cache(op).w27), dense(2 * w0))
    c = sk._cache(op)
    op.diag.add_(1.0)
    assert sk._cache(op) is not c
    assert sk._cache(op) is sk._cache(op)
