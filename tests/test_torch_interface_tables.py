"""The interface kernel's tables and index math, emulated in numpy.

``csrc/interface.cu`` runs only on a card.  Here its arithmetic is repeated
step for step on the port's own tables (``FusedInterface``): the packed
row -> class mapping, the host-built linear tap descriptors, each lane's
share of a row's taps in the kernel's order, and the fixed butterfly that
combines the lanes.  The emulation must equal the plain version
(``apply_fused_interface_reference``) to 1e-13 in fp64 on the JAX tests'
mixed lattice (A and A^T) and on the N=60 deuteron lattice's A^T, whose
stride-13 class the JAX plan leaves to a plain path.  The plain version
itself is held against the JAX package's Pallas kernel in
tests/test_torch_composite2.py.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import lanczos_tpu_torch as pt  # noqa: E402
from lanczos_tpu_torch.ops import interface_kernel as ik  # noqa: E402

#: Lanes per packed row of the kernel the package launches (the kLanes of
#: ``launch``'s defaults in csrc/interface.cu).
LANES = 8


def _mixed():
    sp = np.full(27, 2, dtype=np.int64)
    sp[13] = 1
    lat = pt.build_lattice(24, 25.0, 3, spacings=sp)
    op, _ = pt.assemble_irregular_hamiltonian_composite2(
        lat, pt.deuteron_potential_3d, dtype=torch.float64, min_grid_rows=4,
        build_transpose=True, device="cpu",
    )
    return op


@pytest.fixture(scope="module")
def operators():
    mixed = _mixed()
    lat = pt.build_lattice(60, 25.0, 3, potential=pt.deuteron_potential_3d)
    n60, _ = pt.assemble_irregular_hamiltonian_composite2(
        lat, pt.deuteron_potential_3d, dtype=torch.float64, build_transpose=True,
        device="cpu",
    )
    return {"mixed A": mixed, "mixed A^T": mixed.transpose_op, "N=60 A^T": n60.transpose_op}


CASES = ["mixed A", "mixed A^T", "N=60 A^T"]


def _rows(fi):
    """Per packed row: its class's table row and its window point, as the
    kernel derives them (row -> class, then two divisions)."""
    cls = fi.cls.numpy().astype(np.int64)
    r = np.arange(fi.num_rows)
    k = cls[fi.row_class.numpy()]
    i = r - k[:, 0]
    iz = i // k[:, 1]
    rem = i - iz * k[:, 1]
    iy = rem // k[:, 2]
    ix = rem - iy * k[:, 2]
    return k, iz, iy, ix


def _emulate(fi, x, y):
    """The kernel on an (M, b) block, in numpy: returns y + the interface
    and every lane's final sum (R, LANES, b)."""
    k, iz, iy, ix = _rows(fi)
    taps = fi.taps.numpy().astype(np.int64)
    w = fi.tap_w.numpy()
    t0, t1 = k[:, 3], k[:, 4]
    lanes = np.zeros((fi.num_rows, LANES, x.shape[1]))
    steps = -(-int((t1 - t0).max()) // LANES)
    for lane in range(LANES):
        acc = np.zeros((fi.num_rows, x.shape[1]))
        # Lane l takes taps t0 + l, t0 + l + LANES, ... in order (the
        # kernel's unroll by kUnroll keeps that order).
        for j in range(steps):
            t = t0 + lane + j * LANES
            ok = t < t1
            d = taps[np.where(ok, t, 0)]
            q = d[:, 0] + d[:, 1] * iz + d[:, 2] * iy + d[:, 3] * ix
            assert (q[ok] >= 0).all() and (q[ok] < x.shape[0]).all()
            acc = acc + np.where(ok[:, None], w[np.where(ok, t, 0)][:, None] * x[np.where(ok, q, 0)], 0.0)
        lanes[:, lane] = acc
    # __shfl_xor_sync butterfly, offsets LANES/2 ... 1: lane l adds lane l ^ off.
    off = LANES // 2
    while off:
        lanes = lanes + lanes[:, np.arange(LANES) ^ off]
        off //= 2
    out = k[:, 5] + k[:, 6] * iz + k[:, 7] * iy + k[:, 8] * ix
    y = y.copy()
    y[out] += lanes[:, 0]
    return y, lanes


def test_descriptors_are_the_strided_windows(operators):
    """Each host-built linear form (tap and output) addresses exactly the
    strided 3D window that class_windows describes, for every row."""
    for fi in (op.fused for op in operators.values()):
        k, iz, iy, ix = _rows(fi)
        taps = fi.taps.numpy().astype(np.int64)
        rc = fi.row_class.numpy()
        wins = ik.class_windows(fi.grid_meta, fi.level_meta)
        for c, (base, (ny, nx), o3, step, acc, ktaps) in enumerate(wins):
            rows = rc == c
            pz, py, px = iz[rows], iy[rows], ix[rows]
            want = base + ((o3[0] + step[0] * pz) * ny + o3[1] + step[1] * py) * nx + o3[2] + step[2] * px
            got = k[rows, 5] + k[rows, 6] * pz + k[rows, 7] * py + k[rows, 8] * px
            np.testing.assert_array_equal(got, want)
            t0 = k[rows][0, 3]
            for t, (sb, (sny, snx), s3, st) in enumerate(ktaps):
                want = sb + ((s3[0] + st[0] * pz) * sny + s3[1] + st[1] * py) * snx + s3[2] + st[2] * px
                d = taps[t0 + t]
                np.testing.assert_array_equal(d[0] + d[1] * pz + d[2] * py + d[3] * px, want)
        # Every address the kernel forms is a slot of the operator, and
        # every int32 partial sum stays in range (all terms >= 0).
        assert taps.min() >= 0 and fi.cls.numpy().min() >= 0


def test_row_class_mapping_covers_each_window_once(operators):
    for fi in (op.fused for op in operators.values()):
        k, iz, iy, ix = _rows(fi)
        rc = fi.row_class.numpy()
        assert len(rc) == fi.num_rows and (np.diff(rc) >= 0).all()
        for c, g in enumerate(fi.grid_meta):
            az, ay, ax = g[3]
            rows = rc == c
            assert rows.sum() == az * ay * ax
            pts = iz[rows] * ay * ax + iy[rows] * ax + ix[rows]
            np.testing.assert_array_equal(pts, np.arange(az * ay * ax))
            assert k[rows][0, 4] - k[rows][0, 3] == len(g[4])  # its taps
        # Every class sits in the tables, at any stride (N=60's A^T too).
        assert fi.cls.shape == (len(fi.grid_meta), ik.CLASS_FIELDS)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("b", [1, 3])
def test_emulated_kernel_matches_reference(operators, case, b):
    fi = operators[case].fused
    rng = np.random.default_rng(7 + b)
    m = fi.num_slots
    x = rng.standard_normal((m, b))
    y0 = rng.standard_normal((m, b))
    got, _ = _emulate(fi, x, y0)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y0.copy())
    if b == 1:
        xt, yt = xt[:, 0].contiguous(), yt[:, 0].contiguous()
    want = ik.apply_fused_interface_reference(fi, xt, yt).numpy().reshape(m, b)
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13 * np.abs(want).max())
    # Rows outside every class window are left as they were.
    touched = np.zeros(m, bool)
    k, iz, iy, ix = _rows(fi)
    touched[k[:, 5] + k[:, 6] * iz + k[:, 7] * iy + k[:, 8] * ix] = True
    np.testing.assert_array_equal(got[~touched], y0[~touched])


@pytest.mark.parametrize("case", CASES)
def test_butterfly_leaves_every_lane_the_same_sum(operators, case):
    """The fixed-order butterfly ends with the same bits in all lanes, so
    the one lane that writes holds the row's sum whatever lane it is."""
    fi = operators[case].fused
    x = np.random.default_rng(3).standard_normal((fi.num_slots, 1))
    _, lanes = _emulate(fi, x, np.zeros_like(x))
    for lane in range(1, LANES):
        np.testing.assert_array_equal(lanes[:, lane], lanes[:, 0])


def test_tables_refuse_addresses_past_the_operator(operators):
    """An output window moved past the last level region's end would have
    the kernel write outside y; the tables refuse to be built."""
    op = operators["mixed A"]
    last = len(op.level_meta) - 1
    c = next(i for i, g in enumerate(op.grid_meta) if g[0] == last)
    row_level, out_start, interior, acc, taps = op.grid_meta[c]
    moved = (row_level, (op.level_meta[last][1][0], *out_start[1:]), interior, acc, taps)
    meta = op.grid_meta[:c] + (moved,) + op.grid_meta[c + 1:]
    with pytest.raises(ValueError, match="leaves the operator"):
        ik.FusedInterface(meta, op.level_meta, op.grid_w, torch.float64, "cpu")
