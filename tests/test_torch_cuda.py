"""Card-only tests of the port: the CUDA stencil, interface, CGS2 and Ritz
rotation kernels, a CompositeV2 on the card, and small solves.

They need an NVIDIA GPU and skip here otherwise (decided inside each test,
so every pytest-xdist worker collects the same tests).  On a card:

    python -m pytest tests/ -m cuda

The file imports no jax, so with ``--noconftest`` it also runs where jax is
not installed.
"""

import os
from functools import lru_cache

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import lanczos_tpu_torch as pt  # noqa: E402
from lanczos_tpu_torch._util import COUNTERS  # noqa: E402
from lanczos_tpu_torch.ops import make_stencil_operator  # noqa: E402
from lanczos_tpu_torch.ops import cgs2_kernels as ck  # noqa: E402
from lanczos_tpu_torch.ops import interface_kernel as ik  # noqa: E402
from lanczos_tpu_torch.ops import ritz_kernels as rk  # noqa: E402
from lanczos_tpu_torch.ops import stencil_kernels as sk  # noqa: E402

EPS32 = float(np.finfo(np.float32).eps)


def _require_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _operators(dtype):
    """The shapes of tests/test_pallas.py, the level grids of the N=60 and
    N=120 irregular lattices (20^3, 30^3, 40^3, 60^3) and two odd grids
    (one plane; rows that are no multiple of 16 bytes), on the card."""
    dev = "cuda"
    reg = [
        pt.build_regular_hamiltonian(
            n, 25.0, pt.deuteron_potential_3d, stencil=s, dtype=dtype, device=dev
        )
        for n, s in ((12, "27"), (10, "7"), (8, "27"), (16, "27"),
                     (20, "27"), (30, "27"), (40, "27"), (60, "27"))
    ]
    rng = np.random.default_rng(6)
    full = [(dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    odd = [
        make_stencil_operator(
            shape, full, rng.standard_normal(27),
            diag=rng.standard_normal(int(np.prod(shape))), dtype=dtype, device=dev,
        )
        for shape in ((3, 5, 7), (1, 9, 130))
    ]
    aniso = make_stencil_operator(
        (6, 10, 14), [(0, 0, 0), (1, 0, 0), (0, -1, 0), (0, 0, 1), (-1, 1, -1)],
        [2.0, -1.0, 0.5, 0.25, 1.5], dtype=dtype, device=dev,
    )
    flat = make_stencil_operator(
        (8, 16, 8),
        [(0, 0, 0), (0, 0, 1), (0, 0, -1), (0, 1, 0), (0, -1, 0), (1, 0, 0),
         (-1, 0, 0), (1, 1, 1), (-1, -1, -1), (0, 1, -1)],
        [1.0, 0.5, -0.5, 0.25, 2.0, -1.5, 3.0, 0.125, -0.25, 0.75],
        diag=np.linspace(-1.0, 1.0, 8 * 16 * 8), dtype=dtype, device=dev,
    )
    return reg + [aniso, flat] + odd


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_kernels_match_reference(dtype):
    _require_card()
    # fp32: test_pallas.py's tolerance (another summation order, FMA);
    # fp64: both kernels sum the taps grouped by dz, ~1e-15 relative.
    atol_scale, rtol = (2e-5, 1e-4) if dtype == torch.float32 else (1e-12, 1e-12)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for op in _operators(dtype):
        m = op.shape[0]
        # b=8 and 20 also as a block that starts one element into its
        # buffer: not 16-byte aligned, so the SpMM takes element copies.
        for b, offset in ((None, 0), (1, 0), (3, 0), (5, 0), (8, 0), (20, 0), (8, 1), (20, 1)):
            shape = (m,) if b is None else (m, b)
            n = int(np.prod(shape))
            buf = torch.randn(n + offset, generator=gen, device="cuda", dtype=dtype)
            x = buf[offset:].view(shape)
            before = (sk.stencil_spmv.launches, sk.stencil_spmm.launches)
            if b is None:
                y, y_ref = sk.stencil_spmv(op, x), sk.stencil_spmv_reference(op, x)
                assert sk.stencil_spmv.launches == before[0] + 1
            else:
                y, y_ref = sk.stencil_spmm(op, x), sk.stencil_spmm_reference(op, x)
                assert sk.stencil_spmm.launches == before[1] + 1
            torch.cuda.synchronize()
            scale = float(y_ref.abs().max())
            torch.testing.assert_close(y, y_ref, atol=atol_scale * scale, rtol=rtol)


@pytest.mark.cuda
def test_cuda_eigsh_fp64_matches_cpu_fp64():
    """The fp64 solve on the card (the lagged recurrence, every step on the
    kernel) against the same solve on the CPU: the eigenvalues fp64 has
    converged agree to 1e-10 ||H||_G, whatever the summation order."""
    _require_card()
    v0 = np.random.default_rng(4).uniform(-1, 1, 12**3)
    on = {}
    for dev in ("cuda", "cpu"):
        H = pt.build_regular_hamiltonian(12, 25.0, pt.deuteron_potential_3d, stencil="27",
                                         dtype=torch.float64, device=dev)
        fused = COUNTERS["lt.cgs2.fused"]
        on[dev] = pt.eigsh(H, k=4, n=80, v0=v0)
        assert COUNTERS["lt.cgs2.fused"] - fused == (79 if dev == "cuda" else 0)
    norm = float(H.weights.abs().sum()) + float(H.diag.abs().max())
    ref, got = on["cpu"], on["cuda"]
    converged = ref.residuals.numpy() < 1e-10 * norm
    assert converged[0]
    vals = got.eigenvalues.cpu().numpy()
    for lam in ref.eigenvalues.numpy()[converged]:
        assert np.min(np.abs(vals - lam)) <= 1e-10 * norm, (lam, vals)


@pytest.mark.cuda
def test_cuda_wrapper_raises_instead_of_falling_back():
    _require_card()
    op = pt.build_regular_hamiltonian(6, 25.0, pt.deuteron_potential_3d, device="cuda")
    with pytest.raises(ValueError):  # operand on the CPU, operator on the card
        sk.stencil_spmv(op, torch.zeros(op.shape[0]))
    with pytest.raises(ValueError):  # not contiguous
        sk.stencil_spmm(op, torch.zeros(2, op.shape[0], device="cuda").T)


@pytest.mark.cuda
def test_cuda_eigsh_matches_cpu_fp64():
    _require_card()
    v0 = np.random.default_rng(4).uniform(-1, 1, 12**3)
    H32 = pt.build_regular_hamiltonian(
        12, 25.0, pt.deuteron_potential_3d, stencil="27", dtype=torch.float32, device="cuda"
    )
    H64 = pt.build_regular_hamiltonian(
        12, 25.0, pt.deuteron_potential_3d, stencil="27", dtype=torch.float64,
        device="cpu",
    )
    launches, cgs2_launches = sk.stencil_spmv.launches, COUNTERS["lt.cgs2.fused"]
    reads = COUNTERS["lt.cgs2.basis_reads"]
    r32 = pt.eigsh(H32, k=4, n=80, v0=v0)
    assert sk.stencil_spmv.launches == launches + 80
    assert COUNTERS["lt.cgs2.fused"] == cgs2_launches + 79  # every step's CGS2 ran the kernel
    assert COUNTERS["lt.cgs2.basis_reads"] - reads == 2 * 79 + 1  # lagged: 2 a step, 1 to close
    r64 = pt.eigsh(H64, k=4, n=80, v0=v0)
    # fp32 storage of H moves eigenvalues by <= eps32/2 * ||H||_G (Weyl); the
    # fp32 SpMVs round by about as much again.
    tol = EPS32 * (float(H64.weights.abs().sum()) + float(H64.diag.abs().max()))
    # Only eigenvalues that fp64 has converged to within tol are fixed to
    # tol; the grid's cubic symmetry makes degenerate multiplets, whose
    # extra copies either run may or may not have converged, so each is
    # matched to the nearest fp32 eigenvalue.
    vals32 = r32.eigenvalues.double().cpu().numpy()
    converged = r64.residuals.numpy() < tol
    assert converged[0]
    for lam in r64.eigenvalues.numpy()[converged]:
        assert np.min(np.abs(vals32 - lam)) <= tol, (lam, vals32, tol)


def _mixed_v2(dtype, device):
    """The JAX tests' mixed lattice (n=24, centre box at spacing 1) as a
    CompositeV2 with its transpose."""
    sp = np.full(27, 2, dtype=np.int64)
    sp[13] = 1
    lat = pt.build_lattice(24, 25.0, 3, spacings=sp)
    return pt.assemble_irregular_hamiltonian_composite2(
        lat, pt.deuteron_potential_3d, dtype=dtype, min_grid_rows=4,
        build_transpose=True, device=device,
    )


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_interface_kernel_matches_reference(dtype):
    _require_card()
    # fp32: the stencil kernels' tolerance (FMA, another rounding of each
    # term); fp64: the kernel sums each row's taps in interleaved
    # per-lane partial sums joined by a butterfly, ~1e-15 relative.
    atol_scale, rtol = (2e-5, 1e-4) if dtype == torch.float32 else (1e-12, 1e-12)
    op, _ = _mixed_v2(dtype, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for fi in (op.fused, op.transpose_op.fused):
        for b in (None, 3):
            shape = (op.shape[0],) if b is None else (op.shape[0], b)
            x = torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
            y0 = torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
            before = ik.apply_fused_interface.launches
            y = ik.apply_fused_interface(fi, x, y0.clone())
            assert ik.apply_fused_interface.launches == before + 1
            y_ref = ik.apply_fused_interface_reference(fi, x, y0.clone())
            torch.cuda.synchronize()
            scale = float(y_ref.abs().max())
            torch.testing.assert_close(y, y_ref, atol=atol_scale * scale, rtol=rtol)
    with pytest.raises(ValueError):  # operand on the CPU, tables on the card
        ik.apply_fused_interface(op.fused, x.cpu(), y0.cpu())


@pytest.mark.cuda
def test_cuda_composite_v2_matches_cpu_fp64():
    _require_card()
    gpu, idx_map = _mixed_v2(torch.float64, "cuda")
    cpu, _ = _mixed_v2(torch.float64, "cpu")
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(cpu.shape[0])) * cpu.live
    X = torch.from_numpy(rng.standard_normal((cpu.shape[0], 4))) * cpu.live[:, None]
    before = (ik.apply_fused_interface.launches, sk.stencil_spmv.launches, sk.stencil_spmm.launches)
    pairs = [(gpu.matvec(x.cuda()), cpu.matvec(x)), (gpu.rmatvec(x.cuda()), cpu.rmatvec(x)),
             (gpu.matmat(X.cuda()), cpu.matmat(X))]
    torch.cuda.synchronize()
    for got, want in pairs:
        torch.testing.assert_close(got.cpu(), want, rtol=1e-12, atol=1e-12 * float(want.abs().max()))
    levels = len(gpu.level_meta)
    assert (ik.apply_fused_interface.launches, sk.stencil_spmv.launches,
            sk.stencil_spmm.launches) == (before[0] + 3, before[1] + 2 * levels, before[2] + levels)



@pytest.mark.cuda
def test_cuda_matvec_dd_runs_the_fp64_kernels():
    """The dd path on the card: the float32 CompositeV2's float64 copy
    launches the float64 SpMV and interface kernels and agrees with the
    same copy on the CPU."""
    from lanczos_tpu_torch.ops.dd import matvec_dd, to_float64

    _require_card()
    gpu, _ = _mixed_v2(torch.float32, "cuda")
    cpu, _ = _mixed_v2(torch.float32, "cpu")
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal(cpu.shape[0])) * cpu.live.double()
    xh = x.float()
    xl = (x - xh.double()).float()
    g64 = to_float64(gpu)
    before = (ik.apply_fused_interface.launches_by_dtype[torch.float64],
              sk.stencil_spmv.launches_by_dtype[torch.float64])
    yh, yl = matvec_dd(g64, xh.cuda(), xl.cuda())
    torch.cuda.synchronize()
    after = (ik.apply_fused_interface.launches_by_dtype[torch.float64],
             sk.stencil_spmv.launches_by_dtype[torch.float64])
    assert after == (before[0] + 1, before[1] + len(gpu.level_meta))
    want = to_float64(cpu).matvec(x)
    got = yh.cpu().double() + yl.cpu().double()
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12 * float(want.abs().max()))


@pytest.mark.cuda
def test_cuda_cli_restart_and_compensated():
    """``solve-regular --restart`` and ``solve-irregular --compensated`` on the
    card agree with the same commands on the CPU."""
    from lanczos_tpu_torch.cli import main

    _require_card()
    reg = ["solve-regular", "-N", "16", "-k", "3", "--restart", "--tol", "1e-9",
           "--dtype", "float64"]
    irr = ["solve-irregular", "-N", "24", "-k", "3", "-n", "40", "--compensated",
           "--dtype", "float64"]
    for args, rtol in ((reg, 1e-9), (irr, 1e-6)):
        on_card = main(args + ["--device", "cuda"]).eigenvalues.cpu().numpy()
        on_cpu = main(args + ["--device", "cpu"]).eigenvalues.numpy()
        np.testing.assert_allclose(on_card, on_cpu, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_captured_cycles_equal_the_eager_ones(dtype):
    """eigs_nonsym and eigsh_restarted on the card: every cycle after the
    first replays a CUDA graph, the kernels' launch counts include the
    replays, and the results equal the eager body's (graphs.eager()),
    bitwise: a replay runs the eager kernels with their arguments."""
    from lanczos_tpu_torch.solver import graphs

    _require_card()
    C, idx_map = _mixed_v2(dtype, "cuda")
    v0 = np.zeros(C.shape[0])
    v0[idx_map] = np.random.default_rng(5).uniform(-1, 1, len(idx_map))
    H = pt.build_regular_hamiltonian(16, 25.0, pt.deuteron_potential_3d, stencil="27",
                                     dtype=dtype, device="cuda")
    solves = (
        lambda: pt.eigs_nonsym(C, k=4, max_basis=30, tol=1e-6, v0=v0),
        lambda: pt.eigsh_restarted(H, k=4, max_basis=20, tol=1e-6, compensated=True, seed=3),
    )
    fused = COUNTERS["lt.cgs2.fused"]
    for solve in solves:
        before = sk.stencil_spmv.launches
        graphs.reset_stats()
        captured = solve()
        torch.cuda.synchronize()
        st = dict(graphs.stats)
        assert len(st["cycles"]) >= 3
        assert (st["eager"], st["captures"], st["replays"]) == (
            1, len(set(st["cycles"][1:])), len(st["cycles"]) - 1)
        launched = sk.stencil_spmv.launches - before
        with graphs.eager():
            before = sk.stencil_spmv.launches
            plain = solve()
            torch.cuda.synchronize()
            assert sk.stencil_spmv.launches - before == launched
        for name in ("eigenvalues", "eigenvectors", "residuals"):
            assert torch.equal(getattr(captured, name), getattr(plain, name)), name
    assert COUNTERS["lt.cgs2.fused"] > fused  # the restart cycles ran the CGS2 kernel


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_captured_block_cycles_equal_the_eager_ones(dtype):
    """eigsh_block_restarted on the card: every block cycle after the first
    replays a CUDA graph of the speculative cycle, and the result equals
    the eager body's (graphs.eager()), bitwise; a rank-deficient operator
    redoes its broken-down cycle eagerly and still equals the eager solve."""
    from lanczos_tpu_torch.ops.operators import DenseOperator
    from lanczos_tpu_torch.solver import graphs

    _require_card()
    H = pt.build_regular_hamiltonian(24, 25.0, pt.deuteron_potential_3d, stencil="27",
                                     dtype=dtype, device="cuda")
    B = np.random.default_rng(5).standard_normal((120, 10))
    A = DenseOperator(torch.as_tensor(B @ B.T, dtype=dtype, device="cuda"))
    solves = (
        (lambda: pt.eigsh_block_restarted(H, k=4, block_size=4, tol=1e-4, max_cycles=30), 0),
        (lambda: pt.eigsh_block_restarted(A, k=4, block_size=4, num_blocks=3, n_locked=4,
                                          tol=1e-9, max_cycles=10, which="LA"), 1),
    )
    for solve, least_redo in solves:
        graphs.reset_stats()
        captured = solve()
        torch.cuda.synchronize()
        st = dict(graphs.stats)
        assert len(st["cycles"]) >= 3 and st["redo"] >= least_redo
        assert (st["eager"], st["captures"], st["replays"]) == (1, 1, len(st["cycles"]) - 1)
        with graphs.eager():
            plain = solve()
        for name in ("eigenvalues", "eigenvectors", "residuals", "inner_prod"):
            assert torch.equal(getattr(captured, name), getattr(plain, name)), name


@pytest.fixture(scope="module")
def cgs2_bases():
    """{M: (V64, V32)}: 399 orthonormal rows of length M (an fp64 QR on the
    card, and its fp32 copy) at the irregular N=120 lattice's M = 280,000
    and the regular N=160^3 cell's M = 4,096,000."""
    _require_card()
    gen = torch.Generator(device="cuda").manual_seed(11)
    bases = {}
    for m in (280_000, 4_096_000):
        q = torch.linalg.qr(
            torch.randn(m, 399, generator=gen, dtype=torch.float64, device="cuda")).Q
        V64 = q.T.contiguous()
        del q
        bases[m] = (V64, V64.float())
    return bases


def _cgs2_input(V64, j, dtype, seed):
    """A vector of unit scale with components of size ~1 in the span of
    the first j rows, in ``dtype``."""
    m = V64.shape[1]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    c = torch.rand(j, generator=gen, dtype=torch.float64, device="cuda") * 2 - 1
    x = torch.randn(m, generator=gen, dtype=torch.float64, device="cuda") / m**0.5
    return (x + c @ V64[:j]).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [280_000, 4_096_000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_cgs2_matches_the_loop(cgs2_bases, dtype, m):
    """The kernel against the plain loop (cuBLAS GEMVs): a few ulps times
    sqrt(j) of the input's scale apart (the same arithmetic, its sums in
    another order), orthogonality as good within 2x, and bitwise the same
    from call to call."""
    V64, V32 = cgs2_bases[m]
    Vfull = V64 if dtype == torch.float64 else V32
    eps = torch.finfo(dtype).eps
    for j in (1, 37, 399):
        V = Vfull[:j]
        v = _cgs2_input(V64, j, dtype, seed=j)
        for passes in (1, 2):
            want = ck.cgs2_reference(V, v, passes)
            got = ck.cgs2(V, v, passes)
            again = ck.cgs2(V, v, passes)
            torch.cuda.synchronize()
            assert torch.equal(got, again), (j, passes)  # no atomics
            err, scale = float((got - want).abs().max()), float(v.abs().max())
            assert err <= 8 * eps * j**0.5 * scale, (j, passes, err, scale)
            if passes == 2 and j > 1:
                # ||V v2||_inf, in fp64 over the stored rows: a max over
                # j >= 37 rows of rounding noise (one row's is one sample).
                Vd = V.double()
                ours = float((Vd @ got.double()).abs().max())
                loop = float((Vd @ want.double()).abs().max())
                del Vd
                assert ours <= 2 * loop, (j, ours, loop)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_cgs2_odd_shapes_match_the_loop(dtype):
    """Rows of odd length and a vector one element into its buffer (element
    copies in place of 16-byte ones), and j up to the tile's capacity (two
    step-B pairs a thread), against the plain loop as above."""
    _require_card()
    eps = torch.finfo(dtype).eps
    gen = torch.Generator(device="cuda").manual_seed(17)
    for m, j, offset in ((100_003, 37, 0), (100_003, 399, 0), (65_536, 600, 1),
                         (65_536, ck.MAX_ROWS, 0)):
        q = torch.linalg.qr(torch.randn(m, j, generator=gen, dtype=torch.float64, device="cuda")).Q
        V = q.T.contiguous().to(dtype)
        del q
        v = (torch.randn(m + offset, generator=gen, dtype=dtype, device="cuda") / m**0.5)[offset:]
        for passes in (1, 2):
            want = ck.cgs2_reference(V, v, passes)
            got = ck.cgs2(V, v, passes)
            torch.cuda.synchronize()
            assert torch.equal(got, ck.cgs2(V, v, passes)), (m, j, passes)
            err, scale = float((got - want).abs().max()), float(v.abs().max())
            assert err <= 8 * eps * j**0.5 * scale, (m, j, passes, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_cgs2_captured_equals_eager(cgs2_bases, dtype):
    """orthogonalize captured in a CUDA graph replays the kernel bitwise as
    its eager call; the counters count the capture, not the replays."""
    from lanczos_tpu_torch.ops.cgs2_kernels import local_basis_dot, orthogonalize

    V64, V32 = cgs2_bases[280_000]
    V = (V64 if dtype == torch.float64 else V32)[:200]
    v = _cgs2_input(V64, 200, dtype, seed=7)
    fused = COUNTERS["lt.cgs2.fused"]
    eager = orthogonalize(V, v, 2, local_basis_dot)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        orthogonalize(V, v, 2, local_basis_dot)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = orthogonalize(V, v, 2, local_basis_dot)
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert COUNTERS["lt.cgs2.fused"] - fused == 3
    assert torch.equal(captured, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_cgs2_beyond_one_tile_runs_row_blocks(dtype):
    """More rows than one tile holds run the kernel in row blocks (two
    sweeps a pass), through orthogonalize as any other j, and so do views
    that are not contiguous (a column slice, a transposed store, a strided
    v: copied first); each against the plain loop as above."""
    from lanczos_tpu_torch.ops.cgs2_kernels import local_basis_dot, orthogonalize

    _require_card()
    eps = torch.finfo(dtype).eps
    gen = torch.Generator(device="cuda").manual_seed(3)
    m = 65_536
    cases = []
    for j in (ck.MAX_ROWS + 1, 2 * ck.MAX_ROWS + 5):
        V = torch.randn(j, m, generator=gen, dtype=dtype, device="cuda") / m**0.5
        cases.append((f"j={j}", V, torch.randn(m, generator=gen, dtype=dtype, device="cuda")))
    wide = torch.randn(300, m + 40, generator=gen, dtype=dtype, device="cuda") / m**0.5
    cases.append(("column slice", wide[:, 8:m + 8], torch.randn(m, generator=gen, dtype=dtype,
                                                                 device="cuda")))
    cases.append(("transposed", wide[:, :m].T.contiguous().T,
                  torch.randn(2 * m, generator=gen, dtype=dtype, device="cuda")[::2]))
    for label, V, v in cases:
        j = V.shape[0]
        calls, fused = COUNTERS["lt.cgs2.calls"], COUNTERS["lt.cgs2.fused"]
        for passes in (1, 2):
            want = ck.cgs2_reference(V, v, passes)
            got = orthogonalize(V, v, passes, local_basis_dot)
            torch.cuda.synchronize()
            assert torch.equal(got, ck.cgs2(V, v, passes)), (label, passes)
            err, scale = float((got - want).abs().max()), float(v.abs().max())
            assert err <= 8 * eps * j**0.5 * scale, (label, passes, err, scale)
        assert COUNTERS["lt.cgs2.calls"] - calls == 2
        assert COUNTERS["lt.cgs2.fused"] - fused == 4  # two through orthogonalize, two direct
    with pytest.raises(TypeError):  # no kernel for other dtypes
        ck.cgs2(V.half(), v.half(), 2)


def _lagged_case(V64, j, dtype, seed, pending):
    """(V, v, h_pending) for one lagged step at row j: V (j + 1, M) in
    ``dtype`` whose row j - 1, when ``pending``, is its orthonormal row
    plus V[:j-1]^T h with h of size ~1e-3 (what the step finishes).  Row
    j, the step's output, is zero where V64 has no row j."""
    V = torch.zeros(j + 1, V64.shape[1], dtype=torch.float64, device="cuda")
    V[: min(j + 1, V64.shape[0])] = V64[: j + 1]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    hp = None
    if pending:
        hp = (torch.rand(j - 1, generator=gen, dtype=torch.float64, device="cuda") - 0.5) * 2e-3
        V[j - 1] += hp @ V[: j - 1]
        hp = hp.to(dtype)
    return V.to(dtype), _cgs2_input(V64, j, dtype, seed), hp


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_cgs2_lagged_matches_the_plain_step(cgs2_bases, dtype):
    """One step of the lagged recurrence on the card (kFinish, then the
    fused sweep with the norm, then the scale) against its plain version at
    j = 1, 2, 40, 399 (M = 4,096,000 and 280,000), with and without a
    pending row: the finished row and the stored v~ a few ulps times
    sqrt(j) of the input's scale apart, the returned h~ (sums over M of
    unit rows times v~, itself rounding noise) a few ulps times sqrt(j) of
    |v~|, bitwise the same from call to call; passes = 3 runs one more
    fused sweep.  v~ - V[:j]^T h~ is the unit vector the plain CGS2
    stores, to the same order.  Each call counts its sweeps."""
    eps = torch.finfo(dtype).eps
    for m in (4_096_000, 280_000):
        V64, _ = cgs2_bases[m]
        for j, pending, passes in ((1, False, 2), (2, True, 2), (40, True, 2), (40, False, 3),
                                   (399, True, 2), (399, True, 3)):
            V, v, hp = _lagged_case(V64, j, dtype, seed=j, pending=pending)
            tol = 8 * eps * j**0.5 * float(v.abs().max())
            Vw, Vr = V.clone(), V.clone()
            reads, fused = COUNTERS["lt.cgs2.basis_reads"], COUNTERS["lt.cgs2.fused"]
            h = ck.cgs2_lagged(Vw, j, v, hp, passes)
            assert COUNTERS["lt.cgs2.basis_reads"] - reads == passes
            assert COUNTERS["lt.cgs2.fused"] - fused == 1
            h_ref = ck.cgs2_lagged_reference(Vr, j, v, hp, passes)
            assert torch.equal(Vw[: j - 1], V[: j - 1])  # the other rows are left as they were
            assert torch.equal(h, ck.cgs2_lagged(V, j, v, hp, passes)) and torch.equal(V, Vw)
            torch.cuda.synchronize()
            tol_h = 8 * eps * j**0.5 * float(Vr[j].norm())
            for name, got, want, bound in (("finished row", Vw[j - 1], Vr[j - 1], tol),
                                           ("v~", Vw[j], Vr[j], tol),
                                           ("h~", h, h_ref, tol_h)):
                err = float((got - want).abs().max())
                assert err <= bound, (m, j, passes, name, err, bound)
            unit = (Vw[j] - h @ Vw[:j]).double()
            plain = ck.cgs2_reference(Vr[:j], v, passes)
            plain = (plain / plain.norm()).double()
            assert float((unit - plain).abs().max()) <= 2 * tol, (m, j, passes)
            del V, Vw, Vr


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_cgs2_lagged_at_the_tile_capacity_and_past_it(dtype):
    """The lagged step at j = 831 (the most rows one tile holds: step B's
    two pairs a thread, the norm's row 832), and past it: cgs2_finish of
    row 1000 in row blocks, and a lagged Lanczos run whose steps cross 831
    (the row they cross at finished, then cgs2 unlagged), against plain
    versions; misaligned rows take the element copies."""
    from lanczos_tpu_torch.solver.lanczos import lanczos_kernel

    _require_card()
    eps = torch.finfo(dtype).eps
    gen = torch.Generator(device="cuda").manual_seed(9)
    m = 65_536
    for mm in (m, m + 3):
        q = torch.linalg.qr(torch.randn(mm, 1002, generator=gen, dtype=torch.float64,
                                        device="cuda")).Q
        V64 = q.T.contiguous()
        del q
        j = ck.MAX_ROWS
        V, v, hp = _lagged_case(V64, j, dtype, seed=3, pending=True)
        tol = 8 * eps * j**0.5 * float(v.abs().max())
        Vw, Vr = V.clone(), V.clone()
        h = ck.cgs2_lagged(Vw, j, v, hp, 2)
        h_ref = ck.cgs2_lagged_reference(Vr, j, v, hp, 2)
        torch.cuda.synchronize()
        for got, want in ((Vw[j - 1], Vr[j - 1]), (Vw[j], Vr[j]), (h, h_ref)):
            assert float((got - want).abs().max()) <= tol + 4 * eps * float(want.abs().max())
        j = 1001
        V, _, hp = _lagged_case(V64, j, dtype, seed=4, pending=True)
        Vw = V.clone()
        reads = COUNTERS["lt.cgs2.basis_reads"]
        ck.cgs2_finish(Vw, j, hp)
        assert COUNTERS["lt.cgs2.basis_reads"] - reads == 1
        want = V[j - 1] - hp @ V[: j - 1]
        torch.cuda.synchronize()
        assert float((Vw[j - 1] - want).abs().max()) <= 8 * eps * j**0.5
        assert torch.equal(Vw[: j - 1], V[: j - 1]) and torch.equal(Vw[j:], V[j:])
        del V64, V, Vw, Vr
    # A Lanczos run across the tile's capacity on a diagonal operator.
    d = torch.linspace(-1.0, 1.0, 4000, dtype=dtype, device="cuda")
    v0 = torch.rand(4000, generator=gen, dtype=dtype, device="cuda") - 0.5
    n = ck.MAX_ROWS + 12
    reads, fused = COUNTERS["lt.cgs2.basis_reads"], COUNTERS["lt.cgs2.fused"]
    fac = lanczos_kernel(lambda x: d * x, v0, n)
    assert COUNTERS["lt.cgs2.fused"] - fused == n - 1
    past = n - 1 - ck.MAX_ROWS  # steps past the tile: cgs2 in row blocks, 2p reads
    assert COUNTERS["lt.cgs2.basis_reads"] - reads == 2 * ck.MAX_ROWS + 1 + 4 * past
    V = fac.V.double()
    orth = float((V @ V.T - torch.eye(n, dtype=torch.float64, device="cuda")).abs().max())
    assert orth <= 20 * eps * n**0.5, orth


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_cgs2_lagged_captured_equals_eager(cgs2_bases, dtype):
    """Two lagged steps and the closing finish captured in a CUDA graph
    replay the kernels bitwise as their eager calls; the counters count the
    capture, not the replays."""
    V64, V32 = cgs2_bases[280_000]
    j = 200
    V0, v, hp = _lagged_case(V64, j, dtype, seed=5, pending=True)
    w = _cgs2_input(V64, j + 1, dtype, seed=6)

    def steps(V):
        h = ck.cgs2_lagged(V, j, v, hp, 2)
        h = ck.cgs2_lagged(V, j + 1, w, h, 2)
        ck.cgs2_finish(V, j + 2, h)
        return h

    pad = torch.zeros(2, V0.shape[1], dtype=dtype, device="cuda")
    eager_V = torch.cat([V0, pad])
    eager = steps(eager_V)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        steps(torch.cat([V0, pad]))
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    Vg = torch.cat([V0, pad])
    fused, reads = COUNTERS["lt.cgs2.fused"], COUNTERS["lt.cgs2.basis_reads"]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = steps(Vg)
    Vg.copy_(torch.cat([V0, pad]))
    graph.replay()
    torch.cuda.synchronize()
    assert COUNTERS["lt.cgs2.fused"] - fused == 2
    assert COUNTERS["lt.cgs2.basis_reads"] - reads == 5
    assert torch.equal(captured, eager) and torch.equal(Vg, eager_V)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_cgs2_lagged_finishes_a_vector_mostly_in_the_span(dtype):
    """The card's flag: a unit v of which two passes keep |v_p| = 0.3 has
    its row finished by the conditional sweep and zero h~ returned; at 0.6
    the row stays unfinished and the sweep returns at once; each against
    the plain step.  Then n = M = 512 on the N=8 deuteron, where the spent
    Krylov space raises the flag: the rows stay orthonormal and T's
    eigenvalues are H's, as in the plain recurrence on the card."""
    from lanczos_tpu_torch.solver.lanczos import lanczos_kernel

    _require_card()
    eps = torch.finfo(dtype).eps
    gen = torch.Generator(device="cuda").manual_seed(12)
    m, j = 65_536, 40
    q = torch.linalg.qr(torch.randn(m, j + 2, generator=gen, dtype=torch.float64,
                                    device="cuda")).Q
    for kept, finished in ((0.3, True), (0.6, False)):
        c = torch.randn(j, generator=gen, dtype=torch.float64, device="cuda")
        v = (kept * q[:, j + 1] + (1 - kept**2) ** 0.5 * (c / c.norm()) @ q.T[:j]).to(dtype)
        V = q.T[: j + 1].contiguous().to(dtype)
        Vr = V.clone()
        h = ck.cgs2_lagged(V, j, v, None, 2)
        h_ref = ck.cgs2_lagged_reference(Vr, j, v, None, 2)
        torch.cuda.synchronize()
        assert bool((h == 0).all()) == finished and bool((h_ref == 0).all()) == finished
        tol = 8 * eps * j**0.5 * float(v.abs().max()) / kept
        assert float((V[j] - Vr[j]).abs().max()) <= tol, (kept, dtype)
        assert float((h - h_ref).abs().max()) <= 8 * eps * j**0.5 / kept
    H = pt.build_regular_hamiltonian(8, 25.0, pt.deuteron_potential_3d, stencil="27",
                                     dtype=dtype, device="cuda")
    v0 = torch.rand(512, generator=gen, dtype=dtype, device="cuda") - 0.5
    exact = np.linalg.eigvalsh(H.to_dense().double().cpu().numpy())

    def ritz(fac):
        a, b = fac.alpha.double().cpu().numpy(), fac.beta.double().cpu().numpy()
        return np.linalg.eigvalsh(np.diag(a) + np.diag(b, 1) + np.diag(b, -1))

    lagged = lanczos_kernel(H.matvec, v0, 512)
    plain = lanczos_kernel(H.matvec, v0, 512, dot=lambda a, b: torch.dot(a, b))
    V = lagged.V.double()
    eye = torch.eye(512, dtype=torch.float64, device="cuda")
    assert float((V @ V.T - eye).abs().max()) < 4 * 512**0.5 * eps
    err = np.abs(ritz(lagged) - exact).max()
    assert err <= 2 * max(np.abs(ritz(plain) - exact).max(), 1e-12 * np.abs(exact).max())


@lru_cache(maxsize=None)
def _restarted_cpu_fp64():
    """eigsh_restarted (compensated) and eigs_nonsym of the N=65 deuteron
    in float64 on the CPU, and the operator's Gershgorin bound."""
    H = pt.build_regular_hamiltonian(65, 25.0, pt.deuteron_potential_3d, stencil="27",
                                     dtype=torch.float64, device="cpu")
    norm = float(H.weights.abs().sum()) + float(H.diag.abs().max())
    threads = torch.get_num_threads()
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    try:
        return (pt.eigsh_restarted(H, **RESTARTED), pt.eigs_nonsym(H, **NONSYM)), norm
    finally:
        torch.set_num_threads(threads)


# k=3: the fourth pair (2.6174 MeV) sits 0.01 MeV above the third, and the
# fp32 restart resolves it on some start vectors only, the loop as the
# kernel (H100, seeds 3, 4, 5).
RESTARTED = dict(k=3, max_basis=20, tol=1e-6, compensated=True, seed=3)
NONSYM = dict(k=3, max_basis=30, tol=1e-6, seed=3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_restarted_solves_match_cpu_fp64(dtype):
    """eigsh_restarted(compensated=True) on the card, whose thick-restart
    cycles (eager and captured) run every CGS2 through the kernel, against
    the same solve in float64 on the CPU at M = 274,625 (the N=65 deuteron,
    the size of the N=120 irregular lattice's 280,000 slots).  eigs_nonsym
    beside it is the control: its Arnoldi takes its own Gram-Schmidt and
    runs no CGS2 kernel.  Each reference pair has a card eigenvalue within
    eps ||H||_G (test_cuda_eigsh_matches_cpu_fp64's bound: storage and
    SpMV rounding) plus both pairs' residual norms (Weyl: a Ritz value is
    within its residual's norm of an eigenvalue), and the card's residuals
    are no larger than 10x the reference's, the solve's tol or the dtype's
    floor, 10 eps ||H||_G (the fp32 restart stalls at 4-5 eps ||H||_G, the
    loop as the kernel)."""
    _require_card()
    (ref_restarted, ref_nonsym), norm = _restarted_cpu_fp64()
    H = pt.build_regular_hamiltonian(65, 25.0, pt.deuteron_potential_3d, stencil="27",
                                     dtype=dtype, device="cuda")
    eps = float(torch.finfo(dtype).eps)
    for solve, kw, ref, kernel in ((pt.eigsh_restarted, RESTARTED, ref_restarted, True),
                                   (pt.eigs_nonsym, NONSYM, ref_nonsym, False)):
        calls, fused = COUNTERS["lt.cgs2.calls"], COUNTERS["lt.cgs2.fused"]
        res = solve(H, **kw)
        torch.cuda.synchronize()
        ran = COUNTERS["lt.cgs2.fused"] - fused
        assert ran == COUNTERS["lt.cgs2.calls"] - calls and (ran > 0) == kernel, (solve, ran)
        vals = res.eigenvalues.double().cpu().numpy()
        resid = res.residuals.double().cpu().numpy() * np.maximum(np.abs(vals), 1.0)
        ref_vals = ref.eigenvalues.numpy()
        ref_resid = ref.residuals.numpy() * np.maximum(np.abs(ref_vals), 1.0)
        for lam, r in zip(ref_vals, ref_resid):
            i = int(np.argmin(np.abs(vals - lam)))
            tol = eps * norm + r + resid[i]
            assert abs(vals[i] - lam) <= tol, (solve, dtype, lam, vals, tol)
        # Residual norms: within 10x the nearest reference pair's, or below
        # the dtype's floor or the requested tolerance.
        for i, r in enumerate(resid):
            j = int(np.argmin(np.abs(ref_vals - vals[i])))
            limit = max(10 * ref_resid[j], 10 * eps * norm, kw["tol"] * max(abs(vals[i]), 1.0))
            assert r <= limit, (solve, dtype, vals, resid, ref_resid)


def _ritz_case(m, n, dtype, seed, offset=0, column_major=False):
    """V (n, m) of Lanczos-basis scale, ``offset`` elements into its buffer,
    and an orthogonal W (n, n) in ``dtype``: row-major, or column-major as
    torch.linalg.eigh returns it."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    buf = torch.randn(n * m + offset, generator=gen, dtype=dtype, device="cuda") / m**0.5
    V = buf[offset:].view(n, m)
    W = torch.linalg.qr(torch.randn(n, n, generator=gen, dtype=torch.float64,
                                    device="cuda")).Q
    W = (W.T.contiguous().T if column_major else W.contiguous()).to(dtype)
    return V, W


def _assert_rotation(V, W, cols, got):
    """got against V^T W[:, cols] in fp64, entry by entry within the
    rounding bound of an n-term fp sum, n eps (|V|^T |W[:, cols]|)."""
    n = V.shape[0]
    eps = torch.finfo(V.dtype).eps
    Wc = W[:, cols].double()
    want = V.double().T @ Wc
    bound = n * eps * (V.double().abs().T @ Wc.abs())
    assert got.shape == want.shape and got.is_contiguous() and got.dtype == V.dtype
    excess = float(((got.double() - want).abs() - bound).max())
    assert excess <= 0, excess


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_ritz_rotate_matches_fp64(dtype):
    """The rotation kernel against fp64 V^T W[:, cols]: M that is no
    multiple of a block's 256 x 16 bytes (and one that is no multiple of 16
    bytes, on a V one element into its buffer: element copies), n = 1, 7
    and 400 (W staged in two parts at k = K_MAX), k = 1, 20, K_MAX, K_MAX +
    1 and 2 K_MAX + 1 (two and three chunks of columns, element stores
    where k is odd) and every column (cols=None: 17 chunks at n = 400),
    unsorted columns with gaps, W row- and column-major; one launch a call,
    bitwise the same from call to call."""
    _require_card()
    assert rk._library().ritz_max_cols() == rk.K_MAX
    gen = torch.Generator().manual_seed(3)
    for m, offset in ((65_540, 0), (100_003, 1)):
        for n in (1, 7, 400):
            V, W = _ritz_case(m, n, dtype, seed=n, offset=offset, column_major=n == 400)
            for k in (1, 20, rk.K_MAX, rk.K_MAX + 1, 2 * rk.K_MAX + 1, None):
                if k is None:
                    cols, arg = torch.arange(n), None
                else:
                    cols = torch.randperm(max(n, k), generator=gen)[:k] % n
                    if n > 2 * k:
                        cols = cols // 2 * 2  # gaps: even columns only
                    arg = cols.to("cuda")
                before = COUNTERS["lt.ritz.launches"]
                got = rk.rotate(V, W, arg)
                again = rk.rotate(V, W, arg)
                torch.cuda.synchronize()
                launches = COUNTERS["lt.ritz.launches"] - before
                assert launches == 2, (m, n, k, launches)
                assert torch.equal(got, again), (m, n, k)
                _assert_rotation(V, W, cols, got)
            del V, W


@pytest.mark.cuda
def test_cuda_ritz_rotate_launches_the_kernel_for_any_layout():
    """On the card every rotation runs the kernel: a V that is not
    contiguous is copied and rotated by it, bitwise as its contiguous copy;
    another dtype, or a W of another dtype, raises TypeError, a W on
    another device ValueError.  An index past W's columns given on the host
    raises, one given on the card gives a column of NaN."""
    _require_card()
    V, W = _ritz_case(4096, 16, torch.float32, seed=1)
    cols = torch.tensor([3, 0, 9], device="cuda")
    strided = V.T.contiguous().T
    assert not strided.is_contiguous()
    before = COUNTERS["lt.ritz.launches"]
    got = rk.rotate(strided, W, cols)
    assert COUNTERS["lt.ritz.launches"] - before == 1
    assert torch.equal(got, rk.rotate(V, W, cols))
    _assert_rotation(V, W, cols.cpu(), got)
    for v, w in ((V.bfloat16(), W.bfloat16()), (V, W.double())):
        with pytest.raises(TypeError):
            rk.rotate(v, w, cols)
    with pytest.raises(ValueError):
        rk.rotate(V, W.cpu(), cols)
    with pytest.raises(IndexError):
        rk.rotate(V, W, torch.tensor([0, 16]))
    got = rk.rotate(V, W, torch.tensor([16, 2], device="cuda"))
    assert bool(got[:, 0].isnan().all()) and bool(got[:, 1].isfinite().all())


@pytest.mark.cuda
def test_cuda_flagship_eigenvectors_equal_the_full_rotation():
    """eigsh on the N=160^3 cell's problem (k=20, n=400, fp32) rotates only
    the 20 selected pairs, on the kernel, and its eigenvectors are the
    selected columns of the full V^T W within the rounding bound of 400-term
    fp32 sums (each computed with another summation order)."""
    _require_card()
    from lanczos_tpu_torch.solver import api

    H = pt.build_regular_hamiltonian(160, 25.0, pt.deuteron_potential_3d, stencil="27",
                                     dtype=torch.float32, device="cuda")
    seen = {}
    real = api.ritz_vectors

    def spy(fac, W, cols=None):
        seen.update(fac=fac, W=W, cols=cols)
        return real(fac, W, cols)

    api.ritz_vectors = spy
    try:
        launches, columns = COUNTERS["lt.ritz.launches"], COUNTERS["lt.ritz.columns"]
        res = pt.eigsh(H, k=20, n=400, which="SA", v0=np.random.default_rng(99).uniform(
            -1.0, 1.0, 160**3))
        torch.cuda.synchronize()
    finally:
        api.ritz_vectors = real
    assert COUNTERS["lt.ritz.launches"] - launches == 1
    assert COUNTERS["lt.ritz.columns"] - columns == 20
    V, W, cols = seen["fac"].V, seen["W"], seen["cols"]
    full = V.T @ W
    eps = torch.finfo(torch.float32).eps
    bound = 2 * 400 * eps * (V.abs().T @ W[:, cols].abs())
    diff = (res.eigenvectors - full[:, cols]).abs()
    assert float((diff - bound).max()) <= 0
