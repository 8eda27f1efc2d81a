"""Card-only tests of the port: the CUDA stencil and interface kernels, a
CompositeV2 on the card, and a small solve.

They need an NVIDIA GPU and skip here otherwise (decided inside each test,
so every pytest-xdist worker collects the same tests).  On a card:

    python -m pytest tests/ -m cuda

The file imports no jax, so with ``--noconftest`` it also runs where jax is
not installed.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import lanczos_tpu_torch as pt  # noqa: E402
from lanczos_tpu_torch.ops import make_stencil_operator  # noqa: E402
from lanczos_tpu_torch.ops import interface_kernel as ik  # noqa: E402
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
    launches = sk.stencil_spmv.launches
    r32 = pt.eigsh(H32, k=4, n=80, v0=v0)
    assert sk.stencil_spmv.launches == launches + 80
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
