"""Drive the PyTorch port's regular-grid and irregular-lattice paths on one
NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each of which fails the run (non-zero exit, no result line):

1. The card: ``nvidia-smi`` name and power limit, torch/CUDA versions, TF32 flags.
2. Build: every kernel library from ``lanczos_tpu_torch/csrc`` for sm_90a
   (``stencil.cu``, ``interface.cu``, ``cgs2.cu``; one nvcc each, started
   together), with nvcc's ``-Xptxas -v`` report.
3. Each stencil kernel against its plain PyTorch version, on the same CUDA
   tensors, in fp32 and fp64, at the test shapes, the level grids of the
   N=60 and N=120 lattices (20^3, 30^3, 40^3, 60^3), two odd grids and the
   flagship N=160^3: the SpMV, and the SpMM at b = 1, 3, 4, 5, 8 and 20 (at
   b = 8 and 20 also on a block that is not 16-byte aligned); then kernel,
   plain and cuSPARSE CSR times at N=160^3 (the SpMM at b=20 and at b=4,
   the block solver's width, in fp32 and fp64).
4. ``eigsh`` at N=64 (k=8, n=150, fp32) against golden eigenvalues that the
   JAX package computed in fp64 (``lanczos_tpu_torch/data/golden_eigsh_n64.json``).
5. The flagship: N=160^3, L=25 fm, 27-point, ``eigsh(k=20, n=400, "SA")``
   in fp32, with the kernels' launch counts (every one of its 399 CGS2
   calls runs the CGS2 kernel), then the same solve in fp64.  Then the
   CGS2 kernel against its plain version (two cuBLAS GEMVs a pass) at the
   flagship's M: j = 200 and 399 in fp32 and fp64, j = 1000 (row blocks)
   in fp32, two passes, within 8 eps sqrt(j), with graph-replay times
   beside the bound of the bytes each must read.

The irregular multi-resolution lattice (the reference's ``Irr3Ddeuteron.py``):

6. The interface kernel against its plain version, fp32 and fp64, for A and
   A^T, on the tests' mixed lattice, the N=60 and the N=120 deuteron
   lattices; at N=60 in fp64 the whole CompositeV2 (matvec, rmatvec)
   against the port's ELL assembly of the same lattice.
7. Times at N=120, fp32: the interface kernel, its plain version and a
   cuSPARSE CSR product of the interface rows; the stencil SpMV, and the
   SpMM at b=8 (the width of the Arnoldi residual block), on the two level
   grids; the whole CompositeV2 matvec and a CSR ``torch.mv`` of the
   whole H; each with its bound (compulsory bytes over the card's
   published HBM rate, 3.35 TB/s, or operations over its fp32 peak) and,
   beside it, the bytes' time at the copy rate measured in the same run.

Times: a kernel's ``ms`` is its graph-replay time (its launches captured
in a CUDA graph with their rotating inputs, replays timed with CUDA
events: device time without the wrapper's host work), printed beside its
eager time (CUDA events around a loop of calls, which the host paces when
its work per call outlasts the kernel) and the launch floor (a one-element
``fill_`` replayed the same way).  Plain versions are timed eagerly.
8. ``eigs_nonsym`` at N=60 (k=5, max_basis=120, tol=1e-4, fp32) against
   golden eigenvalues the JAX package computed in fp64
   (``lanczos_tpu_torch/data/golden_eigs_irregular_n60.json``).
9. The irregular flagship: N=120, box depth 3, ``eigs_nonsym(k=8,
   max_basis=300, tol=1e-4)`` on the CompositeV2 in fp32, then fp64, with
   the kernels' launch counts, held against golden eigenvalues the JAX
   package computed in fp64 (``golden_eigs_irregular_n120.json``); the
   distance to ``IRREGULAR_r04.json`` is printed, not held.  On the card
   every Krylov–Schur cycle after the first replays a CUDA graph
   (``solver/graphs.py``), and the launch counts include the replays.
10. ``two_sided_lanczos`` at N=60 in fp64 (n=250) on the CompositeV2 and
    its transpose, against the N=60 golden values.

The north-star path (compensated reductions, thick restart, refinement):

11. ``dot2_rounded`` and ``norm2`` on the card at M = 160^3 against the CPU
    result of the same inputs (within 1 fp32 ulp).
12. ``eigsh_restarted(k=20, compensated=True)`` in fp32 on the regular
    flagship (default basis 70), held against the same solve in fp64
    (converged: its true residuals below a tenth of the tolerance) value by
    value, multiplicity included, within eps32 ||H||_G, and against phase
    5's fp64 ``eigsh`` on the values that one converged; every pair's true
    residual within 14 eps32 ||H||_G; with its wall, cycles, peak memory
    (beside the n=400 ``eigsh``'s) and kernel launches.
13. Checkpoints at N=64, fp32: a run stopped after 2 cycles and resumed
    from its file against an uninterrupted run (1e-6 relative).
14. ``scripts/northstar_torch.py``'s pipeline in full at n_fine=72 (k=100
    + 10 buffer pairs, fp32 tol 3e-7, refinement tol 1e-8): the 100
    eigenvalues against scipy ``eigsh(L + I, k=110, "SA", tol=1e-12)``
    (atol 1e-8) and the true fp64 residuals (<= 3e-8 relative to the
    shifted eigenvalue); the refinement's units (``solver/refine.py``, one
    CUDA graph per unit and width on the card) replayed on every call after
    the first of their key, and the refinement run again from the same
    float32 pairs under ``graphs.eager()``: eigenvalues, relative residuals
    and vectors bitwise equal, both walls, captures, replays and capture
    seconds printed; then each kernel against its plain version at the
    shapes this operator gives it (below).
15. The same pipeline at n_fine=216 (1,586,304 points), with each stage's
    wall, cycles, peak memory and every kernel's launches by dtype: the
    refinement completes, lambda_0 is 0 within 1e-8, all 100 pairs reach
    3e-8, and the SpMV and interface kernels run in fp32 and fp64 and the
    SpMM in fp32.  Then, on that operator: each kernel against its plain
    version on the same inputs at the shapes the pipeline gives it (the
    SpMV in fp32 and fp64 and the SpMM at b=8 in fp32 on each level grid,
    the interface kernel in fp32 at b=1 and 8 and in fp64 at b=1; phase
    3's tolerances); the device busy share (``torch.profiler``) of one
    restart cycle and of one refinement round (``max_rounds=1, tol=0``),
    each captured and eager: the round's unprofiled wall, device busy
    share, peak memory, captures, capture seconds and replays, its results
    bitwise equal between the two, and each kernel's launches in one
    replayed correction chunk (the profiler's count); and the kernel, plain and
    cuSPARSE times of the interface kernel (fp32, fp64), the SpMV (fp32,
    fp64) and the SpMM at b=8 (fp32) on the lattice's level grids.  The
    restart cycles run as CUDA graphs; the busy share of one cycle is taken
    captured and eager (``graphs.eager()``).
16. ``eigs_nonsym(compensated=True, k=8)`` at N=60 (fp32) and
    ``refine_eigenpairs_dd_nonsym`` of its pairs, against the N=60 golden;
    every refined pair of a complete cluster (one that does not hold the
    highest computed pair; the 2.514/2.524 cluster only when all five of
    its copies are there) at a relative residual <= 1e-8.  The refinement
    runs captured (every unit call after the first of its key a replay)
    and again under ``graphs.eager()``: both walls, the results bitwise
    equal.

The block solver, look-ahead, the CLI and the benchmark:

17. ``eigsh_block_restarted(k=20, block_size=4)`` at N=160^3 in fp32 (tol
    1e-4) and fp64 (tol 1e-5), with wall, cycles, peak memory, launches
    and the SpMM's call widths (b=4 in the recurrence, k in the
    verification): every cycle after the first a CUDA graph replay (one
    capture; captures, replays and cycles redone printed), the first 6
    cycles' a/b blocks bitwise equal to an eager 6-cycle run's
    (``graphs.eager()``; the 6-cycle runs' walls and peak memory, eager and
    captured); true residuals within 14 eps32 ||H||_G (fp32) and a
    tenth of eps32 ||H||_G (fp64); the fp32 block against the fp64 block,
    sorted, within eps32 ||H||_G; the fp64 block as phase 12's
    multiplicity reference (the 5.2368/5.2370/5.2373 cluster's copies in
    each solve; phase 12's fp32 values by sorted pairing, or, where the
    single-vector solve holds other copies, by nearest value each way).
    Then a breakdown on the card: a rank-10 120 x 120 fp64 operator whose
    first captured cycle breaks down and is redone eagerly with the cure,
    held bitwise against the eager solve.
18. The CLI in process on the default device: ``solve-regular -N 64 -k 8
    --block-size 4`` against the N=64 golden by nearest value, each way.
19. ``two_sided_lanczos_lookahead(n=250)`` and ``lookahead_eigs(k=5,
    residual_tol=1e-5)`` at N=60 in fp64 on the CompositeV2 and its
    transpose (phase 10's starts): closed blocks, interface launches >= 2
    x 249, the pairs against the N=60 golden as phase 10 holds them.
20. ``python -m lanczos_tpu_torch bench``'s measurement (N=160^3 fp32 SpMV
    by graph replay): its GB/s within 50-100% of phase 3's copy rate.

Row sharding (``lanczos_tpu_torch/parallel``), over a one-rank NCCL process
group the script starts itself (the card cannot hold two NCCL ranks); each
of its collectives is first captured alone in a CUDA graph and replayed
against its eager call:

21. ``lanczos_sharded(shard_operator(H), n=400)`` at N=160^3 in fp32 from
    phase 5's start vector: its 20 lowest Ritz values against phase 5's
    and the unsharded recurrence's (eps32 ||H||_G), with walls and launch
    counts (>= 2 SpMV launches a step: the slab and its halo correction);
    then, in this process, every rank's slab matvec at D = 4 and 8 (40 and
    20 planes) fed its halo planes cut from the global x, against the
    global matvec's rows in fp32 and fp64 (phase 3's gates), the slab and
    correction kernels against their plain version, the slab SpMV timed;
    ``benchmark_matvec`` on the flagship within 50-100% of the copy rate.
22. ``shard_operator`` of phase 15's n_fine=216 operator and of the N=120
    deuteron CompositeV2: matvecs against the unsharded ones in fp32 and
    fp64 (``ops/dd.py:to_float64``); every level's slab and 4-plane
    halo-correction SpMV of those sharded operators, and of the n_fine=72
    one, against their plain version in fp32 and fp64; the n_fine=216
    level slabs at D = 4 (18 and 27 planes) against their plain version
    and timed; phase 14's pipeline with its fp32 compensated
    ``eigsh_restarted`` on the sharded operator, held to phase 14's scipy
    values and residual gates, its launches counted over that solve alone;
    its cycles captured with their collectives (fails if a cycle after the
    first does not replay), its wall and a cycle's wall and busy share
    beside the same solve with eager cycles and phase 14's unsharded one.
23. The v1 ``CompositeOperator`` at N=120 (``eigs_nonsym(k=8,
    max_basis=300, tol=1e-4)``, fp32), unsharded and through
    ``shard_composite``, each with captured cycles and then eager ones,
    each held to the N=120 golden as phase 9 holds it (fails if a
    captured cycle after the first does not replay; the sharded solve's
    cycle wall and busy share, captured and eager);
    ``lanczos_sharded`` on ``shard_operator`` and ``shard_ell_halo`` of the
    N=60 ELL against the unsharded recurrence (1e-5).

The tools (``scripts/irregular_flagship_torch.py``, the SciPy race, the
native ELL packer):

24. ``irregular_flagship_torch.main`` at N=60 on the card (the v1 composite,
    ``eigs_nonsym(k=8, max_basis=300)`` in fp32, the fp64 host
    refinement): refined true residuals <= 1e-10 and the eigenvalues in
    the N=60 golden's range held to it by ``check_against``; the race trio
    at n_fine=48 (``northstar_torch.run`` on the card, then
    ``northstar_scipy_torch.run``, then ``merge_race_torch``): both runs
    done, ``speedup_vs_scipy`` present, the ten lowest eigenvalues of the
    two within 1e-8; the N=60 fp64 ELL assembly through the native packer
    equal to the one through numpy, with both walls.

The restart cycles as CUDA graphs (``lanczos_tpu_torch/solver/graphs.py``):

25. Phase 9's N=120 solve in fp32 and fp64 through the captured cycles and
    through the eager body (``graphs.eager()``) from the same v0, in turns
    (captured, eager, eager, captured): walls, peak memory, graphs captured
    and their capture time, replays, the device busy share of a whole
    solve and of one cycle (the third cycle's device time over the wall
    of a replayed cycle) with the interface kernel's and the SpMV's device
    time a launch in it, and the largest
    |diff| of the eigenvalues and of every cycle's B between the two paths
    and between two runs of each.  Fails if a solve captures more graphs
    than it has distinct (l, m), if a cycle after the first does not
    replay, or if the captured results miss phase 9's golden check; then
    one level stencil's weights are scaled in place by 1.01: the captured
    solve of the changed operator is held to its eager solve and must have
    left the old spectrum, and one ``CycleGraphs`` across such a change
    must run an eager cycle and capture anew, its replays equal to the
    changed operator's matvec.

The line before the last is a JSON object of the kernels (with their
sharded launch counts and slab times); the last line is
``{"ok": true, "device": {...}}``.
"""

import collections
import contextlib
import gc
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
EPS32 = float(np.finfo(np.float32).eps)


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def fmt(samples):
    return ["%.4f" % s for s in samples]


def device_times(fn, launches=50, eager_launches=100):
    """(graph-replay ms, eager ms) per call of ``fn`` (a kernel or the
    library call it is measured against), with every sample
    (``lanczos_tpu_torch.utils.timing``)."""
    from lanczos_tpu_torch.utils.timing import eager_ms, graph_ms

    g, g_samples = graph_ms(fn, launches=launches)
    e, e_samples = eager_ms(fn, launches=eager_launches)
    return g, e, g_samples, e_samples


def launch_floor():
    """Graph-replay ms of a one-element ``fill_``: what any kernel of a graph
    costs at the least."""
    from lanczos_tpu_torch.utils.timing import graph_ms

    buf = torch.zeros(1, device="cuda")
    ms, _ = graph_ms(lambda: buf.fill_(1.0))
    print(f"  launch floor (graph replay of a one-element fill_): {ms:.5f} ms")
    return ms


def card_label():
    """``nvidia-smi``'s name and power limit of the card."""
    from lanczos_tpu_torch.utils.timing import card_label as label

    return label()


def gershgorin_norm(op):
    """sum_k |w_k| + max |diag|: a bound on ||H|| from the operator's arrays."""
    bound = float(op.weights.abs().sum())
    if op.diag is not None:
        bound += float(op.diag.abs().max())
    return bound


def fp32_tolerance(op):
    """Tolerance on an fp32 eigenvalue against fp64: eps32 * ||H||_G.

    Storing H in fp32 perturbs it by at most eps32/2 * |H| entrywise, a
    matrix of norm at most eps32/2 * ||H||_G, so its eigenvalues move by at
    most that much (Weyl); each fp32 SpMV of the recurrence rounds by about
    as much again.
    """
    return EPS32 * gershgorin_norm(op)


def kernel_cases(lt, dtype):
    """(name, operator) at the CPU tests' shapes, the irregular lattices'
    level grids, two odd grids (one plane; a row that is no multiple of 16
    bytes) and the flagship."""
    from lanczos_tpu_torch.ops.operators import make_stencil_operator

    dev = "cuda"
    pot = lt.deuteron_potential_3d

    def reg(n, stencil):
        return lt.build_regular_hamiltonian(
            n, 25.0, pot, stencil=stencil, dtype=dtype, device=dev
        )

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
    rng = np.random.default_rng(6)
    full = list(itertools.product((-1, 0, 1), repeat=3))

    def odd(shape):
        return make_stencil_operator(
            shape, full, rng.standard_normal(27),
            diag=rng.standard_normal(int(np.prod(shape))), dtype=dtype, device=dev)

    return [
        ("N12_27pt", reg(12, "27")),
        ("N10_7pt", reg(10, "7")),
        ("N8_27pt", reg(8, "27")),
        ("6x10x14_asym_nodiag", aniso),
        ("8x16x8_diag", flat),
        ("N16_27pt_graded", reg(16, "27")),
        # The level grids of the N=60 and N=120 irregular lattices.
        ("N20_27pt", reg(20, "27")),
        ("N30_27pt", reg(30, "27")),
        ("N40_27pt", reg(40, "27")),
        ("N60_27pt", reg(60, "27")),
        ("3x5x7_27tap", odd((3, 5, 7))),
        ("1x9x130_27tap", odd((1, 9, 130))),
        ("N160_27pt_flagship", reg(160, "27")),
    ]


def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    print("== card (nvidia-smi name, power.limit)")
    print(smi[0])
    print(f"torch.cuda.get_device_name(0) = {torch.cuda.get_device_name(0)}; "
          f"device_count = {torch.cuda.device_count()}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    print(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    return smi[0]


def phase_build():
    from lanczos_tpu_torch.ops._build import build_all

    t0 = time.perf_counter()
    infos = build_all()
    print(f"== build (the kernel libraries in parallel: {time.perf_counter() - t0:.2f} s wall)")
    for info in infos.values():
        print(f"library {os.path.relpath(info.path, HERE)} "
              f"({'already built' if info.cached else 'built'}; "
              f"nvcc {info.seconds:.2f} s)")
        for line in info.log.splitlines():
            if "ptxas" in line or "spill" in line:
                print(f"  {line.strip()}")


def against_plain(label, y, y_ref):
    """Hold a kernel's output to its plain version's; print the line and
    return the max abs error.  fp32: the tolerance of the JAX package's
    kernel tests (the sums run in another order); fp64: the kernels sum the
    same taps in another order (grouped by dz), ~1e-15 relative."""
    torch.cuda.synchronize()
    atol_scale, rtol = {torch.float32: (2e-5, 1e-4), torch.float64: (1e-12, 1e-12)}[y_ref.dtype]
    scale = float(y_ref.abs().max())
    err = (y - y_ref).abs()
    ok = bool((err <= atol_scale * scale + rtol * y_ref.abs()).all())
    abs_err = float(err.max())
    print(f"  {label:44s} {abs_err:.3e} {abs_err / scale:.3e} {'ok' if ok else 'MISMATCH'}")
    check(ok, f"{label}: the kernel disagrees with its plain version")
    return abs_err


def phase_kernels(lt):
    """Kernel vs plain version at every shape; returns max abs error per kernel."""
    from lanczos_tpu_torch.ops import stencil_kernels as sk

    print("== kernels vs plain version (max abs err, max abs err / max |y_ref|)")
    max_abs = {"stencil_spmv": 0.0, "stencil_spmm": 0.0}
    gen = torch.Generator(device="cuda").manual_seed(0)
    # (kernel, b, offset): a block at offset 1 starts one element into its
    # buffer, so it is not 16-byte aligned and the SpMM takes element copies.
    launches = [("stencil_spmv", None, 0)] + [("stencil_spmm", b, 0) for b in (1, 3, 4, 5, 8, 20)] + [
        ("stencil_spmm", 8, 1), ("stencil_spmm", 20, 1)]
    for dtype in (torch.float32, torch.float64):
        for name, op in kernel_cases(lt, dtype):
            m = op.shape[0]
            for kname, b, offset in launches:
                shape = (m,) if b is None else (m, b)
                buf = torch.randn(int(np.prod(shape)) + offset, generator=gen, device="cuda",
                                  dtype=dtype)
                x = buf[offset:].view(shape)
                if b is None:
                    y, y_ref = sk.stencil_spmv(op, x), sk.stencil_spmv_reference(op, x)
                else:
                    y, y_ref = sk.stencil_spmm(op, x), sk.stencil_spmm_reference(op, x)
                label = kname if b is None else f"{kname} b={b}{' unaligned' if offset else ''}"
                abs_err = against_plain(f"{str(dtype)[6:]:8s} {name:22s} {label:28s}", y, y_ref)
                max_abs[kname] = max(max_abs[kname], abs_err)
    return max_abs


#: Published peaks of one H100 SXM (NVIDIA's data sheet, dense, 700 W): its
#: HBM3 rate and its fp32 and fp64 rates outside the tensor cores.
PEAK_HBM_BYTES = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_FP64_FLOPS = 34e12


def bound(bytes_moved, flops, peak_flops=PEAK_FP32_FLOPS):
    """(bound_ms, bound_by): the larger of the compulsory bytes over the
    card's published HBM rate and the operations over its peak (fp32 unless
    given)."""
    t_bytes = bytes_moved / PEAK_HBM_BYTES * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def stencil_csr(op):
    """The stencil operator as a cuSPARSE-ready CSR (int32 indices, sorted
    columns), built on the card: the library call the kernels are timed
    against."""
    nz, ny, nx = op.grid_shape
    m, k = nz * ny * nx, len(op.offsets)
    p = torch.arange(m, device=op.weights.device)
    z, y, x = p // (ny * nx), (p // nx) % ny, p % nx
    cols = torch.stack([(((z + dz) % nz) * ny + (y + dy) % ny) * nx + (x + dx) % nx
                        for dz, dy, dx in op.offsets], dim=1)
    del p, z, y, x
    vals = op.weights[None, :].expand(m, k).clone()
    if op.diag is not None:
        vals[:, op.offsets.index((0, 0, 0))] += op.diag
    cols, order = cols.sort(dim=1)
    vals = vals.gather(1, order)
    del order
    crow = torch.arange(0, m * k + 1, k, dtype=torch.int32, device=cols.device)
    return torch.sparse_csr_tensor(crow, cols.to(torch.int32).reshape(-1),
                                   vals.reshape(-1), size=(m, m))


def copy_rate():
    """Device-to-device copy rate in GB/s (256 MB read + 256 MB write)."""
    from lanczos_tpu_torch.utils.timing import eager_ms

    buf = torch.empty(64 * 2**20, device="cuda")
    dst = torch.empty_like(buf)
    copy_ms, _ = eager_ms(lambda: dst.copy_(buf))
    gbs = 2 * buf.numel() * 4 / copy_ms / 1e6
    print(f"  device-to-device copy (256 MB read + 256 MB write): {copy_ms:.4f} ms "
          f"= {gbs:.1f} GB/s")
    return gbs


def kernel_row(label, fn, plain, lib, bytes_moved, flops, copy_gbs, floor_ms,
               launches=50, eager_launches=100, plain_launches=100, peak_flops=PEAK_FP32_FLOPS):
    """Time a kernel, its plain version and its library yardstick; print
    one line and return the JSON line's timing fields."""
    from lanczos_tpu_torch.utils.timing import eager_ms

    ms, eager, g_samples, e_samples = device_times(fn, launches, eager_launches)
    plain_ms, _ = eager_ms(plain, launches=plain_launches)
    lib_ms, lib_eager, _, _ = device_times(lib, launches, eager_launches)
    bound_ms, bound_by = bound(bytes_moved, flops, peak_flops)
    copy_ms = bytes_moved / copy_gbs / 1e6
    print(f"  {label:34s} graph {ms:.5f} ms ({bound_ms / ms:.1%} of its bound), eager {eager:.5f} ms; "
          f"plain {plain_ms:.4f} ms (eager); library {lib_ms:.5f} ms (graph; eager {lib_eager:.5f}); "
          f"bound {bound_ms:.6f} ms ({bound_by}; {bytes_moved} B at 3.35 TB/s); the bytes at the "
          f"measured copy rate {copy_ms:.6f} ms ({copy_ms / ms:.1%}); launch floor {floor_ms:.5f} ms")
    print(f"    samples graph {fmt(g_samples)} eager {fmt(e_samples)}")
    return dict(ms=ms, eager_ms=eager, launch_floor_ms=floor_ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by)


def phase_timing(lt, floor_ms):
    """Kernel, plain and cuSPARSE times at N=160^3, fp32 (and the SpMM in
    fp64); returns a dict of the fp32 timing fields per kernel."""
    from lanczos_tpu_torch.ops import stencil_kernels as sk

    print("== times at N=160^3, 27-point, fp32 (graph: replays of 50 calls, median of 20; "
          "eager: median of 5 x 100 calls; SpMM 5 and 10)")
    op = lt.build_regular_hamiltonian(
        160, 25.0, lt.deuteron_potential_3d, stencil="27", dtype=torch.float32,
        device="cuda",
    )
    m = op.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(1)
    # x rotates through 8 vectors (131 MB, over twice the 50 MB L2), so each
    # SpMV reads x from HBM as in the solver, where the reorthogonalization
    # streams the basis through L2 between SpMVs.
    xs = itertools.cycle([torch.randn(m, generator=gen, device="cuda") for _ in range(8)])
    X = torch.randn((m, 20), generator=gen, device="cuda")
    X4 = torch.randn((m, 4), generator=gen, device="cuda")
    csr = stencil_csr(op)
    copy_gbs = copy_rate()
    rows = {
        "stencil_spmv": kernel_row(
            "stencil_spmv", lambda: sk.stencil_spmv(op, next(xs)),
            lambda: sk.stencil_spmv_reference(op, next(xs)), lambda: torch.mv(csr, next(xs)),
            12 * m, 2 * 27 * m, copy_gbs, floor_ms),
        "stencil_spmm": kernel_row(
            "stencil_spmm b=20", lambda: sk.stencil_spmm(op, X),
            lambda: sk.stencil_spmm_reference(op, X), lambda: torch.sparse.mm(csr, X),
            (8 * 20 + 4) * m, 2 * 27 * 20 * m, copy_gbs, floor_ms,
            launches=5, eager_launches=10, plain_launches=5),
    }
    # The SpMM at b=4, the width of the block solver's recurrence: 36 B/pt.
    b4 = {torch.float32: kernel_row(
        "stencil_spmm b=4", lambda: sk.stencil_spmm(op, X4),
        lambda: sk.stencil_spmm_reference(op, X4), lambda: torch.sparse.mm(csr, X4),
        (4 * 4 * 2 + 4) * m, 2 * 27 * 4 * m, copy_gbs, floor_ms,
        launches=20, eager_launches=20, plain_launches=5)}
    del op, xs, X, X4, csr
    torch.cuda.empty_cache()
    # The SpMM in fp64, as the flagship's fp64 rerun calls it: 328 B/pt.
    op = lt.build_regular_hamiltonian(
        160, 25.0, lt.deuteron_potential_3d, stencil="27", dtype=torch.float64,
        device="cuda",
    )
    X = torch.randn((m, 20), generator=gen, device="cuda", dtype=torch.float64)
    X4 = torch.randn((m, 4), generator=gen, device="cuda", dtype=torch.float64)
    csr = stencil_csr(op)
    kernel_row(
        "stencil_spmm b=20 fp64", lambda: sk.stencil_spmm(op, X),
        lambda: sk.stencil_spmm_reference(op, X), lambda: torch.sparse.mm(csr, X),
        (16 * 20 + 8) * m, 2 * 27 * 20 * m, copy_gbs, floor_ms,
        launches=5, eager_launches=10, plain_launches=2, peak_flops=PEAK_FP64_FLOPS)
    b4[torch.float64] = kernel_row(
        "stencil_spmm b=4 fp64", lambda: sk.stencil_spmm(op, X4),
        lambda: sk.stencil_spmm_reference(op, X4), lambda: torch.sparse.mm(csr, X4),
        (8 * 4 * 2 + 8) * m, 2 * 27 * 4 * m, copy_gbs, floor_ms,
        launches=20, eager_launches=20, plain_launches=2, peak_flops=PEAK_FP64_FLOPS)
    del op, X, X4, csr
    torch.cuda.empty_cache()
    rows["stencil_spmm"]["block_b4"] = {str(dt)[6:]: row for dt, row in b4.items()}
    return rows, copy_gbs


def phase_cgs2():
    """The CGS2 kernel against its plain version (two cuBLAS GEMVs a pass)
    at the flagship's M = 4,096,000 and passes = 2: j = 200 and 399 in fp32
    and fp64 (one tile: p + 1 = 3 reads of V[:j]) and j = 1000 in fp32 (row
    blocks: 2p = 4 reads), each held to 8 eps sqrt(j) of the input's scale
    (tests/test_torch_cuda.py's bound), bitwise repeatable, and timed as
    graph replays; then one step of the lagged recurrence (cgs2_lagged,
    finishing row j - 1: p = 2 reads) at j = 200 and 399 against its plain
    version the same way; returns the fields of the kernels JSON line."""
    from lanczos_tpu_torch._util import COUNTERS
    from lanczos_tpu_torch.ops import cgs2_kernels as ck
    from lanczos_tpu_torch.utils.timing import graph_ms

    m, passes = 4_096_000, 2
    print(f"== cgs2 vs plain version at M = {m}, passes = {passes} (graph: replays of 5 calls, "
          f"median of 10; bound: the reads of V[:j] at 3.35 TB/s)")
    gen = torch.Generator(device="cuda").manual_seed(8)
    cases = {}
    for dtype, rows in ((torch.float32, (200, 399, 1000)), (torch.float64, (200, 399))):
        eps = torch.finfo(dtype).eps
        Vfull = torch.randn(max(rows) + 1, m, generator=gen, dtype=dtype, device="cuda") / m**0.5
        for j in rows:
            V = Vfull[:j]
            c = torch.rand(j, generator=gen, dtype=dtype, device="cuda") * 2 - 1
            v = torch.randn(m, generator=gen, dtype=dtype, device="cuda") / m**0.5 + c @ V
            before = COUNTERS["lt.cgs2.fused"]
            got = ck.cgs2(V, v, passes)
            want = ck.cgs2_reference(V, v, passes)
            torch.cuda.synchronize()
            check(COUNTERS["lt.cgs2.fused"] - before == 1, "cgs2 did not launch its kernel")
            check(torch.equal(got, ck.cgs2(V, v, passes)), f"cgs2 j={j}: not bitwise repeatable")
            err, scale = float((got - want).abs().max()), float(v.abs().max())
            tol = 8 * eps * j**0.5 * scale
            ms, samples = graph_ms(lambda: ck.cgs2(V, v, passes), launches=5, samples=10)
            plain_ms, _ = graph_ms(lambda: ck.cgs2_reference(V, v, passes), launches=5,
                                   samples=10)
            reads = passes + 1 if j <= ck.MAX_ROWS else 2 * passes
            bound_ms = 1e3 * reads * j * m * V.element_size() / PEAK_HBM_BYTES
            plain_bound = 1e3 * 2 * passes * j * m * V.element_size() / PEAK_HBM_BYTES
            label = f"{str(dtype)[6:]} j={j}"
            print(f"  {label:13s} max abs err {err:.3e} (tol {tol:.3e}); graph {ms:.4f} ms, "
                  f"{bound_ms / ms:.1%} of its {reads} reads' bound {bound_ms:.4f} ms; plain "
                  f"{plain_ms:.4f} ms, {plain_bound / plain_ms:.1%} of its {2 * passes} reads' "
                  f"bound {plain_bound:.4f} ms")
            print(f"    samples graph {fmt(samples)}")
            check(err <= tol, f"cgs2 {label}: the kernel disagrees with its plain version")
            cases[label] = dict(max_abs_err=err, tol=tol, reads=reads, ms=ms, plain_ms=plain_ms,
                                bound_ms=bound_ms, plain_bound_ms=plain_bound)
            del V, c, v, got, want
            if j > ck.MAX_ROWS:
                continue
            # One lagged step: row j - 1 unfinished by ~1e-3 of its coefficients.
            hp = (torch.rand(j - 1, generator=gen, dtype=dtype, device="cuda") - 0.5) * 2e-3
            Vs = Vfull[: j + 1].clone()
            Vs[j - 1] += hp @ Vs[: j - 1]
            c = torch.rand(j, generator=gen, dtype=dtype, device="cuda") * 2 - 1
            v = torch.randn(m, generator=gen, dtype=dtype, device="cuda") / m**0.5 + c @ Vs[:j]
            Vr = Vs.clone()
            h_ref = ck.cgs2_lagged_reference(Vr, j, v, hp, passes)
            want = Vr[j - 1:j + 1].clone()
            del Vr
            Vk = Vs.clone()
            before = COUNTERS["lt.cgs2.fused"]
            h = ck.cgs2_lagged(Vk, j, v, hp, passes)
            again = ck.cgs2_lagged(Vs, j, v, hp, passes)
            torch.cuda.synchronize()
            check(COUNTERS["lt.cgs2.fused"] - before == 2, "cgs2_lagged did not launch its kernel")
            check(torch.equal(h, again) and torch.equal(Vk, Vs),
                  f"cgs2_lagged j={j}: not bitwise repeatable")
            # The rows to the input's scale; h~, sums of M products, to |v~|'s.
            err, err_h = float((Vk[j - 1:j + 1] - want).abs().max()), float((h - h_ref).abs().max())
            tol, tol_h = (8 * eps * j**0.5 * float(x) for x in (v.abs().max(), want[1].norm()))
            check(err_h <= tol_h, f"cgs2 lagged j={j}: h~ off by {err_h:.3e} (tol {tol_h:.3e})")
            del Vs, again, want
            ms, samples = graph_ms(lambda: ck.cgs2_lagged(Vk, j, v, hp, passes), launches=5,
                                   samples=10)
            bound_ms = 1e3 * passes * j * m * Vk.element_size() / PEAK_HBM_BYTES
            label = f"lagged {str(dtype)[6:]} j={j}"
            print(f"  {label:20s} max abs err {err:.3e} (tol {tol:.3e}); graph {ms:.4f} ms, "
                  f"{bound_ms / ms:.1%} of its {passes} reads' bound {bound_ms:.4f} ms")
            print(f"    samples graph {fmt(samples)}")
            check(err <= tol, f"cgs2 {label}: the kernel disagrees with its plain version")
            cases[label] = dict(max_abs_err=err, tol=tol, reads=passes, ms=ms, bound_ms=bound_ms)
            del Vk, v, c, h, h_ref
        del Vfull
        torch.cuda.empty_cache()
    at = cases["float32 j=399"]
    return dict(max_abs_err=max(c["max_abs_err"] for c in cases.values()), ms=at["ms"],
                lagged_ms=cases["lagged float32 j=399"]["ms"],
                plain_ms=at["plain_ms"], bound_ms=at["bound_ms"], bound_by="bytes", cases=cases)


def compare_eigs(label, vals, ref_vals, accepted, tol):
    """Print |vals - ref_vals| and fail where an accepted pair exceeds tol."""
    print(f"  {label}: tolerance {tol:.3e} MeV on the pairs the reference accepts")
    for i, (a, b) in enumerate(zip(vals, ref_vals)):
        print(f"    {i:2d} {a:14.8f} {b:14.8f} |diff| {abs(a - b):.3e} rel "
              f"{abs(a - b) / max(abs(b), 1e-30):.3e} {'checked' if accepted[i] else '-'}")
    check(accepted[0], f"{label}: the reference's ground state is not accepted")
    bad = [i for i in range(len(vals)) if accepted[i] and abs(vals[i] - ref_vals[i]) > tol]
    check(not bad, f"{label}: pairs {bad} disagree beyond {tol:.3e}")


def phase_golden(lt):
    print("== eigsh at N=64 (27-point, fp32, k=8, n=150) vs lanczos_tpu fp64 golden")
    with open(os.path.join(HERE, "lanczos_tpu_torch", "data", "golden_eigsh_n64.json")) as f:
        golden = json.load(f)
    c = golden["config"]
    H = lt.build_regular_hamiltonian(
        c["N"], c["L"], lt.deuteron_potential_3d, stencil=c["stencil"],
        dtype=torch.float32, device="cuda",
    )
    v0 = np.random.default_rng(c["v0_seed"]).uniform(-1.0, 1.0, c["N"] ** 3)
    res = lt.eigsh(H, k=c["k"], n=c["n"], which=c["which"], v0=v0)
    torch.cuda.synchronize()
    print(res.summary())
    vals = res.eigenvalues.double().cpu().numpy()
    check(np.all(np.isfinite(vals)), "non-finite eigenvalues at N=64")
    accepted = np.abs(1.0 - np.asarray(golden["inner_prod"])) < 0.01
    tol = fp32_tolerance(H)
    compare_eigs("N=64 fp32 (port, GPU) vs fp64 (lanczos_tpu, CPU)", vals,
                 golden["eigenvalues"], accepted, tol)


def phase_flagship(lt):
    from lanczos_tpu_torch._util import COUNTERS
    from lanczos_tpu_torch.ops import stencil_kernels as sk

    print("== flagship: N=160^3, L=25, 27-point, eigsh(k=20, n=400, 'SA')")
    N, k, n = 160, 20, 400
    v0 = np.random.default_rng(99).uniform(-1.0, 1.0, N**3)
    runs = {}
    for dtype in (torch.float32, torch.float64):
        H = lt.build_regular_hamiltonian(
            N, 25.0, lt.deuteron_potential_3d, stencil="27", dtype=dtype, device="cuda"
        )
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sk.stencil_spmv.launches = 0
        sk.stencil_spmm.launches = 0
        cgs2_before = (COUNTERS["lt.cgs2.calls"], COUNTERS["lt.cgs2.fused"],
                       COUNTERS["lt.cgs2.basis_reads"])
        t0 = time.perf_counter()
        res = lt.eigsh(H, k=k, n=n, which="SA", v0=v0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        cgs2_calls = COUNTERS["lt.cgs2.calls"] - cgs2_before[0]
        launches = (sk.stencil_spmv.launches, sk.stencil_spmm.launches,
                    COUNTERS["lt.cgs2.fused"] - cgs2_before[1])
        peak = torch.cuda.max_memory_allocated()
        print(f"  {str(dtype)[6:]}: wall {wall:.3f} s, peak device memory "
              f"{peak / 2**30:.2f} GiB, launches spmv {launches[0]} spmm {launches[1]} "
              f"cgs2 {launches[2]} (of {cgs2_calls} CGS2 calls)")
        print(res.summary(print_nr=k))
        vals = res.eigenvalues.double().cpu().numpy()
        check(tuple(res.eigenvalues.shape) == (k,)
              and tuple(res.eigenvectors.shape) == (N**3, k), "flagship result shapes")
        for name, t in (("eigenvalues", res.eigenvalues), ("eigenvectors", res.eigenvectors),
                        ("residuals", res.residuals), ("inner_prod", res.inner_prod)):
            check(bool(torch.isfinite(t).all()), f"flagship {dtype}: non-finite {name}")
        check(launches[0] >= n, f"spmv launched {launches[0]} times, expected >= {n}")
        check(launches[1] >= 1, f"spmm launched {launches[1]} times, expected >= 1")
        check(launches[2] == cgs2_calls == n - 1,
              f"cgs2 launched {launches[2]} times for {cgs2_calls} CGS2 calls, expected {n - 1}")
        reads = COUNTERS["lt.cgs2.basis_reads"] - cgs2_before[2]
        check(reads == 2 * (n - 1) + 1,
              f"the solve swept the basis {reads} times, expected {2 * (n - 1) + 1} (lagged)")
        runs[dtype] = dict(vals=vals, res=res, wall=wall, peak=peak, launches=launches,
                           tol=fp32_tolerance(H))
        del H, res
        torch.cuda.empty_cache()
    ref = runs[torch.float64]
    accepted = ref["res"].good_mask()
    check(accepted[0], "flagship fp64: ground state not accepted")
    compare_eigs("flagship fp32 vs fp64 (same v0)", runs[torch.float32]["vals"],
                 ref["vals"], accepted, runs[torch.float32]["tol"])
    return runs


# ---------------------------------------------------------------------------
# The irregular multi-resolution lattice


def irregular_tolerance(norm_inf, norm_1, eps, resid_abs, ref_resid_abs):
    """(checked-pair residual floor, per-pair eigenvalue tolerance) in MeV,
    for a solve of the non-symmetric H in a dtype of unit roundoff ``eps``
    (PERF.md, "Tolerance for the irregular solves").

    A Ritz pair (lam, x), ||x|| = 1, is checked when its measured residual
    ||r|| <= floor = 2 eps ||H||_inf (the dtype's floor: measured through x
    and a matmat in that dtype, r carries ~eps ||H||_inf of rounding), or
    its relative residual is below the solve's tol.  Then (lam, x) is an
    exact eigenpair of H_dtype + E with ||E||_2 <= max(||r||, floor) +
    eps ||H||_inf, and H_dtype = H + F with |F| <= eps/2 |H| entrywise,
    ||F||_2 <= eps/2 sqrt(||H||_1 ||H||_inf).  To first order each moves lam
    by at most kappa times its norm, kappa = ||x|| ||y|| / |y.x| (1.18 for
    the N=60 ground state, up to 2.53 inside a near-degenerate cluster),
    taken as 3; the reference value's own residual enters the same way.
    """
    floor = 2 * eps * norm_inf
    meas = eps * norm_inf
    store = 0.5 * eps * np.sqrt(norm_1 * norm_inf)
    return floor, 3.0 * (np.maximum(resid_abs, floor) + meas + store + ref_resid_abs)


def rows_and_norms(lt, lat):
    """The assembled rows of H, its diagonal, t_factor and (||H||_inf,
    ||H||_1), on the host."""
    from lanczos_tpu_torch.models.irr_hamiltonian import _diagonal, irregular_laplacian_rows

    nbrs, rels, weights = irregular_laplacian_rows(lat)
    t = lt.kinetic_prefactor(lat.s)
    diag = _diagonal(lat, weights, t, lt.deuteron_potential_3d)
    mask = nbrs >= 0
    absw = t * np.abs(weights) * mask
    col = np.abs(diag).copy()
    np.add.at(col, nbrs[mask], absw[mask])
    norms = (float((np.abs(diag) + absw.sum(axis=1)).max()), float(col.max()))
    return (nbrs, rels, weights, diag, t), norms


def csr_of_rows(rows, idx_map, m):
    """H (from its rows, lattice order) as a (m, m) CSR in the operator's
    region-slot order, on the card."""
    import scipy.sparse

    nbrs, _, weights, diag, t = rows
    p, k = nbrs.shape
    mask = nbrs >= 0
    r = np.concatenate([np.repeat(np.arange(p), k)[mask.reshape(-1)], np.arange(p)])
    c = np.concatenate([nbrs[mask], np.arange(p)])
    v = np.concatenate([-t * weights[mask], diag])
    h = scipy.sparse.csr_matrix((v, (idx_map[r], idx_map[c])), shape=(m, m))
    return to_torch_csr(h)


def to_torch_csr(h, dtype=torch.float32):
    h.sort_indices()
    return torch.sparse_csr_tensor(
        torch.as_tensor(h.indptr, dtype=torch.int32), torch.as_tensor(h.indices, dtype=torch.int32),
        torch.as_tensor(h.data, dtype=dtype), size=h.shape, device="cuda")


def interface_csr(fi, dtype=torch.float32):
    """The fused classes as a CSR (R, M) over the operator's slots, plus the
    R output slots: the same sums the kernel computes, for cuSPARSE."""
    import scipy.sparse

    from lanczos_tpu_torch.ops.interface_kernel import class_windows

    out_slots, rr, cc, vv = [], [], [], []
    r0 = 0
    for (base, (ny, nx), o3, step, acc, taps), ws in zip(
            class_windows(fi.grid_meta, fi.level_meta), fi.grid_w):
        iz, iy, ix = (a.reshape(-1) for a in np.meshgrid(*(np.arange(a) for a in acc), indexing="ij"))
        out_slots.append(base + ((o3[0] + step[0] * iz) * ny + o3[1] + step[1] * iy) * nx
                         + o3[2] + step[2] * ix)
        rows = r0 + np.arange(len(iz))
        for (sbase, (sny, snx), s3, st), w in zip(taps, ws.double().cpu().numpy()):
            rr.append(rows)
            cc.append(sbase + ((s3[0] + st[0] * iz) * sny + s3[1] + st[1] * iy) * snx
                      + s3[2] + st[2] * ix)
            vv.append(np.full(len(iz), w))
        r0 += len(iz)
    m = sum(int(np.prod(ext)) for _, ext, _ in fi.level_meta)
    h = scipy.sparse.csr_matrix(
        (np.concatenate(vv), (np.concatenate(rr), np.concatenate(cc))), shape=(r0, m))
    return to_torch_csr(h, dtype), np.concatenate(out_slots)


def interface_bytes(fi, elem):
    """Compulsory bytes of one fused-interface application: each source
    element read once, each class row's y read and written once, the tables
    read once."""
    csr, _ = interface_csr(fi)
    n_src = int(torch.unique(csr.col_indices()).numel())
    tables = sum(t.numel() * t.element_size() for t in (fi.cls, fi.taps, fi.row_class))
    return elem * (n_src + 2 * fi.num_rows + fi.num_taps) + tables


def irregular_lattices(lt):
    """(name, lattice, min_grid_rows): the tests' mixed lattice (n=24, box
    depth 3, centre box at spacing 1), the N=60 and the N=120 deuteron
    lattices (box depth 3, spacings from the potential)."""
    sp = np.full(27, 2, dtype=np.int64)
    sp[13] = 1
    out = [("mixed n=24", lt.build_lattice(24, 25.0, 3, spacings=sp), 4)]
    for n in (60, 120):
        t0 = time.perf_counter()
        lat = lt.build_lattice(n, 25.0, 3, potential=lt.deuteron_potential_3d)
        print(f"  N={n} lattice: {lat.num_points} points, spacings "
              f"{sorted(set(lat.spacings.tolist()))}, built in {time.perf_counter() - t0:.2f} s")
        out.append((f"N={n}", lat, 16))
    return out


def phase_interface_kernel(lt, lattices):
    """Interface kernel vs plain at every lattice, fp32/fp64, A and A^T,
    one column and three; returns (max abs error, {(name, dtype): op})."""
    from lanczos_tpu_torch.ops import interface_kernel as ik
    from lanczos_tpu_torch.ops.composite2 import build_composite_v2

    print("== interface kernel vs plain version (classes, rows, tap reads, build s, "
          "max abs err, max abs err / max |y_ref|)")
    gen = torch.Generator(device="cuda").manual_seed(2)
    max_abs, ops, host = 0.0, {}, {}
    for name, lat, min_rows in lattices:
        rows, norms = rows_and_norms(lt, lat)
        host[name] = (lat, rows, norms)
        nbrs, rels, weights, diag, t = rows
        for dtype in (torch.float32, torch.float64):
            t0 = time.perf_counter()
            op, idx_map = build_composite_v2(
                lat, nbrs, rels, weights, diag, scale=-t, dtype=dtype,
                min_grid_rows=min_rows, build_transpose=True, device="cuda",
            )
            build_s = time.perf_counter() - t0
            ops[(name, dtype)] = (op, idx_map)
            for which, o in (("A", op), ("A^T", op.transpose_op)):
                fi = o.fused
                for b in (None, 3):
                    shape = (o.shape[0],) if b is None else (o.shape[0], b)
                    x = torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
                    y0 = torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
                    abs_err = against_plain(
                        f"{str(dtype)[6:]:8s} {name:11s} {which:3s} b={b or 1} "
                        f"{fi.cls.shape[0]:4d} {fi.num_rows:6d} {fi.tap_reads:7d} {build_s:6.2f}",
                        ik.apply_fused_interface(fi, x, y0.clone()),
                        ik.apply_fused_interface_reference(fi, x, y0.clone()))
                    max_abs = max(max_abs, abs_err)
    return max_abs, ops, host


def phase_whole_operator(lt, ops, host):
    """N=60, fp64: CompositeV2 matvec/rmatvec on the card vs the port's ELL."""
    print("== whole operator at N=60, fp64: CompositeV2 vs the port's ELL assembly")
    lat = host["N=60"][0]
    op, idx_map = ops[("N=60", torch.float64)]
    ell = lt.assemble_irregular_hamiltonian(
        lat, lt.deuteron_potential_3d, dtype=torch.float64, device="cuda")
    x = np.random.default_rng(3).standard_normal(lat.num_points)
    v = torch.zeros(op.shape[0], dtype=torch.float64, device="cuda")
    idx = torch.as_tensor(idx_map, device="cuda")
    v[idx] = torch.as_tensor(x, device="cuda")
    for label, got, want in (
        ("matvec", op.matvec(v)[idx], ell.matvec(torch.as_tensor(x, device="cuda"))),
        ("rmatvec", op.rmatvec(v)[idx],
         torch.as_tensor(ell.to_scipy().T @ x, device="cuda")),
    ):
        rel = float((got - want).abs().max() / want.abs().max())
        print(f"  {label:8s} max |diff| / max |y| = {rel:.3e} (tolerance 1e-9)")
        check(rel <= 1e-9, f"CompositeV2 {label} disagrees with the ELL assembly")


def phase_interface_timing(lt, ops, host, copy_gbs, floor_ms):
    """N=120, fp32: interface kernel, plain, CSR; the stencil SpMV and the
    SpMM at b=8 on the level grids; whole matvec vs CSR mv.  Returns the
    JSON line's timing fields of the interface kernel."""
    from lanczos_tpu_torch.ops import interface_kernel as ik
    from lanczos_tpu_torch.ops import stencil_kernels as sk

    print("== times at N=120, fp32 (graph: replays of 50 calls, median of 20; eager: median "
          "of 5 x 100 calls; plain 5 x 10)")
    op, idx_map = ops[("N=120", torch.float32)]
    fi = op.fused
    m = op.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(4)
    xs = itertools.cycle([torch.randn(m, generator=gen, device="cuda") * op.live for _ in range(8)])
    y = torch.zeros(m, device="cuda")
    csr_i, slots = interface_csr(fi)
    # The CSR sums equal the kernel's contribution on the class rows.
    x = next(xs)
    got = ik.apply_fused_interface(fi, x, torch.zeros_like(x))[torch.as_tensor(slots, device="cuda")]
    want = torch.mv(csr_i, x)
    check(bool(torch.allclose(got, want, rtol=1e-4, atol=2e-5 * float(want.abs().max()))),
          "interface CSR and kernel disagree")
    by = interface_bytes(fi, 4)
    print(f"  apply_fused_interface: {fi.cls.shape[0]} classes, {fi.num_rows} rows, "
          f"{fi.tap_reads} tap reads, {by} compulsory bytes")
    row = kernel_row(
        "apply_fused_interface", lambda: ik.apply_fused_interface(fi, next(xs), y),
        lambda: ik.apply_fused_interface_reference(fi, next(xs), y),
        lambda: torch.mv(csr_i, next(xs)), by, 2 * fi.tap_reads, copy_gbs, floor_ms,
        plain_launches=10)
    # The stencil SpMV on the lattice's level grids, as the solve runs it.
    for level in op.level_ops:
        ml = level.shape[0]
        xl = itertools.cycle([torch.randn(ml, generator=gen, device="cuda") for _ in range(8)])
        csr_l = stencil_csr(level)
        kernel_row(
            f"stencil_spmv level {'x'.join(map(str, level.grid_shape))}",
            lambda level=level, xl=xl: sk.stencil_spmv(level, next(xl)),
            lambda level=level, xl=xl: sk.stencil_spmv_reference(level, next(xl)),
            lambda csr_l=csr_l, xl=xl: torch.mv(csr_l, next(xl)),
            (8 if level.diag is None else 12) * ml, 2 * len(level.offsets) * ml, copy_gbs,
            floor_ms)
        # The SpMM at b=8, as each matmat of the Arnoldi residual block runs
        # it: X read and Y written, 64 B/pt (and the diag, if any).
        Xl = torch.randn((ml, 8), generator=gen, device="cuda")
        kernel_row(
            f"stencil_spmm b=8 level {'x'.join(map(str, level.grid_shape))}",
            lambda level=level, Xl=Xl: sk.stencil_spmm(level, Xl),
            lambda level=level, Xl=Xl: sk.stencil_spmm_reference(level, Xl),
            lambda csr_l=csr_l, Xl=Xl: torch.sparse.mm(csr_l, Xl),
            (64 if level.diag is None else 68) * ml, 2 * len(level.offsets) * 8 * ml, copy_gbs,
            floor_ms, plain_launches=10)
    # The whole operator against one CSR mv of the whole H.
    rows = host["N=120"][1]
    csr_h = csr_of_rows(rows, idx_map, m)
    x = next(xs)
    got, want = op.matvec(x), torch.mv(csr_h, x)
    check(bool(torch.allclose(got, want, rtol=1e-4, atol=2e-5 * float(want.abs().max()))),
          "CompositeV2 matvec and the CSR of H disagree")
    mv_ms, mv_eager, mv_g, mv_e = device_times(lambda: op.matvec(next(xs)))
    h_ms, h_eager, _, _ = device_times(lambda: torch.mv(csr_h, next(xs)))
    buckets = sum(t.numel() * t.element_size() for b in op.ifc_buckets for t in b)
    mv_bytes = 16 * m + by - 8 * fi.num_rows + buckets  # x, diag, keep read, y written
    mv_bound, mv_by = bound(mv_bytes, 2 * 27 * m)
    print(f"  CompositeV2.matvec graph {mv_ms:.5f} ms, eager {mv_eager:.5f} ms (host-paced) vs "
          f"CSR torch.mv of H ({csr_h.values().numel()} nnz) {h_ms:.5f} ms (eager {h_eager:.5f}); "
          f"bound {mv_bound:.6f} ms ({mv_by}; {mv_bytes} B at 3.35 TB/s, "
          f"{mv_bytes / copy_gbs / 1e6:.6f} ms at the measured copy rate)")
    print(f"    samples matvec graph {fmt(mv_g)} eager {fmt(mv_e)}")
    return row


def lattice_start(op, idx_map, p, seed):
    """Uniform(-1, 1) from a numpy seed in lattice order, scattered into the
    v2 layout: zero on the dead slots (the live mask)."""
    v = np.zeros(op.shape[0])
    v[idx_map] = np.random.default_rng(seed).uniform(-1.0, 1.0, p)
    return v


def check_against(label, vals, resid_rel, ref, eps, norms, solve_tol):
    """Hold each checked pair to the nearest reference eigenvalue within
    its tolerance (irregular_tolerance); the ground state must be checked.
    ``ref`` is a golden JSON (eigenvalues, residuals)."""
    ref_vals, ref_res = np.asarray(ref["eigenvalues"]), np.asarray(ref["residuals"])
    scale = np.maximum(np.abs(vals), 1.0)
    nearest = np.array([int(np.argmin(np.abs(ref_vals - lam))) for lam in vals])
    floor, tol = irregular_tolerance(
        *norms, eps, resid_rel * scale, ref_res[nearest] * np.maximum(np.abs(ref_vals[nearest]), 1.0))
    checked = (resid_rel * scale <= floor) | (resid_rel < solve_tol)
    diff = np.abs(vals - ref_vals[nearest])
    print(f"  {label}: residual floor {floor:.3e} MeV; tolerance per pair below")
    for i in range(len(vals)):
        print(f"    {i:2d} {vals[i]:14.8f} resid {resid_rel[i]:.3e}  nearest ref "
              f"{ref_vals[nearest[i]]:14.8f} |diff| {diff[i]:.3e} tol {tol[i]:.3e} "
              f"{'checked' if checked[i] else '-'}")
    check(checked[0] and nearest[0] == 0 and diff[0] <= tol[0],
          f"{label}: the ground state is not checked or not within {tol[0]:.3e}")
    bad = [i for i in range(len(vals)) if checked[i] and diff[i] > tol[i]]
    check(not bad, f"{label}: checked pairs {bad} are off their reference values")
    return float(diff[checked].max()), int(checked.sum())


def load_golden(n):
    with open(os.path.join(HERE, "lanczos_tpu_torch", "data",
                           f"golden_eigs_irregular_n{n}.json")) as f:
        return json.load(f)


def phase_irregular_golden(lt, ops, host):
    print("== eigs_nonsym at N=60 (k=5, max_basis=120, tol=1e-4, fp32) vs lanczos_tpu fp64 golden")
    golden = load_golden(60)
    c = golden["config"]
    lat = host["N=60"][0]
    check(lat.num_points == golden["num_points"], "N=60 lattice size differs from the golden's")
    op, idx_map = ops[("N=60", torch.float32)]
    v0 = lattice_start(op, idx_map, lat.num_points, c["v0_seed"])
    res = lt.eigs_nonsym(op, k=c["k"], max_basis=c["max_basis"], tol=c["tol"], v0=v0)
    torch.cuda.synchronize()
    print(res.summary())
    vals, resid = res.eigenvalues.cpu().numpy(), res.residuals.cpu().numpy()
    check(np.all(np.isfinite(vals)) and np.all(np.isfinite(resid)), "non-finite N=60 result")
    check_against("N=60 fp32 (port, GPU) vs fp64 (lanczos_tpu, CPU)", vals, resid, golden,
                  EPS32, (golden["norm_inf"], golden["norm_1"]), c["tol"])


def phase_irregular_flagship(lt, host):
    from lanczos_tpu_torch import native
    from lanczos_tpu_torch.ops import interface_kernel as ik
    from lanczos_tpu_torch.ops import stencil_kernels as sk
    from lanczos_tpu_torch.solver import graphs

    print("== irregular flagship: N=120, box depth 3, eigs_nonsym(k=8, max_basis=300, tol=1e-4)")
    # The anchor is the JAX package's fp64 solve of today's operator
    # (make_torch_golden_irregular.py --n 120).  IRREGULAR_r04.json, the
    # reference's own production spectrum, predates a change of the LSQ rows
    # and is printed beside it, not held (PERF.md).
    golden = load_golden(120)
    with open(os.path.join(HERE, "IRREGULAR_r04.json")) as f:
        r04 = json.load(f)
    N, k, basis, tol = 120, 8, 300, 1e-4
    _, _, norms = host["N=120"]
    print(f"  ||H||_inf {norms[0]:.4f}, ||H||_1 {norms[1]:.4f} MeV (golden: "
          f"{golden['norm_inf']:.4f}, {golden['norm_1']:.4f}); anchor "
          f"golden_eigs_irregular_n120.json, {golden['num_points']} points")
    runs = {}
    for dtype in (torch.float32, torch.float64):
        t0 = time.perf_counter()
        lat = lt.build_lattice(N, 25.0, 3, potential=lt.deuteron_potential_3d)
        t_lat = time.perf_counter() - t0
        op, idx_map = lt.assemble_irregular_hamiltonian_composite2(
            lat, lt.deuteron_potential_3d, dtype=dtype, device="cuda")
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0 - t_lat
        check(lat.num_points == golden["num_points"], "N=120 lattice size differs from the golden's")
        print(f"  {str(dtype)[6:]}: host build {t_lat:.2f} s lattice + {t_build:.2f} s "
              f"assembly (neighbor backend: {'native' if native.available() else 'numpy'}); "
              f"M = {op.shape[0]} slots, {lat.num_points} live")
        v0 = lattice_start(op, idx_map, lat.num_points, 99)
        torch.cuda.reset_peak_memory_stats()
        ik.apply_fused_interface.launches = 0
        sk.stencil_spmv.launches = 0
        sk.stencil_spmm.launches = 0
        graphs.reset_stats()
        t0 = time.perf_counter()
        res = lt.eigs_nonsym(op, k=k, max_basis=basis, tol=tol, v0=v0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = (ik.apply_fused_interface.launches, sk.stencil_spmv.launches,
                    sk.stencil_spmm.launches)
        peak = torch.cuda.max_memory_allocated()
        st = graphs.stats
        print(f"  {str(dtype)[6:]}: wall {wall:.3f} s, peak device memory {peak / 2**30:.3f} GiB, "
              f"launches apply_fused_interface {launches[0]} stencil_spmv {launches[1]} "
              f"stencil_spmm {launches[2]} (graph replays included); {len(st['cycles'])} "
              f"cycles, graphs captured {st['captures']}, replays {st['replays']}")
        print(res.summary(print_nr=k))
        vals, resid = res.eigenvalues.cpu().numpy(), res.residuals.cpu().numpy()
        check(tuple(res.eigenvectors.shape) == (op.shape[0], k), "irregular flagship shapes")
        for name, t in (("eigenvalues", res.eigenvalues), ("eigenvectors", res.eigenvectors),
                        ("residuals", res.residuals), ("inner_prod", res.inner_prod)):
            check(bool(torch.isfinite(t).all()), f"irregular flagship {dtype}: non-finite {name}")
        check(min(launches) > 0, f"a kernel of the irregular path was not launched: {launches}")
        check(float((res.eigenvectors * (1 - op.live)[:, None]).abs().max()) == 0.0,
              "eigenvectors are not zero on the dead slots")
        worst, n_checked = check_against(
            f"N=120 {str(dtype)[6:]} (port, GPU) vs lanczos_tpu fp64 (CPU)", vals, resid,
            golden, float(torch.finfo(dtype).eps), norms, tol)
        print(f"  vs IRREGULAR_r04.json (not held): |diff| "
              f"{np.abs(vals - np.asarray(r04['eigenvalues'])).round(9).tolist()}")
        runs[dtype] = dict(wall=wall, peak=peak, launches=launches, worst=worst,
                           checked=n_checked)
        del op, res
        torch.cuda.empty_cache()
    return runs[torch.float32]


def solve_record(lt, op, v0, **kw):
    """eigs_nonsym(op, v0=v0, **kw) with its wall, peak device memory, the
    host copy of every cycle's Rayleigh quotient B[:m, :m] (a spy on the
    Schur step), the graph counts of the solve and its cycles' clock
    (cycle_clock; the device synchronized around each cycle)."""
    import importlib

    from lanczos_tpu_torch.solver import graphs

    # The module, not the function that lanczos_tpu_torch.solver exports
    # under the same name.
    arnoldi = importlib.import_module("lanczos_tpu_torch.solver.arnoldi")
    quotients = []
    schur = arnoldi._schur_sort_select

    def spy(Bm, which, k):
        quotients.append(Bm.copy())
        return schur(Bm, which, k)

    graphs.reset_stats()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    arnoldi._schur_sort_select = spy
    try:
        with cycle_clock() as marks:
            t0 = time.perf_counter()
            res = lt.eigs_nonsym(op, v0=v0, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        arnoldi._schur_sort_select = schur
    return dict(res=res, wall=wall, peak=torch.cuda.max_memory_allocated(), B=quotients,
                stats=graph_stats(), marks=marks)


def graph_stats():
    """A copy of ``graphs.stats`` that later cycles leave as it is."""
    from lanczos_tpu_torch.solver import graphs

    return dict(graphs.stats, cycles=list(graphs.stats["cycles"]))


def graph_stats_since(before):
    """What was added to ``graphs.stats`` since ``before`` (graph_stats())."""
    now = graph_stats()
    return dict({k: now[k] - before[k] for k in ("eager", "captures", "capture_s", "replays")},
                cycles=now["cycles"][len(before["cycles"]):])


def hold_unit_replays(label, st):
    """Print a refinement's unit calls by key and its graph counts, and fail
    unless every call after the first of its key replayed a graph (the
    refinement's CycleGraphs runs each key's first call eagerly and
    captures its second)."""
    keys = collections.Counter(st["cycles"])
    want = (len(keys), sum(n > 1 for n in keys.values()), sum(n - 1 for n in keys.values()))
    got = (st["eager"], st["captures"], st["replays"])
    calls = ", ".join(f"{' '.join(map(str, key))}: {n}" for key, n in keys.items())
    print(f"  {label}: {len(st['cycles'])} unit calls ({calls}); eager {got[0]}, graphs captured "
          f"{got[1]} in {st['capture_s']:.3f} s, replays {got[2]}")
    check(got == want, f"{label}: not every unit call after the first of its key replayed a "
          f"graph: (eager, captures, replays) {got}, owed {want}")


def same_arrays(pairs):
    """(all bitwise equal, largest |diff|) over (a, b) pairs of arrays or tensors."""
    pairs = [tuple(np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t) for t in p)
             for p in pairs]
    return (all(np.array_equal(a, b) for a, b in pairs),
            max(float(np.abs(a.astype(np.float64) - b).max()) for a, b in pairs))


def max_diff(a, b):
    """Largest |a - b| over the cycles both runs have, and whether they had
    as many."""
    n = min(len(a), len(b))
    return max((float(np.abs(x - y).max()) for x, y in zip(a[:n], b[:n])), default=0.0), \
        len(a) == len(b)


def phase_graph_cycles(lt, host):
    """Phase 25: the N=120 CompositeV2 solve of phase 9 through the captured
    cycles and through the eager body (``graphs.eager()``) from the same
    v0, fp32 and fp64: walls, device busy shares of a whole solve and of
    one cycle, captures, replays, peak memory, the largest |diff| of the
    eigenvalues and of every cycle's B between the two (and between two
    runs of each); the interface kernel's device time a launch inside a
    replayed cycle; a weight change between two solves."""
    from lanczos_tpu_torch.solver import graphs

    print("== captured restart cycles: N=120 eigs_nonsym(k=8, max_basis=300, tol=1e-4) on the "
          f"CompositeV2, captured against eager, on {card_label()}")
    golden = load_golden(120)
    lat, _, norms = host["N=120"]
    kw = dict(k=8, max_basis=300, tol=1e-4)
    kernels = ("interface_kernel", "spmv_kernel")
    out = {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype)[6:]
        eps = float(torch.finfo(dtype).eps)
        op, idx_map = lt.assemble_irregular_hamiltonian_composite2(
            lat, lt.deuteron_potential_3d, dtype=dtype, device="cuda")
        v0 = lattice_start(op, idx_map, lat.num_points, 99)
        runs = {"captured": [], "eager": []}
        for mode in ("captured", "eager", "eager", "captured"):
            with graphs.eager() if mode == "eager" else contextlib.nullcontext():
                runs[mode].append(solve_record(lt, op, v0, **kw))
        cycle_s = {}
        for mode, rs in runs.items():
            st = rs[0]["stats"]
            walls = ", ".join(f"{r['wall']:.3f}" for r in rs)
            marks = [m for r in rs for m in r["marks"]]
            clock = "; ".join(f"{k} {', '.join(f'{e - s:.3f}' for kk, s, e in marks if kk == k)}"
                              for k in ("eager", "capture", "replay", "plain")
                              if any(kk == k for kk, _, _ in marks))
            kind = "replay" if mode == "captured" else "plain"
            cycle_s[mode] = [cycle_walls(r["marks"], kind) for r in rs]
            print(f"  {name} {mode}: walls {walls} s, {len(st['cycles'])} cycles "
                  f"(l = {[c[1] for c in st['cycles']]}), graphs captured {st['captures']} in "
                  f"{st['capture_s']:.3f} s, replays {st['replays']}, peak device memory "
                  f"{max(r['peak'] for r in rs) / 2**30:.3f} GiB; cycle walls (s) {clock}")
        for r in runs["captured"]:
            st = r["stats"]
            distinct = len(set(st["cycles"]))
            check(st["captures"] <= distinct,
                  f"{name}: {st['captures']} graphs captured for {distinct} distinct (l, m)")
            check(st["captures"] == len(set(st["cycles"][1:]))
                  and st["replays"] == len(st["cycles"]) - 1 and st["eager"] == 1,
                  f"{name}: not every cycle after the first was a replay: {st}")
        for r in runs["eager"]:
            check(r["stats"]["captures"] == r["stats"]["replays"] == 0,
                  f"{name}: the eager solve captured or replayed a graph")
        diffs = {}
        for label, a, b in (("captured - eager", runs["captured"][0], runs["eager"][0]),
                            ("eager - eager", runs["eager"][0], runs["eager"][1]),
                            ("captured - captured", runs["captured"][0], runs["captured"][1])):
            d_val = float(np.abs(a["res"].eigenvalues.cpu().numpy()
                                 - b["res"].eigenvalues.cpu().numpy()).max())
            d_b, same = max_diff(a["B"], b["B"])
            diffs[label] = dict(eigenvalues=d_val, B=d_b, same_cycles=same)
            print(f"  {name} {label}: max |diff| eigenvalues {d_val:.3e}, B {d_b:.3e} over "
                  f"{min(len(a['B']), len(b['B']))} cycles{'' if same else ' (cycle counts differ)'}")
        res = runs["captured"][0]["res"]
        check(bool(torch.isfinite(res.eigenvectors).all()), f"{name}: non-finite eigenvectors")
        check_against(f"N=120 {name} captured vs lanczos_tpu fp64", res.eigenvalues.cpu().numpy(),
                      res.residuals.cpu().numpy(), golden, eps, norms, kw["tol"])

        busy = {}
        for mode in ("captured", "eager"):
            with graphs.eager() if mode == "eager" else contextlib.nullcontext():
                pwall, dev = busy_share(lambda: lt.eigs_nonsym(op, v0=v0, **kw))
                cyc_dev, per_kernel = cycle_profile(
                    lambda c: lt.eigs_nonsym(op, v0=v0, max_cycles=c, **kw), kernels)
            cyc_wall = float(np.median([o for _, o in cycle_s[mode] if o is not None]))
            busy[mode] = dict(solve_profiled_wall_s=pwall, solve_device_busy_s=dev,
                              cycle_wall_s=cyc_wall, cycle_device_busy_s=cyc_dev,
                              cycle_kernels=per_kernel)
            per = ", ".join(f"{k} {n} launches, {t * 1e6 / max(n, 1):.2f} us each"
                            for k, (n, t) in per_kernel.items())
            print(f"  {name} {mode}: whole solve under the profiler {pwall:.3f} s, device busy "
                  f"{dev:.3f} s ({dev / pwall:.1%}); one cycle after the first "
                  f"{'replayed ' if mode == 'captured' else ''}(with the host work to the next) "
                  f"{cyc_wall:.3f} s unprofiled, its device time {cyc_dev:.3f} s "
                  f"({cyc_dev / cyc_wall:.1%}); in the third cycle {per}")
        out[name] = dict(walls={m: [r["wall"] for r in rs] for m, rs in runs.items()},
                         peak_gib={m: max(r["peak"] for r in rs) / 2**30
                                   for m, rs in runs.items()},
                         stats={k: v for k, v in runs["captured"][0]["stats"].items()
                                if k != "cycles"},
                         cycles=len(runs["captured"][0]["stats"]["cycles"]), diffs=diffs,
                         busy=busy)
        if dtype == torch.float32:
            out[name]["weight_change"] = weight_change(lt, op, v0, kw, runs, norms)
        del op, runs
        torch.cuda.empty_cache()
    print(f"  record: {json.dumps(out)}")
    return out


def weight_change(lt, op, v0, kw, runs, norms):
    """Scale one level stencil's weights in place between two solves: the
    captured solve of the changed operator is held to its eager solve and
    must have left the old spectrum; then one CycleGraphs across a change,
    as within a solver call, must run an eager cycle and capture anew."""
    from lanczos_tpu_torch.solver import graphs

    dtype = op.dtype
    name, eps = str(dtype)[6:], float(torch.finfo(dtype).eps)
    # A weight change between two solves: a new capture, held to the
    # eager solve of the changed operator and away from the old values.
    scale = 1.01
    level = op.level_ops[0]
    level.weights.mul_(scale)
    changed = solve_record(lt, op, v0, **kw)
    with graphs.eager():
        ref = solve_record(lt, op, v0, **kw)
    new_vals = changed["res"].eigenvalues.cpu().numpy()
    ref_gold = dict(eigenvalues=ref["res"].eigenvalues.cpu().numpy().tolist(),
                    residuals=ref["res"].residuals.cpu().numpy().tolist())
    worst, _ = check_against(
        f"N=120 {name}, level 0 weights x{scale}: captured vs eager", new_vals,
        changed["res"].residuals.cpu().numpy(), ref_gold, eps,
        tuple(scale * n for n in norms), kw["tol"])
    moved = abs(float(new_vals[0]) - float(runs["eager"][0]["res"].eigenvalues[0]))
    print(f"  {name} after the weight change: captures {changed['stats']['captures']}, "
          f"replays {changed['stats']['replays']}; ground state moved {moved:.4e} MeV; "
          f"captured - eager {worst:.3e}")
    check(changed["stats"]["captures"] >= 1, "no capture after the weight change")
    check(moved > 100 * worst, "the solve after the weight change kept the old spectrum")
    # One CycleGraphs across the change, as within a solver call.
    x = torch.as_tensor(v0, dtype=dtype, device="cuda")
    y = torch.empty_like(x)

    def body(x, y):
        y.copy_(op.matvec(x))
        return y

    graphs.reset_stats()
    cg = graphs.CycleGraphs(op)
    got = []
    for factor in (1.0, 1.0, 1.0, 1.0 / scale, 1.0, 1.0):
        if factor != 1.0:
            level.weights.mul_(factor)
        got.append((cg.run(("matvec",), body, x, y).clone(), op.matvec(x)))
    st = graphs.stats
    d = max(float((a - b).abs().max()) for a, b in got)
    print(f"  one CycleGraphs across a weight change: eager {st['eager']}, captures "
          f"{st['captures']}, replays {st['replays']}; max |replay - eager matvec| {d:.3e}")
    check((st["eager"], st["captures"], st["replays"]) == (2, 2, 4),
          f"a weight change did not force an eager cycle and a new capture: {st}")
    # The ELL tail's index_add_ sums in an order that changes from run to
    # run; a replay of the old weights would be off by the 1% change.
    check(d <= 2e-5 * float(got[-1][1].abs().max()),
          "a replay after a weight change is off the changed operator's matvec")
    return dict(ground_state_moved=moved, captured_minus_eager=worst, replay_max_abs=d)


def phase_two_sided(lt, ops, host):
    from lanczos_tpu_torch.ops import interface_kernel as ik

    print("== two_sided_lanczos at N=60, fp64, n=250, on the CompositeV2 and its transpose")
    golden = load_golden(60)
    lat = host["N=60"][0]
    op, idx_map = ops[("N=60", torch.float64)]
    p = lat.num_points
    ik.apply_fused_interface.launches = 0
    t0 = time.perf_counter()
    fac = lt.two_sided_lanczos(
        op, 250, v0=lattice_start(op, idx_map, p, 99), w0=lattice_start(op, idx_map, p, 100),
        op_transpose=op.transpose())
    res = lt.two_sided_eigs(fac, k=5, op=op, residual_tol=1e-6)
    torch.cuda.synchronize()
    launches = ik.apply_fused_interface.launches
    print(f"  {time.perf_counter() - t0:.3f} s, breakdown at {int(fac.breakdown_iter)}/250, "
          f"max biorth drift {float(fac.biorth_drift.max()):.2e}, "
          f"apply_fused_interface launches {launches} (A and A^T)")
    print(res.summary())
    check(launches >= 2 * 249, f"interface kernel launched {launches} times in 250 two-sided steps")
    hold_fp64_pairs("two-sided", res, golden)


def hold_fp64_pairs(label, res, golden, residual_tol=1e-6):
    """Hold an fp64 solve's pairs (true residual < residual_tol) to the
    N=60 golden: the ground state within 3e-5 and every pair in the
    golden's range within 3e-5 max(1, |lam|) of its nearest golden value."""
    check(res.k >= 1, f"{label}: no pair with true residual < {residual_tol:g}")
    vals = res.eigenvalues.cpu().numpy()
    # fp64, residual < 1e-6: eigenvalue error <= kappa * 1e-6 * max(|lam|, 1)
    # (the measured errors are ~1e-9 at residuals up to 1e-5).
    # Pairs above the golden's range are printed, not held: the golden
    # holds the five lowest eigenvalues only.
    ref = np.asarray(golden["eigenvalues"])
    worst = 0.0
    for lam, r in zip(vals, res.residuals.cpu().numpy()):
        d = float(np.min(np.abs(ref - lam)))
        held = lam <= ref.max() + 1e-3
        if held:
            worst = max(worst, d)
        print(f"    {lam:14.8f} resid {r:.3e} |diff| to nearest golden {d:.3e} "
              f"{'checked' if held else '- (above the golden range)'}")
    check(abs(vals[0] - ref[0]) <= 3e-5, f"{label}: ground state off the golden value")
    check(worst <= 3e-5 * max(1.0, float(np.abs(ref).max())), f"{label} pair {worst:.3e} off")


# ---------------------------------------------------------------------------
# The north-star path: compensated reductions, thick restart, refinement


#: The north-star pipeline's lattice in phase 15 (reduced from the
#: north star's 432: its host build alone takes ~5 min there).
NORTHSTAR_N_FINE = 216


def _wrappers():
    from lanczos_tpu_torch.ops import interface_kernel as ik
    from lanczos_tpu_torch.ops import stencil_kernels as sk

    return {"stencil_spmv": sk.stencil_spmv, "stencil_spmm": sk.stencil_spmm,
            "apply_fused_interface": ik.apply_fused_interface}


def reset_launches():
    for w in _wrappers().values():
        w.launches = 0
        for dt in w.launches_by_dtype:
            w.launches_by_dtype[dt] = 0


def read_launches():
    """{kernel: {"total": n, "float32": n, "float64": n}}."""
    return {name: {"total": w.launches,
                   **{str(dt)[6:]: n for dt, n in w.launches_by_dtype.items()}}
            for name, w in _wrappers().items()}


def ulps32(a, b):
    a, b = np.float32(a), np.float32(b)
    return abs(int(a.view(np.int32)) - int(b.view(np.int32)))


def phase_compensated_dots():
    from lanczos_tpu_torch.ops.compensated import dot2_rounded, norm2

    print("== compensated reductions at M = 160^3 on the card vs the CPU (fp32 ulps)")
    rng = np.random.default_rng(11)
    m = 160**3
    a = rng.standard_normal(m).astype(np.float32)
    b = rng.standard_normal(m).astype(np.float32)
    cases = {"random": (a, b),
             # the products cancel in pairs but for a 2^-20 relative part
             "cancelling": (np.concatenate([a[: m // 2], a[: m // 2]]) * np.float32(1e4),
                            np.concatenate([b[: m // 2], -b[: m // 2] * np.float32(1 + 2**-20)]))}
    for name, (x, y) in cases.items():
        xc, yc = torch.from_numpy(x), torch.from_numpy(y)
        xg, yg = xc.cuda(), yc.cuda()
        d_cpu, d_gpu = float(dot2_rounded(xc, yc)), float(dot2_rounded(xg, yg))
        n_cpu = sum(float(t) for t in norm2(xc))
        n_gpu = sum(float(t) for t in norm2(xg))
        exact = float(np.dot(x.astype(np.float64), y.astype(np.float64)))
        print(f"  {name:10s} dot2_rounded gpu {d_gpu:.9e} cpu {d_cpu:.9e} ({ulps32(d_gpu, d_cpu)} ulp; "
              f"float64 dot {exact:.9e}); norm2 gpu {n_gpu:.9e} cpu {n_cpu:.9e} "
              f"({ulps32(n_gpu, n_cpu)} ulp)")
        check(ulps32(d_gpu, d_cpu) <= 1, f"dot2_rounded ({name}) differs from the CPU by > 1 ulp")
        check(ulps32(n_gpu, n_cpu) <= 1, f"norm2 ({name}) differs from the CPU by > 1 ulp")


def phase_restarted_flagship(lt, flagship):
    """eigsh_restarted(k=20, compensated) fp32 on N=160^3 against the fp64
    operator (a Rayleigh-Ritz bound on its block), the same solve in fp64
    and phase 5's fp64 eigsh."""
    print("== eigsh_restarted at N=160^3 (27-point, fp32, k=20, compensated, default basis 70) "
          "vs the fp64 operator, eigsh_restarted in fp64 and the fp64 eigsh(n=400)")
    N, k = 160, 20
    v0 = np.random.default_rng(99).uniform(-1.0, 1.0, N**3)
    H = lt.build_regular_hamiltonian(N, 25.0, lt.deuteron_potential_3d, stencil="27",
                                     dtype=torch.float32, device="cuda")
    tol = fp32_tolerance(H)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    res = lt.eigsh_restarted(H, k=k, compensated=True, v0=v0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    print(f"  wall {wall:.3f} s, {res.cycles} cycles, peak device memory {peak / 2**30:.2f} GiB "
          f"(eigsh n=400 fp32: {flagship[torch.float32]['peak'] / 2**30:.2f} GiB), launches "
          f"{ {n: c['total'] for n, c in launches.items()} }")
    print(res.summary(print_nr=k))
    vals = res.eigenvalues.double().cpu().numpy()
    resid = res.residuals.double().cpu().numpy()
    X = res.eigenvectors.double()
    check(bool(torch.isfinite(res.eigenvalues).all() and torch.isfinite(res.eigenvectors).all()),
          "eigsh_restarted: non-finite result")
    check(launches["stencil_spmv"]["total"] > 0, "eigsh_restarted ran no SpMV launch")
    del H, res
    torch.cuda.empty_cache()
    # The true residuals are measured in fp32: A x carries the rounding of
    # its 27-term rows, at most gamma_27 || |H| || <= 13.5 eps32 ||H||_G, and
    # the fp32 rounding of x itself moves A x by up to eps32/2 ||H||.
    print(f"  true residuals (fp32): max {resid.max():.3e} MeV = {resid.max() / tol:.2f} "
          f"eps32 ||H||_G (gate 14)")
    check(resid.max() <= 14 * tol, f"eigsh_restarted: a true residual {resid.max():.3e} > "
                                   f"14 eps32 ||H||_G = {14 * tol:.3e}")

    # The block against the fp64 operator.  Kahan's theorem: for Q with
    # orthonormal columns, the eigenvalues theta' of Q^T H Q lie, with
    # their multiplicity, within rho = ||H Q - Q (Q^T H Q)||_2 of k
    # eigenvalues of H.  A ghost (a second copy of one vector) would leave
    # X^T X singular.
    H = lt.build_regular_hamiltonian(N, 25.0, lt.deuteron_potential_3d, stencil="27",
                                     dtype=torch.float64, device="cuda")
    gram_dev = float(torch.linalg.matrix_norm(X.T @ X - torch.eye(k, dtype=X.dtype,
                                                                  device=X.device), ord=2))
    Q = torch.linalg.qr(X).Q
    del X
    W = H.matmat(Q)
    theta_rr, Y = np.linalg.eigh(to_host_sym(Q.T @ W))
    Yd = torch.as_tensor(Y, device="cuda")
    R = W @ Yd - (Q @ Yd) * torch.as_tensor(theta_rr, device="cuda")[None, :]
    rho = float(np.sqrt(np.linalg.eigvalsh((R.T @ R).cpu().numpy()).max()))
    del Q, W, Yd, R
    torch.cuda.empty_cache()
    print(f"  the block in fp64: ||X^T X - I||_2 {gram_dev:.3e} (<= 1e-3); Rayleigh-Ritz on "
          f"the fp64 H: rho {rho:.3e} MeV = {rho / tol:.2f} eps32 ||H||_G (gate 14), "
          f"max |theta' - theta| {np.abs(theta_rr - np.sort(vals)).max():.3e} MeV")
    check(gram_dev <= 1e-3, f"the restarted block is not orthonormal: {gram_dev:.3e}")
    check(rho <= 14 * tol, f"the restarted block's fp64 residual {rho:.3e} > 14 eps32 ||H||_G")

    # The converged fp64 reference: its residuals bound its own eigenvalue
    # error by a tenth of the tolerance.
    t0 = time.perf_counter()
    ref = lt.eigsh_restarted(H, k=k, v0=v0, max_cycles=400)
    torch.cuda.synchronize()
    ref_vals = ref.eigenvalues.double().cpu().numpy()
    ref_res = ref.residuals.double().cpu().numpy()
    print(f"  fp64 eigsh_restarted: wall {time.perf_counter() - t0:.3f} s, {ref.cycles} cycles, "
          f"true residual max {ref_res.max():.3e} MeV (<= tol / 10 = {tol / 10:.3e})")
    check(ref_res.max() <= tol / 10, "the fp64 eigsh_restarted reference did not converge")
    del H, ref
    torch.cuda.empty_cache()
    # In fp64 a single-vector Krylov space all but misses the second and
    # third copies of a multiplet, which fp32 rounding feeds into the
    # fp32 solve: the values pair by nearest, each way, and the counts are
    # the Rayleigh-Ritz bound's.
    a, b = np.sort(vals), np.sort(ref_vals)
    d_ab, d_ba = nearest_each_way(a, b, tol)
    print(f"  fp32 value, theta' (fp64 Rayleigh-Ritz), nearest fp64 eigsh_restarted value "
          f"(tolerance eps32 ||H||_G = {tol:.3e} MeV):")
    for i in range(k):
        j = int(np.argmin(np.abs(b - a[i])))
        print(f"    {i:2d} {a[i]:14.8f} {theta_rr[i]:14.8f} {b[j]:14.8f} |diff| {d_ab[i]:.3e} "
              f"{'ok' if d_ab[i] <= tol else 'MISMATCH'}")
    print(f"  fp64 values not reached by the fp32 block: "
          f"{np.round(b[b > a[-1] + tol], 8).tolist()}")
    check(d_ab.max() <= tol, f"an fp32 value is {d_ab.max():.3e} off every fp64 value")
    check(d_ba.max() <= tol, f"an fp64 value is {d_ba.max():.3e} off every fp32 value")

    # Phase 5's eigsh(n=400) also keeps one copy of each multiplet, and
    # reports a few Ritz values that mix neighbouring clusters (its
    # acceptance test passes them).  Each of its values in the restarted
    # range whose residual is within the tolerance is an eigenvalue within
    # that much: the restarted solve holds one.
    eig = flagship[torch.float64]
    eig_res = eig["res"].residuals.double().cpu().numpy()
    print(f"  eigsh(n=400) fp64 values with residual <= {tol:.3e} MeV, nearest restarted value:")
    for lam, r in zip(eig["vals"], eig_res):
        if r <= tol and lam <= a[-1] + tol:
            d = float(np.abs(vals - lam).min())
            print(f"    {lam:14.8f} resid {r:.3e}  |diff| {d:.3e} {'ok' if d <= tol else 'MISSING'}")
            check(d <= tol, f"eigsh_restarted holds no eigenvalue within {tol:.3e} of {lam:.8f}")
    return dict(vals=vals, ref_vals=ref_vals, tol=tol)


def nearest_each_way(a, b, tol):
    """(distance of each a to the nearest b, distance of each b up to
    max(a) + tol to the nearest a), for sorted value lists."""
    d_ab = np.abs(a[:, None] - b[None, :]).min(axis=1)
    below = b[b <= a[-1] + tol]
    return d_ab, np.abs(below[:, None] - a[None, :]).min(axis=1)


def to_host_sym(S):
    """A small symmetric device matrix on the host in fp64, symmetrized."""
    S = S.double().cpu().numpy()
    return (S + S.T) / 2


def phase_checkpoint(lt):
    import tempfile

    print("== checkpoint at N=64 (fp32, k=8, compensated): stop after 2 cycles, resume from "
          "the file, vs an uninterrupted run")
    H = lt.build_regular_hamiltonian(64, 25.0, lt.deuteron_potential_3d, stencil="27",
                                     dtype=torch.float32, device="cuda")
    v0 = np.random.default_rng(7).uniform(-1.0, 1.0, 64**3)
    kw = dict(k=8, compensated=True, v0=v0)
    straight = lt.eigsh_restarted(H, **kw)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "restart.npz")
        first = lt.eigsh_restarted(H, max_cycles=2, checkpoint_path=path, **kw)
        resumed = lt.eigsh_restarted(H, checkpoint_path=path, **kw)
    a = straight.eigenvalues.double().cpu().numpy()
    b = resumed.eigenvalues.double().cpu().numpy()
    rel = np.abs(a - b) / np.abs(a)
    print(f"  uninterrupted: {straight.cycles} cycles; interrupted after {first.cycles}, "
          f"resumed to {resumed.cycles}; max relative eigenvalue difference {rel.max():.3e} "
          "(tolerance 1e-6)")
    print(f"    uninterrupted {np.round(a, 8).tolist()}")
    print(f"    resumed       {np.round(b, 8).tolist()}")
    check(first.cycles == 2 and rel.max() <= 1e-6, "resumed run disagrees with the uninterrupted one")


def _northstar():
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import northstar_torch

    return northstar_torch


def phase_northstar_small(mesh=None, ref=None, unsharded=None):
    """Phase 14 (and, with ``mesh``, phase 22's sharded solve, held against
    its eager cycles and beside ``unsharded``, phase 14's record): returns
    (max abs error per kernel, the scipy reference values, launches, the
    pipeline's record)."""
    import scipy.sparse
    import scipy.sparse.linalg

    from lanczos_tpu_torch.solver import graphs, refine, restart

    print(f"== north-star pipeline at n_fine=72 (k=100 + 10, fp32 tol 3e-7, refinement tol "
          f"1e-8{'; the fp32 solve row-sharded over ' + repr(mesh) if mesh else ''}) vs scipy "
          "eigsh(L + I, k=110, 'SA', tol=1e-12)")
    reset_launches()
    graphs.reset_stats()
    # The fp32 solve's eigenvalues, graph counts and cycle marks (the
    # refinement's units follow them in graphs.stats and the marks), and
    # the refinement's start, result, wall and graph counts, kept for the
    # comparisons with eager runs (the pipeline keeps only the refined
    # pairs).
    solved, refined = [], []
    solver, refiner = restart.eigsh_restarted, refine.refine_eigenpairs_dd_hosted

    def keep(*args, **kw):
        res = solver(*args, **kw)
        solved.append((res.eigenvalues.cpu().numpy(), graph_stats(), len(marks)))
        return res

    def keep_refined(op, lam, X64, **kw):
        start, before = (np.array(lam, np.float64), np.array(X64, np.float64)), graph_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = refiner(op, lam, X64, **kw)
        torch.cuda.synchronize()
        refined.append(dict(op=op, start=start, kw=kw, out=out, wall=time.perf_counter() - t0,
                            stats=graph_stats_since(before)))
        return out

    restart.eigsh_restarted, refine.refine_eigenpairs_dd_hosted = keep, keep_refined
    try:
        with cycle_clock() as marks:
            t0 = time.perf_counter()
            info, extra = _northstar().run(n_fine=72, device="cuda", verbose=False, mesh=mesh)
            wall = time.perf_counter() - t0
    finally:
        restart.eigsh_restarted, refine.refine_eigenpairs_dd_hosted = solver, refiner
    launches = read_launches()
    solved_vals, st, n_marks = solved[0]
    marks = marks[:n_marks]
    info["graphs"] = {key: st[key] for key in ("eager", "captures", "capture_s", "replays")}
    _, info["cycle_wall_s"] = cycle_walls(marks, "replay")
    print(f"  {info['num_points']} points, M = {info['m_operator']}, {info['n_interface_classes']} "
          f"interface classes; wall {wall:.2f} s (fp32 solve {info['t_solve_fp32_s']:.2f} s, "
          f"{info['cycles']} cycles: eager {st['eager']}, graphs captured {st['captures']} in "
          f"{st['capture_s']:.3f} s, replays {st['replays']}; refinement "
          f"{info['t_refine_s']:.2f} s)")
    check(st["eager"] == 1 and st["replays"] == len(st["cycles"]) - 1,
          f"n_fine=72{' sharded' if mesh else ''}: not every cycle after the first replayed: {st}")
    hold_unit_replays(f"n_fine=72 refinement{' (after the sharded solve)' if mesh else ''}",
                      refined[0]["stats"])
    if mesh is None:
        info["refine_graphs"] = refine_against_eager(refined[0], refiner)
    check(info["refine_completed"], f"n_fine=72 refinement failed: {info.get('refine_error')}")
    L = extra["L"]
    t0 = time.perf_counter()
    if ref is None:
        ref = np.sort(scipy.sparse.linalg.eigsh(L + scipy.sparse.identity(L.shape[0]), k=110,
                                                which="SA", tol=1e-12)[0])[:100] - 1.0
    lam, rel = extra["lam"], extra["rel_shifted"]
    diff = np.abs(np.sort(lam) - ref)
    print(f"  scipy eigsh {time.perf_counter() - t0:.2f} s; max |lambda - scipy| {diff.max():.3e} "
          f"(atol 1e-8); true residual / |lambda + 1|: max {rel.max():.3e} (<= 3e-8), "
          f"median {np.median(rel):.3e}")
    print(f"    lowest eigenvalues {np.round(np.sort(lam)[:8], 10).tolist()}")
    check(diff.max() <= 1e-8, f"n_fine=72: eigenvalues off scipy by {diff.max():.3e}")
    check(rel.max() <= 3e-8, f"n_fine=72: true residual {rel.max():.3e} > 3e-8")
    if mesh is not None:
        # The sharded fp32 solve's own launches (the refinement runs whole).
        launches = {name: {"total": sum(by_dt.values()), **by_dt}
                    for name, by_dt in info["launches_solve"].items()}
        print(f"  launches in the sharded fp32 solve {json.dumps(launches)}")
        # This operator's interface rows all take the ELL tail (0 classes):
        # the sharded interface kernel is held on the n_fine=216 and N=120
        # operators instead.
        check(launches["stencil_spmv"]["float32"] > 0, "sharded n_fine=72: no SpMV launch")
        from lanczos_tpu_torch.ops.dd import to_float64
        from lanczos_tpu_torch.parallel import shard_operator

        gen = torch.Generator(device="cuda").manual_seed(14)
        worst = max(hold_sharded_levels(shard_operator(o, mesh), "n_fine=72", gen)
                    for o in (extra["op"], to_float64(extra["op"])))
        info["against_eager"] = sharded_n72_against_eager(
            mesh, info, extra, (info["t_solve_fp32_s"], st, marks, solved_vals), unsharded)
        return {"stencil_spmv": worst}, ref, launches, info
    return check_operator_kernels(extra["op"], "n_fine=72"), ref, launches, info


def refine_against_eager(captured, refiner):
    """Phase 14's refinement (``captured``: its start, arguments, result,
    wall and graph counts, kept as the pipeline ran it) again under
    ``graphs.eager()`` from the same float32 pairs: the refined
    eigenvalues, relative residuals and vectors must be bitwise equal."""
    from lanczos_tpu_torch.solver import graphs

    lam0, X0 = captured["start"]
    with graphs.eager():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager = refiner(captured["op"], lam0.copy(), X0.copy(), **captured["kw"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    lam, X, rel = captured["out"]
    same, diff = same_arrays([(lam, eager[0]), (rel, eager[2]), (X, eager[1])])
    st = captured["stats"]
    print(f"  n_fine=72 refinement: captured {captured['wall']:.3f} s (graphs captured "
          f"{st['captures']} in {st['capture_s']:.3f} s, replays {st['replays']}), eager "
          f"{wall:.3f} s; captured - eager: eigenvalues, relative residuals and vectors "
          f"{'bitwise equal' if same else f'differ by up to {diff:.3e}'}")
    check(same, "n_fine=72: the captured refinement differs from the eager one")
    return dict(captured_s=captured["wall"], eager_s=wall, bitwise_equal=same,
                **{k: st[k] for k in ("eager", "captures", "capture_s", "replays")})


def sharded_n72_against_eager(mesh, info, extra, captured, unsharded):
    """The pipeline's sharded fp32 solve (``captured``) against the same
    solve with eager cycles, beside phase 14's unsharded solve."""
    from lanczos_tpu_torch.parallel import shard_operator
    from lanczos_tpu_torch.solver.restart import eigsh_restarted

    op = shard_operator(extra["op"], mesh)
    v0 = np.zeros(extra["op"].shape[0], dtype=np.float32)
    v0[extra["idx_map"]] = np.random.default_rng(99).uniform(-1, 1, size=info["num_points"])
    kw = dict(k=info["k"] + info["k_buffer"], tol=3e-7, which="SA", v0=op.host.to_sharded(v0),
              compensated=True, max_basis=info["max_basis"], n_locked=info["n_locked"],
              rr_verify=False)
    out = captured_against_eager(
        "sharded n_fine=72 fp32 eigsh_restarted",
        lambda c: eigsh_restarted(op, max_cycles=c or 400, **kw).eigenvalues.cpu().numpy(),
        {"captured": captured})
    d = float(np.abs(out.pop("captured_result") - out.pop("eager_result")).max())
    ratio = out["captured"]["wall_s"] / unsharded["t_solve_fp32_s"]
    print(f"  sharded n_fine=72: captured - eager eigenvalues max |diff| {d:.3e}; captured "
          f"{out['captured']['wall_s']:.3f} s against the unsharded captured solve (phase 14) "
          f"{unsharded['t_solve_fp32_s']:.3f} s ({ratio:.2f}x; a cycle there "
          f"{unsharded['cycle_wall_s']:.3f} s)")
    out.update(eigenvalues_max_diff=d, unsharded_solve_s=unsharded["t_solve_fp32_s"],
               unsharded_cycle_wall_s=unsharded["cycle_wall_s"])
    return out


def captured_against_eager(label, solve, timed=None):
    """A solve on a row-sharded operator with its cycles captured and eager
    (``graphs.eager()``): walls, graph counts, the wall of a cycle after the
    first with the host work up to the next (cycle_clock) and that cycle's
    device time (cycle_profile), so its busy share.  ``solve(max_cycles)``
    runs the solve (``None``: to the end) and returns its eigenvalues;
    ``timed`` maps a mode to (wall, graph stats, cycle marks, eigenvalues)
    of a solve already timed in that mode.  Fails if a captured cycle after
    the first did not replay."""
    from lanczos_tpu_torch.solver import graphs

    timed = timed or {}
    out = {}
    for mode, kind in (("captured", "replay"), ("eager", "plain")):
        with graphs.eager() if mode == "eager" else contextlib.nullcontext():
            if mode in timed:
                wall, st, marks, vals = timed[mode]
            else:
                graphs.reset_stats()
                torch.cuda.synchronize()
                with cycle_clock() as marks:
                    t0 = time.perf_counter()
                    vals = solve(None)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                st = graph_stats()
            device_s, _ = cycle_profile(solve)
        _, cycle_s = cycle_walls(marks, kind)
        out[mode] = dict(wall_s=wall, cycles=len(st["cycles"]), eager=st["eager"],
                         captures=st["captures"], capture_s=st["capture_s"],
                         replays=st["replays"], cycle_wall_s=cycle_s, cycle_device_s=device_s)
        out[f"{mode}_result"] = vals
        print(f"  {label}, {mode} cycles: wall {wall:.3f} s, {len(st['cycles'])} cycles, graphs "
              f"captured {st['captures']} in {st['capture_s']:.3f} s, replays {st['replays']}; "
              f"a cycle after the first (with the host work to the next) {cycle_s:.3f} s, its "
              f"device time {device_s:.3f} s ({device_s / cycle_s:.1%} busy)")
    st = out["captured"]
    check(st["eager"] == 1 and st["replays"] == st["cycles"] - 1,
          f"{label}: not every cycle after the first replayed a graph: {st}")
    return out


def phase_northstar(n_fine):
    print(f"== north-star pipeline at n_fine={n_fine} (k=100 + 10, fp32 tol 3e-7, refinement "
          "tol 1e-8)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    info, extra = _northstar().run(n_fine=n_fine, device="cuda", verbose=True)
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    info.update(wall_s=wall, peak_device_gib=peak / 2**30, launches=launches)
    print(f"  stages (s): neighbors {info['t_neighbors_s']:.2f}, reciprocity "
          f"{info['t_reciprocity_s']:.2f}, composite build {info['t_build_composite_s']:.2f}, "
          f"fp32 solve {info['t_solve_fp32_s']:.2f} ({info['cycles']} cycles, basis "
          f"{info['max_basis']}, locked {info['n_locked']}), refinement {info['t_refine_s']:.2f}, "
          f"host true residuals {info['t_true_residuals_s']:.2f}; total {wall:.2f}")
    print(f"  {info['num_points']} points, M = {info['m_operator']}, "
          f"{info['n_interface_classes']} interface classes, peak device memory "
          f"{peak / 2**30:.2f} GiB")
    print(f"  launches by dtype: {json.dumps(launches)}")
    print(f"  pairs_below_1e-8 {info['pairs_below_1e-8']}, 1e-7 {info['pairs_below_1e-7']}, "
          f"1e-6 {info['pairs_below_1e-6']}; true residual max {info['true_residual_max']:.3e} "
          f"(scripts/northstar.py's measure), / |lambda + 1| max "
          f"{info['true_residual_shifted_max']:.3e}")
    print(f"  lowest eigenvalues {info['eigenvalues_head']}")
    check(info["refine_completed"], f"refinement failed: {info.get('refine_error')}")
    rel = extra["rel_shifted"]
    check(bool(np.isfinite(extra["lam"]).all() and np.isfinite(rel).all()), "NaN in the result")
    check(abs(float(np.min(extra["lam"]))) <= 1e-8, "lambda_0 (the constant mode) is not 0")
    check(rel.max() <= 3e-8, f"true residual {rel.max():.3e} > 3e-8")
    for name, dt in (("stencil_spmv", "float32"), ("stencil_spmv", "float64"),
                     ("apply_fused_interface", "float32"), ("apply_fused_interface", "float64"),
                     ("stencil_spmm", "float32")):
        check(launches[name][dt] > 0, f"{name} was not launched in {dt}")
    max_abs = check_operator_kernels(extra["op"], f"n_fine={n_fine}")
    info["busy"] = northstar_busy_shares(info, extra)
    northstar_kernel_times(extra["op"], launches)
    print(f"  record: {json.dumps(info)}")
    return info, max_abs, extra["op"]


def busy_share(fn, kernels=()):
    """(profiled wall s, device busy s) of one call of ``fn`` under
    ``torch.profiler``: the kernels' and copies' own device time.  Only the
    device activity is traced: a refinement round runs ~10^5 host ops, and
    their trace takes tens of GB of host memory.  With ``kernels`` (names
    to look for in the profiler's kernel names), a third item: {name:
    (launches, device s)}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_type != DeviceType.CPU]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    if not kernels:
        return wall, busy
    found = {name: (sum(e.count for e in events if name in e.key),
                    sum(e.self_device_time_total for e in events if name in e.key) / 1e6)
             for name in kernels}
    return wall, busy, found


def cycle_profile(solve, kernels=(), index=2):
    """Device time of one cycle of a restarted solve: ``solve(c)`` runs c
    cycles; of a run of ``index + 1`` cycles only cycle ``index`` runs
    under the profiler, the device synchronized around it (cycle 2 is a
    replay when the cycles are captured: cycle 0 runs eagerly, cycle 1 is
    the capture).  Returns (device s, {kernel: (launches, device s)})."""
    from lanczos_tpu_torch.solver import graphs

    run = graphs.CycleGraphs.run
    calls, out = [], {}

    def profiled(self, static, body, *args):
        calls.append(static)
        if len(calls) - 1 != index:
            return run(self, static, body, *args)
        result = []
        _, out["busy"], out["found"] = busy_share(
            lambda: result.append(run(self, static, body, *args)), kernels or ("_",))
        return result[0]

    graphs.CycleGraphs.run = profiled
    try:
        solve(index + 1)
    finally:
        graphs.CycleGraphs.run = run
    check("busy" in out, f"the solve ended before its cycle {index}")
    return out["busy"], {n: out["found"][n] for n in kernels}


@contextlib.contextmanager
def cycle_clock():
    """Time every cycle that a solve runs through ``CycleGraphs.run``, the
    device synchronized before and after it: yields a list that gets one
    (kind, start s, end s) a cycle on the host clock, kind "eager" (the
    first cycle of a capturing solve), "capture" (a capture and its first
    replay), "replay", or "plain" (``graphs.eager()``)."""
    from lanczos_tpu_torch.solver import graphs

    run = graphs.CycleGraphs.run
    marks = []
    names = ("eager", "captures", "replays")

    def timed(self, static, body, *args):
        before = [graphs.stats[n] for n in names]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(self, static, body, *args)
        torch.cuda.synchronize()
        e, c, r = (graphs.stats[n] - b for n, b in zip(names, before))
        marks.append(("eager" if e else "capture" if c else "replay" if r else "plain", t0,
                      time.perf_counter()))
        return out

    graphs.CycleGraphs.run = timed
    try:
        yield marks
    finally:
        graphs.CycleGraphs.run = run


def cycle_walls(marks, kind):
    """Median (cycle s, cycle and the host work up to the next cycle s) of
    the cycles of ``kind`` after the first cycle of a solve, each followed
    by another cycle (the last one's host work is the verification)."""
    inner = [e - s for (k, s, e), _ in zip(marks[1:], marks[2:]) if k == kind]
    outer = [s1 - s for (k, s, _), (_, s1, _) in zip(marks[1:], marks[2:]) if k == kind]
    return (float(np.median(inner)), float(np.median(outer))) if inner else (None, None)


def northstar_busy_shares(info, extra):
    """Device busy share of one restart cycle and of one refinement round,
    each captured (CUDA graph replays) and eager (``graphs.eager()``).  A
    cycle is m - l steps from the locked block, the host eigh of the
    arrowhead and the Ritz rotation: its device time is the third cycle of
    a run (cycle_profile), its wall the median of cycles 2 and 3 of a
    5-cycle run (cycle 0 from the start vector, cycle 1 the capture of l =
    n_locked; cycle_clock).  The round is ``max_rounds=1, tol=0``: a
    residual sweep, the Rayleigh-Ritz rotation, the deflated CG of every
    chunk, and the closing residual sweep; its wall and peak memory are
    taken unprofiled, its device time in a second run under the profiler.
    The captured round's results must equal the eager round's bitwise."""
    from lanczos_tpu_torch.solver import graphs
    from lanczos_tpu_torch.solver.refine import refine_eigenpairs_dd_hosted
    from lanczos_tpu_torch.solver.restart import eigsh_restarted

    op, idx_map = extra["op"], extra["idx_map"]
    kk = info["k"] + info["k_buffer"]
    v0 = np.zeros(op.shape[0], dtype=np.float32)
    v0[idx_map] = np.random.default_rng(99).uniform(-1, 1, size=info["num_points"])
    kw = dict(k=kk, tol=3e-7, v0=v0, compensated=True, max_basis=info["max_basis"],
              n_locked=info["n_locked"], rr_verify=False)

    busy_share(lambda: op.matvec(torch.as_tensor(v0, device="cuda")))  # the profiler's start-up
    out, peaks = {}, {}
    for mode, kind in (("captured", "replay"), ("eager", "plain")):
        with graphs.eager() if mode == "eager" else contextlib.nullcontext():
            torch.cuda.reset_peak_memory_stats()
            with cycle_clock() as marks:
                eigsh_restarted(op, max_cycles=5, **kw)
            peaks[mode] = torch.cuda.max_memory_allocated()
            busy, _ = cycle_profile(lambda c: eigsh_restarted(op, max_cycles=c, **kw))
        _, wall = cycle_walls(marks, kind)
        out[f"restart_cycle_{mode}"] = (wall, busy)
    for name, (wall, busy) in out.items():
        print(f"  {name}: {wall:.3f} s (the cycle and the host work to the next), device "
              f"busy {busy:.3f} s ({busy / wall:.1%})")
    print(f"  peak device memory of a 5-cycle solve: captured {peaks['captured'] / 2**30:.3f} "
          f"GiB, eager {peaks['eager'] / 2**30:.3f} GiB")
    shares = {name: dict(wall_s=w, device_busy_s=b) for name, (w, b) in out.items()}
    shares["peak_5_cycles_gib"] = {k: v / 2**30 for k, v in peaks.items()}

    lam, X = extra["lam_shifted"], extra["X64"]
    rkw = dict(tol=0.0, max_rounds=1, cg_steps=200, col_chunk=8, k_report=info["k"])

    def refine_round():
        return refine_eigenpairs_dd_hosted(op, lam, X.copy(), **rkw)

    rounds, results = {}, {}
    for mode in ("captured", "eager"):
        with graphs.eager() if mode == "eager" else contextlib.nullcontext():
            graphs.reset_stats()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            results[mode] = refine_round()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            st = graph_stats()
            pwall, busy = busy_share(refine_round)
        rounds[mode] = dict(wall_s=wall, profiled_wall_s=pwall, device_busy_s=busy,
                            peak_gib=peak / 2**30, base_gib=base / 2**30,
                            **{k: st[k] for k in ("eager", "captures", "capture_s", "replays")},
                            unit_calls=len(st["cycles"]))
        print(f"  refine_round_{mode}: {wall:.3f} s unprofiled, device busy {busy:.3f} s "
              f"({busy / wall:.1%}; under the profiler {pwall:.3f} s); peak device memory "
              f"{peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} GiB above the "
              f"{base / 2**30:.3f} GiB held before it)")
        if mode == "captured":
            hold_unit_replays("n_fine=216 refinement round", st)
    same, diff = same_arrays([(a, b) for a, b in zip(results["captured"], results["eager"])])
    ratio = rounds["captured"]["peak_gib"] / rounds["eager"]["peak_gib"]
    print(f"  refinement round captured - eager: eigenvalues, vectors and relative residuals "
          f"{'bitwise equal' if same else f'differ by up to {diff:.3e}'}; wall "
          f"{rounds['captured']['wall_s'] / rounds['eager']['wall_s']:.3f}x, peak memory "
          f"{ratio:.3f}x the eager round's")
    check(same, "n_fine=216: the captured refinement round differs from the eager one")
    shares["refine_round"] = rounds
    shares["refine_chunk_launches"] = refine_chunk_launches(refine_round)
    return shares


class _Stop(Exception):
    """Ends a run once its profiled unit has run."""


def refine_chunk_launches(refine_round, key=("cg", 200, 8, torch.float32), index=2):
    """Each kernel's launches and device time, under the profiler, in one
    replayed correction chunk of a refinement round: call ``index`` of
    ``key`` (call 0 runs eagerly, call 1 is the capture); the round stops
    after it."""
    from lanczos_tpu_torch.solver import graphs

    run = graphs.CycleGraphs.run
    calls, out = [], {}
    # The port's kernels, then cuBLAS's and PyTorch's by name fragment.
    kernels = ("spmv_kernel", "spmm_kernel", "interface_kernel", "gemm", "gemv", "splitK",
               "native::reduce_kernel", "elementwise_kernel")

    def profiled(self, static, body, *args):
        if static != key:
            return run(self, static, body, *args)
        calls.append(static)
        if len(calls) - 1 != index:
            return run(self, static, body, *args)
        replays = graphs.stats["replays"]
        _, out["busy"], out["found"] = busy_share(lambda: run(self, static, body, *args), kernels)
        out["replayed"] = graphs.stats["replays"] == replays + 1
        out["wrappers"] = {w.__name__: n for w, (n, _) in
                           zip(graphs._wrappers(), self._graphs[static].launches)}
        raise _Stop

    graphs.CycleGraphs.run = profiled
    try:
        refine_round()
    except _Stop:
        pass
    finally:
        graphs.CycleGraphs.run = run
    check(out.get("replayed"), f"the refinement's correction call {index} was not a replay")
    found = {name: dict(launches=n, device_s=t) for name, (n, t) in out["found"].items()}
    print(f"  one replayed correction chunk (b=8, 200 CG steps): device time {out['busy']:.4f} s; "
          "kernels whose names hold "
          + ", ".join(f"{name} {v['launches']} launches, {v['device_s'] * 1e3:.2f} ms"
                      for name, v in found.items())
          + f" (the profiler's count; the graph holds {json.dumps(out['wrappers'])} by the "
          "wrappers' count)")
    return dict(device_s=out["busy"], kernels=found, graph_launches=out["wrappers"])


def check_operator_kernels(op, label):
    """Each kernel against its plain version, on the same CUDA inputs, at
    the shapes the north-star pipeline gives it on ``op``: the SpMV in fp32
    (the restarted solve) and fp64 (the refinement's residuals) and the
    SpMM at b=8 in fp32 (the deflated CG) on each level grid; the
    interface kernel in fp32 at b=1 and 8 and in fp64 at b=1, on the
    fp64 copy the refinement builds.  Returns {kernel: max abs error}."""
    from lanczos_tpu_torch.ops import interface_kernel as ik
    from lanczos_tpu_torch.ops import stencil_kernels as sk
    from lanczos_tpu_torch.ops.dd import to_float64

    print(f"== kernels vs plain version on the {label} operator (max abs err, "
          "max abs err / max |y_ref|)")
    gen = torch.Generator(device="cuda").manual_seed(8)
    max_abs = dict.fromkeys(("stencil_spmv", "stencil_spmm", "apply_fused_interface"), 0.0)

    def hold(kernel, text, y, y_ref):
        max_abs[kernel] = max(max_abs[kernel], against_plain(text, y, y_ref))

    for dtype, o in ((torch.float32, op), (torch.float64, to_float64(op))):
        name = str(dtype)[6:]
        widths = (None, 8) if dtype == torch.float32 else (None,)
        for level in o.level_ops:
            shape = "x".join(map(str, level.grid_shape))
            for b in widths:
                x = torch.randn((level.shape[0],) if b is None else (level.shape[0], b),
                                generator=gen, device="cuda", dtype=dtype)
                if b is None:
                    hold("stencil_spmv", f"{name} stencil_spmv level {shape}",
                         sk.stencil_spmv(level, x), sk.stencil_spmv_reference(level, x))
                else:
                    hold("stencil_spmm", f"{name} stencil_spmm b={b} level {shape}",
                         sk.stencil_spmm(level, x), sk.stencil_spmm_reference(level, x))
        fi = o.fused
        if fi.num_rows == 0:
            print(f"  {name} apply_fused_interface: no interface rows on this operator")
            continue
        for b in widths:
            shape = (o.shape[0],) if b is None else (o.shape[0], b)
            x = torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
            x = x * (o.live if b is None else o.live[:, None])
            y0 = torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
            hold("apply_fused_interface", f"{name} apply_fused_interface b={b or 1} "
                 f"({fi.num_rows} rows)", ik.apply_fused_interface(fi, x, y0.clone()),
                 ik.apply_fused_interface_reference(fi, x, y0.clone()))
        del o
        torch.cuda.empty_cache()
    return max_abs


def northstar_kernel_times(op, launches):
    """Kernel, plain and cuSPARSE times on the north-star operator: the
    interface kernel in fp32 and fp64, the SpMV in fp32 and fp64 and the
    SpMM at b=8 in fp32 on each level grid."""
    from lanczos_tpu_torch.ops import interface_kernel as ik
    from lanczos_tpu_torch.ops import stencil_kernels as sk
    from lanczos_tpu_torch.ops.dd import to_float64

    print("== kernel times on the north-star operator (graph: replays of 50 calls, median of "
          "20; eager: median of 5 x 100 calls; plain 5 x 10)")
    floor_ms, copy_gbs = launch_floor(), copy_rate()
    gen = torch.Generator(device="cuda").manual_seed(5)
    for dtype, o in ((torch.float32, op), (torch.float64, to_float64(op))):
        name = str(dtype)[6:]
        elem = torch.finfo(dtype).bits // 8
        peak = PEAK_FP32_FLOPS if dtype == torch.float32 else PEAK_FP64_FLOPS
        m = o.shape[0]
        fi = o.fused
        xs = itertools.cycle([torch.randn(m, generator=gen, device="cuda", dtype=dtype) * o.live
                              for _ in range(8)])
        y = torch.zeros(m, device="cuda", dtype=dtype)
        csr_i, _ = interface_csr(fi, dtype)
        print(f"  apply_fused_interface {name}: {fi.cls.shape[0]} classes, {fi.num_rows} rows, "
              f"{fi.tap_reads} tap reads; {launches['apply_fused_interface'][name]} launches in "
              "the pipeline")
        kernel_row(
            f"apply_fused_interface {name}", lambda: ik.apply_fused_interface(fi, next(xs), y),
            lambda: ik.apply_fused_interface_reference(fi, next(xs), y),
            lambda: torch.mv(csr_i, next(xs)), interface_bytes(fi, elem), 2 * fi.tap_reads,
            copy_gbs, floor_ms, plain_launches=10, peak_flops=peak)
        del csr_i
        print(f"  stencil_spmv {name}: {launches['stencil_spmv'][name]} launches in the pipeline; "
              f"stencil_spmm: {launches['stencil_spmm'][name]}")
        for level in o.level_ops:
            ml = level.shape[0]
            shape = "x".join(map(str, level.grid_shape))
            xl = itertools.cycle([torch.randn(ml, generator=gen, device="cuda", dtype=dtype)
                                  for _ in range(8)])
            csr_l = stencil_csr(level)
            kernel_row(
                f"stencil_spmv {name} level {shape}",
                lambda level=level, xl=xl: sk.stencil_spmv(level, next(xl)),
                lambda level=level, xl=xl: sk.stencil_spmv_reference(level, next(xl)),
                lambda csr_l=csr_l, xl=xl: torch.mv(csr_l, next(xl)),
                (2 if level.diag is None else 3) * elem * ml, 2 * len(level.offsets) * ml,
                copy_gbs, floor_ms, plain_launches=10, peak_flops=peak)
            if dtype == torch.float32:
                # The deflated CG's matmat: (M, 8) read and written, 64 B/pt.
                Xl = torch.randn((ml, 8), generator=gen, device="cuda")
                kernel_row(
                    f"stencil_spmm b=8 {name} level {shape}",
                    lambda level=level, Xl=Xl: sk.stencil_spmm(level, Xl),
                    lambda level=level, Xl=Xl: sk.stencil_spmm_reference(level, Xl),
                    lambda csr_l=csr_l, Xl=Xl: torch.sparse.mm(csr_l, Xl),
                    (64 if level.diag is None else 68) * ml, 2 * len(level.offsets) * 8 * ml,
                    copy_gbs, floor_ms, plain_launches=10)
            del csr_l
        torch.cuda.empty_cache()


#: Pairs of phase 16's solve: the golden's five cut the 2.514/2.524 cluster
#: (five members: 2.51392 x3, 2.52358 x2), so its refinement stalled
#: (scripts/compare_nonsym_refine.py: both packages alike); eight reach
#: past it.
NONSYM_REFINE_K = 8


def phase_nonsym_refine(lt, lat):
    from lanczos_tpu_torch.solver import graphs
    from lanczos_tpu_torch.solver.refine import refine_eigenpairs_dd_nonsym

    print(f"== eigs_nonsym(compensated=True, k={NONSYM_REFINE_K}) at N=60 (fp32) and "
          "refine_eigenpairs_dd_nonsym vs the lanczos_tpu fp64 golden")
    golden = load_golden(60)
    c = golden["config"]
    op, idx_map = lt.assemble_irregular_hamiltonian_composite2(
        lat, lt.deuteron_potential_3d, dtype=torch.float32, device="cuda")
    v0 = lattice_start(op, idx_map, lat.num_points, c["v0_seed"])
    t0 = time.perf_counter()
    res = lt.eigs_nonsym(op, k=NONSYM_REFINE_K, max_basis=c["max_basis"], tol=c["tol"], v0=v0,
                         compensated=True)
    torch.cuda.synchronize()
    print(f"  eigs_nonsym {time.perf_counter() - t0:.2f} s")
    print(res.summary())
    vals, resid = res.eigenvalues.cpu().numpy(), res.residuals.cpu().numpy()
    norms = (golden["norm_inf"], golden["norm_1"])
    # The golden holds the five lowest values: pairs above its range are
    # printed, not held.
    top = max(golden["eigenvalues"]) + 1e-3
    inside = vals <= top
    check_against("N=60 fp32 compensated vs fp64 golden", vals[inside], resid[inside], golden,
                  EPS32, norms, c["tol"])
    walls, refined = {}, {}
    for mode in ("captured", "eager"):
        with graphs.eager() if mode == "eager" else contextlib.nullcontext():
            before = graph_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            refined[mode] = refine_eigenpairs_dd_nonsym(op, vals, res.eigenvectors, tol=1e-9,
                                                        max_rounds=8, cg_steps=60)
            torch.cuda.synchronize()
            walls[mode] = time.perf_counter() - t0
        if mode == "captured":
            hold_unit_replays("refine_eigenpairs_dd_nonsym", graph_stats_since(before))
    lam, Xh, Xl, rel = refined["captured"]
    same, diff = same_arrays(list(zip(refined["captured"], refined["eager"])))
    print(f"  refine_eigenpairs_dd_nonsym captured {walls['captured']:.3f} s, eager "
          f"{walls['eager']:.3f} s ({walls['eager'] / walls['captured']:.2f}x); captured - eager: "
          f"eigenvalues, vectors and relative residuals "
          f"{'bitwise equal' if same else f'differ by up to {diff:.3e}'}")
    check(same, "N=60: the captured refinement differs from the eager one")
    print(f"  relative residuals {np.array2string(rel, precision=3)} (against the fp32-stored "
          "operator)")
    check(bool(np.isfinite(lam).all() and np.isfinite(rel).all()), "refined pairs not finite")
    # Clusters: sorted neighbours within 1% of max(|lam|, 1).  A cluster
    # that holds the highest computed pair may have members beyond k, which
    # the refinement cannot deflate: its pairs are printed, not held.
    # Every pair of a complete cluster is held at 1e-8.
    order = np.argsort(lam)
    s = lam[order]
    gaps = np.abs(np.diff(s)) > 1e-2 * np.maximum(np.abs(s[1:]), 1.0)
    cluster = np.concatenate([[0], np.cumsum(gaps)])
    incomplete = cluster == cluster[-1]
    # The 2.514/2.524 cluster has five members (2.51392 x3, 2.52358 x2;
    # scripts/compare_nonsym_refine.py).  A single-vector Krylov solve may
    # hold fewer copies of it even at k=8: it is then incomplete, and its
    # pairs are printed, not held.
    in_cluster = (s > 2.5) & (s < 2.53)
    copies = int(in_cluster.sum())
    if copies < 5:
        incomplete |= in_cluster
    held = order[~incomplete]
    print(f"  the 2.514/2.524 cluster: {copies} of its 5 copies in the fp32 solve "
          f"({'held' if copies == 5 else 'incomplete: printed, not held'})")
    print(f"  complete clusters: pairs {held.tolist()} held at 1e-8 (max {rel[held].max():.3e}); "
          f"pairs {order[incomplete].tolist()} in an incomplete cluster")
    check(order[0] in held, "the ground state lies in an incomplete cluster")
    check(rel[held].max() <= 1e-8, "a refined pair of a complete cluster is above 1e-8")
    check(float((Xh * (1 - op.live)[:, None]).abs().max()) == 0.0,
          "refined vectors are not zero on the dead slots")
    # The refined pairs are eigenpairs of the fp32-stored operator: held to
    # the golden (fp64 coefficients) within its storage-rounding tolerance.
    rel_scaled = rel * np.abs(lam) / np.maximum(np.abs(lam), 1.0)
    o = order[s <= top]
    check_against("refined N=60 vs fp64 golden", lam[o], rel_scaled[o], golden, EPS32, norms,
                  c["tol"])


# ---------------------------------------------------------------------------
# The block solver, look-ahead two-sided Lanczos, the CLI and the benchmark


def cluster_copies(vals):
    """{value rounded to 4 decimals: copies} of the 5.2368/5.2370/5.2373
    cluster among ``vals``."""
    v = np.round(np.sort(np.asarray(vals)), 4)
    keys, counts = np.unique(v[(v > 5.2360) & (v < 5.2380)], return_counts=True)
    return {f"{key:.4f}": int(n) for key, n in zip(keys, counts)}


def phase_block_flagship(lt, restarted):
    """eigsh_block_restarted(k=20, block_size=4) at N=160^3 in fp32 and fp64,
    its cycles captured, each held against the eager path over its first
    6 cycles; the fp64 block is phase 12's multiplicity reference; then a
    breakdown on the card.  Returns each dtype's launches."""
    from lanczos_tpu_torch.ops import operators
    from lanczos_tpu_torch.solver import block, graphs

    N, k, b = 160, 20, 4
    print(f"== eigsh_block_restarted at N=160^3 (27-point, k={k}, block_size={b}): fp32 (tol "
          "1e-4), fp64 (tol 1e-5), every cycle after the first a CUDA graph replay; the fp64 "
          f"block as phase 12's multiplicity reference; on {card_label()}")
    # Record the width of every SpMM call made from Python (a replay makes
    # none): the recurrence runs at b, the Rayleigh-Ritz verification and
    # the acceptance at k.
    widths = {}
    spmm = operators.stencil_spmm

    def spy(op, X):
        widths[X.shape[1]] = widths.get(X.shape[1], 0) + 1
        return spmm(op, X)

    # Every cycle's a/b blocks as the solver reads them back.
    blocks = []
    read_cycle = block._read_cycle

    def read_spy(*args):
        out = read_cycle(*args)
        blocks.append(out[:2])
        return out

    runs = {}
    operators.stencil_spmm = spy
    block._read_cycle = read_spy
    try:
        # fp32 stops at its floor, far above either tol, so its tol only
        # sets when the verification starts; fp64's puts every true residual
        # below 1e-5 |lambda|, under its gate.
        for dtype, solve_tol in ((torch.float32, 1e-4), (torch.float64, 1e-5)):
            name = str(dtype)[6:]
            H = lt.build_regular_hamiltonian(N, 25.0, lt.deuteron_potential_3d, stencil="27",
                                             dtype=dtype, device="cuda")
            tol = fp32_tolerance(H)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            graphs.reset_stats()
            widths.clear()
            blocks.clear()
            t0 = time.perf_counter()
            res = lt.eigsh_block_restarted(H, k=k, block_size=b, tol=solve_tol, max_cycles=400)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_launches()
            peak = torch.cuda.max_memory_allocated()
            st = graph_stats()
            print(f"  {name}: wall {wall:.3f} s, {res.cycles} cycles, peak device memory "
                  f"{peak / 2**30:.2f} GiB, launches {json.dumps(launches)}, SpMM calls from "
                  f"Python by width {dict(sorted(widths.items()))}")
            print(f"  {name}: eager cycles {st['eager']}, graphs captured {st['captures']} in "
                  f"{st['capture_s']:.3f} s, replays {st['replays']}, cycles redone "
                  f"{st['redo']}")
            check(st["eager"] == 1 and st["replays"] == res.cycles - 1
                  and st["captures"] == len(set(st["cycles"][1:])),
                  f"block {name}: not every cycle after the first was a replay: {st}")
            first = blocks[:6]
            # The eager path over the first 6 cycles, and the captured one
            # over the same window for its peak memory.
            window = {}
            for mode in ("eager", "captured"):
                blocks.clear()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                with graphs.eager() if mode == "eager" else contextlib.nullcontext():
                    lt.eigsh_block_restarted(H, k=k, block_size=b, tol=solve_tol, max_cycles=6)
                torch.cuda.synchronize()
                window[mode] = (time.perf_counter() - t0, torch.cuda.max_memory_allocated(),
                                list(blocks))
            eager_blocks = window["eager"][2]
            same = len(first) == len(eager_blocks) == 6 and all(
                np.array_equal(x, y) for pair in zip(first, eager_blocks) for x, y in zip(*pair))
            d_ab = max(float(np.abs(x - y).max(initial=0.0))
                       for pair in zip(first, eager_blocks) for x, y in zip(*pair))
            print(f"  {name}: the first 6 cycles, 6-cycle solves: eager "
                  f"{window['eager'][0]:.3f} s, peak {window['eager'][1] / 2**30:.2f} GiB; captured "
                  f"{window['captured'][0]:.3f} s, peak {window['captured'][1] / 2**30:.2f} GiB; "
                  f"the solve's a/b blocks against the eager path's: max |diff| {d_ab:.3e}, "
                  f"{'bitwise equal' if same else 'NOT bitwise equal'}")
            check(same, f"block {name}: the captured cycles' a/b blocks differ from the eager "
                        "path's")
            print(res.summary(print_nr=k))
            for what, t in (("eigenvalues", res.eigenvalues), ("eigenvectors", res.eigenvectors),
                            ("residuals", res.residuals), ("inner_prod", res.inner_prod)):
                check(bool(torch.isfinite(t).all()), f"block {name}: non-finite {what}")
            check(tuple(res.eigenvectors.shape) == (N**3, k), "block result shapes")
            check(launches["stencil_spmm"][name] > 0 and widths.get(b, 0) > 0,
                  f"block {name}: the SpMM was not launched at b={b}")
            check(set(widths) <= {b, k}, f"block {name}: SpMM widths {sorted(widths)}")
            resid = res.residuals.double().cpu().numpy()
            gate = 14 * tol if dtype == torch.float32 else tol / 10
            print(f"  {name} true residuals: max {resid.max():.3e} MeV = "
                  f"{resid.max() / tol:.3f} eps32 ||H||_G (gate "
                  f"{'14' if dtype == torch.float32 else '0.1'})")
            check(resid.max() <= gate, f"block {name}: a true residual {resid.max():.3e} > "
                                       f"{gate:.3e} MeV")
            runs[dtype] = dict(vals=np.sort(res.eigenvalues.double().cpu().numpy()), wall=wall,
                               cycles=res.cycles, peak=peak, launches=launches, tol=tol)
            del H, res
            torch.cuda.empty_cache()
    finally:
        operators.stencil_spmm = spmm
        block._read_cycle = read_cycle
    block_breakdown(lt)

    tol = runs[torch.float32]["tol"]
    ref = runs[torch.float64]["vals"]
    print(f"  copies of the 5.2368/5.2370/5.2373 cluster (tolerance eps32 ||H||_G = {tol:.3e} MeV):")
    for label, v in (("phase 12 fp32 eigsh_restarted", restarted["vals"]),
                     ("phase 12 fp64 eigsh_restarted", restarted["ref_vals"]),
                     ("block fp32", runs[torch.float32]["vals"]), ("block fp64", ref)):
        print(f"    {label:32s} {cluster_copies(v)}")
    d = np.abs(runs[torch.float32]["vals"] - ref)
    print(f"  block fp32 vs block fp64, sorted: max |diff| {d.max():.3e} MeV")
    check(d.max() <= tol, f"the fp32 block is {d.max():.3e} off the fp64 block (sorted)")
    a = np.sort(restarted["vals"])
    d = np.abs(a - ref)
    print("  phase 12 fp32 value, fp64 block value (sorted pairing):")
    for i in range(k):
        print(f"    {i:2d} {a[i]:14.8f} {ref[i]:14.8f} |diff| {d[i]:.3e} "
              f"{'ok' if d[i] <= tol else 'MISMATCH'}")
    if d.max() <= tol:
        print(f"  sorted pairing holds: max |diff| {d.max():.3e} MeV")
    else:
        # A single-vector solve may drop a multiplet copy: that is a finding
        # about it, and its values are then held by nearest value, each way.
        d_ab, d_ba = nearest_each_way(a, ref, tol)
        print(f"  sorted pairing FAILS (max |diff| {d.max():.3e} MeV): the single-vector fp32 "
              f"solve holds other copies; nearest each way: {d_ab.max():.3e} / {d_ba.max():.3e}")
        check(max(d_ab.max(), d_ba.max()) <= tol,
              "phase 12's fp32 values are off the fp64 block by nearest value")
    return {str(dt)[6:]: r["launches"] for dt, r in runs.items()}


def block_breakdown(lt):
    """A breakdown on the card: the rank-10 operator B B^T (120 x 120,
    fp64, a DenseOperator), 3 blocks of 4 a cycle, whose second cycle (the
    first one captured) breaks down and is redone eagerly with the cure;
    the captured solve is held bitwise against the eager one, and near the
    four largest dense eigenvalues (the solve runs out its 10 cycles)."""
    from lanczos_tpu_torch.ops.operators import DenseOperator
    from lanczos_tpu_torch.solver import graphs

    Bm = np.random.default_rng(5).standard_normal((120, 10))
    op = DenseOperator(torch.as_tensor(Bm @ Bm.T, device="cuda"))
    kw = dict(k=4, block_size=4, num_blocks=3, n_locked=4, tol=1e-9, max_cycles=10, which="LA")
    out = {}
    for mode in ("captured", "eager"):
        graphs.reset_stats()
        with graphs.eager() if mode == "eager" else contextlib.nullcontext():
            res = lt.eigsh_block_restarted(op, **kw)
        out[mode] = (res, graph_stats())
    (cap, st), (plain, st_e) = out["captured"], out["eager"]
    same = all(torch.equal(getattr(cap, f), getattr(plain, f))
               for f in ("eigenvalues", "eigenvectors", "residuals", "inner_prod"))
    exact = np.sort(np.linalg.eigvalsh(Bm @ Bm.T))[::-1][:4]
    d = float(np.abs(cap.eigenvalues.cpu().numpy() - exact).max())
    print(f"  a breakdown on the card (rank-10 B B^T, 120 x 120 fp64, b=4, 3 blocks): captured "
          f"{cap.cycles} cycles, replays {st['replays']}, cycles redone {st['redo']} (eager: "
          f"{st_e['redo']}); captured against eager {'bitwise equal' if same else 'DIFFER'}; "
          f"max |lambda - dense| {d:.3e}")
    check(st["redo"] >= 1 and st["redo"] == st_e["redo"] and st["replays"] == cap.cycles - 1,
          f"the rank-deficient block solve did not redo a captured cycle: {st}")
    check(same, "the rank-deficient block solve's captured result differs from the eager one")
    check(d <= 1e-6 * exact[0], "the rank-deficient block solve is off the dense eigenvalues")


def phase_cli_block(lt):
    """``solve-regular -N 64 -k 8 --block-size 4`` in process on the default
    device, against the N=64 golden by nearest value, each way."""
    from lanczos_tpu_torch.cli import main as cli_main

    print("== CLI: solve-regular -N 64 -k 8 --block-size 4 (default device, fp32) vs the N=64 "
          "golden")
    with open(os.path.join(HERE, "lanczos_tpu_torch", "data", "golden_eigsh_n64.json")) as f:
        golden = json.load(f)
    reset_launches()
    t0 = time.perf_counter()
    res = cli_main(["solve-regular", "-N", "64", "-k", "8", "--block-size", "4"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    print(f"  wall {wall:.3f} s, {res.cycles} cycles, launches {json.dumps(launches)}")
    check(res.eigenvectors.device.type == "cuda", "the CLI did not solve on the card")
    check(launches["stencil_spmm"]["float32"] > 0, "the CLI's block solve ran no SpMM launch")
    tol = fp32_tolerance(lt.build_regular_hamiltonian(
        64, 25.0, lt.deuteron_potential_3d, stencil="27", dtype=torch.float32, device="cuda"))
    vals = np.sort(res.eigenvalues.double().cpu().numpy())
    resid = res.residuals.double().cpu().numpy()
    # The golden is a single-vector eigsh(n=150): past its two lowest pairs
    # its Ritz values mix neighbouring clusters (residuals 0.024-7.6 MeV,
    # though the acceptance statistic passes some).  Only its values whose
    # own residual is within the tolerance are eigenvalues to that much;
    # they and the block values in their range pair by nearest value, each
    # way.  The block values beyond are held by their true residuals.
    g_res = np.asarray(golden["residuals"])
    g = np.sort(np.asarray(golden["eigenvalues"])[g_res <= tol])
    d_ab, d_ba = nearest_each_way(g, vals, tol)
    print(f"  block values {np.round(vals, 6).tolist()}, true residuals max {resid.max():.3e} MeV "
          f"(gate 14 eps32 ||H||_G = {14 * tol:.3e})")
    print(f"  golden values with residual <= {tol:.3e}: {np.round(g, 6).tolist()}")
    print(f"  nearest each way: {d_ab.max():.3e} / {d_ba.max():.3e} MeV (tolerance {tol:.3e})")
    check(len(g) >= 1 and resid.max() <= 14 * tol, "CLI block residuals above the fp32 gate")
    check(max(d_ab.max(), d_ba.max()) <= tol, "CLI block values are off the N=64 golden")
    return launches


def phase_lookahead(lt, lat):
    """two_sided_lanczos_lookahead(n=250) and lookahead_eigs(k=5) at N=60 in
    fp64 on the CompositeV2 and its transpose, against the N=60 golden."""
    # The explicit oblique pencil (W A V^T, W V^T) floors the ground state's
    # true residual near 1e-6 at n=250, far above the plain two-sided
    # solve's (PERF.md §6), so 1e-6 would accept it or not by rounding:
    # the pairs are accepted at 1e-5.
    print("== two_sided_lanczos_lookahead at N=60, fp64, n=250, on the CompositeV2 and its "
          "transpose; lookahead_eigs(k=5, residual_tol=1e-5)")
    golden = load_golden(60)
    op, idx_map = lt.assemble_irregular_hamiltonian_composite2(
        lat, lt.deuteron_potential_3d, dtype=torch.float64, build_transpose=True, device="cuda")
    p = lat.num_points
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    fac = lt.two_sided_lanczos_lookahead(
        op, 250, v0=lattice_start(op, idx_map, p, 99), w0=lattice_start(op, idx_map, p, 100),
        op_transpose=op.transpose())
    res = lt.lookahead_eigs(fac, k=5, op=op, residual_tol=1e-5)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    sizes = np.bincount([e - a for a, e in fac.blocks])
    print(f"  wall {wall:.3f} s, n {fac.n}, {len(fac.blocks)} closed blocks (by size "
          f"{ {i: int(c) for i, c in enumerate(sizes) if c} }), max_block_used "
          f"{fac.max_block_used}, incurable {fac.incurable}; launches {json.dumps(launches)}")
    print(res.summary())
    n_ifc = launches["apply_fused_interface"]["float64"]
    check(n_ifc >= 2 * 249, f"interface kernel launched {n_ifc} times in 250 look-ahead steps")
    check(launches["stencil_spmv"]["float64"] > 0, "look-ahead ran no fp64 SpMV launch")
    hold_fp64_pairs("look-ahead", res, golden, residual_tol=1e-5)
    return launches


def phase_bench(copy_gbs):
    """``python -m lanczos_tpu_torch bench``'s measurement, its GB/s held
    between 50% and 100% of the copy rate phase 3 measured."""
    import contextlib
    import io

    from lanczos_tpu_torch.utils.bench_impl import main as bench_main

    print("== bench: the N=160^3 fp32 SpMV by graph replay (utils/bench_impl.py)")
    reset_launches()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        line = bench_main(device="cuda")
    wall = time.perf_counter() - t0
    launches = read_launches()
    share = line["value"] / copy_gbs
    print(f"  bench line: {out.getvalue().strip()}")
    print(f"  wall {wall:.2f} s, launches {json.dumps(launches)}; {line['value']} GB/s = "
          f"{share:.1%} of the copy rate {copy_gbs:.1f} GB/s (held in [50%, 100%])")
    check(line["detail"]["backend"] == "cuda" and launches["stencil_spmv"]["float32"] > 0,
          "the bench did not run the SpMV kernel")
    check(0.5 <= share <= 1.0, f"bench {line['value']} GB/s is {share:.1%} of the copy rate")
    return launches


# ---------------------------------------------------------------------------
# Row sharding (lanczos_tpu_torch/parallel/): world size 1 over NCCL on the
# card; D = 4 and 8 slabs in one process


def start_row_mesh():
    """A one-rank NCCL process group (the script sets the launcher's
    environment itself) and its row mesh."""
    from lanczos_tpu_torch.parallel import initialize_distributed, make_row_mesh
    from lanczos_tpu_torch.parallel.launch import free_port

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()), WORLD_SIZE="1",
                      RANK="0", LOCAL_RANK="0")
    check(initialize_distributed(device="cuda") == 1, "the process group is not of one rank")
    mesh = make_row_mesh()
    import torch.distributed as dist

    print(f"== row mesh: {mesh}, backend {dist.get_backend()}")
    check(dist.get_backend() == "nccl" and mesh.device.type == "cuda", "the mesh is not NCCL")
    # The first collectives set up the NCCL communicator: done here, so the
    # timed runs below do not carry it.  At D = 1 the halo exchange hands
    # the rank its own last plane as from_prev and first as from_next.
    t0 = time.perf_counter()
    planes = torch.arange(6.0, device="cuda").reshape(2, 3)
    from_prev, from_next = mesh.halo_exchange(planes[0], planes[1])
    total = float(mesh.all_reduce(planes.sum()))
    gathered = mesh.all_gather(planes)
    torch.cuda.synchronize()
    print(f"  first collectives (communicator set-up) {time.perf_counter() - t0:.3f} s")
    check(from_prev.tolist() == planes[1].tolist() and from_next.tolist() == planes[0].tolist()
          and total == 15.0 and gathered.tolist() == planes.tolist(),
          "the one-rank collectives do not return the rank's own data")
    capture_collectives(mesh)
    return mesh


def capture_collectives(mesh):
    """Each collective of the row mesh captured alone in a CUDA graph (after
    one eager call on the capture's stream) and replayed on new inputs,
    held bitwise against its eager call: phases 22 and 23 capture them
    inside the sharded restart cycles."""
    cases = {
        "all_reduce": (lambda a: mesh.all_reduce(a), (1000,)),
        "all_gather": (lambda a: mesh.all_gather(a), (7, 3)),
        "halo_exchange": (lambda a: torch.stack(mesh.halo_exchange(a[0], a[1])), (2, 4096)),
    }
    gen = torch.Generator(device="cuda").manual_seed(21)
    stream = torch.cuda.Stream()
    for name, (fn, shape) in cases.items():
        x = torch.randn(shape, generator=gen, device="cuda")
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            fn(x)
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            graph.capture_begin()
            try:
                out = fn(x)
            finally:
                graph.capture_end()
        same = []
        for _ in range(3):
            x.copy_(torch.randn(shape, generator=gen, device="cuda"))
            graph.replay()
            same.append(torch.equal(out, fn(x)))
        print(f"  {name} captured in a CUDA graph: 3 replays on new inputs "
              f"{'bitwise equal to' if all(same) else 'DIFFER from'} the eager call")
        check(all(same), f"a replayed {name} differs from the eager one")
        del graph


def slab_ops(H, d):
    """Every rank's ShardedStencilOperator of H split into d z-slabs, built
    in this process (a rank's slab arithmetic needs no collective)."""
    from lanczos_tpu_torch.parallel import RowMesh
    from lanczos_tpu_torch.parallel.distributed import ShardedStencilOperator

    return [ShardedStencilOperator(H, RowMesh(None, r, d, H.device)) for r in range(d)]


def phase_sharded_flagship(lt, mesh, flagship, copy_gbs, floor_ms):
    """Phase 21: lanczos_sharded(shard_operator(H), n=400) at N=160^3 fp32
    over the one-rank NCCL mesh against the unsharded recurrence; each
    rank's slab matvec at D = 4 and 8 (fp32, fp64) against the global
    matvec; the slab kernels against their plain version and timed;
    benchmark_matvec on the flagship."""
    from lanczos_tpu_torch.ops import stencil_kernels as sk
    from lanczos_tpu_torch.parallel import lanczos_sharded, shard_operator
    from lanczos_tpu_torch.solver.tridiag import ritz_from_factorization
    from lanczos_tpu_torch.utils.metrics import benchmark_matvec

    print("== sharded flagship: lanczos_sharded(shard_operator(H), n=400) at N=160^3, fp32, "
          f"over {mesh}, against the unsharded recurrence and phase 5's eigsh")
    N, n, k = 160, 400, 20
    v0 = np.random.default_rng(99).uniform(-1.0, 1.0, N**3)
    H = lt.build_regular_hamiltonian(N, 25.0, lt.deuteron_potential_3d, stencil="27",
                                     dtype=torch.float32, device="cuda")
    tol = fp32_tolerance(H)
    Hs = shard_operator(H, mesh)
    walls, thetas = {}, {}
    for label, run in (("unsharded", lambda: lt.lanczos(H, n, v0=v0)),
                       ("sharded", lambda: lanczos_sharded(Hs, n, v0=v0)),
                       ("sharded again", lambda: lanczos_sharded(Hs, n, v0=v0))):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        theta, X, _ = ritz_from_factorization(run())
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t0
        if label == "sharded":
            launches = read_launches()
        thetas[label] = np.sort(theta.double().cpu().numpy())[:k]
        del X
    torch.cuda.empty_cache()
    print(f"  walls (recurrence + Ritz): {json.dumps({a: round(b, 4) for a, b in walls.items()})} s;"
          f" sharded launches {json.dumps(launches)}")
    check(launches["stencil_spmv"]["float32"] >= 2 * n,
          f"the sharded recurrence launched the SpMV {launches['stencil_spmv']['float32']} times")
    d_flag = np.abs(thetas["sharded"] - np.sort(flagship[torch.float32]["vals"])).max()
    d_one = np.abs(thetas["sharded"] - thetas["unsharded"]).max()
    print(f"  lowest {k} Ritz values: max |sharded - phase 5 eigsh| {d_flag:.3e}, max |sharded - "
          f"unsharded| {d_one:.3e} MeV (gate eps32 ||H||_G = {tol:.3e})")
    check(max(d_flag, d_one) <= tol, "the sharded flagship's Ritz values are off the unsharded")

    print("  rank slabs at D = 4 and 8: local_matvec(x_r, from_prev, from_next) vs the global "
          "matvec's rows; the slab kernels vs their plain version")
    max_abs = 0.0
    gen = torch.Generator(device="cuda").manual_seed(21)
    rows_t = {}
    for dtype in (torch.float32, torch.float64):
        Hd = H if dtype == torch.float32 else lt.build_regular_hamiltonian(
            N, 25.0, lt.deuteron_potential_3d, stencil="27", dtype=dtype, device="cuda")
        x = torch.randn(Hd.shape[0], generator=gen, device="cuda", dtype=dtype)
        y_ref = Hd.matvec(x)
        plane = N * N
        for d in (4, 8):
            ops = slab_ops(Hd, d)
            rows = Hd.shape[0] // d
            for r, op in enumerate(ops):
                xr = x[r * rows:(r + 1) * rows]
                prev = x.roll(plane - r * rows)[:plane]
                nxt = x.roll(-(r + 1) * rows)[:plane]
                against_plain(f"{str(dtype)[6:]:8s} D={d} rank {r} slab {op.slab.grid_shape[0]} "
                              "planes vs global", op.local_matvec(xr, prev, nxt),
                              y_ref[r * rows:(r + 1) * rows])
            op = ops[1]
            for kop in (op.slab, op.corr):
                xk = torch.randn(kop.shape[0], generator=gen, device="cuda", dtype=dtype)
                max_abs = max(max_abs, against_plain(
                    f"{str(dtype)[6:]:8s} stencil_spmv D={d} {'x'.join(map(str, kop.grid_shape))}",
                    sk.stencil_spmv(kop, xk), sk.stencil_spmv_reference(kop, xk)))
            if dtype == torch.float32:
                rows_t[d] = slab_row(op.slab, f"stencil_spmv D={d} slab", copy_gbs, floor_ms)
        del Hd, x, y_ref
        torch.cuda.empty_cache()

    st = benchmark_matvec(H)
    share = st.effective_gbps / copy_gbs
    print(f"  benchmark_matvec(flagship): {st}; {share:.1%} of the copy rate (held in [50%, 100%])")
    check(0.5 <= share <= 1.0, f"benchmark_matvec reads {share:.1%} of the copy rate")
    del H, Hs
    torch.cuda.empty_cache()
    return dict(walls=walls, launches=launches, max_abs=max_abs, slab_rows=rows_t,
                benchmark_gbps=st.effective_gbps)


def slab_row(slab, label, copy_gbs, floor_ms, peak_flops=PEAK_FP32_FLOPS):
    """Kernel, plain and cuSPARSE times of the SpMV on one rank's slab."""
    from lanczos_tpu_torch.ops import stencil_kernels as sk

    m = slab.shape[0]
    elem = slab.weights.element_size()
    gen = torch.Generator(device="cuda").manual_seed(22)
    xs = itertools.cycle([torch.randn(m, generator=gen, device="cuda", dtype=slab.dtype)
                          for _ in range(8)])
    csr = stencil_csr(slab)
    row = kernel_row(f"{label} {'x'.join(map(str, slab.grid_shape))}",
                     lambda: sk.stencil_spmv(slab, next(xs)),
                     lambda: sk.stencil_spmv_reference(slab, next(xs)),
                     lambda: torch.mv(csr, next(xs)),
                     (2 if slab.diag is None else 3) * elem * m, 2 * len(slab.offsets) * m,
                     copy_gbs, floor_ms, plain_launches=10, peak_flops=peak_flops)
    row["copy_share"] = (2 if slab.diag is None else 3) * elem * m / copy_gbs / 1e6 / row["ms"]
    del csr
    return row


def hold_sharded_levels(so, label, gen):
    """The SpMV kernel of every level of a sharded CompositeV2 against its
    plain version, at the shapes its matvec launches it: the rank's slab
    and the 4-plane halo-correction grid.  Returns the max abs error."""
    from lanczos_tpu_torch.ops import stencil_kernels as sk

    worst = 0.0
    for lv in so.levels:
        check(lv.kernel, f"{label}: a level slab is outside the SpMV kernel's domain")
        for kop in (lv.slab, lv.corr):
            xk = torch.randn(kop.shape[0], generator=gen, device="cuda", dtype=kop.dtype)
            worst = max(worst, against_plain(
                f"{str(kop.dtype)[6:]:8s} stencil_spmv {label} {'x'.join(map(str, kop.grid_shape))}",
                sk.stencil_spmv(kop, xk), sk.stencil_spmv_reference(kop, xk)))
    return worst


def phase_sharded_composite2(lt, mesh, n216, n120, northstar_ref, unsharded, copy_gbs,
                             floor_ms):
    """Phase 22: shard_operator of phase 15's n_fine=216 operator and of the
    N=120 deuteron CompositeV2 over the one-rank mesh, matvecs against the
    unsharded ones in fp32 and fp64, and each level's slab and correction
    kernels against their plain version; the slab kernels of the n_fine=216
    levels at D = 4 against their plain version and timed; the n_fine=72
    pipeline with its fp32 solve sharded, held as phase 14, its cycles
    captured, against the same solve with eager cycles and beside phase
    14's unsharded solve."""
    from lanczos_tpu_torch.ops import stencil_kernels as sk
    from lanczos_tpu_torch.ops.dd import to_float64
    from lanczos_tpu_torch.parallel import shard_operator
    from lanczos_tpu_torch.utils.metrics import exchange_stats

    print(f"== sharded CompositeV2 over {mesh}: matvecs against the unsharded operators")
    gen = torch.Generator(device="cuda").manual_seed(23)
    cases = []
    for name, op32 in (("n_fine=216", n216), ("N=120", n120)):
        for o in (op32, to_float64(op32)):
            x = torch.randn(o.shape[0], generator=gen, device="cuda", dtype=o.dtype) * o.live
            cases.append((name, o, x, o.matvec(x)))
    reset_launches()  # the sharded matvecs' own launches, read below
    sharded = []
    for name, o, x, want in cases:
        so = shard_operator(o, mesh)
        xs = torch.as_tensor(so.host.to_sharded(x.cpu().numpy()), device="cuda")
        y = torch.as_tensor(so.host.from_sharded(so.matvec(xs).cpu().numpy()), device="cuda")
        against_plain(f"{str(o.dtype)[6:]:8s} {name} sharded matvec vs unsharded", y, want)
        ex = exchange_stats(so, mesh.size)
        print(f"    runs per level {[len(r) for r in so.support_runs]}; exchange at D=1 "
              f"{ex['per_device_recv_elements']} elements ({100 * ex['fraction_of_m']:.2f}% of M)")
        sharded.append((name, so))
    launches = read_launches()
    del cases
    print(f"  launches in the sharded matvecs {json.dumps(launches)}")
    for name in ("stencil_spmv", "apply_fused_interface"):
        check(launches[name]["float32"] > 0 and launches[name]["float64"] > 0,
              f"the sharded CompositeV2 did not launch {name} in both dtypes")

    print("  the level kernels of the sharded matvecs (slab and halo correction) vs plain")
    max_abs, rows_t = 0.0, {}
    for name, so in sharded:
        max_abs = max(max_abs, hold_sharded_levels(so, name, gen))
    del sharded

    print("  the n_fine=216 level slabs at D = 4 (18 and 27 planes): kernel vs plain, and times")
    for level in n216.level_ops:
        op = slab_ops(level, 4)[0]
        for dtype in (torch.float32, torch.float64):
            kop = op.slab if dtype == torch.float32 else to_float64(op.slab)
            xk = torch.randn(kop.shape[0], generator=gen, device="cuda", dtype=dtype)
            max_abs = max(max_abs, against_plain(
                f"{str(dtype)[6:]:8s} stencil_spmv D=4 slab {'x'.join(map(str, kop.grid_shape))}",
                sk.stencil_spmv(kop, xk), sk.stencil_spmv_reference(kop, xk)))
        rows_t["x".join(map(str, op.slab.grid_shape))] = slab_row(
            op.slab, "stencil_spmv n_fine=216 D=4 slab", copy_gbs, floor_ms)

    n72_abs, _, solve_launches, n72 = phase_northstar_small(mesh=mesh, ref=northstar_ref,
                                                           unsharded=unsharded)
    return dict(launches=launches, solve_launches=solve_launches,
                max_abs=max(max_abs, n72_abs["stencil_spmv"]), slab_rows=rows_t,
                n72_against_eager=n72["against_eager"])


def phase_composite_v1(lt, mesh, host):
    """Phase 23: the v1 CompositeOperator at N=120 through eigs_nonsym,
    unsharded and through shard_composite over the one-rank mesh, held to
    the N=120 golden as phase 9 holds it; lanczos_sharded on shard_operator
    and shard_ell_halo of the N=60 ELL against the unsharded recurrence."""
    from lanczos_tpu_torch.ops.composite import shard_composite
    from lanczos_tpu_torch.parallel import lanczos_sharded, shard_ell_halo, shard_operator
    from lanczos_tpu_torch.solver import graphs

    print("== v1 CompositeOperator at N=120 (fp32): eigs_nonsym(k=8, max_basis=300, tol=1e-4), "
          f"unsharded and sharded over {mesh}, vs lanczos_tpu fp64 golden")
    golden = load_golden(120)
    lat, _, norms = host["N=120"]
    t0 = time.perf_counter()
    comp, perm = lt.assemble_irregular_hamiltonian_composite(
        lat, lt.deuteron_potential_3d, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    print(f"  assembly {time.perf_counter() - t0:.2f} s: {comp.shape[0]} points, levels "
          f"{[(lv.nbox, lv.m) for lv in comp.levels]} (boxes, points a side), "
          f"{comp.ifc_rows.shape[0]} interface rows")
    v_lat = np.random.default_rng(99).uniform(-1.0, 1.0, lat.num_points)
    sc = shard_composite(comp, mesh.size)
    sop, v_sharded = sc.as_operator(mesh), sc.to_sharded(v_lat[perm])
    out = {}
    # Each solve runs its cycles as CUDA graphs (the sharded one with its
    # NCCL collectives inside), and again with the eager body.
    for label, op, v0 in (("unsharded", comp, v_lat[perm]),
                          ("unsharded, eager cycles", comp, v_lat[perm]),
                          ("shard_composite", sop, v_sharded),
                          ("shard_composite, eager cycles", sop, v_sharded)):
        reset_launches()
        graphs.reset_stats()
        torch.cuda.synchronize()
        with cycle_clock() as marks:
            t0 = time.perf_counter()
            with graphs.eager() if "eager" in label else contextlib.nullcontext():
                res = lt.eigs_nonsym(op, k=8, max_basis=300, tol=1e-4, v0=v0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        st = graph_stats()
        print(f"  {label}: {len(st['cycles'])} cycles, graphs captured {st['captures']} in "
              f"{st['capture_s']:.3f} s, replays {st['replays']}")
        if "eager" not in label:
            check(st["eager"] == 1 and st["replays"] == len(st["cycles"]) - 1,
                  f"v1 {label}: the cycles after the first did not all replay a graph")
        vals, resid = res.eigenvalues.cpu().numpy(), res.residuals.cpu().numpy()
        print(f"  {label}: wall {wall:.3f} s, launches {json.dumps(read_launches())}")
        check(bool(torch.isfinite(res.eigenvectors).all()) and np.isfinite(vals).all(),
              f"v1 {label}: non-finite result")
        # The golden holds the 8 lowest values; a single-vector solve may
        # hold fewer copies of a multiplet and reach past them.  Pairs above
        # the golden's range are printed, not held.
        top = max(golden["eigenvalues"]) + 1e-2
        for lam, r in zip(vals[vals > top], resid[vals > top]):
            print(f"    {lam:14.8f} resid {r:.3e} - (above the golden range)")
        worst, n_checked = check_against(f"v1 N=120 fp32 {label} vs lanczos_tpu fp64",
                                         vals[vals <= top], resid[vals <= top], golden, EPS32,
                                         norms, 1e-4)
        out[label] = dict(wall=wall, worst=worst, checked=n_checked, stats=st, marks=marks,
                          vals=vals)
        del res
    # The sharded solve's cycles, captured against eager: the walls above,
    # a cycle's wall and device time.
    sharded = {mode: out[label] for mode, label in (("captured", "shard_composite"),
                                                    ("eager", "shard_composite, eager cycles"))}
    busy = captured_against_eager(
        "sharded v1 N=120 fp32 eigs_nonsym",
        lambda c: lt.eigs_nonsym(sop, k=8, max_basis=300, tol=1e-4, v0=v_sharded,
                                 max_cycles=c or 60).eigenvalues.cpu().numpy(),
        {mode: (r["wall"], r["stats"], r["marks"], r["vals"]) for mode, r in sharded.items()})
    d = float(np.abs(sharded["captured"]["vals"] - sharded["eager"]["vals"]).max())
    print(f"  sharded v1: captured - eager eigenvalues max |diff| {d:.3e}; walls: sharded "
          f"captured {sharded['captured']['wall']:.3f} s, sharded eager "
          f"{sharded['eager']['wall']:.3f} s, unsharded captured {out['unsharded']['wall']:.3f} s, "
          f"unsharded eager {out['unsharded, eager cycles']['wall']:.3f} s; {card_label()}")
    for label in list(out):
        out[label] = {key: out[label][key] for key in ("wall", "worst", "checked")}
    busy.pop("captured_result")
    busy.pop("eager_result")
    out["sharded_against_eager"] = dict(busy, eigenvalues_max_diff=d)
    del comp, sc, sop
    torch.cuda.empty_cache()

    print("== lanczos_sharded(n=100) on the N=60 ELL (fp32): shard_operator (all-gather) and "
          "shard_ell_halo vs the unsharded recurrence")
    ell = lt.assemble_irregular_hamiltonian(host["N=60"][0], lt.deuteron_potential_3d,
                                            dtype=torch.float32, device="cuda")
    ref = lt.lanczos(ell, 100, seed=5)
    a_ref, b_ref = ref.alpha.double().cpu().numpy(), ref.beta.double().cpu().numpy()
    for label, op in (("shard_operator", shard_operator(ell, mesh)),
                      ("shard_ell_halo", shard_ell_halo(ell, mesh))):
        fac = lanczos_sharded(op, 100, seed=5)
        da = np.abs(fac.alpha.double().cpu().numpy() - a_ref).max() / np.abs(a_ref).max()
        db = np.abs(fac.beta.double().cpu().numpy() - b_ref).max() / np.abs(b_ref).max()
        print(f"  {label}: max |alpha - alpha_1| / max |alpha_1| {da:.3e}, beta {db:.3e} "
              f"(gate 1e-5)")
        check(max(da, db) <= 1e-5, f"lanczos_sharded on {label} is off the unsharded recurrence")
    del ell, ref
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# The tools: the irregular flagship script, the SciPy race, the ELL packer


def phase_tools(lt, lat60):
    import tempfile

    from lanczos_tpu_torch import native

    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import irregular_flagship_torch
    import merge_race_torch
    import northstar_scipy_torch

    print("== tools: irregular_flagship_torch at N=60, the SciPy race at n_fine=48, the ELL "
          "packer")
    golden = load_golden(60)
    out = {}
    reset_launches()
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        path = os.path.join(d, "irr60.json")
        check(irregular_flagship_torch.main(["--n-fine", "60", "--out", path]) == 0,
              "irregular_flagship_torch at N=60 failed")
        with open(path) as f:
            irr = json.load(f)
        out["flagship_s"] = time.perf_counter() - t0
        print(f"  irregular_flagship_torch N=60: {out['flagship_s']:.1f} s (solve "
              f"{irr['t_solve_s']:.2f} s, fp64 assembly {irr['t_assemble64_s']:.2f} s, refine "
              f"{irr['t_refine_s']:.2f} s, peak {irr['peak_device_gib']:.3f} GiB) on "
              f"{irr['device']}; refined residual max {irr['residual_max']:.3e}")
        check(irr["num_points"] == golden["num_points"], "N=60 lattice size differs")
        check(irr["residual_max"] <= 1e-10, f"N=60 refined residual {irr['residual_max']:.3e}")
        vals, rel = np.asarray(irr["eigenvalues"]), np.asarray(irr["true_rel_residuals"])
        # The golden holds the five lowest values: pairs above its range
        # are printed, not held (as phase 16).
        inside = vals <= max(golden["eigenvalues"]) + 1e-3
        check_against("N=60 fp64-refined (irregular_flagship_torch) vs fp64 golden",
                      vals[inside], rel[inside], golden, float(np.finfo(np.float64).eps),
                      (golden["norm_inf"], golden["norm_1"]), 1e-10)

        t0 = time.perf_counter()
        info, _ = _northstar().run(n_fine=48, device="cuda", verbose=False)
        port_path = os.path.join(d, "port48.json")
        with open(port_path, "w") as f:
            json.dump(info, f)
        t_port = time.perf_counter() - t0
        t0 = time.perf_counter()
        scipy_path = os.path.join(d, "scipy48.json")
        sc = northstar_scipy_torch.run(n_fine=48, out=scipy_path)
        t_scipy = time.perf_counter() - t0
        art = os.path.join(d, "race48.json")
        merge_race_torch.main([art, "--same-size", port_path, scipy_path])
        with open(art) as f:
            race = json.load(f).get("same_size_race", {})
        head = np.abs(np.asarray(info["eigenvalues_head"]) - np.asarray(sc["eigenvalues_head"]))
        print(f"  race n_fine=48 ({info['num_points']} points): port {t_port:.1f} s in all "
              f"(fp32 solve + refinement {info['t_solve_s']:.2f} s; pairs below 1e-8 "
              f"{info['pairs_below_1e-8']}), scipy {t_scipy:.1f} s in all (eigsh "
              f"{sc['scipy_eigsh_s']:.2f} s; pairs below 1e-8 {sc['pairs_below_1e-8']}); "
              f"speedup_vs_scipy {race.get('speedup_vs_scipy')}; max |head diff| {head.max():.3e}")
        check(race.get("scipy_status") == "done" and race.get("port_refine_completed")
              and "speedup_vs_scipy" in race, f"race n_fine=48 incomplete: {race}")
        check(head.max() <= 1e-8, f"race n_fine=48: lowest eigenvalues differ by {head.max():.3e}")
        out["race"] = {"port_total_s": race["port_total_s"], "scipy_eigsh_s": sc["scipy_eigsh_s"]}
    out["launches"] = read_launches()
    print(f"  launches (the N=60 flagship's v1 composite is plain PyTorch; the race's port run "
          f"launches the stencil kernels): {json.dumps(out['launches'])}")
    check(out["launches"]["stencil_spmv"]["total"] > 0
          and out["launches"]["stencil_spmm"]["total"] > 0,
          "the race's port run launched no stencil kernel")

    walls, ells = {}, {}
    real = native.pack_ell_native
    for way in ("native", "numpy", "native", "numpy"):
        native.pack_ell_native = real if way == "native" else (lambda *a: None)
        try:
            t0 = time.perf_counter()
            H = lt.assemble_irregular_hamiltonian(lat60, lt.deuteron_potential_3d,
                                                  dtype=torch.float64, device="cuda")
            torch.cuda.synchronize()
            walls.setdefault(way, []).append(time.perf_counter() - t0)
        finally:
            native.pack_ell_native = real
        ells[way] = (H.cols.cpu().numpy(), H.vals.cpu().numpy())
    print(f"  N=60 fp64 ELL {ells['native'][0].shape}: native packer "
          f"{fmt(walls['native'])} s, numpy {fmt(walls['numpy'])} s (engine built: "
          f"{native.available()})")
    check(native.available(), "the native engine did not build")
    check(all(np.array_equal(a, b) for a, b in zip(ells["native"], ells["numpy"])),
          "the native packer's ELL differs from numpy's")
    out["assembly_s"] = walls
    return out


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script drives the port on a GPU")
    if not os.path.isdir(os.path.join(HERE, "lanczos_tpu_torch")):
        fail(f"no lanczos_tpu_torch package beside {__file__}: run from a checkout")
    sys.path.insert(0, HERE)
    import lanczos_tpu_torch as lt

    t_start = time.perf_counter()
    phase_card()
    phase_build()
    max_abs = phase_kernels(lt)
    floor_ms = launch_floor()
    times, copy_gbs = phase_timing(lt, floor_ms)
    phase_golden(lt)
    flagship = phase_flagship(lt)
    cgs2 = phase_cgs2()
    print(f"== regular path done at {time.perf_counter() - t_start:.1f} s")

    print("== irregular lattices")
    lattices = irregular_lattices(lt)
    max_abs["apply_fused_interface"], ops, host = phase_interface_kernel(lt, lattices)
    phase_whole_operator(lt, ops, host)
    times["apply_fused_interface"] = phase_interface_timing(lt, ops, host, copy_gbs, floor_ms)
    phase_irregular_golden(lt, ops, host)
    phase_two_sided(lt, ops, host)
    n120 = ops[("N=120", torch.float32)][0]  # phase 22 shards it
    del ops
    torch.cuda.empty_cache()
    irregular = phase_irregular_flagship(lt, host)
    print(f"== irregular path done at {time.perf_counter() - t_start:.1f} s")

    n60 = {name: lat for name, lat, _ in lattices}["N=60"]
    phases = {
        11: phase_compensated_dots,
        12: lambda: phase_restarted_flagship(lt, flagship),
        13: lambda: phase_checkpoint(lt),
        14: phase_northstar_small,
        15: lambda: phase_northstar(NORTHSTAR_N_FINE),
        16: lambda: phase_nonsym_refine(lt, n60),
        17: lambda: phase_block_flagship(lt, results[12]),
        18: lambda: phase_cli_block(lt),
        19: lambda: phase_lookahead(lt, n60),
        20: lambda: phase_bench(copy_gbs),
        # Row sharding: one NCCL rank on the card (21-23).
        21: lambda: phase_sharded_flagship(lt, mesh, flagship, copy_gbs, floor_ms),
        22: lambda: phase_sharded_composite2(lt, mesh, results[15][2], n120, results[14][1],
                                             results[14][3], copy_gbs, floor_ms),
        23: lambda: phase_composite_v1(lt, mesh, host),
        24: lambda: phase_tools(lt, n60),
        25: lambda: phase_graph_cycles(lt, host),
    }
    results = {}
    import torch.distributed as dist

    try:
        for n, phase in phases.items():
            if n == 21:
                mesh = start_row_mesh()
            t0 = time.perf_counter()
            results[n] = phase()
            torch.cuda.empty_cache()
            print(f"== phase {n} done in {time.perf_counter() - t0:.1f} s "
                  f"(at {time.perf_counter() - t_start:.1f} s)")
    finally:
        if dist.is_initialized():
            # No captured graph holds the communicator past this point.
            gc.collect()
            torch.cuda.synchronize()
            dist.destroy_process_group()
    print(f"== all phases done at {time.perf_counter() - t_start:.1f} s")
    northstar, northstar_abs, _ = results[15]
    for errs in (results[14][0], northstar_abs):
        for name, err in errs.items():
            max_abs[name] = max(max_abs[name], err)
    for n in (21, 22):
        max_abs["stencil_spmv"] = max(max_abs["stencil_spmv"], results[n]["max_abs"])
    flagship = flagship[torch.float32]

    kernels = [
        dict(name="stencil_spmv", route="cuda", source="lanczos_tpu_torch/csrc/stencil.cu",
             replaces="lanczos_tpu/ops/pallas_kernels.py:451", launches=flagship["launches"][0]),
        dict(name="stencil_spmm", route="cuda", source="lanczos_tpu_torch/csrc/stencil.cu",
             replaces="lanczos_tpu/ops/pallas_kernels.py:465", launches=flagship["launches"][1]),
        dict(name="apply_fused_interface", route="cuda",
             source="lanczos_tpu_torch/csrc/interface.cu",
             replaces="lanczos_tpu/ops/interface_kernel.py:226",
             launches=irregular["launches"][0]),
    ]
    for k in kernels:
        t = times[k["name"]]
        k.update(max_abs_err=max_abs[k["name"]], **t,
                 northstar_launches_by_dtype=northstar["launches"][k["name"]],
                 block_launches={dt: ls[k["name"]] for dt, ls in results[17].items()},
                 cli_block_launches=results[18][k["name"]],
                 lookahead_launches=results[19][k["name"]],
                 bench_launches=results[20][k["name"]],
                 sharded_launches={
                     "flagship": results[21]["launches"][k["name"]],
                     "composite_v2_matvecs": results[22]["launches"][k["name"]],
                     "northstar_n72_solve": results[22]["solve_launches"][k["name"]]},
                 tools_launches=results[24]["launches"][k["name"]])
        if k["name"] == "stencil_spmv":
            k["sharded_slab_times"] = {
                **{f"N160_D{d}": row for d, row in results[21]["slab_rows"].items()},
                **{f"n216_D4_{g}": row for g, row in results[22]["slab_rows"].items()}}
    kernels.append(dict(
        name="cgs2", route="cuda", source="lanczos_tpu_torch/csrc/cgs2.cu",
        replaces="no TPU kernel: the JAX package's CGS2 (lanczos_tpu/solver/lanczos.py:"
                 "_orthogonalize) is plain matmuls",
        launches=flagship["launches"][2], **cgs2))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
