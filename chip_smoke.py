"""Drive the PyTorch port's regular-grid eigsh path on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each of which fails the run (non-zero exit, no result line):

1. The card: ``nvidia-smi`` name and power limit, torch/CUDA versions, TF32 flags.
2. Build: the stencil kernels from ``lanczos_tpu_torch/csrc`` for sm_90a,
   with nvcc's ``-Xptxas -v`` report.
3. Each kernel against its plain PyTorch version, on the same CUDA tensors,
   in fp32 and fp64, at the test shapes and at the flagship N=160^3; then
   kernel and plain times at N=160^3 (CUDA events).
4. ``eigsh`` at N=64 (k=8, n=150, fp32) against golden eigenvalues that the
   JAX package computed in fp64 (``lanczos_tpu_torch/data/golden_eigsh_n64.json``).
5. The flagship: N=160^3, L=25 fm, 27-point, ``eigsh(k=20, n=400, "SA")``
   in fp32, with the kernels' launch counts, then the same solve in fp64.

The line before the last is a JSON object of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

import itertools
import json
import os
import statistics
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


def cuda_ms(fn, launches=100, samples=5):
    """Median ms per call over ``samples`` runs of ``launches`` calls, timed
    with CUDA events after one warm-up call; also returns every sample."""
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / launches)
    return statistics.median(per_call), per_call


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
    """(name, operator) at the CPU tests' shapes plus the flagship."""
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
    return [
        ("N12_27pt", reg(12, "27")),
        ("N10_7pt", reg(10, "7")),
        ("N8_27pt", reg(8, "27")),
        ("6x10x14_asym_nodiag", aniso),
        ("8x16x8_diag", flat),
        ("N16_27pt_graded", reg(16, "27")),
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
    from lanczos_tpu_torch.ops._build import load_stencil_library

    _, info = load_stencil_library()
    print("== build")
    print(f"library {os.path.relpath(info.path, HERE)} "
          f"({'already built' if info.cached else 'built'}; "
          f"nvcc {info.seconds:.2f} s)")
    for line in info.log.splitlines():
        if "ptxas" in line:
            print(f"  {line.strip()}")


def phase_kernels(lt):
    """Kernel vs plain version at every shape; returns max abs error per kernel."""
    from lanczos_tpu_torch.ops import stencil_kernels as sk

    print("== kernels vs plain version (max abs err, max abs err / max |y_ref|)")
    tol = {torch.float32: (2e-5, 1e-4), torch.float64: (1e-12, 1e-12)}
    max_abs = {"stencil_spmv": 0.0, "stencil_spmm": 0.0}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float32, torch.float64):
        # fp32: the tolerance of the JAX package's kernel tests (the sums run
        # in another order); fp64: both sides take the same taps in the same
        # order and differ only by FMA contraction.
        atol_scale, rtol = tol[dtype]
        for name, op in kernel_cases(lt, dtype):
            m = op.shape[0]
            for kname, b in (("stencil_spmv", None), ("stencil_spmm", 3), ("stencil_spmm", 20)):
                shape = (m,) if b is None else (m, b)
                x = torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
                if b is None:
                    y, y_ref = sk.stencil_spmv(op, x), sk.stencil_spmv_reference(op, x)
                else:
                    y, y_ref = sk.stencil_spmm(op, x), sk.stencil_spmm_reference(op, x)
                torch.cuda.synchronize()
                scale = float(y_ref.abs().max())
                err = (y - y_ref).abs()
                ok = bool((err <= atol_scale * scale + rtol * y_ref.abs()).all())
                abs_err = float(err.max())
                max_abs[kname] = max(max_abs[kname], abs_err)
                label = kname if b is None else f"{kname} b={b}"
                print(f"  {str(dtype)[6:]:8s} {name:22s} {label:18s} "
                      f"{abs_err:.3e} {abs_err / scale:.3e} {'ok' if ok else 'MISMATCH'}")
                check(ok, f"{label} disagrees with its plain version on {name} {dtype}")
    return max_abs


def phase_timing(lt):
    """Kernel and plain times at N=160^3, fp32; returns ms per kernel."""
    from lanczos_tpu_torch.ops import stencil_kernels as sk

    print("== times at N=160^3, 27-point, fp32 (CUDA events, median of 5 x 100 calls)")
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

    def rot(fn):
        return lambda: fn(op, next(xs))

    buf = torch.empty(64 * 2**20, device="cuda")  # 256 MB
    dst = torch.empty_like(buf)
    copy_ms, _ = cuda_ms(lambda: dst.copy_(buf))
    copy_gbs = 2 * buf.numel() * 4 / copy_ms / 1e6
    print(f"  device-to-device copy (256 MB read + 256 MB write): {copy_ms:.4f} ms "
          f"= {copy_gbs:.1f} GB/s")

    rows = {}
    for kname, fn, ref, bytes_per_call in (
        ("stencil_spmv", rot(sk.stencil_spmv), rot(sk.stencil_spmv_reference), 12 * m),
        ("stencil_spmm", lambda: sk.stencil_spmm(op, X),
         lambda: sk.stencil_spmm_reference(op, X), (8 * 20 + 4) * m),
    ):
        ms, samples = cuda_ms(fn)
        plain_ms, plain_samples = cuda_ms(ref)
        rows[kname] = (ms, plain_ms)
        label = kname if kname == "stencil_spmv" else f"{kname} b=20"
        print(f"  {label:18s} kernel {ms:.4f} ms ({bytes_per_call / ms / 1e6:.1f} GB/s "
              f"of compulsory traffic, {bytes_per_call / ms / 1e6 / copy_gbs:.1%} of copy); "
              f"plain {plain_ms:.4f} ms; samples kernel {['%.4f' % s for s in samples]} "
              f"plain {['%.4f' % s for s in plain_samples]}")
    return rows


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
        t0 = time.perf_counter()
        res = lt.eigsh(H, k=k, n=n, which="SA", v0=v0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = (sk.stencil_spmv.launches, sk.stencil_spmm.launches)
        peak = torch.cuda.max_memory_allocated()
        print(f"  {str(dtype)[6:]}: wall {wall:.3f} s, peak device memory "
              f"{peak / 2**30:.2f} GiB, launches spmv {launches[0]} spmm {launches[1]}")
        print(res.summary(print_nr=k))
        vals = res.eigenvalues.double().cpu().numpy()
        check(tuple(res.eigenvalues.shape) == (k,)
              and tuple(res.eigenvectors.shape) == (N**3, k), "flagship result shapes")
        for name, t in (("eigenvalues", res.eigenvalues), ("eigenvectors", res.eigenvectors),
                        ("residuals", res.residuals), ("inner_prod", res.inner_prod)):
            check(bool(torch.isfinite(t).all()), f"flagship {dtype}: non-finite {name}")
        check(launches[0] >= n, f"spmv launched {launches[0]} times, expected >= {n}")
        check(launches[1] >= 1, f"spmm launched {launches[1]} times, expected >= 1")
        runs[dtype] = dict(vals=vals, res=res, wall=wall, peak=peak, launches=launches,
                           tol=fp32_tolerance(H))
        del H, res
        torch.cuda.empty_cache()
    ref = runs[torch.float64]
    accepted = ref["res"].good_mask()
    check(accepted[0], "flagship fp64: ground state not accepted")
    compare_eigs("flagship fp32 vs fp64 (same v0)", runs[torch.float32]["vals"],
                 ref["vals"], accepted, runs[torch.float32]["tol"])
    return runs[torch.float32]


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script drives the port on a GPU")
    if not os.path.isdir(os.path.join(HERE, "lanczos_tpu_torch")):
        fail(f"no lanczos_tpu_torch package beside {__file__}: run from a checkout")
    sys.path.insert(0, HERE)
    import lanczos_tpu_torch as lt

    phase_card()
    phase_build()
    max_abs = phase_kernels(lt)
    times = phase_timing(lt)
    phase_golden(lt)
    flagship = phase_flagship(lt)

    replaces = {
        "stencil_spmv": "lanczos_tpu/ops/pallas_kernels.py:451",
        "stencil_spmm": "lanczos_tpu/ops/pallas_kernels.py:465",
    }
    kernels = [
        dict(name=name, route="cuda", source="lanczos_tpu_torch/csrc/stencil.cu",
             replaces=replaces[name], launches=flagship["launches"][i],
             max_abs_err=max_abs[name], ms=times[name][0], plain_ms=times[name][1])
        for i, name in enumerate(("stencil_spmv", "stencil_spmm"))
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
