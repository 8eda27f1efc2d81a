"""Time the port's kernels and the N=120 CompositeV2 matvec on one GPU, for
the ``lanczos_tpu_torch`` package under a given root.

    python scripts/time_torch_kernels.py [--root DIR] [--label NAME]

``--root`` (default: this checkout) names the directory whose package is
imported, so one call can time two trees on the same card: unpack the other
commit beside this one (``git archive``) and run A, B, B, A.  The timing
helpers always come from this checkout (``lanczos_tpu_torch/utils/timing.py``,
loaded by path).  All in fp32, each case as graph-replay ms per launch (a
CUDA graph of the calls, rotating inputs fixed at capture) and eager ms per
call (CUDA events around a loop of calls, which the host paces when its
work per call outlasts the kernels):

* ``stencil_spmv`` on the regular N=160^3 27-point Hamiltonian and on the
  N=120 irregular lattice's two level grids (40^3, 60^3);
* ``stencil_spmm`` with b=20 at N=160^3, and with b=8 (the Arnoldi
  residual block's width) on the two level grids;
* ``apply_fused_interface`` of A at N=120 (138 classes, 11,598 rows);
* ``CompositeV2.matvec`` at N=120;
* CGS2, two passes against V[:j] at the regular cell's M = 4,096,000, in
  fp32 and fp64 with j = 200 and 399: ``ops/cgs2_kernels.py:cgs2`` (three
  sweeps) and one step of the lagged recurrence, ``cgs2_lagged`` with a
  row to finish (two sweeps), where the package has them, and the plain
  loop (two cuBLAS GEMVs a pass) in either tree (these cases alone also
  in fp64);
* the Ritz rotation of the regular cell's 20 selected pairs, V^T W[:, cols]
  at M = 4,096,000 and n = 400 in fp32 and fp64:
  ``ops/ritz_kernels.py:rotate`` where the package has it, cuBLAS's
  ``V.T @ W[:, cols]``, and (fp32) the full ``V.T @ W``, by cuBLAS in
  either tree and by the kernel's 17 chunks where the package has it;
* the launch floor: a one-element ``fill_`` replayed the same way.

Prints one line per case and, last, one JSON object of them all.
"""

import argparse
import importlib.util
import itertools
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _timing():
    spec = importlib.util.spec_from_file_location(
        "_timing", os.path.join(HERE, "lanczos_tpu_torch", "utils", "timing.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE, help="directory holding lanczos_tpu_torch")
    ap.add_argument("--label", default=None, help="name printed with the results")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    t = _timing()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import lanczos_tpu_torch as lt
    from lanczos_tpu_torch.ops import interface_kernel as ik
    from lanczos_tpu_torch.ops import stencil_kernels as sk

    label = args.label or root
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"# {label}: package {os.path.dirname(lt.__file__)}; card {card}")
    gen = torch.Generator(device="cuda").manual_seed(5)
    out = {"label": label, "card": card}

    def case(name, fn, launches=50, eager_launches=100):
        g, g_s = t.graph_ms(fn, launches=launches)
        e, e_s = t.eager_ms(fn, launches=eager_launches)
        out[name] = {"graph_ms": g, "eager_ms": e, "graph_min_ms": min(g_s), "eager_min_ms": min(e_s)}
        print(f"  {name:34s} graph {g:.5f} ms (min {min(g_s):.5f})  eager {e:.5f} ms "
              f"(min {min(e_s):.5f})", flush=True)

    def rotating(m, k=8, scale=None):
        xs = [torch.randn(m, generator=gen, device="cuda") for _ in range(k)]
        return itertools.cycle([x * scale for x in xs] if scale is not None else xs)

    fill = torch.zeros(1, device="cuda")
    case("launch_floor", lambda: fill.fill_(1.0))

    H = lt.build_regular_hamiltonian(160, 25.0, lt.deuteron_potential_3d, stencil="27",
                                     dtype=torch.float32, device="cuda")
    xs = rotating(H.shape[0])
    case("stencil_spmv N=160^3", lambda: sk.stencil_spmv(H, next(xs)))
    X = torch.randn((H.shape[0], 20), generator=gen, device="cuda")
    case("stencil_spmm N=160^3 b=20", lambda: sk.stencil_spmm(H, X), launches=5, eager_launches=10)
    del H, X, xs
    torch.cuda.empty_cache()

    lat = lt.build_lattice(120, 25.0, 3, potential=lt.deuteron_potential_3d)
    op, _ = lt.assemble_irregular_hamiltonian_composite2(
        lat, lt.deuteron_potential_3d, dtype=torch.float32, device="cuda")
    for level in op.level_ops:
        grid = "x".join(map(str, level.grid_shape))
        xl = rotating(level.shape[0])
        case(f"stencil_spmv level {grid}",
             lambda level=level, xl=xl: sk.stencil_spmv(level, next(xl)))
        Xl = torch.randn((level.shape[0], 8), generator=gen, device="cuda")
        case(f"stencil_spmm b=8 level {grid}", lambda level=level, Xl=Xl: sk.stencil_spmm(level, Xl))
    xo = rotating(op.shape[0], scale=op.live)
    y = torch.zeros(op.shape[0], device="cuda")
    case("apply_fused_interface N=120 A", lambda: ik.apply_fused_interface(op.fused, next(xo), y))
    case("CompositeV2.matvec N=120", lambda: op.matvec(next(xo)))
    del op, xo, y
    torch.cuda.empty_cache()

    try:
        from lanczos_tpu_torch.ops import cgs2_kernels as ck
    except ImportError:  # a tree from before the kernel
        ck = None

    def loop(V, v):
        for _ in range(2):
            v = v - (V @ v) @ V
        return v

    lagged = getattr(ck, "cgs2_lagged", None)
    m = 4_096_000
    for dtype in (torch.float32, torch.float64):
        # Row j is the lagged step's output; its finish moves row j - 1 by
        # ~1e-7 of itself a call, which changes no time.  Each lagged case
        # takes a unit vector of its own: one that an earlier case stored
        # as a row would lie in the span and raise the finish-now flag.
        V = torch.randn(400, m, generator=gen, device="cuda", dtype=dtype) / m**0.5
        v = torch.randn(m, generator=gen, device="cuda", dtype=dtype) / m**0.5
        for j in (200, 399):
            tag = f"{str(dtype)[6:]} j={j}"
            if ck is not None:
                case(f"cgs2 {tag}", lambda j=j: ck.cgs2(V[:j], v, 2), launches=5,
                     eager_launches=10)
            if lagged is not None:
                hp = torch.randn(j - 1, generator=gen, device="cuda", dtype=dtype) * 1e-7
                u = torch.randn(m, generator=gen, device="cuda", dtype=dtype)
                u /= u.norm()
                case(f"cgs2 lagged {tag}", lambda j=j, hp=hp, u=u: lagged(V, j, u, hp, 2),
                     launches=5, eager_launches=10)
            case(f"cgs2 loop {tag}", lambda j=j: loop(V[:j], v), launches=5, eager_launches=10)
        del V, v
        torch.cuda.empty_cache()

    try:
        from lanczos_tpu_torch.ops import ritz_kernels as rk
    except ImportError:  # a tree from before the kernel
        rk = None
    n, k = 400, 20
    for dtype in (torch.float32, torch.float64):
        tag = f"{str(dtype)[6:]} n={n}"
        V = torch.randn(n, m, generator=gen, device="cuda", dtype=dtype) / m**0.5
        W = torch.linalg.qr(torch.randn(n, n, generator=gen, device="cuda",
                                        dtype=torch.float64)).Q.to(dtype)
        cols = torch.randperm(n, generator=gen, device="cuda")[:k]
        if rk is not None:
            case(f"ritz rotate {tag} k={k}", lambda: rk.rotate(V, W, cols), launches=5,
                 eager_launches=10)
        case(f"ritz cuBLAS V.T@W[:,sel] {tag} k={k}", lambda: V.T @ W[:, cols], launches=5,
             eager_launches=10)
        if dtype == torch.float32:
            if rk is not None:
                case(f"ritz rotate full {tag}", lambda: rk.rotate(V, W), launches=2,
                     eager_launches=2)
            case(f"ritz cuBLAS full V.T@W {tag}", lambda: V.T @ W, launches=2, eager_launches=2)
        del V, W
        torch.cuda.empty_cache()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
