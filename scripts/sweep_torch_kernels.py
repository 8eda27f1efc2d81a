"""Sweep the tuning constants of the port's redesigned kernels on one GPU.

    python scripts/sweep_torch_kernels.py

* The interface kernel's lanes per row and tap unroll (template parameters
  of ``csrc/interface.cu``): the source is built once more with
  ``-DFUSED_INTERFACE_SWEEP``, which adds an fp32 entry point taking both,
  and every pair of lanes in {4, 8, 16, 32} and unroll in {2, 4, 8, 16}
  runs on the N=120 lattice's A and A^T with the operator's own tables (they
  do not depend on either constant).
* The stencil SpMV's z-chunk (a launch argument): the N=120 lattice's 40^3
  and 60^3 level grids and the regular N=160^3 Hamiltonian, each at a range
  of chunks, the one ``spmv_z_chunk`` picks on this card marked.
* The stencil SpMM's outputs per thread (a template parameter of
  ``csrc/stencil.cu``: a second build with ``-DSTENCIL_SPMM_SWEEP`` adds an
  fp32 entry point taking 1, 2, 4 or 8), its tile (ty x tx points), column
  chunk cb and z-chunk (launch arguments): at N=160^3 with b=20 and on the
  level grids with b=8, the package's choice (``spmm_tile``,
  ``spmm_z_chunk``, 4 outputs a thread) marked.  A variant the launch
  refuses (more than 512 threads, or more copies a thread than it holds)
  is listed as refused.

Every variant is first held against the plain version (fp32 tolerance of
``chip_smoke.py``), then timed by graph replay (50 launches with rotating
inputs, the SpMM's 10; median of 20).  Prints one line per variant and, last, one JSON
object of them all.
"""

import ctypes
import itertools
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import lanczos_tpu_torch as lt  # noqa: E402
from lanczos_tpu_torch.ops import _build  # noqa: E402
from lanczos_tpu_torch.ops import interface_kernel as ik  # noqa: E402
from lanczos_tpu_torch.ops import stencil_kernels as sk  # noqa: E402
from lanczos_tpu_torch.utils.timing import graph_ms  # noqa: E402

#: The pair the package's entry points launch (launch's defaults in
#: csrc/interface.cu).
SHIPPED = (8, 8)

#: cudaErrorInvalidValue: the launch refused the variant's tile.
REFUSED = 1


def close(got, want):
    torch.testing.assert_close(got, want, rtol=1e-4, atol=2e-5 * float(want.abs().max()))


def stream():
    return torch.cuda.current_stream().cuda_stream


def sweep_interface(op, gen):
    info = _build._build(_build._CSRC / "interface.cu", "interface_sweep",
                         ("-DFUSED_INTERFACE_SWEEP",))
    fn = ctypes.CDLL(str(info.path)).fused_interface_sweep_f32
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i32, i32, ptr, ptr, i32, i32, ptr, ptr, ptr, ptr, ptr]
    fn.restype = i32
    print(f"== interface kernel at N=120, fp32 (sweep build: nvcc {info.seconds:.2f} s)")
    xs = [torch.randn(op.shape[0], generator=gen, device="cuda") * op.live for _ in range(8)]
    out = {}
    for lanes, unroll in itertools.product((4, 8, 16, 32), (2, 4, 8, 16)):
        times = {}
        for which, fi in (("A", op.fused), ("A^T", op.transpose_op.fused)):
            def launch(x, y, fi=fi):
                err = fn(lanes, unroll, x.data_ptr(), y.data_ptr(), 1, fi.num_rows,
                         fi.cls.data_ptr(), fi.taps.data_ptr(), fi.tap_w.data_ptr(),
                         fi.row_class.data_ptr(), stream())
                if err:
                    raise RuntimeError(f"launch failed with CUDA error {err}")

            y = torch.zeros_like(xs[0])
            launch(xs[0], y)
            close(y, ik.apply_fused_interface_reference(fi, xs[0], torch.zeros_like(y)))
            it = itertools.cycle(xs)
            times[which] = graph_ms(lambda: launch(next(it), y))[0]
        out[f"lanes {lanes} unroll {unroll}"] = times
        mark = "  (shipped)" if (lanes, unroll) == SHIPPED else ""
        print(f"  lanes {lanes:2d} unroll {unroll:2d}: A {times['A'] * 1e3:.3f} us, "
              f"A^T {times['A^T'] * 1e3:.3f} us{mark}", flush=True)
    return out


def sweep_z_chunk(name, op, gen, chunks):
    fn = sk._library().stencil_spmv_f32
    nz, ny, nx = op.grid_shape
    picked = sk.spmv_z_chunk(op.grid_shape, sk._resident_blocks(
        "stencil_spmv_resident_f32", torch.cuda.current_device()))
    w27 = sk._cache(op).w27
    d = None if op.diag is None else op.diag.data_ptr()
    xs = [torch.randn(op.shape[0], generator=gen, device="cuda") for _ in range(8)]
    print(f"== stencil_spmv z-chunk, {name} ({nz}x{ny}x{nx}, fp32); spmv_z_chunk picks {picked}")
    out = {}
    for zc in sorted({z for z in chunks if z <= nz} | {picked}):
        def launch(x, y, zc=zc):
            err = fn(x.data_ptr(), d, y.data_ptr(), nz, ny, nx, zc, w27, stream())
            if err:
                raise RuntimeError(f"launch failed with CUDA error {err}")

        y = torch.empty_like(xs[0])
        launch(xs[0], y)
        close(y, sk.stencil_spmv_reference(op, xs[0]))
        it = itertools.cycle(xs)
        out[zc] = graph_ms(lambda: launch(next(it), y))[0]
        mark = "  (picked)" if zc == picked else ""
        print(f"  zc {zc:3d}: {out[zc] * 1e3:.3f} us{mark}", flush=True)
    return {"picked": picked, "us": {z: t * 1e3 for z, t in out.items()}}


def sweep_spmm(name, op, b, gen, tiles, chunks):
    """Every outputs-per-thread r, tile (ty, tx, cb) of ``tiles`` and
    z-chunk of ``chunks`` (plus each tile's own pick) of the fp32 SpMM on
    ``op`` at width b."""
    info = _build._build(_build._CSRC / "stencil.cu", "stencil_sweep", ("-DSTENCIL_SPMM_SWEEP",))
    fn = ctypes.CDLL(str(info.path)).stencil_spmm_sweep_f32
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i32, ptr, ptr, ptr, *[i32] * 8, ptr, ptr]
    fn.restype = i32
    nz, ny, nx = op.grid_shape
    w27 = sk._cache(op).w27
    d = None if op.diag is None else op.diag.data_ptr()
    shipped_tile = sk.spmm_tile(b, 4)
    resident = sk._resident_blocks("stencil_spmm_resident_f32", torch.cuda.current_device(),
                                   b, *shipped_tile, int(op.diag is not None))
    picked = sk.spmm_z_chunk(op.grid_shape, b, shipped_tile, resident)
    print(f"== stencil_spmm, {name} ({nz}x{ny}x{nx}, b={b}, fp32; sweep build: nvcc "
          f"{info.seconds:.2f} s); package: r {sk.SPMM_OUTPUTS}, tile {shipped_tile}, "
          f"z-chunk {picked} ({resident} resident blocks)")
    Xs = [torch.randn((op.shape[0], b), generator=gen, device="cuda") for _ in range(4)]
    want = sk.stencil_spmm_reference(op, Xs[0])
    out = {}
    for r, tile in itertools.product((1, 2, 4, 8), tiles):
        tile_pick = sk.spmm_z_chunk(op.grid_shape, b, tile, resident)
        for zc in sorted({z for z in chunks if z <= nz} | {tile_pick}):
            def launch(X, Y, r=r, tile=tile, zc=zc):
                return fn(r, X.data_ptr(), d, Y.data_ptr(), nz, ny, nx, b, *tile, zc, w27,
                          stream())

            Y = torch.empty_like(Xs[0])
            key = f"r {r} tile {tile[0]}x{tile[1]} cb {tile[2]} zc {zc}"
            err = launch(Xs[0], Y)
            if err == REFUSED:
                out[key] = None
                print(f"  {key}: refused", flush=True)
                break
            if err:
                raise RuntimeError(f"{key}: launch failed with CUDA error {err}")
            close(Y, want)
            it = itertools.cycle(Xs)

            def call(Y=Y, launch=launch):
                if launch(next(it), Y):
                    raise RuntimeError("launch failed")

            out[key] = graph_ms(call, launches=10)[0]
            mark = ("  (package)" if (r, tile, zc) == (sk.SPMM_OUTPUTS, shipped_tile, picked)
                    else "")
            print(f"  {key}: {out[key] * 1e3:.3f} us{mark}", flush=True)
    return {"package": f"r {sk.SPMM_OUTPUTS} tile {shipped_tile[0]}x{shipped_tile[1]} cb "
                       f"{shipped_tile[2]} zc {picked}",
            "us": {k: None if t is None else t * 1e3 for k, t in out.items()}}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"# card {card}")
    gen = torch.Generator(device="cuda").manual_seed(8)
    result = {"card": card}
    lat = lt.build_lattice(120, 25.0, 3, potential=lt.deuteron_potential_3d)
    op, _ = lt.assemble_irregular_hamiltonian_composite2(
        lat, lt.deuteron_potential_3d, dtype=torch.float32, build_transpose=True, device="cuda")
    result["interface_us"] = {k: {w: t * 1e3 for w, t in v.items()}
                              for k, v in sweep_interface(op, gen).items()}
    chunks = (1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 20, 27, 32, 40, 54, 80, 160)
    result["z_chunk"] = {}
    result["spmm"] = {}
    level_tiles = [(8, tx, 8) for tx in (8, 16, 20, 32)] + [(4, 32, 8), (16, 16, 8)]
    for level in op.level_ops:
        name = "level " + "x".join(map(str, level.grid_shape))
        result["z_chunk"][name] = sweep_z_chunk(name, level, gen, chunks)
        result["spmm"][name] = sweep_spmm(name, level, 8, gen, level_tiles, (1, 2, 3, 4))
    del op
    H = lt.build_regular_hamiltonian(160, 25.0, lt.deuteron_potential_3d, stencil="27",
                                     dtype=torch.float32, device="cuda")
    result["z_chunk"]["N=160^3"] = sweep_z_chunk("N=160^3", H, gen, chunks)
    flagship_tiles = [(8, 4, 20), (8, 8, 20), (16, 8, 20), (8, 16, 20), (4, 16, 20),
                      (8, 8, 8), (8, 16, 8)]
    result["spmm"]["N=160^3"] = sweep_spmm("N=160^3", H, 20, gen, flagship_tiles, (10, 20, 40))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
