"""Where the block solver's time goes at N=160^3 on one GPU.

    python scripts/profile_torch_block.py      # ~2 min on one H100

For fp32 and fp64 it runs ``eigsh_block_restarted(k=20, block_size=4)`` on
the regular flagship (``chip_smoke.py``'s phase 17 tolerances) with a
synchronized host timer around each part (``_block_cycle`` and, inside it,
the SpMM, CGS2 and the tall-skinny QR; the Ritz rotation; the
Rayleigh–Ritz verification) and counts the breakdown cures; the timers'
synchronizations add to the wall.  Then it times the candidates for each
part on one (M, 4) block with CUDA events (``utils/timing.py``): cuSOLVER's
``torch.linalg.qr`` against Cholesky QR twice, CGS2's coefficients in
either orientation of the product, and the SpMM at b=4 by graph replay.
Last, a ``torch.profiler`` table of a three-cycle fp32 solve (host and
device activity), and the caching allocator's counters.
"""

import collections
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import lanczos_tpu_torch as lt  # noqa: E402
from lanczos_tpu_torch.ops import stencil_kernels as sk  # noqa: E402
from lanczos_tpu_torch.solver import block as pb  # noqa: E402
from lanczos_tpu_torch.utils.timing import eager_ms, graph_ms  # noqa: E402


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_block.py times the block solver on a GPU")
    seconds, calls = collections.defaultdict(float), collections.Counter()

    def timed(name, fn):
        def wrap(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seconds[name] += time.perf_counter() - t0
            calls[name] += 1
            return out
        return wrap

    cure = pb._qr_cure_breakdown

    def counted_cure(r, q, b, orth, j, **kwargs):
        out = cure(r, q, b, orth, j, **kwargs)
        calls["cures"] += out[0] is not q
        return out

    saved = {name: getattr(pb, name) for name in
             ("_qr_cure_breakdown", "_block_cycle", "_ritz_update", "_refined_block",
              "_tall_qr", "_orth_block")}
    pb._qr_cure_breakdown = counted_cure
    for name in ("_block_cycle", "_ritz_update", "_refined_block", "_tall_qr", "_orth_block"):
        setattr(pb, name, timed(name, saved[name]))
    print(torch.cuda.get_device_name(0), flush=True)
    try:
        for dtype, tol in ((torch.float32, 1e-4), (torch.float64, 1e-5)):
            seconds.clear()
            calls.clear()
            H = lt.build_regular_hamiltonian(160, 25.0, lt.deuteron_potential_3d, stencil="27",
                                             dtype=dtype, device="cuda")
            H.matmat = timed("matmat", H.matmat)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = lt.eigsh_block_restarted(H, k=20, block_size=4, tol=tol, max_cycles=400)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            print(f"{str(dtype)[6:]}: wall {wall:.3f} s (timers on), {res.cycles} cycles, "
                  f"{calls['cures']} cures", flush=True)
            for name in sorted(seconds, key=seconds.get, reverse=True):
                print(f"  {name:16s} {seconds[name]:8.3f} s in {calls[name]:5d} calls, "
                      f"{seconds[name] / calls[name] * 1e3:8.3f} ms each")
            del res, H.matmat
            m = H.shape[0]
            gen = torch.Generator(device="cuda").manual_seed(0)
            r = torch.randn((m, 4), generator=gen, dtype=dtype, device="cuda")
            basis = torch.randn((84, m), generator=gen, dtype=dtype, device="cuda")
            rows = {
                "torch.linalg.qr (cuSOLVER)": lambda: torch.linalg.qr(r),
                "_tall_qr (Cholesky QR twice)": lambda: saved["_tall_qr"](r),
                "basis @ r (K=84)": lambda: basis @ r,
                "(r.T @ basis.T).T (K=84)": lambda: (r.T @ basis.T).T,
                "_orth_block (K=84)": lambda: saved["_orth_block"](basis, r),
            }
            for label, fn in rows.items():
                print(f"  {label:32s} {eager_ms(fn, launches=10)[0]:8.3f} ms (CUDA events)")
            print(f"  {'SpMM b=4':32s} {graph_ms(lambda: sk.stencil_spmm(H, r), launches=20)[0]:8.4f}"
                  f" ms (graph replay), tile {sk.spmm_tile(4, r.element_size())}", flush=True)
            del H, r, basis
            torch.cuda.empty_cache()
    finally:
        for name, fn in saved.items():
            setattr(pb, name, fn)
    profile_cycles()


def profile_cycles(cycles=3):
    from torch.profiler import ProfilerActivity, profile

    H = lt.build_regular_hamiltonian(160, 25.0, lt.deuteron_potential_3d, stencil="27",
                                     dtype=torch.float32, device="cuda")
    lt.eigsh_block_restarted(H, k=20, block_size=4, tol=1e-4, max_cycles=1)
    torch.cuda.synchronize()
    stats0 = torch.cuda.memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        lt.eigsh_block_restarted(H, k=20, block_size=4, tol=1e-4, max_cycles=cycles)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    stats = torch.cuda.memory_stats()
    print(f"fp32, {cycles} cycles under the profiler: wall {wall:.3f} s; allocator: "
          + ", ".join(f"{key} +{stats.get(key, 0) - stats0.get(key, 0)}"
                      for key in ("num_alloc_retries", "num_device_alloc", "num_device_free",
                                  "num_sync_all_streams")))
    table = prof.key_averages()
    for key in ("self_device_time_total", "self_cuda_time_total"):
        try:
            print(table.table(sort_by=key, row_limit=20))
            break
        except (AttributeError, KeyError, ValueError) as err:
            print(f"sort by {key}: {err}")
    print(table.table(sort_by="self_cpu_time_total", row_limit=15))


if __name__ == "__main__":
    main()
