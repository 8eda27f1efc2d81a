"""Where a row-sharded solve's time goes, beside the unsharded one, on one GPU.

    python scripts/profile_torch_sharded.py [--n-fine 72] [--cycles 1] [--trace-dir DIR]

Builds the north-star operator (``scripts/northstar_torch.py``) at n_fine,
starts a one-rank NCCL row mesh (the environment set here, one card holds
one NCCL rank) and runs ``eigsh_restarted(k=110, compensated=True,
rr_verify=False)`` for ``--cycles`` cycles on the CompositeV2 and on its
sharded form, first unprofiled (walls), then under ``torch.profiler``
(``utils/metrics.py:profile_trace``; its Chrome traces, ~30 MB each, are
kept under ``--trace-dir`` when given).  For each it prints the unprofiled
wall and matvec count, the device busy time (the kernels' own time, from
the profiled run) as a share of the unprofiled wall, the NCCL kernels'
count and time, and the ops that take the most host time (as the
profiler inflates it) and device time.
"""

import argparse
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def _device_us(evt):
    return getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0)


def summarize(label, prof, prof_wall, wall, top=8):
    """The profiled run's device busy time over the unprofiled wall (the
    kernels' own time is the card's; the host's is inflated by the
    profiler, so its wall is printed but shares no number)."""
    events = prof.key_averages()
    kernels = [e for e in events if _device_us(e) > 0]
    busy = sum(_device_us(e) for e in kernels) / 1e6
    nccl = [e for e in kernels if "nccl" in e.key.lower()]
    print(f"== {label}: device busy {busy:.3f} s = {busy / wall:.1%} of the unprofiled wall "
          f"{wall:.3f} s (profiled wall {prof_wall:.3f} s); NCCL kernels "
          f"{sum(e.count for e in nccl)} taking {sum(_device_us(e) for e in nccl) / 1e6:.3f} s")
    print("   host, under the profiler (self CPU s, calls):")
    for e in sorted(events, key=lambda e: -e.self_cpu_time_total)[:top]:
        print(f"     {e.self_cpu_time_total / 1e6:8.3f} {e.count:7d}  {e.key[:70]}")
    print("   device (self s, calls):")
    for e in sorted(kernels, key=lambda e: -_device_us(e))[:top]:
        print(f"     {_device_us(e) / 1e6:8.3f} {e.count:7d}  {e.key[:70]}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-fine", type=int, default=72)
    ap.add_argument("--cycles", type=int, default=1)
    ap.add_argument("--trace-dir", default="")
    args = ap.parse_args()

    import torch
    import torch.distributed as dist

    from lanczos_tpu_torch.ops.composite2 import build_composite_v2
    from lanczos_tpu_torch.parallel import initialize_distributed, make_row_mesh, shard_operator
    from lanczos_tpu_torch.parallel.launch import free_port
    from lanczos_tpu_torch.solver.restart import eigsh_restarted
    from lanczos_tpu_torch.utils.metrics import profile_trace
    from northstar_torch import build_graph_laplacian_rows

    if not torch.cuda.is_available():
        raise SystemExit("this script profiles the card; no CUDA device is visible")
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()), WORLD_SIZE="1",
                      RANK="0", LOCAL_RANK="0")
    initialize_distributed(device="cuda")
    mesh = make_row_mesh()
    try:
        lat, nbrs, rels, weights, deg, _ = build_graph_laplacian_rows(args.n_fine)
        comp, idx_map = build_composite_v2(
            lat, nbrs, rels, weights, deg + 1.0, scale=1.0, dtype=torch.float32,
            interior_weights=lambda a: np.full(26, -1.0), symmetric=True, min_grid_rows=4096,
            device="cuda")
        sharded = shard_operator(comp, mesh)
        v0 = np.zeros(comp.shape[0], dtype=np.float32)
        v0[idx_map] = np.random.default_rng(99).uniform(-1, 1, lat.num_points)
        kw = dict(k=110, tol=3e-7, compensated=True, max_basis=250, n_locked=114,
                  max_cycles=args.cycles, rr_verify=False)
        print(f"n_fine={args.n_fine}: M={comp.shape[0]}, {len(comp.grid_meta)} interface classes; "
              f"{torch.cuda.get_device_name(0)}")
        for label, op, start in (("unsharded", comp, v0),
                                 ("sharded (1 NCCL rank)", sharded, sharded.host.to_sharded(v0))):
            counted = {"matvecs": 0}
            real = op.matvec

            def counting(x, real=real):
                counted["matvecs"] += 1
                return real(x)

            op.matvec = counting
            eigsh_restarted(op, v0=start, **kw)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eigsh_restarted(op, v0=start, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counted["matvecs"] = 0
            with tempfile.TemporaryDirectory() as tmp:
                out = os.path.join(args.trace_dir or tmp, label.split()[0])
                t0 = time.perf_counter()
                with profile_trace(out) as prof:
                    eigsh_restarted(op, v0=start, **kw)
                    torch.cuda.synchronize()
                prof_wall = time.perf_counter() - t0
            print(f"{label}: unprofiled wall {wall:.3f} s for {args.cycles} cycle(s), "
                  f"{counted['matvecs']} matvecs, {wall / max(counted['matvecs'], 1) * 1e3:.3f} "
                  "ms a matvec step")
            summarize(label, prof, prof_wall, wall)
            del op.matvec
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
