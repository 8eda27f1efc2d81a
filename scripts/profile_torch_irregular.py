"""Where the time of the port's N=120 irregular solve goes, on one GPU.

Builds the reference's production irregular lattice (N=120, L=25 fm, box
depth 3, spacings from the deuteron potential), assembles the fused
CompositeV2 in fp32, runs ``eigs_nonsym(k=8, max_basis=300, tol=1e-4)`` once
to warm up and once under ``torch.profiler``, and prints the wall times,
the device busy time and the profiler's table of device time by kernel
(the first 25 rows; ``--out FILE`` writes the first 200 there).

    python scripts/profile_torch_irregular.py [--out FILE]
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import lanczos_tpu_torch as lt  # noqa: E402


def solve(op, idx_map, p):
    v0 = np.zeros(op.shape[0])
    v0[idx_map] = np.random.default_rng(99).uniform(-1.0, 1.0, p)
    t0 = time.perf_counter()
    res = lt.eigs_nonsym(op, k=8, max_basis=300, tol=1e-4, v0=v0)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="file for the longer profiler table")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    lat = lt.build_lattice(120, 25.0, 3, potential=lt.deuteron_potential_3d)
    op, idx_map = lt.assemble_irregular_hamiltonian_composite2(
        lat, lt.deuteron_potential_3d, dtype=torch.float32, device="cuda")
    _, warm = solve(op, idx_map, lat.num_points)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res, wall = solve(op, idx_map, lat.num_points)
    events = prof.key_averages()
    # Device time of the kernels and copies themselves (an aten op's device
    # time is its kernels' again).
    device_us = sum(e.self_device_time_total for e in events if e.device_type != DeviceType.CPU)
    print(f"# {torch.cuda.get_device_name(0)}; warm-up solve {warm:.3f} s, "
          f"profiled solve {wall:.3f} s, device busy {device_us / 1e6:.3f} s "
          f"({device_us / 1e6 / wall:.1%} of the profiled wall)")
    print(f"# ground state {float(res.eigenvalues[0]):.8f} MeV")
    table = events.table(sort_by="self_device_time_total", row_limit=25)
    print(table)
    if args.out:
        with open(args.out, "w") as f:
            f.write(events.table(sort_by="self_device_time_total", row_limit=200))


if __name__ == "__main__":
    main()
