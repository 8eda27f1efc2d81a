"""The flagship SpMV benchmark: the 3D deuteron Hamiltonian's 27-point
stencil at N=160^3 (4,096,000 points), fp32 (counterpart of
``lanczos_tpu/utils/bench_impl.py``).

    python -m lanczos_tpu_torch bench [--device cpu]

prints one JSON line:

  metric       spmv_effective_bandwidth: the stencil SpMV's compulsory
               traffic (read x, read diag, write y: 12 B/point in fp32) over
               its time.
  vs_baseline  speedup in nnz/s over the reference's own compute path for
               this problem: a scipy CSR SpMV on the host CPU
               (3Ddeuteron.py:95 runs use_cuda=False), timed here on the
               same matrix.

On a card the SpMV is timed by CUDA graph replay
(``utils/metrics.py:benchmark_matvec``): 50 calls captured once, their x
rotating through vectors that outgrow the 50 MB L2 (so each call reads x
from memory, as in a solve), replays timed with CUDA events; the median
over 20 replays, with the fastest and slowest as the spread.  On the CPU the same calls are
timed with the host clock.
"""

from __future__ import annotations

import itertools
import json
import statistics
import time

import numpy as np
import torch

__all__ = ["bench_spmv", "bench_scipy_baseline", "main"]


def _host_seconds(fn, launches: int, samples: int):
    """Seconds per call in each of ``samples`` host-clock runs of
    ``launches`` calls, after one warm-up call."""
    fn()
    per_call = []
    for _ in range(samples):
        t0 = time.perf_counter()
        for _ in range(launches):
            fn()
        per_call.append((time.perf_counter() - t0) / launches)
    return per_call


def bench_spmv(n_grid: int = 160, dtype="float32", device="cuda", launches: int = 50,
               samples: int = 20):
    """Time ``StencilOperator.matvec`` of the N=n_grid deuteron Hamiltonian
    on ``device`` (on a card by ``utils/metrics.py:benchmark_matvec``);
    returns its rates and their spread over the samples."""
    import lanczos_tpu_torch as lt
    from lanczos_tpu_torch._util import as_torch_dtype

    from .metrics import benchmark_matvec

    dtype = as_torch_dtype(dtype)
    H = lt.build_regular_hamiltonian(
        n_grid, 25.0, lt.deuteron_potential_3d, stencil="27", dtype=dtype, device=device
    )
    m = H.shape[0]
    if H.device.type == "cuda":
        per_s = benchmark_matvec(H, launches, samples).samples
    else:
        gen = torch.Generator(device=device).manual_seed(1)
        xs = itertools.cycle([torch.randn(m, generator=gen, dtype=dtype, device=device)
                              for _ in range(8)])
        per_s = _host_seconds(lambda: H.matvec(next(xs)), launches, samples)
    spmv_s, best_s, worst_s = statistics.median(per_s), min(per_s), max(per_s)
    bytes_per = 3 * m * H.weights.element_size()  # read x, read diag, write y
    nnz_per = 27 * m  # stencil taps, the diagonal merged into the centre tap
    return {
        "m": m,
        "spmv_s": spmv_s,
        "gbps": bytes_per / spmv_s / 1e9,
        "gbps_best": bytes_per / best_s / 1e9,
        "gbps_worst": bytes_per / worst_s / 1e9,
        "n_samples": len(per_s),
        "nnz_per_s": nnz_per / spmv_s,
        "backend": H.device.type,
        "device_name": (torch.cuda.get_device_name(H.device)
                        if H.device.type == "cuda" else "cpu"),
    }


def bench_scipy_baseline(n_grid: int = 160, iters: int = 3, dtype="float64"):
    """The reference's compute path: a scipy CSR SpMV of the same H on the
    host CPU."""
    import scipy.sparse

    import lanczos_tpu_torch as lt
    from lanczos_tpu_torch._util import to_numpy
    from lanczos_tpu_torch.ops.assemble import stencil_to_ell

    H = lt.build_regular_hamiltonian(
        n_grid, 25.0, lt.deuteron_potential_3d, stencil="27", dtype=torch.float32, device="cpu"
    )
    ell = stencil_to_ell(H)
    m, k = ell.cols.shape
    # Uniform rows: the CSR arrays straight from the ELL, no COO round trip.
    csr = scipy.sparse.csr_matrix(
        (to_numpy(ell.vals).astype(dtype).reshape(-1), to_numpy(ell.cols).reshape(-1),
         np.arange(m + 1, dtype=np.int64) * k),
        shape=(m, m),
    )
    x = np.ones(m, dtype=dtype) / np.sqrt(m)
    csr @ x  # warm
    t0 = time.perf_counter()
    for _ in range(iters):
        csr @ x
    dt = (time.perf_counter() - t0) / iters
    return {"spmv_s": dt, "nnz_per_s": csr.nnz / dt}


def main(n_grid: int = 160, device="cuda"):
    """Run both sides and print the JSON line; returns it as a dict."""
    dev = bench_spmv(n_grid, device=device)
    ref = bench_scipy_baseline(n_grid)
    line = {
        "metric": "spmv_effective_bandwidth",
        "value": round(dev["gbps"], 2),
        "unit": "GB/s",
        "vs_baseline": round(dev["nnz_per_s"] / ref["nnz_per_s"], 2),
        "detail": {
            "problem": f"3D deuteron, 27pt stencil, N={n_grid}^3, fp32",
            "backend": dev["backend"],
            "device": dev["device_name"],
            "statistic": ("median over CUDA graph replays" if dev["backend"] == "cuda"
                          else "median over host-clock samples"),
            "gbps_spread": [round(dev["gbps_worst"], 2), round(dev["gbps_best"], 2)],
            "n_samples": dev["n_samples"],
            "spmv_time_s": round(dev["spmv_s"], 9),
            "nnz_per_s": round(dev["nnz_per_s"], 0),
            "baseline": "scipy CSR SpMV, host CPU (reference path)",
            "baseline_spmv_time_s": round(ref["spmv_s"], 4),
        },
    }
    print(json.dumps(line), flush=True)
    return line
