"""Per-rank exchange volume of the sharded CompositeV2 at production shape.

A host count, no process group and no card: the north-star operator
(``scripts/northstar_torch.py``: the graph Laplacian + 1 of the lattice of
box depth 3 with the centre box at spacing 1) is built on the CPU, planned
for D ranks (``parallel/composite2.py:plan_composite_v2``: z-slabs and the
surface runs of ``_plan_support``), and ``utils/metrics.py:exchange_stats``
counts what each rank receives per matvec: two halo planes per level and
the support runs.

    python scripts/exchange_torch.py                     # n_fine=216 at D=4, 192 at D=8
    python scripts/exchange_torch.py --case 48:8 --min-grid-rows 4 --out exchange.json

Every level's z-extent (n_fine/3 fine, n_fine/2 coarse) must divide by D:
n_fine a multiple of 6 D.  The pipeline builds with ``min_grid_rows``
4096; n_fine=48 at D=8 with ``--min-grid-rows 4`` is the JAX dry run's toy
(``MULTICHIP_r05.json``: 109.29% of M).
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def count(n_fine: int, ranks: int, min_grid_rows: int = 4096) -> dict:
    import torch

    from lanczos_tpu_torch.ops.composite2 import build_composite_v2
    from lanczos_tpu_torch.parallel.composite2 import plan_composite_v2
    from lanczos_tpu_torch.utils.metrics import exchange_stats
    from northstar_torch import build_graph_laplacian_rows

    t0 = time.perf_counter()
    lat, nbrs, rels, weights, deg, _ = build_graph_laplacian_rows(n_fine)
    comp, _ = build_composite_v2(
        lat, nbrs, rels, weights, deg + 1.0, scale=1.0, dtype=torch.float32,
        interior_weights=lambda a: np.full(26, -1.0), symmetric=True,
        min_grid_rows=min_grid_rows, device="cpu")
    t_build = time.perf_counter() - t0
    host = plan_composite_v2(comp, ranks)
    ex = host.exchange_elements()
    st = exchange_stats(host, ranks)
    return {
        "n_fine": n_fine, "ranks": ranks, "min_grid_rows": min_grid_rows,
        "num_points": int(lat.num_points),
        "operator_dim": st["operator_dim"], "interface_classes": len(comp.grid_meta),
        "levels": [{"a": a, "region": list(ext), "planes_per_rank": nzl,
                    "runs": [list(r) for r in runs]}
                   for (a, ext, st_, sl, nzl), runs in zip(host.level_meta, host.support_runs)],
        "halo_elements": ex["halo"], "support_run_elements": ex["support_runs"],
        "per_device_recv_elements": st["per_device_recv_elements"],
        "per_device_recv_bytes_fp32": st["per_device_recv_bytes"],
        "fraction_of_m": st["fraction_of_m"], "host_build_s": t_build,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--case", action="append", default=[],
                    help="n_fine:ranks (repeatable); default 216:4 and 192:8")
    ap.add_argument("--min-grid-rows", type=int, default=4096,
                    help="the pipeline's 4096; the JAX dry run's toy used 4")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    cases = [tuple(int(v) for v in c.split(":")) for c in args.case] or [(216, 4), (192, 8)]
    records = []
    for n_fine, ranks in cases:
        rec = count(n_fine, ranks, args.min_grid_rows)
        records.append(rec)
        print(f"n_fine={n_fine} D={ranks}: {rec['num_points']} points, M={rec['operator_dim']}; "
              f"per rank per matvec {rec['halo_elements']} halo + {rec['support_run_elements']} "
              f"run elements = {rec['per_device_recv_elements']} "
              f"({100 * rec['fraction_of_m']:.2f}% of M)", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    return records


if __name__ == "__main__":
    main()
