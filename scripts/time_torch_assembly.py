"""Wall of the irregular ELL assembly (``assemble_irregular_hamiltonian``)
through the native packer and through numpy.

Three ways, in turns (native, packer off, engine off; ROUNDS times):

* ``native``: the C++ engine does the neighbor search and the packing;
* ``packer_numpy``: ``native.pack_ell_native`` patched to return None, so
  only the packing takes ``ell_from_coo``'s numpy path;
* ``engine_numpy``: ``native._lib`` patched to return None, so the
  neighbor search and the packing both take their numpy paths.

The operator is float64 and the lattice is built once, outside the timed
region.  Every way must give the same operator (exactly); one JSON line
per run, then a summary with the card (``nvidia-smi`` name and power
limit) or ``cpu``.

Usage: python scripts/time_torch_assembly.py [--n-fine 120] [--device cuda]
"""

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ROUNDS = 2


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-fine", type=int, default=120)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    import torch

    import lanczos_tpu_torch as lt
    from lanczos_tpu_torch import native
    from lanczos_tpu_torch.utils.timing import card_label

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is visible; pass --device cpu")
    if not native.available():
        raise SystemExit("the native engine did not build (no g++?): nothing to compare")
    lat = lt.build_lattice(args.n_fine, 25.0, 3, potential=lt.deuteron_potential_3d)
    real = {"pack_ell_native": native.pack_ell_native, "_lib": native._lib}
    ways = {"native": {}, "packer_numpy": {"pack_ell_native": lambda *a: None},
            "engine_numpy": {"_lib": lambda: None}}
    walls = {w: [] for w in ways}
    ref = None
    for rnd in range(ROUNDS):
        for way, patch in ways.items():
            for name, fn in patch.items():
                setattr(native, name, fn)
            try:
                t0 = time.perf_counter()
                H = lt.assemble_irregular_hamiltonian(lat, lt.deuteron_potential_3d,
                                                      dtype=torch.float64, device=args.device)
                if args.device == "cuda":
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                for name in patch:
                    setattr(native, name, real[name])
            got = (H.cols.cpu().numpy(), H.vals.cpu().numpy())
            if ref is None:
                ref = got
            if not (np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])):
                raise SystemExit(f"{way}: the operator differs from the native assembly's")
            walls[way].append(wall)
            print(json.dumps({"round": rnd, "way": way, "wall_s": wall}), flush=True)
            del H
    print(json.dumps({
        "n_fine": args.n_fine, "num_points": int(lat.num_points), "dtype": "float64",
        "ell_shape": list(ref[0].shape), "device": card_label(args.device),
        "host_cores": os.cpu_count(),
        "median_wall_s": {w: statistics.median(t) for w, t in walls.items()},
        "walls_s": walls}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
