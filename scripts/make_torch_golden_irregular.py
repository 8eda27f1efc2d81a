"""Write the golden eigenvalues that chip_smoke.py holds the port's irregular
solve to.

The JAX package builds the N=60, L=25 fm, box-depth-3 deuteron lattice
(spacings from the potential: 1 in the centre box, 2 elsewhere), assembles
the raw non-symmetric Hamiltonian as padded ELL in fp64 on the CPU, and
solves it with ``eigs_nonsym(k=5, max_basis=120, which="SR")`` from the
lattice-order start vector ``np.random.default_rng(99).uniform(-1, 1, P)``,
to a true relative residual of 1e-9 (the card's solve stops at 1e-4, so the
golden values carry no error of their own at the card's tolerance).  It
also records the operator's norms ``||H||_inf`` and ``||H||_1``, from which
chip_smoke.py derives its tolerance.  The result goes to
``lanczos_tpu_torch/data/golden_eigs_irregular_n60.json``.

    python scripts/make_torch_golden_irregular.py           # N=60, ~10 s
    python scripts/make_torch_golden_irregular.py --n 120   # N=120, minutes

``--n 120`` writes ``golden_eigs_irregular_n120.json`` (k=8, max_basis=300),
the fp64 anchor to use if ``IRREGULAR_r04.json`` and the port ever disagree.
"""

import argparse
import json
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import lanczos_tpu as lt  # noqa: E402

CONFIGS = {
    60: dict(N=60, L=25.0, box_depth=3, k=5, max_basis=120, tol=1e-4, golden_tol=1e-9,
             which="SR", v0_seed=99),
    120: dict(N=120, L=25.0, box_depth=3, k=8, max_basis=300, tol=1e-4, golden_tol=1e-9,
              which="SR", v0_seed=99),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=60, choices=sorted(CONFIGS))
    c = CONFIGS[ap.parse_args().n]
    lat = lt.build_lattice(c["N"], c["L"], c["box_depth"], potential=lt.deuteron_potential_3d)
    H = lt.assemble_irregular_hamiltonian(lat, lt.deuteron_potential_3d, dtype=np.float64)
    A = abs(H.to_scipy())
    v0 = np.random.default_rng(c["v0_seed"]).uniform(-1.0, 1.0, lat.num_points)
    res = lt.eigs_nonsym(
        H, k=c["k"], max_basis=c["max_basis"], tol=c["golden_tol"], which=c["which"],
        v0=v0, dtype=np.float64,
    )
    golden = dict(
        source="lanczos_tpu.eigs_nonsym on assemble_irregular_hamiltonian (ELL), "
               "float64, JAX CPU backend",
        config=c,
        num_points=lat.num_points,
        spacings=sorted(set(lat.spacings.tolist())),
        norm_inf=float(A.sum(axis=1).max()),
        norm_1=float(A.sum(axis=0).max()),
        eigenvalues=np.asarray(res.eigenvalues).tolist(),
        residuals=np.asarray(res.residuals).tolist(),
        inner_prod=np.asarray(res.inner_prod).tolist(),
    )
    out = os.path.join(ROOT, "lanczos_tpu_torch", "data",
                       f"golden_eigs_irregular_n{c['N']}.json")
    with open(out, "w") as f:
        json.dump(golden, f, indent=1)
        f.write("\n")
    print(res.summary())
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
