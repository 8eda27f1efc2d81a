"""Write the golden eigenvalues that chip_smoke.py holds the port's GPU solve to.

The JAX package solves the N=64, L=25 fm, 27-point regular-grid deuteron in
fp64 on the CPU, with eigsh(k=8, n=150, which="SA") from the start vector
np.random.default_rng(99).uniform(-1, 1, 64**3), and the result goes to
lanczos_tpu_torch/data/golden_eigsh_n64.json (JSON, since .npy is not
committed).  Run from the repository root:

    python scripts/make_torch_golden.py
"""

import json
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import lanczos_tpu as lt  # noqa: E402

CONFIG = dict(N=64, L=25.0, stencil="27", k=8, n=150, which="SA", v0_seed=99)
OUT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "lanczos_tpu_torch", "data", "golden_eigsh_n64.json",
)


def main():
    c = CONFIG
    H = lt.build_regular_hamiltonian(
        c["N"], c["L"], lt.deuteron_potential_3d, stencil=c["stencil"],
        dtype="float64",
    )
    v0 = np.random.default_rng(c["v0_seed"]).uniform(-1.0, 1.0, c["N"] ** 3)
    res = lt.eigsh(H, k=c["k"], n=c["n"], which=c["which"], v0=v0,
                   dtype=np.float64)
    golden = dict(
        source="lanczos_tpu.eigsh, float64, JAX CPU backend",
        config=c,
        eigenvalues=np.asarray(res.eigenvalues).tolist(),
        residuals=np.asarray(res.residuals).tolist(),
        inner_prod=np.asarray(res.inner_prod).tolist(),
    )
    with open(OUT, "w") as f:
        json.dump(golden, f, indent=1)
        f.write("\n")
    print(res.summary())
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
