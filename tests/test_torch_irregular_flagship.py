"""``scripts/irregular_flagship_torch.py`` (the port's irregular flagship) at
n_fine=24 on the CPU: its JSON holds every key of the JAX script's
(``scripts/irregular_flagship.py``), and its fp64-refined eigenvalues are
scipy's fp64 ``eigs(which="SR")`` of the ELL operator within
1e-8 max(|lam|, 1), at true residuals below 1e-10.
"""

import ast
import json
import os
import sys

import numpy as np
import scipy.sparse.linalg
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import irregular_flagship_torch  # noqa: E402


def jax_script_keys():
    """The keys the JAX script writes: its ``info`` dict literal and every
    ``info["..."] = ...``."""
    with open(os.path.join(ROOT, "scripts", "irregular_flagship.py")) as f:
        tree = ast.parse(f.read())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == "info" and isinstance(node.value, ast.Dict):
            keys |= {k.value for k in node.value.keys}
        if isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Store) \
                and isinstance(node.value, ast.Name) and node.value.id == "info":
            keys.add(node.slice.value)
    return keys


def test_flagship_script_at_n24(tmp_path):
    import lanczos_tpu_torch as lt

    out = tmp_path / "irr24.json"
    rc = irregular_flagship_torch.main(["--n-fine", "24", "--device", "cpu", "--out", str(out)])
    assert rc == 0
    with open(out) as f:
        info = json.load(f)
    keys = jax_script_keys()
    assert len(keys) > 20 and "residual_max" in keys
    assert keys <= set(info), keys - set(info)
    assert info["backend"] == "cpu" and info["device"] == "cpu" and info["v0_seed"] == 99
    assert info["peak_device_gib"] is None and info["compensated"] is True
    assert info["num_points"] == 13824 and info["k"] == 8
    assert info["residual_max"] <= 1e-10
    assert info["all_accepted_ref_tol"]

    lat = lt.build_lattice(24, 25.0, 3, potential=lt.deuteron_potential_3d)
    A = lt.assemble_irregular_hamiltonian(lat, lt.deuteron_potential_3d, symmetrize=None,
                                          dtype=torch.float64, device="cpu").to_scipy()
    ref = np.real(scipy.sparse.linalg.eigs(A, k=10, which="SR", tol=1e-12,
                                           v0=np.ones(A.shape[0]))[0])
    got = np.asarray(info["eigenvalues"])
    for lam in got:
        assert np.min(np.abs(ref - lam)) <= 1e-8 * max(abs(lam), 1.0), (lam, np.sort(ref))
    assert abs(got.min() - ref.min()) <= 1e-8 * max(abs(ref.min()), 1.0)
