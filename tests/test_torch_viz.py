"""The port's ``utils/viz.py`` against ``lanczos_tpu/utils/viz.py``: the same
inputs (``tests/test_viz_symmetry.py``'s) through both packages' four
functions give figures whose plotted data are equal (scatter offsets and
colours, line data, titles, labels).  The port's functions also take
tensors.  Skips without matplotlib.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("matplotlib")

import lanczos_tpu as ltj  # noqa: E402
import lanczos_tpu_torch as lt  # noqa: E402
from lanczos_tpu.utils import viz as viz_jax  # noqa: E402
from lanczos_tpu_torch.utils import viz  # noqa: E402


@pytest.fixture(scope="module")
def lattices():
    sp = np.full(27, 2, dtype=np.int64)
    sp[13] = 1
    return (ltj.build_lattice(24, 25.0, 3, spacings=sp), lt.build_lattice(24, 25.0, 3, spacings=sp))


@pytest.fixture(autouse=True)
def close_figures():
    yield
    import matplotlib.pyplot as plt

    plt.close("all")


def plotted(fig):
    """Every axis's title, axis labels, legend labels, scatter offsets and
    face colours, and line data."""
    out = []
    for ax in fig.axes:
        leg = ax.get_legend()
        out.append({
            "title": ax.get_title(), "xlabel": ax.get_xlabel(), "ylabel": ax.get_ylabel(),
            "legend": [t.get_text() for t in leg.get_texts()] if leg else [],
            "scatter": [(np.asarray(c.get_offsets()), np.asarray(c.get_facecolors()))
                        for c in ax.collections],
            "lines": [(np.asarray(ln.get_xdata()), np.asarray(ln.get_ydata()))
                      for ln in ax.get_lines()],
        })
    return out


def assert_same_figure(a, b):
    pa, pb = plotted(a), plotted(b)
    assert len(pa) == len(pb)
    for x, y in zip(pa, pb):
        for key in ("title", "xlabel", "ylabel", "legend"):
            assert x[key] == y[key], key
        assert len(x["scatter"]) == len(y["scatter"]) and len(x["lines"]) == len(y["lines"])
        for (oa, ca), (ob, cb) in zip(x["scatter"], y["scatter"]):
            np.testing.assert_array_equal(oa, ob)
            np.testing.assert_array_equal(ca, cb)
        for (xa, ya), (xb, yb) in zip(x["lines"], y["lines"]):
            np.testing.assert_array_equal(xa, xb)
            np.testing.assert_array_equal(ya, yb)


@pytest.mark.parametrize("slice_coord", [0, 9])
def test_plot_lattice_matches_jax(lattices, slice_coord, tmp_path):
    lat_j, lat_t = lattices
    fig = viz.plot_lattice(lat_t, slice_coord=slice_coord)
    assert_same_figure(viz_jax.plot_lattice(lat_j, slice_coord=slice_coord), fig)
    assert sum(len(o) for o, _ in plotted(fig)[0]["scatter"]) > 0
    fig.savefig(tmp_path / "lat.png")


@pytest.mark.parametrize("d", [1, 2])
def test_plot_neighbors_matches_jax(lattices, d, tmp_path):
    lat_j, lat_t = lattices
    point = lat_t.num_points // 2
    fig = viz.plot_neighbors(lat_t, point=point, d=d)
    assert_same_figure(viz_jax.plot_neighbors(lat_j, point=point, d=d), fig)
    fig.savefig(tmp_path / "nbrs.png")


@pytest.mark.parametrize("as_tensor", [False, True])
def test_plot_eigenvectors_1d_matches_jax(as_tensor, tmp_path):
    n = 101
    H = ltj.build_chain_hamiltonian_1d(n, 10.0, ltj.square_well_1d(n))
    res = ltj.eigsh(H, k=4, n=n, which="SA", dtype=np.float64)
    x = np.linspace(0.0, 10.0, n)
    vecs, vals = np.asarray(res.eigenvectors), np.asarray(res.eigenvalues)
    ref = viz_jax.plot_eigenvectors_1d(x, vecs, vals)
    args = (torch.tensor(x), torch.tensor(vecs), torch.tensor(vals)) if as_tensor \
        else (x, vecs, vals)
    fig = viz.plot_eigenvectors_1d(*args)
    assert_same_figure(ref, fig)
    assert len(plotted(fig)[0]["lines"]) == 4
    fig.savefig(tmp_path / "vecs.png")


@pytest.mark.parametrize("as_tensor", [False, True])
def test_plot_convergence_matches_jax(as_tensor, tmp_path):
    hist = np.geomspace(1, 1e-9, 40)
    fig = viz.plot_convergence(torch.as_tensor(hist) if as_tensor else hist)
    assert_same_figure(viz_jax.plot_convergence(hist), fig)
    fig.savefig(tmp_path / "conv.png")


def test_package_imports_without_matplotlib():
    """``import lanczos_tpu_torch`` and its solver paths never import
    matplotlib, so a host without it runs every solver."""
    import os
    import subprocess
    import sys

    code = ("import sys\n"
            "sys.modules['matplotlib'] = None  # any import of it now raises\n"
            "import lanczos_tpu_torch, lanczos_tpu_torch.utils, lanczos_tpu_torch.cli\n"
            "from lanczos_tpu_torch.utils import viz\n"
            "try:\n"
            "    viz.plot_convergence([1.0, 0.1])\n"
            "except ImportError:\n"
            "    print('viz needs matplotlib')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "viz needs matplotlib"
