"""The port's operator I/O, ``export-matrix`` and ``bench`` against
lanczos_tpu's (utils/io.py, cli.py, utils/bench_impl.py)."""

import json
import re

import jax  # noqa: F401  (kept on the CPU by conftest)
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import lanczos_tpu as lt  # noqa: E402
from lanczos_tpu.cli import main as jax_main  # noqa: E402
from lanczos_tpu.utils import io as jio  # noqa: E402

import lanczos_tpu_torch as pt  # noqa: E402
from lanczos_tpu_torch.cli import main  # noqa: E402
from lanczos_tpu_torch.utils import io as pio  # noqa: E402
from lanczos_tpu_torch.utils.bench_impl import main as bench_main  # noqa: E402

from conftest import random_sparse_symmetric  # noqa: E402


def _ell(seed=4, m=50):
    a = random_sparse_symmetric(np.random.default_rng(seed), m)
    return a, lt.ell_from_scipy(a, dtype=np.float64), pt.ell_from_scipy(
        a, dtype=torch.float64, device="cpu")


def test_ell_roundtrip_across_packages(tmp_path):
    """save_ell/load_ell keep cols and vals exactly, and each package reads
    the other's file."""
    _, opj, opp = _ell()
    pio.save_ell(str(tmp_path / "port"), opp)
    back = pio.load_ell(str(tmp_path / "port.npz"), device="cpu")
    assert torch.equal(back.cols, opp.cols) and torch.equal(back.vals, opp.vals)
    jio.save_ell(str(tmp_path / "jax.npz"), opj)
    from_jax_file = pio.load_ell(str(tmp_path / "jax.npz"), device="cpu")
    np.testing.assert_array_equal(from_jax_file.vals.numpy(), np.asarray(opj.vals))
    np.testing.assert_array_equal(from_jax_file.cols.numpy(), np.asarray(opj.cols))
    from_port_file = jio.load_ell(str(tmp_path / "port.npz"))
    np.testing.assert_array_equal(np.asarray(from_port_file.vals), opp.vals.numpy())


def test_cached_ell_builds_once(tmp_path):
    _, _, opp = _ell()
    calls = []

    def builder():
        calls.append(1)
        return opp

    path = str(tmp_path / "sub" / "cached")
    first = pio.cached_ell(path, builder, device="cpu")
    second = pio.cached_ell(path, builder, device="cpu")
    assert len(calls) == 1  # the second call hits the cache
    assert first is opp and torch.equal(second.vals, opp.vals)
    assert second.cols.dtype == torch.int64


def _read_export(path):
    """(header lines, {(row, col): value}) of a Mathematica export."""
    text = open(path).read()
    assert text.endswith("}};")
    head, rest = text.split("H = ", 1)
    cut = rest.index("}, {") + 4
    header = head.splitlines() + ["H = " + rest[:cut]]
    triplets = {(int(r), int(c)): float(v) for r, c, v in
                re.findall(r"\{(-?\d+), (-?\d+), ([-+0-9.e]+)\},\n", rest[cut:])}
    assert len(triplets) == rest[cut:].count("\n")
    return header, triplets


def _same_export(a, b):
    ha, ta = _read_export(a)
    hb, tb = _read_export(b)
    assert ha == hb
    assert ta.keys() == tb.keys()
    for key, v in ta.items():
        assert abs(v - tb[key]) <= 1e-15 * max(abs(tb[key]), 1e-300)


def test_export_mathematica_matches_jax(tmp_path):
    """The same operator exported by both packages: identical header lines
    and the same (row, col, value) triplets."""
    _, opj, opp = _ell(seed=5, m=40)
    kw = dict(ndim=3, length=25.0, potential_name="Deuteron")
    pio.export_mathematica(str(tmp_path / "p.dat"), opp, **kw)
    jio.export_mathematica(str(tmp_path / "j.dat"), opj, **kw)
    _same_export(tmp_path / "p.dat", tmp_path / "j.dat")
    text = open(tmp_path / "p.dat").read()
    assert text.startswith("numd = 3;") and 'potential = "Deuteron";' in text
    assert "H = {{40, 40}, {" in text


def test_export_matrix_cli_matches_jax(tmp_path, capsys):
    """``export-matrix -N 12`` on the CPU against lanczos_tpu.cli's."""
    out = main(["export-matrix", "-N", "12", "--device", "cpu", "--out", str(tmp_path / "p.dat")])
    assert "# wrote" in capsys.readouterr().out and out == str(tmp_path / "p.dat")
    jax_main(["export-matrix", "-N", "12", "--out", str(tmp_path / "j.dat")])
    _same_export(tmp_path / "p.dat", tmp_path / "j.dat")


def test_export_matrix_default_name_and_checks(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    main(["export-matrix", "-N", "6", "-L", "20", "--device", "cpu"])
    assert (tmp_path / "matrix_d=3_N=6_L=20_p=Deuteron.dat").exists()
    with pytest.raises(SystemExit, match="unsupported potential"):
        main(["export-matrix", "-p", "Harmonic", "--device", "cpu"])
    with pytest.raises(SystemExit, match="only 3 dimensions"):
        main(["export-matrix", "-d", "2", "--device", "cpu"])


#: The JSON line of lanczos_tpu/utils/bench_impl.py:main.
JAX_BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "detail"}
JAX_BENCH_DETAIL_KEYS = {"problem", "backend", "statistic", "gbps_spread", "n_samples",
                         "spmv_time_s", "nnz_per_s", "baseline", "baseline_spmv_time_s"}


def test_bench_line_has_the_jax_keys(capsys):
    line = bench_main(n_grid=12, device="cpu")
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == line
    assert set(line) == JAX_BENCH_KEYS
    assert JAX_BENCH_DETAIL_KEYS <= set(line["detail"])
    assert line["metric"] == "spmv_effective_bandwidth" and line["unit"] == "GB/s"
    assert line["value"] > 0 and line["vs_baseline"] > 0
    d = line["detail"]
    assert d["backend"] == "cpu" and d["n_samples"] >= 5
    assert d["gbps_spread"][0] <= line["value"] <= d["gbps_spread"][1]
    # 12 B a point (x, diag, y in fp32) over the median time, rounded to
    # two decimals in the line.
    assert abs(line["value"] - 12 * 12**3 / d["spmv_time_s"] / 1e9) <= 0.005 + 1e-9


@pytest.mark.parametrize("argv", [["bench"], ["export-matrix", "-N", "8"]])
def test_cuda_device_without_card_fails_loudly(argv):
    if torch.cuda.is_available():
        pytest.skip("a card is visible; this checks hosts without one")
    with pytest.raises(SystemExit, match="no CUDA device"):
        main(argv + ["--device", "cuda"])
