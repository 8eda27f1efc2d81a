"""The port's ``utils/metrics.py`` against the JAX package's.

``exchange_stats`` and ``operator_nnz`` give JAX's numbers for the same
operators (the unsharded stencil and ELL, the halo ELL of an 8-rank split
carried over by ``from_jax``, the v1 composite).  ``matvec_stats`` turns a
time into the rates of its byte model; ``benchmark_matvec`` times only the
card and raises on a CPU operator; ``profile_trace`` writes a Chrome trace.
"""

import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import lanczos_tpu as lt  # noqa: E402
from lanczos_tpu.parallel import make_row_mesh as jax_mesh  # noqa: E402
from lanczos_tpu.parallel import shard_ell_halo as jax_halo  # noqa: E402
from lanczos_tpu.utils.metrics import exchange_stats as jax_exchange  # noqa: E402
from lanczos_tpu.utils.metrics import operator_nnz as jax_nnz  # noqa: E402

import lanczos_tpu_torch as pt  # noqa: E402
from lanczos_tpu_torch.convert import from_jax  # noqa: E402
from lanczos_tpu_torch.parallel import RowMesh  # noqa: E402
from lanczos_tpu_torch.utils.metrics import (  # noqa: E402
    benchmark_matvec,
    exchange_stats,
    matvec_stats,
    operator_nnz,
    profile_trace,
)


@pytest.fixture(scope="module")
def hams():
    hj = lt.build_regular_hamiltonian(32, 25.0, lt.deuteron_potential_3d, stencil="27",
                                      dtype="float32")
    return hj, from_jax(hj, device="cpu")


@pytest.mark.parametrize("d", [4, 8])
def test_exchange_stats_equal_jax(hams, d):
    hj, ht = hams
    assert exchange_stats(ht, d) == jax_exchange(hj, d)
    assert exchange_stats(ht.to_ell(), d) == jax_exchange(hj.to_ell(), d)
    assert exchange_stats(ht, d)["per_device_recv_elements"] == 2 * 32 * 32
    halo_j = jax_halo(hj.to_ell(), jax_mesh(d))
    halo_t = from_jax(halo_j, mesh=RowMesh(None, 0, d, torch.device("cpu")))
    assert exchange_stats(halo_t, d) == jax_exchange(halo_j, d)
    assert halo_t.exchange_elements == halo_j.exchange_elements
    with pytest.raises(TypeError, match="no exchange model"):
        exchange_stats(pt.DenseOperator(torch.eye(4)), d)


def test_operator_nnz_equals_jax(hams):
    hj, ht = hams
    assert operator_nnz(ht) == jax_nnz(hj)
    assert operator_nnz(ht.to_ell()) == jax_nnz(hj.to_ell())
    lat_j = lt.build_lattice(12, 25.0, 3, overwrite_spacing=True)
    cj, _ = lt.assemble_irregular_hamiltonian_composite(lat_j, lt.deuteron_potential_3d,
                                                        dtype=np.float64)
    assert operator_nnz(from_jax(cj, device="cpu")) == jax_nnz(cj)


def test_matvec_stats_byte_model(hams):
    ht = hams[1]
    st = matvec_stats(ht, 1e-3, "test")
    assert st.effective_gbps == pytest.approx(3 * ht.shape[0] * 4 / 1e-3 / 1e9)
    assert st.nnz_per_s == pytest.approx(operator_nnz(ht) / 1e-3)
    ell = ht.to_ell()
    k = ell.cols.shape[1]
    assert matvec_stats(ell, 1e-3, "test").effective_gbps == pytest.approx(
        (ell.shape[0] * k * (4 + 8) + 2 * ell.shape[0] * 4) / 1e-3 / 1e9)
    assert "GB/s" in str(st)


def test_benchmark_matvec_needs_the_card(hams):
    with pytest.raises(ValueError, match="times the card"):
        benchmark_matvec(hams[1])


def test_profile_trace_writes_a_trace(tmp_path, hams):
    x = torch.ones(hams[1].shape[0])
    with profile_trace(str(tmp_path)) as prof:
        hams[1].matvec(x)
    assert len(prof.key_averages()) > 0
    with open(os.path.join(tmp_path, "trace.json")) as f:
        assert "traceEvents" in json.load(f)


def test_from_jax_halo_ell_rows(hams):
    """from_jax of a JAX EllHaloOperator gives each rank its rows of the
    remapped columns and values, and the whole export table."""
    hj = hams[0]
    halo_j = jax_halo(hj.to_ell(), jax_mesh(4))
    rows = hj.shape[0] // 4
    for r in range(4):
        part = from_jax(halo_j, mesh=RowMesh(None, r, 4, torch.device("cpu")))
        np.testing.assert_array_equal(part.cols.numpy(),
                                      np.asarray(halo_j.cols)[r * rows:(r + 1) * rows])
        np.testing.assert_array_equal(part.vals.numpy(),
                                      np.asarray(halo_j.vals)[r * rows:(r + 1) * rows])
        np.testing.assert_array_equal(part.export_ids.numpy(), np.asarray(halo_j.export_ids))
        assert (part.row_offset, part.local_rows, part.shape) == (r * rows, rows, hj.shape)
    with pytest.raises(ValueError, match="row mesh"):
        from_jax(halo_j)
