"""Port's CompositeV2, fused-interface tables and plan against lanczos_tpu.

The lattice is the JAX tests' mixed lattice (n=24, box depth 3, centre box
at spacing 1) with ``min_grid_rows=4``, so the strided-class path and the
block-ELL tail both take part.  The JAX package's Pallas interface kernel
runs in interpret mode.  fp64 throughout.
"""

import jax  # noqa: F401  (kept on the CPU by conftest)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import lanczos_tpu as lt  # noqa: E402
from lanczos_tpu.ops.composite2 import build_composite_v2 as jax_build  # noqa: E402
from lanczos_tpu.ops.interface_kernel import apply_fused_interface as jax_fused  # noqa: E402

import lanczos_tpu_torch as pt  # noqa: E402
from lanczos_tpu_torch.convert import from_jax  # noqa: E402
from lanczos_tpu_torch.models.irr_hamiltonian import irregular_laplacian_rows  # noqa: E402
from lanczos_tpu_torch.models.potentials import kinetic_prefactor  # noqa: E402
from lanczos_tpu_torch.ops import interface_kernel as ik  # noqa: E402
from lanczos_tpu_torch.ops.composite2 import build_composite_v2  # noqa: E402

PLAN_FIELDS = ("operands", "out_operands", "classes", "fallback")


def _mixed(pkg):
    sp = np.full(27, 2, dtype=np.int64)
    sp[13] = 1
    return pkg.build_lattice(24, 25.0, 3, spacings=sp)


def _build_pair(fuse_interface):
    """(JAX operator, port operator, idx_map, P) built from the same rows,
    with their transposes; the diagonal carries the deuteron potential.
    ``fuse_interface`` is the JAX builder's switch: the port always applies
    every class with its interface kernel."""
    lat_j, lat_p = _mixed(lt), _mixed(pt)
    nbrs, rels, weights = irregular_laplacian_rows(lat_p)
    t = kinetic_prefactor(lat_p.s)
    phys = lat_p.physical_coords()
    diag = t * weights.sum(axis=1) + pt.deuteron_potential_3d(
        *(torch.from_numpy(phys[:, a]) for a in range(3))
    ).numpy()
    kw = dict(scale=-t, min_grid_rows=4, build_transpose=True)
    J, idx_j = jax_build(
        lat_j, nbrs, rels, weights, diag, dtype=np.float64, fuse_interface=fuse_interface, **kw
    )
    P, idx_p = build_composite_v2(
        lat_p, nbrs, rels, weights, diag, dtype=torch.float64, device="cpu", **kw
    )
    np.testing.assert_array_equal(idx_p, idx_j)
    return J, P, idx_p, lat_p.num_points


@pytest.fixture(scope="module")
def pair():
    """The fused builds (the card's path)."""
    return _build_pair(True)


@pytest.fixture(scope="module")
def unfused_pair():
    """The JAX operator without its fused plan: every class through its
    plain interface path."""
    return _build_pair(False)


def _x(op, seed, b=None):
    """A random live-masked vector (or (M, b) block) of the operator."""
    rng = np.random.default_rng(seed)
    live = op.live.numpy()
    x = rng.standard_normal(op.shape[0] if b is None else (op.shape[0], b))
    return x * (live if b is None else live[:, None])


def _assert_plan_equal(p, j):
    for f in PLAN_FIELDS:
        assert getattr(p, f) == getattr(j, f), f


def test_build_matches_jax(pair):
    J, P, _, _ = pair
    for A, B in ((P, J), (P.transpose_op, J.transpose_op)):
        assert A.level_meta == B.level_meta and A.grid_meta == B.grid_meta
        for name in ("diag", "keep", "live"):
            np.testing.assert_array_equal(getattr(A, name).numpy(), np.asarray(getattr(B, name)))
        for wa, wb in zip(A.grid_w, B.grid_w):
            np.testing.assert_array_equal(wa.numpy(), np.asarray(wb))
        assert len(A.ifc_buckets) == len(B.ifc_buckets) > 0
        for ba, bb in zip(A.ifc_buckets, B.ifc_buckets):
            for ta, tb in zip(ba, bb):
                np.testing.assert_array_equal(ta.numpy(), np.asarray(tb))
        for la, lb in zip(A.level_ops, B.level_ops):
            assert (la.grid_shape, la.offsets, la.graded) == (lb.grid_shape, lb.offsets, lb.graded)
            np.testing.assert_array_equal(la.weights.numpy(), np.asarray(lb.weights))
    assert set(dict(P.named_buffers())) >= {"diag", "keep", "live", "fused.tap_w", "bucket0_rows"}


def test_plan_matches_jax(pair):
    J, P, _, _ = pair
    for A, B in ((P, J), (P.transpose_op, J.transpose_op)):
        plan = ik.plan_interface_kernel(
            A.grid_meta, A.level_meta, [w.numpy() for w in A.grid_w]
        )
        _assert_plan_equal(plan, B.fused_plan)
        assert len(plan.classes) > 0
        # The port's kernel takes every class, the JAX plan's fallback too.
        assert A.fused.cls.shape[0] == len(A.grid_meta) >= len(plan.classes)
    plan = ik.plan_interface_kernel(P.grid_meta, P.level_meta, P.grid_w)
    assert plan.fallback == ()  # 2:1 graded: every class of A covered


@pytest.mark.parametrize("transposed", [False, True])
def test_fused_reference_matches_pallas(pair, transposed):
    J, P, _, _ = pair
    if transposed:
        J, P = J.transpose_op, P.transpose_op
    rng = np.random.default_rng(4)
    x = rng.standard_normal(P.shape[0])
    y = rng.standard_normal(P.shape[0])
    x3 = [jnp.asarray(x[st:st + int(np.prod(e))].reshape(e)) for _, e, st in J.level_meta]
    y3 = [jnp.asarray(y[st:st + int(np.prod(e))].reshape(e)) for _, e, st in J.level_meta]
    # The JAX plan covers every class here, as the port's tables do (a class
    # the JAX plan leaves out: test_class_outside_tpu_strides_at_n60).
    assert J.fused_plan.fallback == ()
    y3 = jax_fused(J.fused_plan, x3, y3, interpret=True)
    y_jax = np.concatenate([np.asarray(v).reshape(-1) for v in y3])
    y_port = ik.apply_fused_interface_reference(
        P.fused, torch.from_numpy(x), torch.from_numpy(y.copy())
    ).numpy()
    np.testing.assert_allclose(y_port, y_jax, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("which", ["pair", "unfused_pair"])
def test_operator_matches_jax(which, request):
    J, P, _, _ = request.getfixturevalue(which)
    assert (J.fused_plan is None) == (which == "unfused_pair")
    x = _x(P, 5)
    X = _x(P, 6, b=3)
    yj = np.asarray(jax.jit(J.matvec)(x))
    tol = dict(rtol=1e-12, atol=1e-12 * np.abs(yj).max())
    np.testing.assert_allclose(P.matvec(torch.from_numpy(x)).numpy(), yj, **tol)
    np.testing.assert_allclose(
        P.rmatvec(torch.from_numpy(x)).numpy(), np.asarray(jax.jit(J.rmatvec)(x)), **tol
    )
    np.testing.assert_allclose(
        P.matmat(torch.from_numpy(X)).numpy(), np.asarray(jax.jit(J.matmat)(X)), **tol
    )


def test_matches_ell_assembly(pair):
    _, P, idx_map, p = pair
    lat = _mixed(pt)
    E = pt.assemble_irregular_hamiltonian(lat, pt.deuteron_potential_3d, dtype=torch.float64, device="cpu")
    x = np.random.default_rng(9).standard_normal(p)
    v = torch.zeros(P.shape[0], dtype=torch.float64)
    v[idx_map] = torch.from_numpy(x)
    y_ell = E.matvec(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(P.matvec(v).numpy()[idx_map], y_ell, rtol=1e-9, atol=1e-9)
    yt = E.to_scipy().T @ x
    np.testing.assert_allclose(P.rmatvec(v).numpy()[idx_map], yt, rtol=1e-9, atol=1e-9)


def test_dead_slots_are_annihilated(pair):
    _, P, _, p = pair
    assert P.shape[0] > p and int(P.live.sum()) == p
    v = torch.from_numpy(np.random.default_rng(10).standard_normal(P.shape[0]))
    v_dead = v * (1 - P.live)
    for f in (P.matvec, P.rmatvec):
        assert float(f(v_dead).abs().max()) == 0.0


def test_class_windows_are_disjoint(pair):
    _, P, _, _ = pair
    for A in (P, P.transpose_op):
        fi = A.fused
        acc = [int(np.prod(g[3])) for g in A.grid_meta]
        assert fi.num_rows == sum(acc)
        # Rows of every class packed densely, class after class, with no
        # block reserved to one class: the kernel's grid follows the rows
        # alone.
        row_class = fi.row_class.numpy()
        np.testing.assert_array_equal(row_class, np.repeat(np.arange(len(acc)), acc))
        np.testing.assert_array_equal(fi.cls[:, 0].numpy(), np.cumsum([0] + acc[:-1]))
        np.testing.assert_array_equal(fi.cls[:, 4].numpy(),
                                      np.cumsum([len(g[4]) for g in A.grid_meta]))
    # Two classes that write the same window are refused: the kernel has
    # one writer per slot and would race.
    with pytest.raises(AssertionError, match="overlapping"):
        ik.FusedInterface(
            P.grid_meta[:1] * 2, P.level_meta, P.grid_w[:1] * 2, torch.float64, "cpu"
        )


def test_wrapper_dispatch_and_checks(pair):
    _, P, _, _ = pair
    fi = P.fused
    x = torch.from_numpy(_x(P, 11))
    y0 = torch.from_numpy(_x(P, 12))
    before = ik.apply_fused_interface.launches
    y = ik.apply_fused_interface(fi, x, y0.clone())
    assert ik.apply_fused_interface.launches == before  # CPU: no launch
    np.testing.assert_array_equal(
        y.numpy(), ik.apply_fused_interface_reference(fi, x, y0.clone()).numpy()
    )
    with pytest.raises(TypeError):
        ik.apply_fused_interface(fi, x.float(), y0.float())
    with pytest.raises(ValueError):
        ik.apply_fused_interface(fi, x[:-1], y0[:-1])
    X = torch.zeros(3, P.shape[0], dtype=torch.float64)
    with pytest.raises(ValueError):
        ik.apply_fused_interface(fi, X.T, X.T)
    with pytest.raises(ValueError):
        ik.apply_fused_interface(fi, x.to("meta"), y0.to("meta"))


def test_from_jax_round_trips(pair):
    J, P, _, _ = pair
    C = from_jax(J, device="cpu")
    assert isinstance(C, pt.CompositeV2) and isinstance(C.transpose_op, pt.CompositeV2)
    for a, b in ((C, P), (C.transpose_op, P.transpose_op)):
        for name in ("cls", "taps", "row_class", "tap_w"):
            assert torch.equal(getattr(a.fused, name), getattr(b.fused, name)), name
    x = torch.from_numpy(_x(P, 13))
    np.testing.assert_array_equal(C.matvec(x).numpy(), P.matvec(x).numpy())
    np.testing.assert_array_equal(C.rmatvec(x).numpy(), P.rmatvec(x).numpy())
    plan = from_jax(J.fused_plan)
    assert isinstance(plan, ik.InterfacePlan)
    lat = from_jax(_mixed(lt))
    assert isinstance(lat, pt.IrregularLattice) and lat.num_points == _mixed(pt).num_points


def test_module_conversions(pair):
    """nn.Module's .to()/.double() walk the operator, its interface tables
    and its transpose; the operator's own methods do not shadow them."""
    J, P, _, _ = pair
    C = from_jax(J, device="cpu", dtype=torch.float32)
    assert C.to("cpu") is C and C.dtype == C.transpose_op.dtype == torch.float32
    assert C.double() is C
    for A in (C, C.transpose_op):
        assert A.dtype == A.fused.tap_w.dtype == A.level_ops[0].weights.dtype == torch.float64
        assert A.fused.cls.dtype == torch.int32
    x = torch.from_numpy(_x(P, 14))
    y = P.matvec(x)
    # fp32-rounded weights, applied in fp64.
    tol = dict(rtol=1e-6, atol=1e-6 * float(y.abs().max()))
    torch.testing.assert_close(C.matvec(x), y, **tol)
    torch.testing.assert_close(C.rmatvec(x), P.rmatvec(x), **tol)


def test_class_outside_tpu_strides_at_n60():
    """At N=60 one class of A^T steps by 13 slots along z: the JAX plan
    leaves it to a plain path (Pallas reads strides 1 and 2 only); the
    port's kernel tables take it with the rest, and the operator still
    equals the ELL assembly."""
    lat = pt.build_lattice(60, 25.0, 3, potential=pt.deuteron_potential_3d)
    C, idx_map = pt.assemble_irregular_hamiltonian_composite2(
        lat, pt.deuteron_potential_3d, dtype=torch.float64, build_transpose=True, device="cpu"
    )
    T = C.transpose_op
    plan = ik.plan_interface_kernel(T.grid_meta, T.level_meta, T.grid_w)
    assert len(plan.fallback) > 0
    assert T.fused.cls.shape[0] == len(T.grid_meta) == len(plan.classes) + len(plan.fallback)
    E = pt.assemble_irregular_hamiltonian(lat, pt.deuteron_potential_3d, dtype=torch.float64, device="cpu")
    x = np.random.default_rng(15).standard_normal(lat.num_points)
    v = torch.zeros(C.shape[0], dtype=torch.float64)
    v[idx_map] = torch.from_numpy(x)
    for got, want in ((C.matvec(v), E.matvec(torch.from_numpy(x)).numpy()),
                      (C.rmatvec(v), E.to_scipy().T @ x)):
        np.testing.assert_allclose(got.numpy()[idx_map], want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max())
