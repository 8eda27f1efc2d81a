"""The port's error-free transforms and compensated solvers against lanczos_tpu.

Same numpy inputs through ``lanczos_tpu.ops.compensated`` (eager, on the JAX
CPU backend) and ``lanczos_tpu_torch.ops.compensated``:

* two_sum, quick_two_sum, two_prod, dd_add, dd_sum_tree: bitwise equal in
  float32 and float64 (both sides are chains of separately rounded ops);
* dot2_rounded / norm2: within 1 float32 ulp of JAX (the port sums the exact
  float32 products in float64, JAX by Dot2) and within
  tests/test_compensated.py's own bounds; float64 (Dot2 on both sides) bitwise;
* compensated Lanczos, Arnoldi and two-sided runs against the JAX
  package's compensated runs and the float64 oracle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import lanczos_tpu as lt  # noqa: E402
from lanczos_tpu.ops import compensated as jc  # noqa: E402

import lanczos_tpu_torch as pt  # noqa: E402
from lanczos_tpu_torch.ops import compensated as tc  # noqa: E402

DTYPES = [np.float32, np.float64]


def _pair(x, dtype):
    x = np.asarray(x, dtype)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def _inputs(seed, dtype, n=512):
    rng = np.random.default_rng(seed)
    scale = 10.0 ** rng.integers(-6, 6, n)
    return [(rng.normal(size=n) * scale).astype(dtype) for _ in range(4)]


def _same(jax_out, torch_out):
    for a, b in zip(jax_out, torch_out):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["two_sum", "quick_two_sum", "two_prod"])
def test_two_term_transforms_bitwise(name, dtype):
    a, b, _, _ = _inputs(0, dtype)
    if name == "quick_two_sum":  # its precondition |a| >= |b|
        a, b = np.where(np.abs(a) >= np.abs(b), a, b), np.where(np.abs(a) >= np.abs(b), b, a)
    aj, at = _pair(a, dtype)
    bj, bt = _pair(b, dtype)
    _same(getattr(jc, name)(aj, bj), getattr(tc, name)(at, bt))


@pytest.mark.parametrize("dtype", DTYPES)
def test_dd_add_bitwise(dtype):
    ins = _inputs(1, dtype)
    # Make genuine double-word inputs: lo below half an ulp of hi.
    ins[1] = (ins[0] * np.finfo(dtype).eps * 0.3).astype(dtype)
    ins[3] = (-ins[2] * np.finfo(dtype).eps * 0.7).astype(dtype)
    ins[2] = -ins[0] * (1 + 4 * np.finfo(dtype).eps)  # heavy hi cancellation
    js, ts = zip(*(_pair(x, dtype) for x in ins))
    _same(jc.dd_add(*js), tc.dd_add(*ts))


@pytest.mark.parametrize("n", [1, 2, 3, 127, 1000, 2**14 + 3])
def test_dd_sum_tree_bitwise_and_accurate(n):
    rng = np.random.default_rng(n)
    for dtype in DTYPES:
        x = rng.normal(size=n).astype(dtype)
        lo = (x * 1e-9).astype(dtype) if dtype == np.float64 else np.zeros(n, dtype)
        jh, jl = jc.dd_sum_tree(*_pair(x, dtype)[:1], _pair(lo, dtype)[0])
        th, tl = tc.dd_sum_tree(torch.from_numpy(x), torch.from_numpy(lo))
        assert float(jh) == float(th) and float(jl) == float(tl)
        want = float(np.sum(x.astype(np.float64)) + np.sum(lo.astype(np.float64)))
        got = float(th) + float(tl)
        assert abs(got - want) <= 1e-12 * max(np.sum(np.abs(x)), 1.0)


def _ulps32(a, b):
    a, b = np.float32(a), np.float32(b)
    return abs(int(a.view(np.int32)) - int(b.view(np.int32)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dot2_rounded_and_norm2_within_an_ulp_of_jax(seed):
    rng = np.random.default_rng(seed)
    n = 50_000
    a = rng.normal(size=n).astype(np.float32)
    b = rng.normal(size=n).astype(np.float32)
    if seed == 2:  # cancellation: the products nearly cancel in pairs
        a = np.concatenate([a, a]) * np.float32(1e4)
        b = np.concatenate([b, -b * np.float32(1 + 2**-20)])
    aj, at = _pair(a, np.float32)
    bj, bt = _pair(b, np.float32)
    assert _ulps32(jc.dot2_rounded(aj, bj), tc.dot2_rounded(at, bt)) <= 1
    hj, lj = jc.norm2(aj)
    ht, lt_ = tc.norm2(at)
    assert _ulps32(float(hj) + float(lj), float(ht) + float(lt_)) <= 1
    # float64: Dot2 on both sides, the same operations in the same order.
    a64, b64 = a.astype(np.float64) * (1 + 1e-9), b.astype(np.float64)
    assert float(jc.dot2_rounded(*_pair(a64, np.float64)[:1], _pair(b64, np.float64)[0])) == \
        float(tc.dot2_rounded(torch.from_numpy(a64), torch.from_numpy(b64)))
    _same(jc.norm2(jnp.asarray(a64)), tc.norm2(torch.from_numpy(a64)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_dot2_bounds_of_the_jax_tests(dtype):
    """tests/test_compensated.py's bounds, on the port."""
    rng = np.random.default_rng(1234)
    n = 4096
    a = (rng.normal(size=n) * 1e4).astype(dtype)
    b = rng.normal(size=n).astype(dtype)
    a2, b2 = np.concatenate([a, a]), np.concatenate([b, -b])
    hi, lo = tc.dot2(torch.from_numpy(a2), torch.from_numpy(b2))
    got = float(hi) + float(lo)
    want = float(np.dot(a2.astype(np.float64), b2.astype(np.float64)))
    mag = float(np.sum(np.abs(a2.astype(np.float64) * b2)))
    assert abs(got - want) <= 1e-10 * mag

    a = rng.normal(size=100_000).astype(dtype)
    b = rng.normal(size=100_000).astype(dtype)
    hi, lo = tc.dot2(torch.from_numpy(a), torch.from_numpy(b))
    want = np.dot(a.astype(np.float64), b.astype(np.float64))
    assert abs(float(hi) + float(lo) - want) / abs(want) < 1e-12

    x = rng.normal(size=50_000).astype(dtype)
    hi, lo = tc.norm2(torch.from_numpy(x))
    want = np.linalg.norm(x.astype(np.float64))
    assert abs(float(hi) + float(lo) - want) / want < 1e-12
    z_hi, z_lo = tc.norm2(torch.zeros(16, dtype=torch.from_numpy(x).dtype))
    assert float(z_hi) == 0.0 and float(z_lo) == 0.0


@pytest.fixture(scope="module")
def lanczos_case():
    """tests/test_compensated.py's case: m=400 random symmetric, n=30; the
    JAX package's float64, float32 and compensated float32 alphas."""
    rng = np.random.default_rng(1234)
    m, n = 400, 30
    A = rng.normal(size=(m, m))
    A = (A + A.T) / 2
    v0 = rng.normal(size=m)
    fac64 = lt.lanczos(lt.DenseOperator(jnp.asarray(A)), n, v0=jnp.asarray(v0), dtype=jnp.float64)
    op32 = lt.DenseOperator(jnp.asarray(A, jnp.float32))
    fac32 = lt.lanczos(op32, n, v0=jnp.asarray(v0, jnp.float32), dtype=jnp.float32)
    fac32c = lt.lanczos(op32, n, v0=jnp.asarray(v0, jnp.float32), dtype=jnp.float32,
                        compensated=True)
    return A, v0, n, np.asarray(fac64.alpha), np.asarray(fac32.alpha), np.asarray(fac32c.alpha)


def test_compensated_lanczos_alpha(lanczos_case):
    A, v0, n, a64, a32_jax, a32c_jax = lanczos_case
    op = pt.DenseOperator(torch.as_tensor(A, dtype=torch.float32))
    v = torch.as_tensor(v0, dtype=torch.float32)
    plain = pt.lanczos(op, n, v0=v).alpha.numpy()
    comp = pt.lanczos(op, n, v0=v, compensated=True).alpha.numpy()
    err_plain = np.max(np.abs(plain - a64))
    err_comp = np.max(np.abs(comp - a64))
    # The JAX test's bounds (tests/test_compensated.py:141-142).
    assert err_comp <= err_plain * 1.5 + 1e-6
    assert abs(comp[0] - a64[0]) < 4e-6 * max(abs(a64[0]), 1.0)
    # Against JAX's compensated alphas.  Both packages round the float32
    # matvec and CGS2 products in their own summation order, so the
    # alphas part by a few ulps of max |alpha| as the run goes on (up to
    # ~16 here), whatever the reductions do.  What compensation can give
    # holds: alpha_0 (one matvec's rounding apart) within 1 ulp of max
    # |alpha| of JAX's, and the port's distance to the float64 alphas in
    # the class of JAX's own (within twice it, plus 2 ulps).
    ulp = np.spacing(np.float32(np.abs(a32c_jax).max()))
    assert abs(comp[0] - a32c_jax[0]) <= ulp
    assert err_comp <= 2 * np.max(np.abs(a32c_jax - a64)) + 2 * ulp


def _diag_lanczos_alphas(d, v0, n, compensated):
    """(JAX compensated alphas, the port's alphas, the port's V[0]) on
    diag(d) in float32.  A diagonal matvec rounds each product once and
    adds zeros, so both packages compute it bitwise alike and the alphas
    differ only by the reductions."""
    A = np.diag(d).astype(np.float32)
    fj = lt.lanczos(lt.DenseOperator(jnp.asarray(A)), n, v0=jnp.asarray(v0, jnp.float32),
                    dtype=jnp.float32, compensated=True)
    ft = pt.lanczos(pt.DenseOperator(torch.from_numpy(A)), n,
                    v0=torch.as_tensor(v0, dtype=torch.float32), compensated=compensated)
    return np.asarray(fj.alpha), ft.alpha.numpy(), ft.V[0].numpy()


@pytest.mark.parametrize("seed", [0, 1234])
def test_compensated_alpha_first_steps_within_2ulp_of_jax(seed):
    """Before the two packages' CGS2 summation orders part the bases, each
    compensated alpha is within 2 of its own float32 ulps of JAX's."""
    rng = np.random.default_rng(seed)
    d, v0 = rng.uniform(1.0, 2.0, 400), rng.normal(size=400)
    want, got, _ = _diag_lanczos_alphas(d, v0, 10, compensated=True)
    assert max(_ulps32(a, b) for a, b in zip(got, want)) <= 2


def test_compensated_alpha_differs_from_plain_under_cancellation():
    """alpha_0 = v^T diag(d) v with d = +-1e4 in pairs on equal entries of v:
    the products cancel to ~0.5.  The compensated alpha_0 is the exact dot
    of the float32 v and A v, rounded once, and JAX's bitwise; the plain
    float32 dot is thousands of ulps off."""
    rng = np.random.default_rng(0)
    d = np.empty(400)
    d[0::2], d[1::2] = 1e4 + rng.uniform(0.5, 1.5, 200), -1e4
    v0 = np.repeat(rng.uniform(-1.0, 1.0, 200), 2)
    want, comp, v = _diag_lanczos_alphas(d, v0, 2, compensated=True)
    _, plain, _ = _diag_lanczos_alphas(d, v0, 2, compensated=False)
    w = (d.astype(np.float32) * v).astype(np.float32)  # the float32 matvec, exactly
    exact = float(np.dot(v.astype(np.float64), w.astype(np.float64)))
    assert comp[0] == want[0]
    assert _ulps32(comp[0], exact) <= 1
    assert _ulps32(plain[0], exact) >= 100


def _spy_dot2(monkeypatch):
    """Count calls of ``dot2_rounded``: ``_resolve_dot`` reads it from
    ``ops/compensated.py`` at each solver call."""
    calls = []
    real = tc.dot2_rounded

    def spy(a, b):
        calls.append(a.shape)
        return real(a, b)

    monkeypatch.setattr(tc, "dot2_rounded", spy)
    return calls


def _run_entry(name, compensated):
    rng = np.random.default_rng(5)
    S = rng.normal(size=(60, 60))
    sym = pt.DenseOperator(torch.as_tensor((S + S.T) / 2, dtype=torch.float32))
    A, v0, w0 = _nonsym(m=60, seed=5)
    gen = pt.DenseOperator(torch.as_tensor(A))
    kw = dict(compensated=compensated)
    if name == "lanczos":
        pt.lanczos(sym, 12, v0=v0, **kw)
    elif name == "eigsh":
        pt.eigsh(sym, k=2, n=20, v0=v0, **kw)
    elif name == "eigsh_restarted":
        pt.eigsh_restarted(sym, k=2, max_basis=16, max_cycles=2, v0=v0, **kw)
    elif name == "arnoldi":
        pt.arnoldi(gen, 10, v0=v0, **kw)
    elif name == "eigs_nonsym":
        pt.eigs_nonsym(gen, k=2, max_basis=16, max_cycles=2, v0=v0, **kw)
    else:
        pt.two_sided_lanczos(gen, 10, v0=v0, w0=w0, op_transpose=pt.DenseOperator(
            torch.as_tensor(A.T.copy())), **kw)


@pytest.mark.parametrize("name", ["lanczos", "eigsh", "eigsh_restarted", "arnoldi",
                                  "eigs_nonsym", "two_sided_lanczos"])
def test_compensated_flag_routes_reductions_through_dot2(name, monkeypatch):
    calls = _spy_dot2(monkeypatch)
    _run_entry(name, compensated=False)
    assert not calls
    _run_entry(name, compensated=True)
    assert calls


def test_compensated_eigsh_and_block_refusal():
    rng = np.random.default_rng(7)
    A = rng.normal(size=(200, 200))
    A = (A + A.T) / 2
    op = pt.DenseOperator(torch.as_tensor(A, dtype=torch.float32))
    res = pt.eigsh(op, k=4, n=120, compensated=True)
    np.testing.assert_allclose(res.eigenvalues.numpy(), np.linalg.eigvalsh(A)[:4], atol=5e-4)
    with pytest.raises(ValueError, match="block_size"):
        pt.eigsh(op, k=4, block_size=2, compensated=True)


def _nonsym(m=150, seed=3):
    rng = np.random.default_rng(seed)
    A = np.diag(np.arange(1.0, m + 1.0)) + 0.05 * rng.normal(size=(m, m))
    return A, rng.uniform(-1, 1, m), rng.uniform(-1, 1, m)


def test_compensated_arnoldi_and_two_sided_match_jax():
    A, v0, w0 = _nonsym()
    jop, top = lt.DenseOperator(jnp.asarray(A)), pt.DenseOperator(torch.as_tensor(A))
    fj = lt.arnoldi(jop, 20, v0=jnp.asarray(v0), compensated=True)
    ft = pt.arnoldi(top, 20, v0=v0, compensated=True)
    np.testing.assert_allclose(ft.H.numpy(), np.asarray(fj.H), atol=1e-12)
    from lanczos_tpu.solver.two_sided import two_sided_lanczos_kernel

    tj = two_sided_lanczos_kernel(jop.matvec, lambda x: jnp.asarray(A.T) @ x, jnp.asarray(v0),
                                  jnp.asarray(w0), 20, compensated=True)
    tt = pt.two_sided_lanczos(top, 20, v0=v0, w0=w0, op_transpose=pt.DenseOperator(
        torch.as_tensor(A.T.copy())), compensated=True)
    # The oblique recurrence amplifies rounding (|alpha| reaches 1108 on a
    # spectrum in [1, 150]): float64 agreement to 1e-8 relative.
    for name in ("alpha", "beta", "gamma"):
        np.testing.assert_allclose(getattr(tt, name).numpy(), np.asarray(getattr(tj, name)),
                                   rtol=1e-8)


def test_compensated_eigs_nonsym_matches_jax():
    A, v0, _ = _nonsym(seed=4)
    want = np.sort(np.linalg.eigvals(A).real)[:4]
    rj = lt.eigs_nonsym(lt.DenseOperator(jnp.asarray(A)), k=4, max_basis=40, tol=1e-10,
                        v0=jnp.asarray(v0), compensated=True)
    rt = pt.eigs_nonsym(pt.DenseOperator(torch.as_tensor(A)), k=4, max_basis=40, tol=1e-10,
                        v0=v0, compensated=True)
    np.testing.assert_allclose(np.sort(rt.eigenvalues.numpy()), np.sort(np.asarray(rj.eigenvalues)),
                               atol=1e-10)
    np.testing.assert_allclose(np.sort(rt.eigenvalues.numpy()), want, atol=1e-9)
