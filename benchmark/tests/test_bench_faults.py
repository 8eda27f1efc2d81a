"""Whole runs on the CPU at a tiny size, past the look for a card: a sound
run comes out correct, and a run with its timed path broken underneath
does not, for each fault the cell can have: an answer altered where it is
produced (an eigenvalue moved, two vectors swapped, a pair returned twice),
half the answers left out, fewer Krylov steps than the traffic asks for,
the reorthogonalization left out so that ghost copies appear, and the
operator itself wrong."""

import dataclasses

import pytest

import lanczos_tpu_torch as lt
from benchmark import core

REGULAR = "regular_n160.eigsh_k20"


def run(root, wrap=None, seconds=0.2, seed=2**31 + 11):
    line, code = core.run(REGULAR, seed, seconds, False, root=root, device="cpu",
                          entry_wrap=wrap, log=lambda msg: None)
    assert code == 0
    return line


def altered(change):
    def wrap(entry):
        def solve(op, **kw):
            return change(entry(op, **kw))
        return solve
    return wrap


def called_with(**changed):
    def wrap(entry):
        def solve(op, **kw):
            return entry(op, **{**kw, **changed})
        return solve
    return wrap


def shift_ground_state(res):
    lam = res.eigenvalues.clone()
    lam[0] += 0.05 * max(abs(float(lam[0])), 1.0)
    return dataclasses.replace(res, eigenvalues=lam)


def swap_vectors(res):
    X = res.eigenvectors.clone()
    X[:, [0, 1]] = X[:, [1, 0]]
    return dataclasses.replace(res, eigenvectors=X)


def ground_state_twice(res):
    """The ground-state pair in the second slot too, with its honest
    residual."""
    lam, X, r = res.eigenvalues.clone(), res.eigenvectors.clone(), res.residuals.clone()
    lam[1], X[:, 1], r[1] = lam[0], X[:, 0], r[0]
    return dataclasses.replace(res, eigenvalues=lam, eigenvectors=X, residuals=r)


def half_left_out(res):
    h = res.k // 2
    return dataclasses.replace(res, eigenvalues=res.eigenvalues[:h],
                               eigenvectors=res.eigenvectors[:, :h], residuals=res.residuals[:h])


def test_sound_run_is_correct(tiny_root):
    line = run(tiny_root)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("fault", [
    altered(shift_ground_state), altered(swap_vectors), altered(ground_state_twice),
    altered(half_left_out), called_with(n=30), called_with(reorth="none", ghost_filter=False),
], ids=["shift_ground_state", "swap_vectors", "ground_state_twice", "half_left_out",
        "fewer_steps", "no_reorthogonalization"])
def test_broken_solve_is_caught(tiny_root, fault):
    line = run(tiny_root, fault)
    assert not line["correct"] and line["failed"] >= 1, line["checks"]


def test_wrong_operator_is_caught(tiny_root, monkeypatch):
    build = lt.build_regular_hamiltonian

    def wrong(*args, **kw):
        op = build(*args, **kw)
        op.diag.mul_(1.001)  # the potential off by 0.1%
        return op

    monkeypatch.setattr(lt, "build_regular_hamiltonian", wrong)
    line = run(tiny_root)
    assert not line["correct"]
    assert line["checks"]["op_err"]["value"] > line["checks"]["op_err"]["limit"]
