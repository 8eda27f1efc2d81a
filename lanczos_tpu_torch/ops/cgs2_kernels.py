"""CGS2 reorthogonalization in few sweeps over the basis: a CUDA kernel
and its plain PyTorch version.

:func:`cgs2` orthogonalizes ``v`` (M,) against the rows of ``V`` (j, M) by
classical Gram-Schmidt run ``passes`` times, ``v <- v - (V v) V`` each pass.
The plain version, :func:`cgs2_reference`, is that loop: two GEMVs a pass,
each reading all of ``V``, so 2p reads of the basis.  On the card the
kernel of ``csrc/cgs2.cu`` reads it p + 1 times: one pass's update and the
next pass's projection share one read of each column tile (see the
source's header for the design and what bounds it).  A basis of more rows
than one tile holds (:data:`MAX_ROWS`) is taken in row blocks, 2p reads as
the loop.  It replaces no TPU kernel: the JAX package's CGS2 is plain
matmuls.

The Lanczos recurrence reads the basis p times a step by lagging each
vector's last update into the next step's first sweep:
:func:`cgs2_lagged` leaves the new row unfinished in ``V`` with the
coefficients that finish it, and finishes the row before it;
:func:`cgs2_finish` finishes the last one.

A solver orthogonalizes through :func:`orthogonalize` or
:func:`cgs2_lagged`: this module alone picks the kernel, its row blocks or
a plain version, and alone keeps the ``lt.cgs2.*`` counters.  Dispatch is
by the tensor's device: a CPU tensor goes to the plain version, a CUDA
tensor of float32 or float64 launches the kernel (for :func:`cgs2` any
number of rows; a view that is not contiguous is copied first).
``COUNTERS["lt.cgs2.calls"]`` counts the calls of
:func:`orthogonalize` and :func:`cgs2_lagged`; ``COUNTERS["lt.cgs2.fused"]``
counts the calls of :func:`cgs2` and :func:`cgs2_lagged` that launched the
kernel, incremented after a successful launch and nowhere else;
``COUNTERS["lt.cgs2.basis_reads"]`` adds the sweeps over the basis each
call makes on the card (the plain version on the CPU counts the same, so
that the paths are told apart on any device).  Inside a CUDA graph they
count the capture, not the replays.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from .._util import COUNTERS
from ._build import launch_on

__all__ = ["MAX_ROWS", "cgs2", "cgs2_finish", "cgs2_lagged", "cgs2_lagged_reference",
           "cgs2_reference", "local_basis_dot", "orthogonalize"]

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}

#: The most rows of ``V`` one tile of the kernel holds (both dtypes), the
#: source's ``kMaxRows``: up to here p passes read ``V`` p + 1 times
#: (:func:`cgs2`) or p times a step (:func:`cgs2_lagged`), beyond it 2p.
MAX_ROWS = 831

# cgs2_lagged finishes the row at once where |v_p|^2 of a unit v falls
# below this (csrc/cgs2.cu: cgs2_reduce_norm).
_FINISH_BELOW = 0.25


def local_basis_dot(V: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The projections ``V @ v`` (j,) of ``v`` (M,) on the rows of an
    unsharded basis ``V`` (j, M)."""
    return V @ v


def cgs2_reference(V: torch.Tensor, v: torch.Tensor, passes: int,
                   basis_dot=local_basis_dot) -> torch.Tensor:
    """Plain PyTorch: ``passes`` CGS passes of ``v`` against the rows of
    ``V``; ``basis_dot(V, v)`` gives the projections (a row-sharded mesh's
    all-reduced product in place of ``V @ v``)."""
    for _ in range(passes):
        h = basis_dot(V, v)
        v = v - h @ V
    return v


@functools.lru_cache(maxsize=None)
def _library():
    from ._build import load_cgs2_library

    lib, _ = load_cgs2_library()
    return lib


@functools.lru_cache(maxsize=None)
def _blocks(index: int) -> int:
    """The kernel's grid on card ``index``: one block per SM."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(V, *vectors):
    if V.dtype not in _DTYPES or any(x.dtype != V.dtype for x in vectors):
        raise TypeError(f"cgs2 kernel takes float32/float64 V and vectors of its dtype, got "
                        f"{V.dtype} and {[x.dtype for x in vectors]}")
    if V.ndim != 2 or any(x.ndim != 1 or x.shape[0] != V.shape[1] or x.device != V.device
                          for x in vectors):
        raise ValueError(f"cgs2 takes V (j, M) and vectors (M,) on one device; got V "
                         f"{tuple(V.shape)} on {V.device}, "
                         f"{[(tuple(x.shape), str(x.device)) for x in vectors]}")


def _launch(V, name, *args):
    err = launch_on(V.device, getattr(_library(), f"{name}_{_DTYPES[V.dtype]}"), *args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def cgs2(V: torch.Tensor, v: torch.Tensor, passes: int) -> torch.Tensor:
    """``passes`` CGS passes of ``v`` (M,) against the rows of ``V`` (j, M),
    returned as a new tensor; ``v`` is left as it was."""
    j = V.shape[0]
    if j > 0 and passes > 0:
        COUNTERS["lt.cgs2.basis_reads"] += passes + 1 if j <= MAX_ROWS else 2 * passes
    if V.device.type == "cpu":
        return cgs2_reference(V, v, passes)
    _check(V, v)
    if j == 0 or passes < 1:
        return v.clone()
    V, v = V.contiguous(), v.contiguous()  # no copy for the solver's V[:j] and v
    blocks = _blocks(V.device.index)
    out = torch.empty_like(v)
    h = torch.empty(j, dtype=v.dtype, device=v.device)
    partial = torch.empty(blocks * j, dtype=v.dtype, device=v.device)
    _launch(V, "cgs2", V.data_ptr(), v.data_ptr(), out.data_ptr(), h.data_ptr(),
            partial.data_ptr(), V.shape[1], j, passes, blocks)
    COUNTERS["lt.cgs2.fused"] += 1
    return out


def orthogonalize(V: torch.Tensor, v: torch.Tensor, passes: int,
                  basis_dot=local_basis_dot) -> torch.Tensor:
    """``passes`` CGS passes of ``v`` (M,) against the rows of ``V`` (j, M),
    returned as a new tensor.  With :func:`local_basis_dot` it runs
    :func:`cgs2`: on the card the kernel, p + 1 sweeps over ``V`` instead of
    2p (2p in row blocks past :data:`MAX_ROWS`), on the CPU the plain loop.
    Any other ``basis_dot`` (a row-sharded mesh's, which all-reduces each
    projection over the ranks) runs the plain loop with it, 2p sweeps."""
    COUNTERS["lt.cgs2.calls"] += 1
    if basis_dot is local_basis_dot:
        return cgs2(V, v, passes)
    COUNTERS["lt.cgs2.basis_reads"] += 2 * passes if V.shape[0] else 0
    return cgs2_reference(V, v, passes, basis_dot)


def cgs2_lagged_reference(V, j, v, h_pending, passes):
    """Plain PyTorch: :func:`cgs2_lagged`, GEMV by GEMV (the flag read on the
    host)."""
    if h_pending is not None:
        V[j - 1] -= h_pending @ V[: j - 1]
    Vj = V[:j]
    h = Vj @ v
    for _ in range(passes - 1):
        v = v - h @ Vj
        h = Vj @ v
    d = torch.dot(v, v) - torch.dot(h, h)
    s = torch.where(d > 0, 1.0 / torch.sqrt(torch.where(d > 0, d, 1.0)), 0.0)
    torch.mul(v, s, out=V[j])
    h = h * s
    if 0 < float(d) < _FINISH_BELOW:
        V[j] -= h @ Vj
        return torch.zeros_like(h)
    return h


def cgs2_lagged(V: torch.Tensor, j: int, v: torch.Tensor, h_pending,
                passes: int) -> Optional[torch.Tensor]:
    """One step of the lagged CGS of ``v``, a unit vector or zero (a
    Lanczos step's r / beta), against the basis ``V`` (n, M), ``passes`` >= 2
    passes in ``passes`` sweeps over ``V[:j]``, j >= 1.  Counts the call in
    ``COUNTERS["lt.cgs2.calls"]``.

    Where ``h_pending`` (j - 1,) is given, row j - 1 is unfinished; it is
    finished first, ``V[j-1] -= h_pending @ V[:j-1]``, in place (on the card
    inside the first sweep).  Of the p passes' result v_p = v_{p-1} - V[:j]^T
    h_p the last update is left for the next step: ``V[j]`` gets s v_{p-1}
    and the call returns s h_p (j,), with s = 1 / sqrt(|v_{p-1}|^2 -
    |h_p|^2), which is 1 / |v_p| for orthonormal rows (0 for a vector with
    nothing left), so that ``V[j] - s h_p @ V[:j]`` is the unit vector the
    plain CGS would store.  ``v`` is left as it was.  Pythagoras holds to
    O(eps |v_{p-1}|^2 / |v_p|^2), which is O(eps) unless v_{p-1} lies in the
    span of ``V[:j]`` to machine precision, where no CGS finds a new
    direction.

    Where the passes leave less than half of v (|v_p|^2 < 1/4: a spent
    Krylov space, r mostly rounding in the span), h~ ~ eps / |v_p| is too
    large to lag, since H v~ would carry |H| |h~| into the next residual:
    the row is finished at once (a conditional sweep, without a host read)
    and the call returns zeros.  That sweep is not counted in
    ``COUNTERS["lt.cgs2.basis_reads"]``, which counts the sweeps every call
    makes.

    Past :data:`MAX_ROWS` rows nothing is lagged: the pending row is
    finished (:func:`cgs2_finish`), ``V[j]`` gets the unit vector of
    :func:`cgs2` (row blocks, 2p sweeps) and the call returns ``None``."""
    COUNTERS["lt.cgs2.calls"] += 1
    if j > MAX_ROWS:
        if h_pending is not None:
            cgs2_finish(V, j, h_pending)
        v = cgs2(V[:j], v, passes)
        nrm = torch.sqrt(torch.dot(v, v))
        V[j] = v * torch.where(nrm > 0, 1.0 / nrm, 0.0)
        return None
    COUNTERS["lt.cgs2.basis_reads"] += passes
    if V.device.type == "cpu":
        return cgs2_lagged_reference(V, j, v, h_pending, passes)
    _check(V, v)
    if not V.is_contiguous() or j < 1 or j >= V.shape[0] or passes < 2:
        raise ValueError(f"cgs2_lagged takes a contiguous V (n, M), 1 <= j < n and "
                         f"passes >= 2; got V {tuple(V.shape)}, j={j}, passes={passes}")
    if h_pending is not None and (tuple(h_pending.shape) != (j - 1,) or j < 2
                                  or h_pending.dtype != V.dtype or not h_pending.is_contiguous()):
        raise ValueError(f"h_pending must be a contiguous ({j - 1},) vector of V's dtype")
    v = v.contiguous()
    blocks = _blocks(V.device.index)
    # h~, s, the flag, and the h~ kept for the next step (zero if flagged).
    h = torch.empty(2 * j + 2, dtype=v.dtype, device=v.device)
    partial = torch.empty(blocks * (j + 1), dtype=v.dtype, device=v.device)
    row = V[j].data_ptr()
    _launch(V, "cgs2_step", V.data_ptr(), v.data_ptr(), row,
            None if h_pending is None else h_pending.data_ptr(), h.data_ptr(),
            partial.data_ptr(), V.shape[1], j, passes, blocks)
    COUNTERS["lt.cgs2.fused"] += 1
    V[j].mul_(h[j])
    _launch(V, "cgs2_update", V.data_ptr(), row, row, h.data_ptr(), V.shape[1], j, 1, blocks)
    return h[j + 2:]


def cgs2_finish(V: torch.Tensor, j: int, h_pending: torch.Tensor) -> None:
    """Finish row j - 1 of ``V`` left by :func:`cgs2_lagged`: ``V[j-1] -=
    h_pending @ V[:j-1]`` in place, one sweep over ``V[:j-1]`` (any j >= 2:
    row blocks past :data:`MAX_ROWS`)."""
    COUNTERS["lt.cgs2.basis_reads"] += 1
    if V.device.type == "cpu":
        V[j - 1] -= h_pending @ V[: j - 1]
        return
    _check(V, V[j - 1])
    if not V.is_contiguous() or not 2 <= j <= V.shape[0] or tuple(h_pending.shape) != (j - 1,):
        raise ValueError(f"cgs2_finish takes a contiguous V (n, M), 2 <= j <= n and "
                         f"h_pending ({j - 1},); got V {tuple(V.shape)}, j={j}, "
                         f"h_pending {tuple(h_pending.shape)}")
    row = V[j - 1].data_ptr()
    _launch(V, "cgs2_update", V.data_ptr(), row, row, h_pending.contiguous().data_ptr(),
            V.shape[1], j - 1, 0, _blocks(V.device.index))
