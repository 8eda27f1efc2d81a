"""The process group of row-partitioned execution, and its collectives.

Counterpart of ``lanczos_tpu/parallel/mesh.py``.  The JAX package builds a
1D device mesh (axis ``"rows"``) over which the Krylov vectors and the
operator's rows are sharded, and lets GSPMD turn every reduction into an
all-reduce.  Here each process is one rank holding one block of rows on
one device, and :class:`RowMesh` carries the few collectives the sharded
code needs:

* :meth:`RowMesh.all_reduce` of a partial sum (dots, norms, Gram and
  Gram-Schmidt coefficient products);
* :meth:`RowMesh.halo_exchange`, each rank's first and last planes to its
  ring neighbours in one ``all_to_all_single`` (z-slab stencils);
* :meth:`RowMesh.all_gather` of a run of rows (ELL columns, surface runs,
  face tables).

Nothing else in the port calls ``torch.distributed``.  The backend is NCCL
for ``"cuda"`` (one card per rank, ``cuda:LOCAL_RANK``) and gloo for
``"cpu"``.  The same code runs at every world size, 1 included: the halo
exchange at D = 1 is a real collective in which a rank sends its planes to
itself, never a local copy.

Over NCCL every collective here can be captured in a CUDA graph (the
sharded restart cycles are, ``solver/graphs.py``): none reads a device
value on the host, the split lists and shapes are Python ints, and each
collective is one NCCL kernel on the group's stream, joined to the
capturing stream by events.  No environment setting is needed for that
(``chip_smoke.py`` captures each alone and holds its replays against the
eager call).  The group's communicator must exist before a capture: any
eager collective creates it, and a solver's first cycle runs eagerly.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from .._util import DEFAULT_DEVICE

__all__ = ["ROWS", "RowMesh", "initialize_distributed", "make_row_mesh"]

#: Canonical name of the row-partitioned axis (the JAX mesh's axis name).
ROWS = "rows"

#: How long a collective or the group's rendezvous waits before it raises.
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def initialize_distributed(
    master_addr: Optional[str] = None,
    master_port: Optional[int] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    local_rank: Optional[int] = None,
    *,
    device=DEFAULT_DEVICE,
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> int:
    """Join a multi-process job (a no-op when nothing is set).

    Arguments default from torchrun's environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), so a
    launcher only exports those and calls this once.  Returns the world
    size: 1, with no process group, when none of them is set.  The backend
    is NCCL when ``device`` is ``"cuda"`` (the rank then takes
    ``cuda:LOCAL_RANK``) and gloo when it is ``"cpu"``; ``timeout`` bounds
    the rendezvous and every collective.  A half-set launch raises instead
    of solving on one rank's rows.
    """
    master_addr = master_addr or os.environ.get("MASTER_ADDR")
    master_port = master_port or _env_int("MASTER_PORT")
    world_size = world_size if world_size is not None else _env_int("WORLD_SIZE")
    rank = rank if rank is not None else _env_int("RANK")
    local_rank = local_rank if local_rank is not None else _env_int("LOCAL_RANK")
    if not master_addr and (not world_size or world_size <= 1):
        return 1  # fully unset: single-process mode
    if world_size and world_size > 1 and not master_addr:
        raise ValueError(
            f"WORLD_SIZE={world_size} but no MASTER_ADDR: a misconfigured "
            "multi-process launch would silently solve on one rank's rows. "
            "Set MASTER_ADDR and MASTER_PORT."
        )
    if master_addr and not world_size:
        raise ValueError(
            f"MASTER_ADDR is set but WORLD_SIZE is {world_size!r}: set both "
            "(and RANK, MASTER_PORT) for a multi-process launch, or neither "
            "for single-process mode."
        )
    if rank is None or master_port is None:
        raise ValueError("a multi-process launch needs RANK and MASTER_PORT too")
    kind = torch.device(device).type
    if kind == "cuda":
        torch.cuda.set_device(local_rank if local_rank is not None else rank)
    elif kind != "cpu":
        raise ValueError(f"row sharding runs on 'cuda' (NCCL) or 'cpu' (gloo), got {device!r}")
    dist.init_process_group(
        "nccl" if kind == "cuda" else "gloo",
        init_method=f"tcp://{master_addr}:{int(master_port)}",
        world_size=world_size, rank=rank, timeout=timeout,
    )
    return world_size


class RowMesh:
    """One rank's view of the row mesh: the process group, this rank,
    the world size and the device its rows live on, with the collectives
    of the sharded code.  Every rank must call each collective in the same
    order with the same shapes."""

    def __init__(self, group, rank: int, size: int, device: torch.device):
        self.group = group
        self.rank = rank
        self.size = size
        self.device = device
        self.prev = (rank - 1) % size
        self.next = (rank + 1) % size

    def __repr__(self):
        return f"RowMesh(rank={self.rank}, size={self.size}, device={self.device})"

    @property
    def backend(self) -> str:
        """The group's backend: ``"nccl"`` or ``"gloo"``."""
        return dist.get_backend(self.group)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over ranks of ``t`` (a new tensor; ``t`` is untouched)."""
        out = t.clone()
        dist.all_reduce(out, group=self.group)
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` stacked along dim 0 in rank order: (size *
        t.shape[0], ...) for a tensor, (size,) for a 0-d one."""
        t = t.contiguous()
        out = torch.empty((self.size * (t.shape[0] if t.ndim else 1), *t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t if t.ndim else t.reshape(1), group=self.group)
        return out

    def halo_exchange(self, first: torch.Tensor, last: torch.Tensor):
        """Ring halo exchange: send ``last`` to the next rank and ``first``
        to the previous one; return (from_prev, from_next), the previous
        rank's ``last`` and the next rank's ``first``.

        One ``all_to_all_single`` whose splits are zero except for the two
        neighbours: at D = 2 both neighbours are the one peer and at D = 1
        the rank itself, cases a ring of point-to-point sends does not
        take (gloo refuses a send to oneself).  The payload to a rank that
        is both neighbours is [last, first]."""
        if first.shape != last.shape or first.dtype != last.dtype:
            raise ValueError("halo planes differ in shape or dtype")
        flat_first, flat_last = first.reshape(1, -1), last.reshape(1, -1)
        send = [[] for _ in range(self.size)]
        send[self.next].append(flat_last)
        send[self.prev].append(flat_first)
        inp = torch.cat([t for chunk in send for t in chunk])
        in_splits = [len(chunk) for chunk in send]
        out_splits = [(s == self.prev) + (s == self.next) for s in range(self.size)]
        out = torch.empty((2, flat_first.shape[1]), dtype=first.dtype, device=first.device)
        dist.all_to_all_single(out, inp, out_splits, in_splits, group=self.group)
        # Rows of ``out`` come by source rank; a source that is both
        # neighbours sent [its last, its first] = [from_prev, from_next].
        if self.prev == self.next or self.prev < self.next:
            from_prev, from_next = out[0], out[1]
        else:
            from_prev, from_next = out[1], out[0]
        return from_prev.reshape(first.shape), from_next.reshape(first.shape)

    # Reductions of the solvers, built on the collectives above.

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """The global dot of two row-sharded vectors."""
        return self.all_reduce(torch.dot(a, b))

    def basis_dot(self, V: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """``V @ v`` over the global rows: (j, M_local) x (M_local,) -> (j,)."""
        return self.all_reduce(V @ v)

    def dot2_rounded(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``ops/compensated.py:dot2_rounded`` of two row-sharded vectors.

        float32: each rank sums its exact products in float64, the float64
        partial sums are all-reduced and the total rounded once; beside the
        single-device ``dot2_rounded`` (one float64 sum) this adds the
        float64 rounding of D partial sums, ~D eps64 relative, below one
        float32 ulp unless the total sits within that of a rounding
        boundary (at most 1 ulp apart).  float64: each rank's Dot2 (hi, lo)
        pair is all-gathered and the D pairs summed by the double-word tree
        on every rank, so the result keeps Dot2's accuracy and is the same
        on every rank."""
        from ..ops.compensated import dd_sum_tree, dot2

        if a.dtype == torch.float32 and b.dtype == torch.float32:
            s = self.all_reduce(torch.dot(a.double(), b.double()))
            hi = s.to(torch.float32)
            return hi + (s - hi.double()).to(torch.float32)
        hi, lo = dot2(a, b)
        pairs = self.all_gather(torch.stack([hi, lo]).reshape(1, 2))
        h, l = dd_sum_tree(pairs[:, 0].contiguous(), pairs[:, 1].contiguous())
        return h + l


def make_row_mesh(num_devices: Optional[int] = None) -> RowMesh:
    """The row mesh over every rank of the initialized process group.

    ``num_devices`` (the JAX signature's) must equal the world size when
    given.  The device is ``cuda:<current device>`` under NCCL and the CPU
    under gloo.  Call :func:`initialize_distributed` first."""
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call initialize_distributed() (with MASTER_ADDR, "
            "MASTER_PORT, WORLD_SIZE and RANK set) before make_row_mesh()"
        )
    size, rank = dist.get_world_size(), dist.get_rank()
    if num_devices is not None and num_devices != size:
        raise ValueError(f"a mesh of {num_devices} ranks asked for, the group has {size}")
    if dist.get_backend() == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    return RowMesh(dist.group.WORLD, rank, size, device)
