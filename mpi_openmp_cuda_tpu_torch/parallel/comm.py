"""The collectives of the sharded paths: one interface, two implementations.

The JAX package never names its collectives: XLA derives them from the
``shard_map`` layouts (``ppermute`` for the ring's neighbour exchange, one
``all_gather`` of the per-device candidates, the host fetch of the output).
The port calls them by hand, through this interface:

* ``shift(blocks)`` — the ring's neighbour exchange along the ``seq`` axis:
  slot ``(b, d)`` receives the block of slot ``(b, d + 1 mod sp)``;
* ``all_gather(parts)`` — every slot receives the ``[sp, ...]`` stack of its
  ``seq`` row's parts, lowest ``d`` first;
* ``gather(rows, take)`` — the rows of the slots ``take``, in that order,
  on the host (the ``MPI_Gather`` analogue, after the compute);
* ``broadcast(arr)`` — rank 0's numpy array on every process (the
  ``MPI_Bcast`` analogue, ``parallel/distributed.py``).

Arguments and results are ``{slot: tensor}`` dicts over this process's
slots (:meth:`local_slots`), slots numbered row-major over the mesh.

:class:`LocalCollectives` runs in one process and copies tensors between
the mesh's devices.  :class:`ProcessCollectives` runs over
``torch.distributed``, one slot a process (slot ``r`` is rank ``r``); over
``gloo`` the tensors it moves are staged through host memory, over
``nccl`` they stay on the card.  Both count their calls by kind in
``counts`` (once per slot) and log each as ``(kind, elements)`` in
``log``, the elements a slot receives: what the structure tests read, as
the JAX package's read the collectives of the compiled program.  Both
also keep each local slot's own sequence in ``slot_log`` (``{slot:
[(kind, elements, bytes)]}``, a ``gather`` or ``broadcast`` in every
local slot's sequence, since every slot takes part): the comms audit
(``analysis/collectives.py``) holds the slots' sequences to each other,
and a process's to the one-process run's.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from .mesh import SEQ_AXIS, Mesh


class Collectives:
    """The mesh, the counters and the ring's neighbours, shared by both
    implementations."""

    world = 1

    def __init__(self, mesh: Mesh | None = None):
        self.mesh = mesh
        self.counts: collections.Counter = collections.Counter()
        self.log: list[tuple[str, int]] = []
        self.slot_log: dict[int, list[tuple[str, int, int]]] = {}

    def reset_counts(self) -> None:
        self.counts.clear()
        self.log.clear()
        self.slot_log.clear()

    def _note(self, kind: str, elements: int, itemsize: int, slots) -> None:
        """Count one call of ``kind`` and log it; ``slots`` are the local
        slots whose sequences it enters."""
        self.counts[kind] += 1
        self.log.append((kind, int(elements)))
        for slot in slots:
            self.slot_log.setdefault(slot, []).append(
                (kind, int(elements), int(elements) * int(itemsize)))

    def _sp(self) -> int:
        return self.mesh.shape.get(SEQ_AXIS, 1)

    def _next(self, slot: int) -> int:
        """The slot whose block ``slot`` receives in a ``shift``."""
        b, d = divmod(slot, self._sp())
        return b * self._sp() + (d + 1) % self._sp()

    def _prev(self, slot: int) -> int:
        """The slot ``slot`` sends its block to in a ``shift``."""
        b, d = divmod(slot, self._sp())
        return b * self._sp() + (d - 1) % self._sp()


class LocalCollectives(Collectives):
    """Every slot of the mesh in this process."""

    def local_slots(self) -> list[int]:
        return list(range(self.mesh.size))

    def shift(self, blocks: dict[int, torch.Tensor]) -> dict[int, torch.Tensor]:
        out = {}
        for slot in blocks:
            src = blocks[self._next(slot)]
            self._note("shift", src.numel(), src.element_size(), [slot])
            out[slot] = src.to(self.mesh.device(slot))
        return out

    def all_gather(self, parts: dict[int, torch.Tensor]) -> dict[int, torch.Tensor]:
        sp = self._sp()
        out = {}
        for slot in parts:
            row = slot - slot % sp
            dev = self.mesh.device(slot)
            out[slot] = torch.stack([parts[row + d].to(dev) for d in range(sp)])
            self._note("all_gather", out[slot].numel(), out[slot].element_size(), [slot])
        return out

    def gather(self, rows: dict[int, torch.Tensor], take: list[int]) -> np.ndarray:
        host = np.concatenate([rows[s].cpu().numpy() for s in take])
        self._note("gather", host.size, host.itemsize, rows)
        return host

    def broadcast(self, arr: np.ndarray) -> np.ndarray:
        arr = np.asarray(arr)
        self._note("broadcast", arr.size, arr.itemsize, self.local_slots())
        return arr


class ProcessCollectives(Collectives):
    """One slot a process over the default ``torch.distributed`` group:
    slot ``r`` is rank ``r``.  A mesh with both axes gets one group per
    ``seq`` row for its ``all_gather`` (every rank creates every group, in
    order, when the scorer is built)."""

    def __init__(self, mesh: Mesh | None = None):
        import torch.distributed as dist

        super().__init__(mesh)
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        if mesh is not None and mesh.size != self.world:
            raise ValueError(
                f"a {self.world}-process job needs a mesh of {self.world} "
                f"devices, got {mesh.size}"
            )
        if dist.get_backend() == "gloo":
            self.stage = torch.device("cpu")
        elif mesh is not None:
            self.stage = mesh.device(self.rank)
        else:  # nccl: the card this rank drives (initialize_distributed set it)
            self.stage = torch.device("cuda", torch.cuda.current_device())
        self.seq_group = None  # None: the whole job
        if mesh is not None and SEQ_AXIS in mesh.shape:
            sp = self._sp()
            if sp < self.world:
                groups = [dist.new_group(list(range(r, r + sp)))
                          for r in range(0, self.world, sp)]
                self.seq_group = groups[self.rank // sp]

    def local_slots(self) -> list[int]:
        return [self.rank]

    def _own(self, parts: dict[int, torch.Tensor]) -> torch.Tensor:
        if list(parts) != [self.rank]:
            raise ValueError(f"rank {self.rank} holds slot {self.rank} only, got {list(parts)}")
        return parts[self.rank].to(self.stage).contiguous()

    def shift(self, blocks: dict[int, torch.Tensor]) -> dict[int, torch.Tensor]:
        import torch.distributed as dist

        send = self._own(blocks)
        recv = torch.empty_like(send)
        src, dst = self._next(self.rank), self._prev(self.rank)
        if src == self.rank:
            recv.copy_(send)
        else:
            ops = [dist.P2POp(dist.isend, send, dst), dist.P2POp(dist.irecv, recv, src)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        self._note("shift", recv.numel(), recv.element_size(), [self.rank])
        return {self.rank: recv.to(self.mesh.device(self.rank))}

    def all_gather(self, parts: dict[int, torch.Tensor]) -> dict[int, torch.Tensor]:
        import torch.distributed as dist

        send = self._own(parts)
        bufs = [torch.empty_like(send) for _ in range(self._sp())]
        dist.all_gather(bufs, send, group=self.seq_group)
        out = torch.stack(bufs).to(self.mesh.device(self.rank))
        self._note("all_gather", out.numel(), out.element_size(), [self.rank])
        return {self.rank: out}

    def gather(self, rows: dict[int, torch.Tensor], take: list[int]) -> np.ndarray:
        import torch.distributed as dist

        send = self._own(rows)
        bufs = [torch.empty_like(send) for _ in range(self.world)]
        dist.all_gather(bufs, send)
        host = np.concatenate([bufs[s].cpu().numpy() for s in take])
        self._note("gather", host.size, host.itemsize, [self.rank])
        return host

    def broadcast(self, arr: np.ndarray) -> np.ndarray:
        """Rank 0's ``arr`` on every rank (same shape and dtype everywhere,
        which the callers' headers guarantee).  An empty array moves
        nothing: every rank knows its shape from the header."""
        import torch.distributed as dist

        arr = np.ascontiguousarray(arr)
        self._note("broadcast", arr.size, arr.itemsize, [self.rank])
        if arr.size == 0:
            return arr
        t = torch.from_numpy(arr.copy()).to(self.stage)
        dist.broadcast(t, src=0)
        return t.cpu().numpy()


def collectives_for(mesh: Mesh | None) -> Collectives:
    """:class:`ProcessCollectives` inside a job of several processes, else
    :class:`LocalCollectives`."""
    from .distributed import process_count

    return ProcessCollectives(mesh) if process_count() > 1 else LocalCollectives(mesh)
