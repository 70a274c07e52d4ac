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
``torch.distributed``, ``k`` slots a process (process ``r`` drives slots
``r * k`` to ``r * k + k - 1``, :meth:`Mesh.owner`): between a process's
own slots it copies, as :class:`LocalCollectives` does, and between
processes it calls ``torch.distributed``; over ``gloo`` the tensors it
moves are staged through host memory, over ``nccl`` through the
process's first card.  Both count their calls by kind in
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

from .distributed import process_count, slots_per_process
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


def group_plan(mesh: Mesh) -> list[tuple[int, ...]]:
    """The process sets of the ``seq`` rows that span processes, first
    appearance first, each once: the groups every rank creates, in this
    order, for the rows' ``all_gather`` (a set of every process is the
    whole job and needs no group of its own)."""
    if SEQ_AXIS not in mesh.shape:
        return []
    sp, plan = mesh.shape[SEQ_AXIS], []
    for row in range(0, mesh.size, sp):
        procs = tuple(sorted({mesh.owner(s) for s in range(row, row + sp)}))
        if 1 < len(procs) < mesh.processes and procs not in plan:
            plan.append(procs)
    return plan


class ProcessCollectives(Collectives):
    """``k`` slots a process over the default ``torch.distributed`` group:
    process ``r`` drives slots ``r * k`` to ``r * k + k - 1``.  A ``seq``
    row that spans some but not all processes gathers in a group of its
    own (:func:`group_plan`; every rank creates every group, in order,
    when the scorer is built)."""

    def __init__(self, mesh: Mesh | None = None):
        import torch.distributed as dist

        super().__init__(mesh)
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self.k = 1
        if mesh is not None:
            self.k = slots_per_process()
            if mesh.size != self.world * self.k:
                raise ValueError(
                    f"a {self.world}-process job of {self.k} slots a process needs a "
                    f"mesh of {self.world * self.k} devices, got {mesh.size}"
                )
        if dist.get_backend() == "gloo":
            self.stage = torch.device("cpu")
        elif mesh is not None:
            self.stage = mesh.device(self.rank * self.k)
        else:  # nccl: the card this rank drives (initialize_distributed set it)
            self.stage = torch.device("cuda", torch.cuda.current_device())
        self.groups = {}  # process set -> group; a set of every process: None
        for procs in group_plan(mesh) if mesh is not None else ():
            self.groups[procs] = dist.new_group(list(procs))

    def local_slots(self) -> list[int]:
        return list(range(self.rank * self.k, (self.rank + 1) * self.k))

    def _staged(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.stage).contiguous()

    def _tag(self, src: int, dst: int) -> int:
        """The P2P tag of slot ``src``'s block to slot ``dst``: distinct for
        every pair of slots, so gloo matches no message by order."""
        return src * self.mesh.size + dst

    def shift(self, blocks: dict[int, torch.Tensor]) -> dict[int, torch.Tensor]:
        """A neighbour on this process is a device copy; the blocks to and
        from other processes move in one ``batch_isend_irecv``, sends then
        receives, each in tag order."""
        import torch.distributed as dist

        owner, slots = self.mesh.owner, self.local_slots()
        out, sends, recvs = {}, [], []
        for slot in slots:
            dst = self._prev(slot)
            if owner(dst) != self.rank:
                sends.append((self._tag(slot, dst), self._staged(blocks[slot]), owner(dst)))
            src = self._next(slot)
            if owner(src) == self.rank:
                out[slot] = blocks[src]
            else:
                buf = torch.empty(blocks[slot].shape, dtype=blocks[slot].dtype,
                                  device=self.stage)
                recvs.append((self._tag(src, slot), buf, owner(src), slot))
        sends.sort(key=lambda op: op[0])
        recvs.sort(key=lambda op: op[0])
        ops = ([dist.P2POp(dist.isend, t, peer, tag=tag) for tag, t, peer in sends]
               + [dist.P2POp(dist.irecv, t, peer, tag=tag) for tag, t, peer, _ in recvs])
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        for _, buf, _, slot in recvs:
            out[slot] = buf
        for slot in slots:
            got = out[slot] = out[slot].to(self.mesh.device(slot))
            self._note("shift", got.numel(), got.element_size(), [slot])
        return out

    def all_gather(self, parts: dict[int, torch.Tensor]) -> dict[int, torch.Tensor]:
        """A ``seq`` row this process holds whole is stacked here; a row that
        spans processes gathers the stack of each holder's slots of it (padded
        to the largest share) in the group of its holders, rows in order."""
        import torch.distributed as dist

        sp, out = self._sp(), {}
        for row in sorted({s - s % sp for s in parts}):
            share = {}  # holder rank -> its slots of the row, ranks ascending
            for s in range(row, row + sp):
                share.setdefault(self.mesh.owner(s), []).append(s)
            mine = share[self.rank]
            if len(share) == 1:
                stack = [parts[s] for s in mine]
            else:
                width = max(map(len, share.values()))
                send = torch.stack([self._staged(parts[s]) for s in mine])
                if len(mine) < width:
                    send = torch.cat([send, send.new_zeros((width - len(mine),
                                                            *send.shape[1:]))])
                bufs = [torch.empty_like(send) for _ in share]
                dist.all_gather(bufs, send, group=self.groups.get(tuple(share)))
                stack = [t for p, buf in zip(share, bufs) for t in buf[: len(share[p])]]
            for s in mine:
                dev = self.mesh.device(s)
                out[s] = torch.stack([t.to(dev) for t in stack])
                self._note("all_gather", out[s].numel(), out[s].element_size(), [s])
        return out

    def gather(self, rows: dict[int, torch.Tensor], take: list[int]) -> np.ndarray:
        """One ``all_gather`` of every process's ``[k, ...]`` stack of its
        slots' rows; the host concatenation takes ``take`` in order."""
        import torch.distributed as dist

        send = torch.stack([self._staged(rows[s]) for s in self.local_slots()])
        bufs = [torch.empty_like(send) for _ in range(self.world)]
        dist.all_gather(bufs, send)
        k = self.k
        host = np.concatenate([bufs[s // k][s % k].cpu().numpy() for s in take])
        self._note("gather", host.size, host.itemsize, self.local_slots())
        return host

    def broadcast(self, arr: np.ndarray) -> np.ndarray:
        """Rank 0's ``arr`` on every rank (same shape and dtype everywhere,
        which the callers' headers guarantee), once a process.  An empty
        array moves nothing: every rank knows its shape from the header."""
        import torch.distributed as dist

        arr = np.ascontiguousarray(arr)
        self._note("broadcast", arr.size, arr.itemsize, self.local_slots())
        if arr.size == 0:
            return arr
        t = torch.from_numpy(arr.copy()).to(self.stage)
        dist.broadcast(t, src=0)
        return t.cpu().numpy()


def collectives_for(mesh: Mesh | None) -> Collectives:
    """:class:`ProcessCollectives` inside a job of several processes, else
    :class:`LocalCollectives`."""
    return ProcessCollectives(mesh) if process_count() > 1 else LocalCollectives(mesh)
