"""Batch sharding: the Scatter/Compute/Gather tier (the port of
``mpi_openmp_cuda_tpu/parallel/sharding.py``; reference parity: C6 + C7).

The reference scatters the Seq2 batch to its ranks (``MPI_Scatter`` of a
fixed-stride buffer), scores each rank's share independently, and gathers
the results (``MPI_Gather`` x3), with a serial remainder on the root
(main.c:110-121,174,184-185,195-197).  Here:

* the dispatch plans the batch's launch groups once
  (``dispatch.launch_plans``: length buckets, then groups priced at one
  device's shard of their rows, ``schedule.plan_fusion_groups``), and
  each group's plan splits into one shard a slot of ``ceil(B /
  devices)`` rows (:func:`shard_plans`), the last shards padded with
  empty rows of length 0: no remainder rank, a padding row costs one row
  of a launch and is dropped on output;
* each device receives one arena a dispatch (``ops/feed.py``, one copy
  from a pinned slot of the device's own ring): Seq1 and the kernels'
  value table once (the ``MPI_Bcast`` / constant-memory tier), then the
  rows and lengths of every shard of every group its slots take;
* each shard is scored by one launch on its own device, the fused kernel
  (or the formulation ``dispatch.effective_backend`` routes the launch
  to), with **no collective inside the compute**, its finished rows
  written, in launch order, into its slot's one ``[sum of shard rows,
  3]`` buffer;
* :meth:`ShardedPending.result` gathers those buffers to the host once a
  dispatch, the ``MPI_Gather`` analogue, and puts the rows in input order.

In a job of several processes each process scores only the shards of
its local slots (``comm.ProcessCollectives``), and the gather is a
collective that every process reaches in the same order.

Obs hooks, the mesh tier's counterparts of the reference's MPI calls
(detail spans, nested under the dispatch's ``chunk_dispatch`` and
``chunk_gather``): ``shard_replicate`` (what every device's arena
shares, made once: the kernel table, and the groups' shards,
``MPI_Bcast``), ``shard_place`` (each device's arena written and sent,
``MPI_Scatter``), ``shard_launch`` (each shard's kernels enqueued, the
finish kernel writing the shard's finished rows) and ``shard_gather``
(the slots' rows back to the host, ``MPI_Gather``), after ``device_wait``
(the host's block on the cards, as in the single-device gather).
:data:`mesh_counts` counts, in every run, each arena
(``mesh_h2d_copies``, ``mesh_h2d_bytes``: a host-to-device copy on a
card), each shard's launch (``mesh_shard_launches``, one a slot a
group), the empty rows the padding adds (``mesh_pad_rows``) and the
length buckets folded into a launch group of two or more
(``mesh_fused_buckets``); with the obs plane armed the run report and
the serve ``metrics`` verb count them too.
"""

from __future__ import annotations

import dataclasses
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from ..obs.metrics import inc as _obs_inc
from ..obs.spans import span as _obs_span
from ..ops.cuda_scorer import kernel_table
from ..ops.dispatch import MIN_BUCKET_ROWS, PlannedLaunch, _upload, run_launch, wait_event
from ..ops.feed import FeedRing
from ..resilience import watchdog
from ..resilience.faults import fire as _fault
from .comm import Collectives, collectives_for
from .mesh import Mesh, make_mesh

BACKENDS = ("cuda", "mm", "gather")

# The batch mesh's placements, launches, padding and grouped buckets, in
# every run (as ``cuda_scorer.launch_counts``); also in the run report
# when armed.
mesh_counts = {"mesh_h2d_copies": 0, "mesh_h2d_bytes": 0, "mesh_shard_launches": 0,
               "mesh_pad_rows": 0, "mesh_fused_buckets": 0}
_count_lock = threading.Lock()


def _count(name: str, n: int = 1) -> None:
    with _count_lock:  # a served mesh dispatches from the fleet's threads too
        mesh_counts[name] += n
    _obs_inc(name, n)


def shard_plans(plan: PlannedLaunch, n: int) -> list[PlannedLaunch]:
    """``plan`` split into ``n`` contiguous shards of ``ceil(B / n)`` rows
    (at least one) at the plan's row width, the last shards padded with
    empty rows of length 0; a shard's ``idx`` holds its real rows only."""
    b = plan.idx.size
    bl = max(1, -(-b // n))
    empty = plan.rows[0][:0]
    out = []
    for s in range(n):
        lo, hi = min(s * bl, b), min((s + 1) * bl, b)
        pad = bl - (hi - lo)
        out.append(dataclasses.replace(
            plan, idx=plan.idx[lo:hi], rows=plan.rows[lo:hi] + (empty,) * pad,
            len2=np.concatenate([plan.len2[lo:hi], np.zeros(pad, dtype=np.int32)])))
    return out


class ShardedPending:
    """A dispatched, not yet gathered sharded result.

    ``rows`` holds per local slot its int32 ``[W, 3]`` rows on the slot's
    device (every slot's the same shape), ``take`` the slots whose rows
    form the output, in order, and ``pos`` each input row's position in
    their concatenation.  :meth:`result` gathers once (``comm.gather``, a
    collective in a multi-process job) and takes ``pos``, under the
    watchdog's guard.  :meth:`prefetch` starts the device-to-host copies
    in a one-process job (in a multi-process one the gather is the
    collective itself)."""

    def __init__(self, comm: Collectives, rows: dict, take: list[int], pos: np.ndarray):
        self.comm = comm
        self.rows = rows
        self.take = take
        self.pos = pos
        self._events = None

    def prefetch(self) -> None:
        _fault("device_transfer")
        if self.comm.world > 1 or self._events is not None:
            return
        events, host = [], {}
        for s in self.take:
            t = self.rows[s]
            if t.device.type == "cuda":
                host[s] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host[s].copy_(t, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(t.device))
                events.append(ev)
            else:
                host[s] = t
        self.rows, self._events = host, events

    def _card_events(self) -> list:
        """Where no :meth:`prefetch` started the copies: in a one-process
        job, one event at the end of each card's queued work, so the wait
        on the cards is its own (``device_wait``) and the gather only
        copies."""
        if self.comm.world > 1:
            return []
        devices = {self.rows[s].device for s in self.take}
        events = []
        for dev in sorted((d for d in devices if d.type == "cuda"), key=lambda d: d.index):
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            events.append(ev)
        return events

    def result(self) -> np.ndarray:
        with watchdog.guard("sharded result gather"):
            _fault("chunk_scoring")
            with _obs_span("chunk_gather"):
                events = self._events if self._events is not None else self._card_events()
                if events:
                    with _obs_span("device_wait", detail=True):
                        for ev in events:
                            wait_event(ev)
                with _obs_span("shard_gather", detail=True):
                    return self.comm.gather(self.rows, self.take)[self.pos]


@dataclass
class BatchSharding:
    """Scores a batch's planned launches data-parallel over a 1-D device
    mesh."""

    mesh: Mesh
    comm: Collectives = field(default=None)
    feeds: dict = field(default_factory=dict, repr=False)  # device -> FeedRing

    # The caps hold on a batch mesh.
    unbounded = False

    def __post_init__(self):
        if self.comm is None:
            self.comm = collectives_for(self.mesh)

    @classmethod
    def over_devices(cls, n_devices: int | None = None, *, device="cuda",
                     devices=None) -> "BatchSharding":
        return cls(mesh=make_mesh(n_devices, devices=devices, device=device))

    @property
    def n_devices(self) -> int:
        return self.mesh.size

    @property
    def min_rows(self) -> int:
        """Length buckets of fewer rows merge into the next wider one: each
        pads to the device count.  Every process derives the same buckets
        and launch groups, in the same order, from the same broadcast
        lengths."""
        return MIN_BUCKET_ROWS * self.n_devices

    def score_async(self, plans, val_flat, backend: str = "cuda") -> ShardedPending:
        """The launch groups ``plans`` (``dispatch.launch_plans``) scored
        without the gather: one arena a device sent, one launch a group a
        local slot queued on its device, and a :class:`ShardedPending`
        returned at once."""
        backend = "cuda" if backend == "auto" else backend
        if backend not in BACKENDS:
            raise ValueError(
                f"backend {backend!r} is not available on a batch mesh; "
                f"use one of {', '.join(BACKENDS)}"
            )
        d, slots = self.n_devices, self.comm.local_slots()
        with _obs_span("shard_replicate", detail=True):
            table = kernel_table(val_flat)
            shards = [shard_plans(p, d) for p in plans]  # [group][slot]
            bls = [group[0].len2.size for group in shards]
            row0 = np.cumsum([0] + bls)
            on = {}  # device -> its local slots
            for s in slots:
                on.setdefault(self.mesh.device(s), []).append(s)
        _count("mesh_pad_rows", sum(bl * d - p.idx.size for bl, p in zip(bls, plans)))
        _count("mesh_fused_buckets", sum(len(p.keys) for p in plans if len(p.keys) > 1))
        launches = {}
        for dev, own in on.items():
            keys = [(i, s) for s in own for i in range(len(plans))]
            with _obs_span("shard_place", detail=True):
                got = _upload(val_flat, [shards[i][s] for i, s in keys], dev,
                              self.feeds.setdefault(dev, FeedRing(dev.type == "cuda")),
                              row0=[row0[i] for i, _ in keys], table=table)
            launches.update(zip(keys, got))
            _count("mesh_h2d_copies")
            _count("mesh_h2d_bytes", got[0].state.rows.untyped_storage().nbytes())
        width = int(row0[-1])
        out = {s: torch.empty((width, 3), dtype=torch.int32, device=self.mesh.device(s))
               for s in slots}
        for i in range(len(plans)):
            for s in slots:
                with _obs_span("shard_launch", detail=True):
                    run_launch(launches[i, s], backend, out[s])
                _count("mesh_shard_launches")
        pos = np.empty(sum(p.idx.size for p in plans), dtype=np.int64)
        for i, group in enumerate(shards):
            for s, shard in enumerate(group):
                pos[shard.idx] = s * width + row0[i] + np.arange(shard.idx.size)
        return ShardedPending(self.comm, out, list(range(d)), pos)
