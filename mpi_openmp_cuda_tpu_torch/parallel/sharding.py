"""Batch sharding: the Scatter/Compute/Gather tier (the port of
``mpi_openmp_cuda_tpu/parallel/sharding.py``; reference parity: C6 + C7).

The reference scatters the Seq2 batch to its ranks (``MPI_Scatter`` of a
fixed-stride buffer), scores each rank's share independently, and gathers
the results (``MPI_Gather`` x3), with a serial remainder on the root
(main.c:110-121,174,184-185,195-197).  Here:

* the batch is padded to a multiple of the device count with empty rows
  (``pad_batch_rows``): no remainder rank, a padded row costs one row of
  a launch and is dropped on output;
* each device of the mesh takes one contiguous shard of rows, and Seq1
  and the value table are copied to every device (the ``MPI_Bcast`` /
  constant-memory tier);
* each shard is scored by one launch on its own device, the fused kernel
  (or the formulation ``dispatch.effective_backend`` routes the launch
  to), with **no collective inside the compute**;
* :meth:`ShardedPending.result` gathers the shards' rows to the host, the
  ``MPI_Gather`` analogue: one ``gather`` a length bucket.

In a job of several processes each process scores only the shards of
its local slots (``comm.ProcessCollectives``), and the gather is a
collective that every process reaches in the same order.

Obs hooks, the mesh tier's counterparts of the reference's MPI calls
(detail spans, nested under the dispatch's ``chunk_dispatch`` and
``chunk_gather``): ``shard_replicate`` (Seq1 and the table to each
device, ``MPI_Bcast``), ``shard_place`` (each shard's rows and lengths,
``MPI_Scatter``), ``shard_launch`` (each shard's kernels enqueued, the
finish kernel writing the shard's finished rows) and ``shard_gather``
(the shards back to the host, ``MPI_Gather``), after ``device_wait`` (the host's block on the cards,
as in the single-device gather).  :data:`mesh_counts` counts, in every
run, each placement (``mesh_h2d_copies``, ``mesh_h2d_bytes``: a
host-to-device copy on a card), each shard's launch
(``mesh_shard_launches``, one a slot a dispatch) and the empty rows the
padding adds (``mesh_pad_rows``); with the obs plane armed the run
report counts them too.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from ..obs.metrics import inc as _obs_inc
from ..obs.spans import span as _obs_span
from ..ops.cuda_scorer import ScorerState, kernel_table
from ..ops.dispatch import (
    BucketLaunch, PaddedBatch, max_scored, pad_batch_rows, put, run_launch, wait_event,
)
from ..ops.values import max_abs_value
from ..resilience import watchdog
from ..resilience.faults import fire as _fault
from .comm import Collectives, collectives_for
from .mesh import Mesh, make_mesh

BACKENDS = ("cuda", "mm", "gather")

# The batch mesh's placements, launches and padding, in every run (as
# ``cuda_scorer.launch_counts``); also in the run report when armed.
mesh_counts = {"mesh_h2d_copies": 0, "mesh_h2d_bytes": 0, "mesh_shard_launches": 0,
               "mesh_pad_rows": 0}
_count_lock = threading.Lock()


def _count(name: str, n: int = 1) -> None:
    with _count_lock:  # a served mesh dispatches from the fleet's threads too
        mesh_counts[name] += n
    _obs_inc(name, n)


def _place(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """``put``, counted as one of the mesh's host-to-device copies."""
    t = put(arr, device)
    _count("mesh_h2d_copies")
    _count("mesh_h2d_bytes", t.numel() * t.element_size())
    return t


class ShardedPending:
    """A dispatched, not yet gathered sharded result.

    ``parts`` holds one entry a dispatch (a length bucket): the input rows
    it scores (None: the first ``n``), per local slot its ``[bl, 3]`` int32
    rows on the slot's device, the slots whose rows form the output (in
    order) and ``n``.  :meth:`result` gathers each part to the host
    (``comm.gather``, a collective in a multi-process job, in part order on
    every process) and restores input order, under the watchdog's guard.
    :meth:`prefetch` starts the device-to-host copies in a one-process job
    (in a multi-process one the gather is the collective itself)."""

    def __init__(self, comm: Collectives, parts: list, count: int):
        self.comm = comm
        self.parts = parts
        self.count = count
        self._events = None

    @classmethod
    def merge(cls, pendings: list, count: int) -> "ShardedPending":
        """One pending over ``[(input rows, ShardedPending)]`` of one
        batch's buckets, dispatched in that order."""
        parts = [(idx, rows, take, n)
                 for idx, pend in pendings for _, rows, take, n in pend.parts]
        return cls(pendings[0][1].comm, parts, count)

    def prefetch(self) -> None:
        _fault("device_transfer")
        if self.comm.world > 1 or self._events is not None:
            return
        events, parts = [], []
        for idx, rows, take, n in self.parts:
            host = {}
            for s in take:
                t = rows[s]
                if t.device.type == "cuda":
                    host[s] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    host[s].copy_(t, non_blocking=True)
                    ev = torch.cuda.Event()
                    ev.record(torch.cuda.current_stream(t.device))
                    events.append(ev)
                else:
                    host[s] = t
            parts.append((idx, host, take, n))
        self.parts, self._events = parts, events

    def _card_events(self) -> list:
        """Where no :meth:`prefetch` started the copies: in a one-process
        job, one event at the end of each card's queued work, so the wait
        on the cards is its own (``device_wait``) and the gather only
        copies."""
        if self.comm.world > 1:
            return []
        devices = {rows[s].device for _, rows, take, _ in self.parts for s in take}
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
                out = np.zeros((self.count, 3), dtype=np.int32)
                with _obs_span("shard_gather", detail=True):
                    for idx, rows, take, n in self.parts:
                        host = self.comm.gather(rows, take)[:n]
                        if idx is None:
                            out[:n] = host
                        else:
                            out[idx] = host
                return out


def _replicas(seq1ext, val_flat, devices) -> dict:
    """Seq1 and the kernels' value table on every device, one copy each."""
    out = {}
    for dev in devices:
        if dev not in out:
            out[dev] = (_place(np.asarray(seq1ext, dtype=np.uint8), dev),
                        _place(kernel_table(val_flat), dev))
    return out


@dataclass
class BatchSharding:
    """Scores a PaddedBatch data-parallel over a 1-D device mesh."""

    mesh: Mesh
    comm: Collectives = field(default=None)

    # Batch meshes take length-bucketed dispatch: every process derives the
    # same buckets, in the same order, from the same broadcast lengths.
    bucketed = True

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

    def score(self, batch: PaddedBatch, val_flat, backend: str = "cuda") -> np.ndarray:
        """[B, 3] int32 host array, input order."""
        return self.score_async(batch, val_flat, backend=backend).result()

    def score_async(self, batch: PaddedBatch, val_flat, backend: str = "cuda") -> ShardedPending:
        """``score`` without the gather: one launch a local shard, queued on
        its device, and a :class:`ShardedPending` returned at once."""
        backend = "cuda" if backend == "auto" else backend
        if backend not in BACKENDS:
            raise ValueError(
                f"backend {backend!r} is not available on a batch mesh; "
                f"use one of {', '.join(BACKENDS)}"
            )
        d, b = self.n_devices, batch.batch_size
        bl = max(1, -(-b // d))  # rows a shard
        rows, lens = pad_batch_rows(batch, bl * d)
        maxv, longest = max_abs_value(val_flat), max_scored(batch)
        _count("mesh_pad_rows", bl * d - b)
        slots = self.comm.local_slots()
        with _obs_span("shard_replicate", detail=True):
            reps = _replicas(batch.seq1ext, val_flat, [self.mesh.device(s) for s in slots])
        out = {}
        for s in slots:
            dev = self.mesh.device(s)
            seq1ext, val = reps[dev]
            shard = slice(s * bl, (s + 1) * bl)
            with _obs_span("shard_place", detail=True):
                st = ScorerState(seq1ext=seq1ext, len1=batch.len1,
                                 rows=_place(rows[shard], dev), lens=_place(lens[shard], dev),
                                 val=val, max_len2=int(lens[shard].max()))
            with _obs_span("shard_launch", detail=True):
                launch = BucketLaunch(np.arange(bl), st, None, maxv=maxv, max_scored=longest)
                out[s] = run_launch(launch, backend)  # [bl, 3] finished rows on its card
            _count("mesh_shard_launches")
        return ShardedPending(self.comm, [(None, out, list(range(d)), b)], b)
