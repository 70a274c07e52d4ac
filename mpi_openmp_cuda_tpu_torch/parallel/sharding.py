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

In a job of several processes each process scores only its own shard
(``comm.ProcessCollectives``), and the gather is a collective that every
process reaches in the same order.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..obs.spans import span as _obs_span
from ..ops.cuda_scorer import ScorerState, finish_rows, kernel_table
from ..ops.dispatch import (
    BucketLaunch, PaddedBatch, max_scored, pad_batch_rows, put, run_launch, wait_event,
)
from ..ops.values import max_abs_value
from ..resilience import watchdog
from ..resilience.faults import fire as _fault
from .comm import Collectives, collectives_for
from .mesh import Mesh, make_mesh

BACKENDS = ("cuda", "mm", "gather")


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

    def result(self) -> np.ndarray:
        with watchdog.guard("sharded result gather"):
            _fault("chunk_scoring")
            with _obs_span("chunk_gather"):
                for ev in self._events or ():
                    wait_event(ev)
                out = np.zeros((self.count, 3), dtype=np.int32)
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
            out[dev] = (put(np.asarray(seq1ext, dtype=np.int32), dev),
                        put(kernel_table(val_flat), dev))
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
        slots = self.comm.local_slots()
        reps = _replicas(batch.seq1ext, val_flat, [self.mesh.device(s) for s in slots])
        out = {}
        for s in slots:
            dev = self.mesh.device(s)
            seq1ext, val = reps[dev]
            shard = slice(s * bl, (s + 1) * bl)
            st = ScorerState(seq1ext=seq1ext, len1=batch.len1, rows=put(rows[shard], dev),
                             lens=put(lens[shard], dev), val=val,
                             max_len2=int(lens[shard].max()))
            launch = BucketLaunch(np.arange(bl), st, None, maxv=maxv, max_scored=longest)
            raw = run_launch(launch, backend)
            out[s] = finish_rows(raw, st.lens, st.len1) if backend == "cuda" else raw
        return ShardedPending(self.comm, [(None, out, list(range(d)), b)], b)
