"""Device meshes (the port of ``mpi_openmp_cuda_tpu/parallel/mesh.py``).

The reference's process topology is ``mpiexec -np N`` over
``MPI_COMM_WORLD``.  A :class:`Mesh` is its counterpart: an array of
``torch.device`` slots with named axes, a 1-D ``('batch',)`` axis for data
parallelism over the Seq2 batch and, for the sequence-parallel ring
(``parallel/ring.py``), a 2-D ``('batch', 'seq')`` one.  One process drives every slot, or, under
``--distributed``, process ``r`` of a job whose processes drive ``k``
slots each drives slots ``r * k`` to ``r * k + k - 1`` (its local slots,
process-major, as ``jax.devices()`` orders a multi-process JAX job;
:meth:`Mesh.owner`, and ``parallel/comm.py`` picks the collectives).

The devices a mesh can take: on ``cuda``, one slot per card
(``torch.cuda.device_count()``) unless ``devices=`` names them (repeats
allowed, as in JAX: a one-card host can run a mesh whose slots all name
``cuda:0``), or, when ``SEQALIGN_HOST_DEVICES`` asks for more slots than
there are cards, that many slots naming the cards in turn (so the native
driver's ``TPU_SEQALIGN_MESH`` reaches a mesh on a one-card host); on
``cpu``, ``SEQALIGN_HOST_DEVICES`` slots (default 1), each naming the one
CPU device, the counterpart of XLA's
``--xla_force_host_platform_device_count``; under ``--distributed``, every
process's local slots (``distributed.local_devices``), this process's own
devices in its slots and placeholders of the device kind in the others.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils.env import env_int
from .distributed import local_devices, process_count, process_index, slots_per_process

BATCH_AXIS = "batch"
SEQ_AXIS = "seq"


@dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``, an object array of ``torch.device``, with one name per
    axis."""

    devices: np.ndarray
    axis_names: tuple[str, ...]
    #: The processes whose local slots the mesh takes, process-major.
    processes: int = 1

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def device(self, slot: int) -> torch.device:
        """The device of flat slot ``slot`` (row-major)."""
        return self.devices.flat[slot]

    @property
    def per_process(self) -> int:
        """The slots each process drives."""
        return self.size // self.processes

    def owner(self, slot: int) -> int:
        """The rank of the process that drives flat slot ``slot``."""
        return slot // self.per_process


def global_devices(device="cuda") -> list[torch.device]:
    """The devices a mesh over ``device`` (``'cuda'`` or ``'cpu'``) can
    take, in slot order: under ``--distributed`` every process's local
    slots, process-major (this process's own devices in its slots), else
    this host's."""
    kind = torch.device(device).type
    world = process_count()
    if world > 1:
        rank, k = process_index(), slots_per_process()
        mine = local_devices(kind)
        if len(mine) != k:
            raise RuntimeError(
                f"rank {rank} drives {len(mine)} {kind} slots, but the job "
                f"agreed on {k} a process"
            )
        return [dev for r in range(world)
                for dev in (mine if r == rank else [torch.device(kind)] * k)]
    slots = max(1, env_int("SEQALIGN_HOST_DEVICES"))
    if kind == "cpu":
        return [torch.device("cpu")] * slots
    cards = [torch.device(f"cuda:{i}") for i in range(torch.cuda.device_count())]
    if cards and slots > len(cards):
        return [cards[i % len(cards)] for i in range(slots)]
    return cards


def _mesh(devs: list, shape: tuple[int, ...], names: tuple[str, ...]) -> Mesh:
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), names, processes=process_count())


def make_mesh(n_devices: int | None = None, *, axis_name: str = BATCH_AXIS,
              devices=None, device="cuda") -> Mesh:
    """1-D mesh over the first ``n_devices`` devices (default: all)."""
    devs = list(devices if devices is not None else global_devices(device))
    if n_devices is not None:
        if n_devices < 1:
            raise ValueError(f"mesh needs at least 1 device, got {n_devices}")
        if n_devices > len(devs):
            raise ValueError(
                f"requested {n_devices} devices but only {len(devs)} available"
            )
        if process_count() > 1 and n_devices != len(devs):
            # Slicing the global device list would leave some processes
            # with no slot; they would hang in the collectives.
            raise ValueError(
                f"multi-host jobs must mesh all {len(devs)} global devices, "
                f"got --mesh {n_devices}"
            )
        devs = devs[:n_devices]
    return _mesh(devs, (len(devs),), (axis_name,))


def make_2d_mesh(batch: int, seq: int, *, devices=None, device="cuda") -> Mesh:
    """[batch, seq] mesh for combined data + sequence parallelism."""
    devs = list(devices if devices is not None else global_devices(device))
    if batch * seq > len(devs):
        raise ValueError(
            f"mesh {batch}x{seq} needs {batch * seq} devices, have {len(devs)}"
        )
    if process_count() > 1 and batch * seq != len(devs):
        raise ValueError(
            f"multi-host jobs must mesh all {len(devs)} global devices, "
            f"got {batch}x{seq}"
        )
    return _mesh(devs[: batch * seq], (batch, seq), (BATCH_AXIS, SEQ_AXIS))
