"""Multi-process jobs over ``torch.distributed`` (the port of
``mpi_openmp_cuda_tpu/parallel/distributed.py``; reference parity: the C7
process tier and the makefile's ``runOn2``).

The reference deploys with ``mpiexec -np 2``: the same binary on every
node, rank 0 doing the I/O.  Here every process runs the same CLI with
``--distributed``; :func:`initialize_distributed` joins the job from
torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, read through
``utils/env.py``), and only rank 0 touches stdin/stdout: the other ranks
feed from its broadcasts, as the reference's ``MPI_Bcast`` of seq1, the
weights and the sizes (main.c:149-152).

One device a process.  On ``cuda`` a rank drives ``cuda:LOCAL_RANK`` over
``nccl`` when the host has a card for every local rank; when ranks must
share a card (a one-card host), rank ``r`` drives ``cuda:(LOCAL_RANK mod
device_count)`` over ``gloo``, with the small tensors it moves staged
through host memory, since NCCL refuses two ranks on one device.  On
``cpu`` the transport is ``gloo``.  The kernels run on the card either
way; the choice is a transport's, told once on stderr and kept in the run
report's gauges.

The broadcasts are two-phase, as in the JAX package: a fixed-shape header
(sizes, or an abort flag) first, then the payload, so a coordinator that
fails before or while parsing releases its workers with an abort header
instead of leaving them blocked in a collective.  Each is a fault site
(``--faults``) and runs under the run's watchdog guard.  The lost-shard
rescue tier (``scatter_gather_rescue`` in the JAX package) is not ported
yet.
"""

from __future__ import annotations

import datetime
import functools

import numpy as np
import torch

from ..obs.events import log_line
from ..obs.metrics import gauge as _obs_gauge
from ..resilience.faults import fire as _fault
from ..resilience.watchdog import guard as _deadline_guard
from ..utils.env import env_int, env_str

# Seconds a collective may wait for a peer before the job fails (a peer
# that died closes its sockets and fails it at once).
TIMEOUT_S = 300


def _guarded(describe: str):
    """Arm the run's watchdog (if any) around a coordinator broadcast; a
    no-op when none is armed."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with _deadline_guard(describe):
                return fn(*args, **kwargs)

        return wrapper

    return deco


def _rendezvous() -> tuple[str, int, int, int]:
    """``(address, port, world size, rank)`` from the environment."""
    addr, port = env_str("MASTER_ADDR"), env_int("MASTER_PORT")
    world, rank = env_int("WORLD_SIZE"), env_int("RANK")
    if None in (addr, port, world, rank):
        raise RuntimeError(
            "multi-process initialization failed: set MASTER_ADDR, MASTER_PORT, "
            "WORLD_SIZE and RANK (torchrun sets them)"
        )
    if not 0 <= rank < world:
        raise RuntimeError(f"multi-process initialization failed: RANK {rank} "
                           f"outside WORLD_SIZE {world}")
    return addr, port, world, rank


def _local() -> tuple[int, int]:
    """``(local rank, local world size)``; a job on one host by default."""
    rank = env_int("LOCAL_RANK")
    world = env_int("LOCAL_WORLD_SIZE")
    return (env_int("RANK", 0) if rank is None else rank,
            env_int("WORLD_SIZE", 1) if world is None else world)


def local_device(kind: str = "cuda") -> torch.device:
    """This process's device: ``cuda:(LOCAL_RANK mod device_count)`` on
    ``cuda``, the CPU on ``cpu``."""
    if torch.device(kind).type == "cpu":
        return torch.device("cpu")
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError(
            "no CUDA device is available; pass --device cpu to score on the CPU"
        )
    return torch.device(f"cuda:{_local()[0] % count}")


def transport(kind: str = "cuda") -> str:
    """``nccl`` when every local rank has a card of its own, else
    ``gloo``."""
    if torch.device(kind).type == "cpu":
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= _local()[1] else "gloo"


def initialize_distributed(device="cuda") -> None:
    """Join the job this process belongs to (the ``runOn2`` analogue), its
    device of kind ``device`` and transport chosen by
    :func:`local_device` and :func:`transport`."""
    import torch.distributed as dist

    addr, port, world, rank = _rendezvous()
    kind = torch.device(device).type
    dev = local_device(kind)
    backend = transport(kind)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    try:
        dist.init_process_group(
            backend, init_method=f"tcp://{addr}:{port}", world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=TIMEOUT_S),
        )
    except (RuntimeError, ValueError) as e:
        raise RuntimeError(f"multi-process initialization failed: {e}") from e
    if rank == 0:
        why = ("ranks share a card" if backend == "gloo" and kind == "cuda"
               else "a card a rank" if backend == "nccl" else "host tensors")
        log_line(f"mpi_openmp_cuda_tpu_torch: distributed: {world} processes, "
                 f"rank 0 on {dev}, transport {backend} ({why})")
    _obs_gauge("distributed_processes", world)
    _obs_gauge("distributed_transport", backend)


def shutdown_distributed() -> None:
    """Leave the job (no-op outside one)."""
    import torch.distributed as dist

    if _joined():
        dist.destroy_process_group()


def _joined() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank (0 outside a job)."""
    import torch.distributed as dist

    return dist.get_rank() if _joined() else 0


def process_count() -> int:
    """The processes of the job (1 outside one)."""
    import torch.distributed as dist

    return dist.get_world_size() if _joined() else 1


def is_coordinator() -> bool:
    """True on the rank that owns stdin/stdout (reference ROOT, main.c:9)."""
    return process_index() == 0


def _bcast(arr) -> np.ndarray:
    from .comm import ProcessCollectives

    return ProcessCollectives().broadcast(np.asarray(arr))


@_guarded("problem broadcast")
def broadcast_problem(problem, *, failed: bool = False):
    """Broadcast a parsed Problem from rank 0 to every rank; the other
    ranks pass ``problem=None`` and receive rank 0's.  ``failed=True``
    (rank 0 only) broadcasts an abort header instead, so the other ranks
    raise rather than hang when rank 0's parse failed."""
    _fault("broadcast_problem")
    if process_count() == 1:
        return problem
    from ..io.parse import Problem
    from ..models.encoding import decode

    if failed:
        header = np.array([0, 0, 0, 1], dtype=np.int32)
    elif problem is not None:
        lens2 = np.array([c.size for c in problem.seq2_codes], dtype=np.int32)
        maxl2 = int(lens2.max()) if lens2.size else 0
        header = np.array(
            [problem.seq1_codes.size, len(problem.seq2_codes), maxl2, 0], dtype=np.int32
        )
    else:
        header = np.zeros(4, dtype=np.int32)
    header = _bcast(header)
    if int(header[3]):
        if is_coordinator():
            # The coordinator's real parse exception is already in flight.
            return None
        raise RuntimeError("coordinator failed before broadcasting the problem; aborting")
    l1, n, maxl2 = int(header[0]), int(header[1]), int(header[2])

    if problem is not None:
        weights = np.asarray(problem.weights, dtype=np.int32)
        seq1 = np.asarray(problem.seq1_codes, dtype=np.int8)
        rows = np.zeros((n, maxl2), dtype=np.int8)
        for i, c in enumerate(problem.seq2_codes):
            rows[i, : c.size] = c
        lens = lens2
    else:
        weights = np.zeros(4, dtype=np.int32)
        seq1 = np.zeros(l1, dtype=np.int8)
        rows = np.zeros((n, maxl2), dtype=np.int8)
        lens = np.zeros(n, dtype=np.int32)
    weights, seq1, rows, lens = (_bcast(a) for a in (weights, seq1, rows, lens))
    seq2_codes = [rows[i, : int(lens[i])] for i in range(n)]
    return Problem(
        weights=[int(x) for x in weights],
        seq1=decode(seq1),
        seq2=[decode(c) for c in seq2_codes],
        seq1_codes=seq1,
        seq2_codes=seq2_codes,
    )


def broadcast_from_coordinator(tree):
    """Rank 0's numpy array (or list/tuple of them) on every rank; a no-op
    in a one-process job."""
    if process_count() == 1:
        return tree
    if isinstance(tree, (list, tuple)):
        return type(tree)(_bcast(a) for a in tree)
    return _bcast(tree)


@_guarded("resume index-set broadcast")
def broadcast_index_set(indices=None, *, failed: bool = False):
    """Two-phase broadcast of an int32 index array from rank 0 (the others
    pass ``None``); returns the array on every rank.  The ``--journal`` x
    ``--distributed`` composition: every rank derives the same reduced
    scoring schedule from rank 0's journal.  ``failed=True`` aborts the
    other ranks (rank 0's journal load failed)."""
    _fault("broadcast_index_set")
    if process_count() == 1:
        return np.asarray([] if indices is None else indices, dtype=np.int32)
    if failed:
        header = np.array([0, 1], dtype=np.int32)
    elif indices is not None:
        header = np.array([len(indices), 0], dtype=np.int32)
    else:
        header = np.zeros(2, dtype=np.int32)
    header = _bcast(header)
    if int(header[1]):
        if is_coordinator():
            return None  # the real exception is already in flight
        raise RuntimeError("coordinator failed while loading the resume journal; aborting")
    n = int(header[0])
    if indices is not None:
        payload = np.asarray(indices, dtype=np.int32).reshape(n)
    else:
        payload = np.zeros(n, dtype=np.int32)
    return _bcast(payload) if n else payload


@_guarded("stream header broadcast")
def broadcast_stream_meta(meta=None, *, failed: bool = False):
    """Broadcast a ``--stream`` run's fixed state ``(weights, seq1_codes,
    num_seq2)`` from rank 0; the others pass ``None`` and receive it.
    ``failed=True`` aborts them (rank 0's header parse failed)."""
    _fault("broadcast_stream_meta")
    if process_count() == 1:
        return meta
    if failed:
        header = np.array([0, 0, 1], dtype=np.int32)
    elif meta is not None:
        weights, seq1_codes, num_seq2 = meta
        header = np.array([len(seq1_codes), num_seq2, 0], dtype=np.int32)
    else:
        header = np.zeros(3, dtype=np.int32)
    header = _bcast(header)
    if int(header[2]):
        if is_coordinator():
            return None
        raise RuntimeError("coordinator failed before broadcasting the stream header; aborting")
    l1, n = int(header[0]), int(header[1])
    if meta is not None:
        weights = np.asarray(meta[0], dtype=np.int32)
        seq1 = np.asarray(meta[1], dtype=np.int8)
    else:
        weights = np.zeros(4, dtype=np.int32)
        seq1 = np.zeros(l1, dtype=np.int8)
    weights, seq1 = (_bcast(a) for a in (weights, seq1))
    return [int(x) for x in weights], seq1, n


@_guarded("chunk broadcast")
def broadcast_chunk(codes=None, *, end: bool = False, failed: bool = False):
    """Broadcast one ``--stream`` chunk's (possibly journal-reduced) code
    arrays from rank 0; the others pass ``None``.  Returns the code arrays,
    or ``None`` when rank 0 signalled ``end=True``; ``failed=True`` aborts
    the other ranks mid-stream."""
    _fault("broadcast_chunk")
    if process_count() == 1:
        return None if (end or failed) else codes
    if failed:
        header = np.array([0, 0, 1, 0], dtype=np.int32)
    elif end:
        header = np.array([0, 0, 0, 1], dtype=np.int32)
    elif codes is not None:
        # maxl floor of 1: a chunk of all-empty sequences still moves
        # (n, 1)-shaped rows; lens recover the empty arrays.
        maxl = max(max((c.size for c in codes), default=0), 1)
        header = np.array([len(codes), maxl, 0, 0], dtype=np.int32)
    else:
        header = np.zeros(4, dtype=np.int32)
    header = _bcast(header)
    if int(header[2]):
        if is_coordinator():
            return None
        raise RuntimeError("coordinator failed mid-stream; aborting")
    if int(header[3]):
        return None  # end of stream
    n, maxl = int(header[0]), int(header[1])
    if not n:
        # A fully journalled chunk: every rank skips the payload together.
        return []
    rows = np.zeros((n, maxl), dtype=np.int8)
    lens = np.zeros(n, dtype=np.int32)
    for i, c in enumerate(codes or ()):
        rows[i, : c.size] = c
        lens[i] = c.size
    rows, lens = (_bcast(a) for a in (rows, lens))
    return [rows[i, : int(lens[i])] for i in range(n)]
