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

Several mesh slots a process (:func:`local_devices`), as a JAX job has
several devices a process.  On ``cuda`` a process drives ``k =
max(1, device_count // LOCAL_WORLD_SIZE)`` cards from
``cuda:(LOCAL_RANK * k mod device_count)`` over ``nccl`` when no two
processes share a card; when they must (a one-card host), over ``gloo``,
with the small tensors it moves staged through host memory, since NCCL
refuses two ranks on one device.  ``SEQALIGN_HOST_DEVICES``, when set,
is the slot count a process instead, its slots naming the process's
cards in turn (two slots of ``cuda:0`` on a one-card host).  On ``cpu``
a process has ``SEQALIGN_HOST_DEVICES`` slots (default 1) and the
transport is ``gloo``.  Every process must have the same count: slot
``rank * k + j`` is process ``rank``'s ``j``-th, process-major, the order
``jax.devices()`` gives a multi-process JAX job.  The kernels run on the
card either way; the choice is a transport's, told once on stderr and
kept in the run report's gauges.

The broadcasts are two-phase, as in the JAX package: a fixed-shape header
(sizes, or an abort flag) first, then the payload, so a coordinator that
fails before or while parsing releases its workers with an abort header
instead of leaving them blocked in a collective.  Each is a fault site
(``--faults``) and runs under the run's watchdog guard.

The lost-shard rescue tier (:func:`scatter_gather_rescue`, under
``--distributed`` with ``SEQALIGN_BEACON_S`` set) trades the collective
gather for per-rank shards posted to the job's key-value store, so a dead
rank's shard is rescored on rank 0 instead of hanging the gather.
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

# The job's TCP store (its server runs in rank 0), kept for the rescue
# board; None outside a job.
_STORE = None
# The mesh slots each process drives, exchanged when the job is joined;
# None outside a job.
_SLOTS = None


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


def _host_slots() -> int | None:
    """``SEQALIGN_HOST_DEVICES`` when set (>= 1), else None."""
    slots = env_int("SEQALIGN_HOST_DEVICES", 0)
    return max(1, slots) if slots else None


def local_devices(kind: str = "cuda") -> list[torch.device]:
    """The mesh slots this process drives: ``SEQALIGN_HOST_DEVICES``
    (default 1) CPU slots on ``cpu``; on ``cuda`` this process's ``k =
    max(1, device_count // LOCAL_WORLD_SIZE)`` cards from
    ``cuda:(LOCAL_RANK * k mod device_count)``, or, with
    ``SEQALIGN_HOST_DEVICES`` set, that many slots naming those cards in
    turn."""
    if torch.device(kind).type == "cpu":
        return [torch.device("cpu")] * (_host_slots() or 1)
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError(
            "no CUDA device is available; pass --device cpu to score on the CPU"
        )
    local_rank, local_world = _local()
    k = max(1, count // local_world)
    cards = [torch.device(f"cuda:{(local_rank * k + j) % count}") for j in range(k)]
    return [cards[j % k] for j in range(_host_slots() or k)]


def local_device(kind: str = "cuda") -> torch.device:
    """This process's first slot (:func:`local_devices`): the device of its
    collectives' staging under ``nccl``, the rescue tier's scorer and the
    rank-0 log line."""
    return local_devices(kind)[0]


def transport(kind: str = "cuda") -> str:
    """``nccl`` when no two processes on this host share a card, else
    ``gloo``."""
    if torch.device(kind).type == "cpu":
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= _local()[1] else "gloo"


def slots_per_process() -> int:
    """The mesh slots each process of the joined job drives (the count
    :func:`initialize_distributed` exchanged; 1 outside a job)."""
    if not _joined():
        return 1
    if _SLOTS is None:
        raise RuntimeError(
            "the torch.distributed job was not joined through "
            "initialize_distributed: the processes' slot counts are unknown"
        )
    return _SLOTS


def _exchange_slots(store, world: int, rank: int, k: int) -> int:
    """Every process's slot count through the job's store; the common
    count, or a RuntimeError when they differ."""
    try:
        store.set(f"seqalign/slots/{rank}", str(k))
        counts = [int(store.get(f"seqalign/slots/{r}")) for r in range(world)]
    except (RuntimeError, ValueError) as e:  # a peer gone mid-exchange
        raise RuntimeError(f"multi-process initialization failed: slot counts: {e}") from e
    if len(set(counts)) != 1:
        raise RuntimeError(
            "multi-process initialization failed: every process must drive "
            f"the same number of mesh slots, got {counts} by rank "
            "(SEQALIGN_HOST_DEVICES, or the cards a process)"
        )
    return k


def initialize_distributed(device="cuda") -> None:
    """Join the job this process belongs to (the ``runOn2`` analogue), its
    slots of kind ``device`` and transport chosen by :func:`local_devices`
    and :func:`transport`, and agree on every process's slot count."""
    import torch.distributed as dist

    addr, port, world, rank = _rendezvous()
    kind = torch.device(device).type
    devs = local_devices(kind)
    dev = devs[0]
    backend = transport(kind)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    global _STORE, _SLOTS
    try:
        # The store is made here, not by init_method="tcp://...", so the
        # rescue tier can post to it through public API: the same
        # TCPStore (server in rank 0) that tcp:// rendezvous would make,
        # handed to the group under the "default_pg" prefix it would use.
        store = dist.TCPStore(addr, port, world, rank == 0, timeout=timeout)
        dist.init_process_group(
            backend, store=dist.PrefixStore("default_pg", store), world_size=world,
            rank=rank, timeout=timeout,
        )
    except (RuntimeError, ValueError) as e:
        raise RuntimeError(f"multi-process initialization failed: {e}") from e
    _STORE = store
    _SLOTS = _exchange_slots(store, world, rank, len(devs))
    if rank == 0:
        why = ("ranks share a card" if backend == "gloo" and kind == "cuda"
               else "a card a rank" if backend == "nccl" else "host tensors")
        log_line(f"mpi_openmp_cuda_tpu_torch: distributed: {world} processes x "
                 f"{_SLOTS} slots, rank 0 on {dev}, transport {backend} ({why})")
    _obs_gauge("distributed_processes", world)
    _obs_gauge("distributed_slots", world * _SLOTS)
    _obs_gauge("distributed_transport", backend)


def shutdown_distributed() -> None:
    """Leave the job (no-op outside one)."""
    import torch.distributed as dist

    global _STORE, _SLOTS
    if _joined():
        dist.destroy_process_group()
    _STORE = _SLOTS = None


def job_store():
    """The key-value store of the job this process joined (the board of
    the rescue tier)."""
    if _STORE is None:
        raise RuntimeError(
            "no torch.distributed job: the beacon board needs --distributed "
            "(or a MemoryBoard in one process)"
        )
    return _STORE


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


def scatter_gather_rescue(
    seq1_codes,
    seq2_codes,
    weights,
    *,
    policy,
    beacon_s: float,
    backend: str = "cuda",
    device="cuda",
    board=None,
    process_id: int | None = None,
    num_processes: int | None = None,
    run_tag: str = "batch0",
    log=None,
):
    """Scatter/gather scoring with lost-shard rescue (the
    ``SEQALIGN_BEACON_S`` tier of ``--distributed`` batch runs).

    The collective gather hangs every peer when one rank dies, the
    reference's MPI_Gatherv failure mode (main.c:190-197).  This tier keeps
    the reference's scatter shape and makes it survivable:

    1. every process derives the same contiguous index ledger
       (:func:`..resilience.rescue.shard_index_sets`, MPI_Scatter parity)
       and scores its own shard, one a process whatever its slot count,
       on its first slot (:func:`local_device` of ``device``'s kind), as
       the JAX tier scores on a local scorer, with no collective, so a
       dead rank hangs no one;
    2. each posts a liveness beacon and its rows to the job's store
       (:class:`..resilience.rescue.StoreBoard`; its server is rank 0's,
       which outlives dead ranks);
    3. rank 0 fetches each shard under the beacon deadline
       (watchdog-guarded); a miss names exactly the index-set that rank
       owned;
    4. the orphaned indices are rescored on rank 0 on its kernels
       (:func:`..resilience.rescue.rescue_orphans`; a kernel that fails
       raises), so the output is byte-identical, minus the dead rank's
       speedup.

    Returns the [N, 3] int32 rows on rank 0 and None on the other ranks
    (they print nothing, main.c:199-211).  ``board``, ``process_id`` and
    ``num_processes`` are injectable, so the lost-rank protocol runs in one
    process (a rank that never posted to a MemoryBoard IS a lost rank).
    """
    from ..obs import export as obs_export
    from ..ops.dispatch import AlignmentScorer
    from ..resilience import rescue

    pid = process_index() if process_id is None else int(process_id)
    nprocs = process_count() if num_processes is None else int(num_processes)
    log = log or log_line
    if board is None:
        board = (rescue.MemoryBoard() if nprocs == 1
                 else rescue.StoreBoard(job_store(), beacon_s))
    dev = None if backend == "oracle" else local_device(torch.device(device).type)
    ledger = rescue.shard_index_sets(len(seq2_codes), nprocs)
    mine = ledger[pid]
    my_rows = (
        AlignmentScorer(backend, device=dev).score_codes(
            seq1_codes, [seq2_codes[i] for i in mine], weights)
        if mine else np.zeros((0, 3), dtype=np.int32)
    )
    rescue.post_shard(board, run_tag, pid, my_rows)
    # Each host's metrics snapshot rides the same board (a no-op with the
    # obs plane off): rank 0's report gets a merged `hosts` section.
    obs_export.post_host_snapshot(board, run_tag, pid)
    if pid != 0:
        return None

    out = np.zeros((len(seq2_codes), 3), dtype=np.int32)
    if mine:
        out[mine] = my_rows
    lost = []
    for w in range(1, nprocs):
        idx = ledger[w]
        if not idx:
            continue
        with _deadline_guard(f"shard gather (worker {w})"):
            rows = rescue.fetch_shard(board, run_tag, w, len(idx), timeout_s=beacon_s)
        if rows is None:
            lost.append(w)
            continue
        out[idx] = rows
    # Ranks already known lost are skipped, not waited for twice.
    obs_export.gather_fleet(board, run_tag, nprocs, skip=lost, timeout_s=beacon_s)
    if lost:
        orphans = [i for w in lost for i in ledger[w]]
        log(
            f"mpi_openmp_cuda_tpu_torch: warning: worker(s) {lost} missed the "
            f"{beacon_s:g}s beacon deadline; rescuing {len(orphans)} orphaned "
            "sequence(s) on the coordinator's local backend"
        )
        out[orphans] = rescue.rescue_orphans(
            seq1_codes, [seq2_codes[i] for i in orphans], weights,
            policy=policy, backend=backend, device=dev,
        )
    return out
