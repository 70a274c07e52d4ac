"""Lost-shard rescue: beacons, the shard ledger, orphan rescoring (the port
of ``mpi_openmp_cuda_tpu/resilience/rescue.py``).

The reference's distribution tier is ``MPI_Scatter`` + ``MPI_Gatherv``
(main.c:174-197): rank 0 owns the index ledger implicitly, and a dead
rank kills the job inside the gather.  The rescue tier (driven by
:func:`..parallel.distributed.scatter_gather_rescue`) keeps the scatter
semantics but makes the gather survivable:

* :func:`shard_index_sets` — the coordinator-side **ledger**: the same
  deterministic contiguous split on every process, so "which index-set
  did the missing worker own" is a pure function, not a negotiation.
* A **board** — a tiny key-value bulletin each process posts its
  liveness beacon and result rows to.  :class:`StoreBoard` backs it with
  the ``torch.distributed`` TCP store of a ``--distributed`` job (rank
  0's store server, the one channel that still works when a *peer* is
  dead: a collective would hang); :class:`MemoryBoard` is the in-process
  equivalent for single-process runs and simulated-loss tests, where a
  missing key IS a missed deadline (deterministic, no clock);
  :class:`FileBoard` is the multi-process single-machine form (atomic
  directory posts, no ``torch.distributed``) that backs the elastic
  serve fleet (serve/fleet.py + resilience/membership.py).
* :func:`fetch_shard` — the per-worker gather: beacon first, rows
  second, timeout (``SEQALIGN_BEACON_S``) identifying the lost worker.
  All timing lives in the board's blocking get; nothing here reads a
  clock.
* :func:`rescue_orphans` — coordinator-side rescoring of the orphaned
  indices on a LOCAL scorer of the run's backend, so the run completes
  with byte-identical output minus the dead worker's speedup.

Every board shares the torn-post guarantee (a post that did not land
whole reads as missing, never as data) and the key layout of the JAX
package, so a ``FileBoard`` directory is shared by either package's
processes.
"""

from __future__ import annotations

import datetime
import errno
import json
import os
import threading

import numpy as np

from ..obs.events import publish
from .faults import scheduled as _fault_scheduled


def shard_index_sets(total: int, parts: int) -> list[list[int]]:
    """The scatter ledger: a contiguous, balanced split of ``total``
    sequence indices over ``parts`` workers (MPI_Scatter parity,
    main.c:174 — earlier workers take the remainder).  Deterministic on
    every process, so ledger agreement needs no communication."""
    if parts < 1:
        raise ValueError(f"shard ledger needs >= 1 worker, got {parts}")
    base, extra = divmod(int(total), parts)
    out, start = [], 0
    for p in range(parts):
        n = base + (1 if p < extra else 0)
        out.append(list(range(start, start + n)))
        start += n
    return out


class MemoryBoard:
    """In-process bulletin board.

    Used by single-process runs and by the simulated-lost-worker tests: a
    worker that never posted simply has no key, and ``get`` returns None
    immediately — absence is the deterministic analogue of a missed
    wall-clock deadline.  A zero-length value (the in-memory stand-in for
    a writer killed before its bytes hit the board) reads as missing.

    The fleet tier (resilience/membership.py) leans on three extra verbs:
    ``claim`` (atomic post-if-absent, the lease race's single-winner
    primitive), ``delete``, and ``keys`` (prefix scan, the worker's offer
    discovery).
    """

    def __init__(self):
        self._kv: dict[str, str] = {}
        # ``claim`` is a check-then-set, which the GIL does not make
        # atomic: two threads racing one lease key could both win.
        self._claim_lock = threading.Lock()

    def post(self, key: str, value: str) -> None:
        self._kv[key] = value

    def get(self, key: str, timeout_s: float | None = None) -> str | None:
        value = self._kv.get(key)
        return value if value else None  # zero-length post reads as missing

    def claim(self, key: str, value: str) -> bool:
        with self._claim_lock:
            if key in self._kv:
                return False
            self._kv[key] = value
            return True

    def delete(self, key: str) -> None:
        self._kv.pop(key, None)

    def keys(self, prefix: str) -> list[str]:
        return sorted(k for k in self._kv if k.startswith(prefix))


class FileBoard:
    """Directory-backed bulletin board for multi-process single-machine
    fleets (serve/fleet.py).

    Key ``a/b/c`` is the file ``root/a/b/c``.  Every ``post`` is atomic
    (tmp file + fsync + ``os.replace``), so a reader never observes a
    half-written value under the final name; a writer killed mid-post
    leaves only a ``.tmp.`` orphan, which readers and ``keys`` skip.
    ``claim`` is ``os.link`` onto the final name: the filesystem makes
    exactly one linker win, so two workers racing one lease resolve
    without a coordination service.  ``get`` still treats unreadable or
    zero-length files as missing: the chaos markers post deliberately
    torn values through ``post`` to prove readers survive a board that
    did tear (a non-atomic network filesystem).
    """

    _TMP = ".tmp."

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def _path(self, key: str) -> str:
        parts = [p for p in key.split("/") if p and p not in (".", "..")]
        if not parts:
            raise ValueError(f"empty board key: {key!r}")
        return os.path.join(self.root, *parts)

    def _write_tmp(self, path: str, value: str) -> str:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        # pid + thread id: in-process worker threads racing one key must
        # not share a staging file (a claim could link the other racer's
        # bytes under its own victory).
        tmp = os.path.join(
            os.path.dirname(path),
            f"{self._TMP}{os.path.basename(path)}.{os.getpid()}.{threading.get_ident()}",
        )
        try:
            with open(tmp, "w", encoding="utf-8") as fh:
                if _fault_scheduled("board:enospc"):
                    # Modelled disk-full: half the bytes land, then the
                    # write fails.  The key must still read as missing and
                    # the orphan must not leak.
                    fh.write(value[: len(value) // 2])
                    fh.flush()
                    raise OSError(errno.ENOSPC, "injected: no space left on device")
                fh.write(value)
                fh.flush()
                os.fsync(fh.fileno())
        except OSError:
            # A failed staging write leaves no tmp orphan: the caller sees
            # the post as never having happened.
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return tmp

    def post(self, key: str, value: str) -> None:
        path = self._path(key)
        os.replace(self._write_tmp(path, value), path)

    def get(self, key: str, timeout_s: float | None = None) -> str | None:
        try:
            with open(self._path(key), encoding="utf-8") as fh:
                value = fh.read()
        except OSError:
            return None
        return value if value else None  # zero-length post reads as missing

    def claim(self, key: str, value: str) -> bool:
        path = self._path(key)
        tmp = self._write_tmp(path, value)
        try:
            os.link(tmp, path)  # atomic: exactly one claimer wins
            return True
        except OSError:
            return False  # taken (or unclaimable): the caller re-polls
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def delete(self, key: str) -> None:
        try:
            os.unlink(self._path(key))
        except OSError:
            pass

    def keys(self, prefix: str) -> list[str]:
        out = []
        for dirpath, _dirs, files in os.walk(self.root):
            rel = os.path.relpath(dirpath, self.root)
            base = "" if rel == "." else rel.replace(os.sep, "/") + "/"
            for name in files:
                if name.startswith(self._TMP):
                    continue  # a dead writer's orphan, not a post
                key = base + name
                if key.startswith(prefix):
                    out.append(key)
        return sorted(out)

    def sweep_orphans(self) -> int:
        """Unlink every ``.tmp.`` orphan under the root (the debris of
        writers killed mid-post).  Racing a live writer is safe: its
        ``os.replace`` of an unlinked tmp raises OSError, which every board
        writer absorbs as a lost post."""
        swept = 0
        for dirpath, _dirs, files in os.walk(self.root):
            for name in files:
                if not name.startswith(self._TMP):
                    continue
                try:
                    os.unlink(os.path.join(dirpath, name))
                    swept += 1
                except OSError:
                    pass
        return swept


class StoreBoard:
    """A board on a ``torch.distributed`` key-value store (multi-process).

    The store of a ``--distributed`` job is the ``TCPStore`` whose server
    runs in rank 0 (:func:`..parallel.distributed.job_store`), so it
    outlives any dead *worker*: exactly the channel a lost-shard gather
    needs, where a collective would hang.  ``get`` waits for the key up
    to the beacon deadline (``store.wait`` with a per-call timeout, since
    ``store.get`` would block for the store's own timeout) and returns
    None when it passes: the caller treats that as "worker lost".

    ``claim`` is ``compare_set`` against the empty value (the store sets
    the key only when it is absent and returns what it then holds, so a
    return equal to the claim's own value is the win).  The store has no
    prefix listing, and the rescue tier needs none: :meth:`keys` refuses,
    so the fleet (which scans offers) stays on :class:`FileBoard`.
    """

    def __init__(self, store, timeout_s: float):
        if timeout_s <= 0:
            raise ValueError(f"beacon deadline must be > 0 seconds, got {timeout_s}")
        self.store = store
        self.timeout_s = float(timeout_s)

    def post(self, key: str, value: str) -> None:
        self.store.set(key, value)

    def get(self, key: str, timeout_s: float | None = None) -> str | None:
        timeout = self.timeout_s if timeout_s is None else float(timeout_s)
        try:
            self.store.wait([key], datetime.timedelta(seconds=timeout))
            value = self.store.get(key)
        except RuntimeError:
            # The wait's timeout (DistStoreError is a RuntimeError): a
            # lost worker, which the ledger names.
            return None
        value = value.decode("utf-8", errors="replace")
        return value if value else None  # zero-length post reads as missing

    def claim(self, key: str, value: str) -> bool:
        got = self.store.compare_set(key, "", value)
        return got.decode("utf-8", errors="replace") == value

    def delete(self, key: str) -> None:
        try:
            self.store.delete_key(key)
        except RuntimeError:
            pass  # best-effort: a stale key is fenced by its epoch

    def keys(self, prefix: str) -> list[str]:
        raise NotImplementedError(
            "StoreBoard cannot list keys (a torch.distributed store has no "
            "prefix scan); the fleet needs a FileBoard (--fleet-board DIR)"
        )


def _beacon_key(run_tag: str, pid: int) -> str:
    return f"seqalign/{run_tag}/beacon/{int(pid)}"


def _rows_key(run_tag: str, pid: int) -> str:
    return f"seqalign/{run_tag}/rows/{int(pid)}"


def post_shard(board, run_tag: str, pid: int, rows) -> None:
    """Worker side: liveness beacon first (cheap, lands even if the rows
    post is what the worker dies inside), then the scored rows."""
    board.post(_beacon_key(run_tag, pid), "scored")
    rows = np.asarray(rows, dtype=np.int32)
    board.post(_rows_key(run_tag, pid), json.dumps(rows.tolist()))


def fetch_shard(
    board, run_tag: str, pid: int, expect_n: int, timeout_s: float | None = None
) -> np.ndarray | None:
    """Coordinator side: gather one worker's shard under the beacon
    deadline.  Returns the [expect_n, 3] rows, or None when the worker is
    lost (no beacon, no rows, or rows of the wrong shape: a torn post is
    rescored, never trusted)."""
    rows = _fetch_shard(board, run_tag, pid, expect_n, timeout_s)
    if rows is None:
        publish("rescue.beacon_miss", worker=pid)
    return rows


def _fetch_shard(board, run_tag, pid, expect_n, timeout_s):
    if board.get(_beacon_key(run_tag, pid), timeout_s) is None:
        return None
    raw = board.get(_rows_key(run_tag, pid), timeout_s)
    if raw is None:
        return None
    try:
        rows = np.asarray(json.loads(raw), dtype=np.int32)
    except (json.JSONDecodeError, ValueError):
        return None
    if rows.shape != (int(expect_n), 3):
        return None
    return rows


def rescue_orphans(
    seq1_codes,
    orphan_codes,
    weights,
    *,
    policy,
    backend: str = "cuda",
    device="cuda",
):
    """Rescore a lost worker's orphaned sequences on a LOCAL scorer of
    ``backend`` on ``device`` under the run's retry policy.  Returns
    [len(orphan_codes), 3] int32 rows.

    There is no degrade chain here (the JAX rescue steps down from
    ``xla``): ``--distributed``, the one caller, refuses ``--degrade``,
    so a kernel that fails to build or launch raises, as on the batch
    path (the CLI's 65)."""
    from ..ops.dispatch import AlignmentScorer

    publish("rescue.orphans", count=len(orphan_codes))
    scorer = AlignmentScorer(backend, device=device)
    return policy.run(
        lambda: scorer.score_codes(seq1_codes, orphan_codes, weights),
        "orphan rescue",
        budget=policy.new_budget(),
    )
