"""Per-sequence result journal: checkpoint / resume (the port of
``mpi_openmp_cuda_tpu/utils/journal.py``, record format and fingerprints
byte for byte, so a journal either CLI wrote resumes under the other).

Format: JSON lines.  Line 1 is a header carrying a fingerprint of the
problem; every later line is one scored result ``{"index": i, "score":
S, "n": N, "k": K}``.  A journal whose fingerprint does not match the
current problem is rejected (fail-stop, not silent corruption).  Appends
are flushed and fsync'd per chunk, so a kill loses at most the in-flight
chunk.

* :class:`ResultJournal` — whole-batch mode: the fingerprint covers every
  sequence up front.
* :class:`StreamJournal` — ``--stream`` mode: the header fingerprints
  (weights, Seq1, N) only and every record carries a short per-sequence
  content hash; on resume an entry is trusted only if its hash matches
  the re-parsed sequence.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from ..obs.metrics import drain_snapshot
from ..resilience.drain import DrainInterrupt, drain_requested
from ..resilience.faults import fire as _fault

_FORMAT = "mpi_openmp_cuda_tpu.journal.v1"
_STREAM_FORMAT = "mpi_openmp_cuda_tpu.stream-journal.v1"

# Sequences scored per journal append.  Small enough that a preemption
# loses little work; large enough to amortise dispatch overhead.
DEFAULT_CHUNK = 64


class JournalMismatchError(RuntimeError):
    """Journal on disk belongs to a different problem (or is corrupt)."""


def _read_records(path, fmt, fingerprint, parse_rec, foreign_hint="", mismatch_hint=""):
    """Shared journal reader: header validation + tolerant record parse.

    ``parse_rec(rec) -> (key, value)``; malformed lines (a torn tail from a
    mid-write kill) are skipped — those sequences simply get rescored.
    Event records (``{"event": ...}`` — e.g. the drain's resumable-exit
    marker) are skipped the same way: they are audit state, not results.

    Kill-shaped header damage is repaired, never escalated: a zero-length
    file, a header-only file, and a torn (newline-less, nothing-after-it)
    header line all read as an EMPTY journal — the header is fsync'd
    before the first record, so none of those shapes can hold resumable
    state.  A malformed header WITH content after it is real corruption
    and still fails fast.
    """
    if not os.path.exists(path):
        return {}
    done = {}
    with open(path, "r", encoding="utf-8") as f:
        header_line = f.readline()
        if not header_line.strip():
            return {}
        try:
            header = json.loads(header_line)
        except json.JSONDecodeError as e:
            if not header_line.endswith("\n") and not f.read(1):
                # Torn header from a mid-write kill: the header write is
                # fsync'd before any record, so a torn header means no
                # record was ever durable — fresh journal, not an error.
                return {}
            raise JournalMismatchError(
                f"journal {path!r}: unreadable header: {e}"
            ) from e
        if header.get("format") != fmt:
            raise JournalMismatchError(
                f"journal {path!r}: not a {fmt} file{foreign_hint}"
            )
        if header.get("fingerprint") != fingerprint:
            raise JournalMismatchError(
                f"journal {path!r} was written for a different problem"
                f"{mismatch_hint}; delete it (or pass a fresh --journal "
                "path) to rescore"
            )
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
                key, value = parse_rec(rec)
                done[key] = value
            except (json.JSONDecodeError, KeyError, ValueError):
                continue
    return done


def _write_records(f, recs) -> None:
    """Append JSON records, then flush + fsync (a kill loses at most the
    in-flight chunk)."""
    # Fault site BEFORE any byte is written: an injected append failure
    # models a full kill of the in-flight chunk, never a torn record.
    _fault("journal_append")
    for rec in recs:
        f.write(json.dumps(rec) + "\n")
    f.flush()
    os.fsync(f.fileno())


def _write_event(f, name: str) -> None:
    """Append one flushed event record (e.g. the drain's resumable-exit
    marker).  Deliberately NOT a fault site: the event is advisory audit
    state written on the way out of an already-exceptional path — resume
    works whether or not it landed, and an injected failure here would
    only mask the drain in flight.

    When a metrics registry is armed the record also carries its
    snapshot (``obs.metrics.drain_snapshot``); the resume reader skips
    event records wholesale."""
    rec = {"event": name}
    payload = drain_snapshot()
    if payload:
        rec.update(payload)
    f.write(json.dumps(rec) + "\n")
    f.flush()
    os.fsync(f.fileno())


def problem_fingerprint(problem) -> str:
    """Stable content hash of (weights, seq1, seq2 batch)."""
    h = hashlib.sha256()
    h.update(json.dumps([int(w) for w in problem.weights]).encode())
    h.update(problem.seq1_codes.tobytes())
    h.update(np.int64(len(problem.seq2_codes)).tobytes())
    for codes in problem.seq2_codes:
        h.update(np.int64(codes.size).tobytes())
        h.update(codes.tobytes())
    return h.hexdigest()


def stream_fingerprint(weights, seq1_codes, num_seq2: int) -> str:
    """Header hash for streaming mode: (weights, Seq1, N) only — the batch
    itself is validated per record via :func:`seq_hash`."""
    h = hashlib.sha256()
    h.update(json.dumps([int(w) for w in weights]).encode())
    h.update(np.asarray(seq1_codes).tobytes())
    h.update(np.int64(num_seq2).tobytes())
    return h.hexdigest()


def seq_hash(codes) -> str:
    """Short per-sequence content hash (16 hex chars: collision odds over
    even a billion-sequence batch are negligible, and a collision only
    risks skipping a rescore, never wrong output for an unchanged input)."""
    return hashlib.sha256(np.asarray(codes).tobytes()).hexdigest()[:16]


class StreamJournal:
    """Per-sequence journal for the --stream pipeline.

    Usage: construct, :meth:`load` the validated done-map, then use as a
    context manager and :meth:`append` each freshly scored chunk::

        journal = StreamJournal(path, weights, seq1_codes, n)
        done = journal.load()
        with journal:
            journal.append(indices, hashes, rows)
    """

    def __init__(self, path: str, weights, seq1_codes, num_seq2: int):
        self.path = path
        self.fingerprint = stream_fingerprint(weights, seq1_codes, num_seq2)
        self._f = None
        self._fresh = True
        self._loaded = False

    def load(self) -> dict[int, tuple[str, tuple[int, int, int]]]:
        """index -> (seq_hash, (score, n, k)); rejects foreign journals."""
        done = _read_records(
            self.path,
            _STREAM_FORMAT,
            self.fingerprint,
            lambda rec: (
                int(rec["index"]),
                (
                    str(rec["h"]),
                    (int(rec["score"]), int(rec["n"]), int(rec["k"])),
                ),
            ),
            foreign_hint=" (a whole-batch journal cannot resume a --stream run)",
            mismatch_hint=" (weights/Seq1/N changed)",
        )
        self._fresh = not done
        self._loaded = True
        return done

    def __enter__(self):
        if not self._loaded:
            # A caller that skips load() must not bypass header validation
            # and silently truncate a resumable journal ('w' below): run
            # the load here (the done-map is discarded, but _fresh and the
            # fingerprint check now reflect the on-disk state).
            self.load()
        fresh = self._fresh or not os.path.exists(self.path)
        if not fresh:
            _repair_torn_tail(self.path)
        self._f = open(self.path, "w" if fresh else "a", encoding="utf-8")
        if fresh:
            self._f.write(
                json.dumps(
                    {"format": _STREAM_FORMAT, "fingerprint": self.fingerprint}
                )
                + "\n"
            )
            self._f.flush()
            os.fsync(self._f.fileno())
        return self

    def __exit__(self, *exc):
        closing, self._f = self._f, None
        closing.close()
        return False

    def append(self, indices, hashes, rows) -> None:
        _write_records(
            self._f,
            (
                {
                    "index": int(i),
                    "h": h,
                    "score": int(score),
                    "n": int(n),
                    "k": int(k),
                }
                for i, h, (score, n, k) in zip(indices, hashes, rows)
            ),
        )

    def append_event(self, name: str) -> None:
        """Append a flushed event record (the drain path's resumable-exit
        marker); the resume reader skips it like any non-result line."""
        _write_event(self._f, name)


def _repair_torn_tail(path: str) -> None:
    """Append a newline if a mid-write kill left a torn final line (gluing
    the next record onto the fragment would lose it on the next resume)."""
    with open(path, "rb") as rf:
        rf.seek(0, os.SEEK_END)
        if rf.tell() == 0:
            return
        rf.seek(-1, os.SEEK_END)
        torn = rf.read(1) != b"\n"
    if torn:
        with open(path, "a", encoding="utf-8") as f:
            f.write("\n")


class ResultJournal:
    """Journalled scoring: skip already-scored sequences on restart."""

    def __init__(self, path: str, chunk: int = DEFAULT_CHUNK):
        self.path = path
        self.chunk = max(1, int(chunk))

    # -- on-disk state -----------------------------------------------------
    def _read(self, fingerprint: str) -> dict[int, tuple[int, int, int]]:
        """Load completed entries; reject foreign or malformed journals."""
        return _read_records(
            self.path,
            _FORMAT,
            fingerprint,
            lambda rec: (
                int(rec["index"]),
                (int(rec["score"]), int(rec["n"]), int(rec["k"])),
            ),
        )

    def _append(self, f, indices, rows) -> None:
        _write_records(
            f,
            (
                {"index": int(i), "score": int(score), "n": int(n), "k": int(k)}
                for i, (score, n, k) in zip(indices, rows)
            ),
        )

    # -- the resumable scoring loop ---------------------------------------
    def load_done(self, problem) -> dict[int, tuple[int, int, int]]:
        """Read and validate the on-disk done-map for ``problem`` (empty
        if no journal exists)."""
        return self._read(problem_fingerprint(problem))

    def score_with_resume(self, scorer, problem, done=None, record: bool = True) -> np.ndarray:
        """Score ``problem``, journalling per chunk; returns [B, 3] int32.

        ``done`` overrides the on-disk done-map (in a multi-process job
        every rank gets rank 0's key set, values None, so the chunked
        schedule below, which is also the collective schedule, is the same
        on every rank).  ``record=False`` runs that schedule without
        touching the file: the other ranks own no journal."""
        if done is None:
            done = self._read(problem_fingerprint(problem))
        total = len(problem.seq2_codes)
        pending = [i for i in range(total) if i not in done]

        results = np.zeros((total, 3), dtype=np.int32)
        for i, row in done.items():
            if i < total and row is not None:
                results[i] = row

        def run(append):
            for start in range(0, len(pending), self.chunk):
                if append is not None and drain_requested():
                    # Chunk-boundary drain: everything scored so far is
                    # flushed; the caller's CLI exits 75.
                    raise DrainInterrupt(
                        f"{total - len(pending) + start} of {total} "
                        "sequences journalled; rerun with --resume to "
                        "score the rest"
                    )
                idx = pending[start : start + self.chunk]
                rows = scorer.score_codes(
                    problem.seq1_codes,
                    [problem.seq2_codes[i] for i in idx],
                    problem.weights,
                )
                for i, row in zip(idx, rows):
                    results[i] = row
                if append is not None:
                    append(idx, rows)

        if not record:
            run(None)
            return results
        fresh = not os.path.exists(self.path) or not done
        mode = "w" if fresh else "a"
        if not fresh:
            _repair_torn_tail(self.path)
        with open(self.path, mode, encoding="utf-8") as f:
            if fresh:
                f.write(
                    json.dumps(
                        {
                            "format": _FORMAT,
                            "fingerprint": problem_fingerprint(problem),
                            "num_seq2": total,
                        }
                    )
                    + "\n"
                )
                f.flush()
                os.fsync(f.fileno())
            try:
                run(lambda idx, rows: self._append(f, idx, rows))
            except DrainInterrupt:
                _write_event(f, "drain")
                raise
        return results
