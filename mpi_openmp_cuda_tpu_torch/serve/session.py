"""Per-request lifecycle: validation, ordered emission, the serve journal
(the port of ``mpi_openmp_cuda_tpu/serve/session.py``; same wire records,
same journal bytes).

The wire protocol is newline-delimited JSON both ways (the loopback socket
and the stdin pipe speak the same records):

request   ``{"id": ..., "weights": [w1,w2,w3,w4], "seq1": "...",
            "seq2": ["...", ...]}`` — ``id`` optional (defaults to
            ``req-<seq>`` from the admission counter)
response  ``{"id": ..., "line": "#j: score: S, n: N, k: K"}`` per
            sequence (the ``line`` value is byte-identical to the batch
            CLI's stdout line for the same problem), then
            ``{"id": ..., "done": true, "n": N}``; malformed input gets
            ``{"id": ..., "error": "..."}`` and the loop lives on; a
            drain hands queued-but-unstarted requests
            ``{"id": ..., "drained": true}`` after journaling them.

Validation runs on the main loop thread and reuses the batch parser's
header validation, so a weight the batch CLI rejects is rejected here with
the same message, as one typed error record, never process death.

Result rows can land out of order (a request's short and long Seq2s sit in
different superblocks); :class:`Session` buffers and emits the longest
consecutively scored prefix, so each client sees its lines in index order.

The serve journal is the drain's resume token: a whole-file atomic write
of the raw requests still unanswered.  Its format line is the JAX
package's, so either package resumes the other's serve journal; batch,
stream and serve journals refuse each other's files.
"""

from __future__ import annotations

import json
import os
import threading

import numpy as np

from ..io.parse import _parse_header_tokens
from ..io.printer import format_result
from ..models.encoding import encode_normalized
from ..obs.events import publish
from ..resilience.faults import scheduled as _fault_scheduled
from ..utils.constants import BUF_SIZE_SEQ1, BUF_SIZE_SEQ2
from ..utils.env import env_float


class RequestError(ValueError):
    """A malformed/invalid request: rejected with a typed error record."""


class Responder:
    """One output stream shared by a request's records, lock-serialised.

    Writes one compact JSON document per line.  A broken client (closed
    socket, vanished pipe) marks the responder dead and later records
    are dropped silently — a client that hung up forfeits its results;
    it must not take the loop (or other clients) down with it.
    """

    def __init__(self, out, on_dead=None):
        self._out = out
        self._lock = threading.Lock()
        self._dead = False
        self._on_dead = on_dead

    @property
    def dead(self) -> bool:
        return self._dead

    def mark_dead(self) -> None:
        """Classify this client dead (failed/timed-out write, chaos
        marker).  The ``on_dead`` callback fires exactly once, outside
        the lock — it re-enters the serve queue's source refcount."""
        notify = False
        with self._lock:
            if not self._dead:
                self._dead = True
                notify = True
        if notify and self._on_dead is not None:
            self._on_dead()

    def send(self, obj: dict) -> None:
        if _fault_scheduled("dead-socket-midstream"):
            # Chaos marker: the client vanished between records.
            publish("serve.client.lost", how="dead-socket")
            self.mark_dead()
            return
        if _fault_scheduled("slow-client"):
            # Chaos marker: a stalled reader whose socket buffer never
            # drains (the SO_SNDTIMEO armor's classification), without
            # holding the loop for the real timeout.
            publish("serve.client.lost", how="slow-client")
            self.mark_dead()
            return
        died = False
        with self._lock:
            if self._dead:
                return
            try:
                self._out.write(json.dumps(obj) + "\n")
                self._out.flush()
            except (OSError, ValueError):
                # socket.timeout is an OSError: a write that cannot make
                # progress within SEQALIGN_SERVE_WRITE_TIMEOUT_S lands
                # here too.
                self._dead = True
                died = True
        if died:
            publish("serve.client.lost", how="write-failed")
            if self._on_dead is not None:
                self._on_dead()


def parse_raw(line: str) -> dict:
    """Reader-thread half of parsing: bytes → dict, nothing more."""
    try:
        raw = json.loads(line)
    except json.JSONDecodeError as e:
        raise RequestError(f"malformed request line (not JSON): {e}") from None
    if not isinstance(raw, dict):
        raise RequestError(
            f"request must be a JSON object, got {type(raw).__name__}"
        )
    return raw


class Session:
    """One validated in-flight request: its problem, its result rows,
    and the emit cursor that keeps output in per-request index order."""

    def __init__(
        self, req_id, weights, seq1, seq1_codes, seq2_codes, responder,
        admitted_t, clock, deadline_t=None, cost_s=0.0, on_close=None,
        trace_id="",
    ):
        self.id = req_id
        self.trace_id = trace_id  # minted at admission (obs/trace.py)
        self.weights = weights
        self.seq1 = seq1
        self.seq1_codes = seq1_codes
        self.seq2_codes = seq2_codes
        self.responder = responder
        self._admitted_t = admitted_t
        self._clock = clock
        self.deadline_t = deadline_t  # absolute clock time, None = no SLO
        self.cost_s = cost_s  # modelled wall charged at admission
        self.poisoned = False  # chaos marker: superblocks with me fail
        self.failed = None  # typed terminal error, if any
        self._on_close = on_close
        n = len(seq2_codes)
        self.rows = np.zeros((n, 3), dtype=np.int64)
        self._have = [False] * n
        self._emitted = 0
        self._done = False

    @property
    def count(self) -> int:
        return len(self.seq2_codes)

    @property
    def closed(self) -> bool:
        """Terminal (done record sent, typed failure, or abandoned):
        this session may not occupy superblock rows any more — the
        batcher skips it when (re-)planning."""
        return self._done

    @property
    def abandoned(self) -> bool:
        """The client is gone (dead responder): nobody reads the rows."""
        return bool(getattr(self.responder, "dead", False))

    @property
    def answered(self) -> bool:
        """Terminal and a reply record went out (the done record or a
        typed error): everything except abandonment, where the vanished
        client was sent nothing."""
        return self._done and self.failed != "abandoned"

    def expired(self, now: float) -> bool:
        return self.deadline_t is not None and now > self.deadline_t

    def _close(self) -> None:
        cb, self._on_close = self._on_close, None
        if cb is not None:
            cb(self)

    def fail(self, error: str, **fields) -> None:
        """Answer the whole request with ONE typed error record and
        retire it (deadline misses, quarantined poison)."""
        if self._done:
            return
        self._done = True
        self.failed = error
        self.responder.send({"id": self.id, "error": error, **fields})
        publish(
            "serve.request.failed",
            id=self.id,
            error=error,
            trace=self.trace_id,
        )
        self._close()

    def abandon(self) -> None:
        """Retire a session whose client vanished: no records (nobody is
        listening), planned rows released, admission cost returned."""
        if self._done:
            return
        self._done = True
        self.failed = "abandoned"
        publish("serve.request.abandoned", id=self.id, trace=self.trace_id)
        self._close()

    def fill(self, j: int, row) -> None:
        """Record sequence ``j``'s (score, n, k) row and emit whatever
        prefix became consecutive."""
        if self._done:
            return
        if self.deadline_t is not None and self._clock.now() > self.deadline_t:
            # Demux-stage deadline checkpoint: the rows landed too late.
            self.fail("deadline")
            return
        self.rows[j] = row
        self._have[j] = True
        self.advance()

    def advance(self) -> None:
        """Emit the longest consecutively-filled prefix; on completion,
        emit the done record and publish the latency event."""
        if self._done:
            return
        n = self.count
        while self._emitted < n and self._have[self._emitted]:
            j = self._emitted
            self.responder.send(
                {
                    "id": self.id,
                    "line": format_result(
                        j,
                        int(self.rows[j][0]),
                        int(self.rows[j][1]),
                        int(self.rows[j][2]),
                    ),
                }
            )
            self._emitted += 1
        if self._emitted == n and not self._done:
            self._done = True
            self.responder.send({"id": self.id, "done": True, "n": n})
            publish(
                "serve.request.done",
                id=self.id,
                n=n,
                latency_s=self._clock.now() - self._admitted_t,
                trace=self.trace_id,
            )
            self._close()


def build_session(item, clock, on_close=None) -> Session:
    """Validate one queued raw request into a :class:`Session`.

    Reuses the batch parser's header validation (same weight-range
    messages as stdin input) plus the encoder's alphabet check and the
    reference buffer caps — the caps must reject HERE, because past this
    point a cap violation would surface as a fatal ``ValueError`` inside
    the scorer and kill the loop.
    """
    raw = item.raw
    rid = raw.get("id")
    rid = f"req-{item.seq}" if rid is None else str(rid)
    deadline_s = raw.get("deadline_s")
    if deadline_s is None:
        deadline_s = env_float("SEQALIGN_SERVE_DEADLINE_S")
    deadline_t = None
    if deadline_s is not None:
        if (
            isinstance(deadline_s, bool)
            or not isinstance(deadline_s, (int, float))
            or deadline_s <= 0
        ):
            raise RequestError(
                f"request {rid!r}: 'deadline_s' must be a positive number"
            )
        # The deadline budget starts at ADMISSION, not at validation:
        # queue wait counts against the SLO.
        deadline_t = item.admitted_t + float(deadline_s)
    weights = raw.get("weights")
    if not isinstance(weights, (list, tuple)) or len(weights) != 4:
        raise RequestError(
            f"request {rid!r}: 'weights' must be a list of 4 integers"
        )
    seq1 = raw.get("seq1")
    if not isinstance(seq1, str) or not seq1.strip():
        raise RequestError(
            f"request {rid!r}: 'seq1' must be a nonempty string"
        )
    seq2 = raw.get("seq2", [])
    if not isinstance(seq2, list) or not all(
        isinstance(s, str) for s in seq2
    ):
        raise RequestError(
            f"request {rid!r}: 'seq2' must be a list of strings"
        )
    try:
        w, s1, _ = _parse_header_tokens(
            [str(x) for x in weights] + [seq1, str(len(seq2))]
        )
        seq1_codes = encode_normalized(s1)
        seq2_codes = [encode_normalized(s) for s in seq2]
    except ValueError as e:
        raise RequestError(f"request {rid!r}: {e}") from None
    if seq1_codes.size > BUF_SIZE_SEQ1:
        raise RequestError(
            f"request {rid!r}: Seq1 length {seq1_codes.size} exceeds "
            f"BUF_SIZE_SEQ1={BUF_SIZE_SEQ1}"
        )
    for j, c in enumerate(seq2_codes):
        if c.size == 0:
            raise RequestError(
                f"request {rid!r}: Seq2[{j}] is empty (whitespace-"
                "delimited batch input cannot express an empty sequence; "
                "drop the entry instead)"
            )
        if c.size > BUF_SIZE_SEQ2:
            raise RequestError(
                f"request {rid!r}: Seq2[{j}] length {c.size} exceeds "
                f"BUF_SIZE_SEQ2={BUF_SIZE_SEQ2}"
            )
    return Session(
        rid, w, s1, seq1_codes, seq2_codes, item.responder,
        item.admitted_t, clock,
        deadline_t=deadline_t,
        cost_s=getattr(item, "cost_s", 0.0),
        on_close=on_close,
        trace_id=getattr(item, "trace_id", ""),
    )


# -- the serve journal -------------------------------------------------------

#: Format fingerprint; foreign --journal files (batch/stream journals,
#: arbitrary JSON) are refused, same stance as utils/journal.py.
SERVE_JOURNAL_FORMAT = "mpi_openmp_cuda_tpu.serve-journal.v1"


def journal_drained(path: str, raw_requests: list[dict]) -> None:
    """Atomically write the drain leftovers: header line, one
    ``{"request": ...}`` record per queued raw dict, and a trailing
    ``{"event": "drain"}`` marker when anything was left.  Whole-file
    tmp+rename (not append): the leftovers ARE the full resume state,
    and a preemption mid-write must leave either the old file or the
    new one, never a torn tail."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(json.dumps({"format": SERVE_JOURNAL_FORMAT}) + "\n")
        for raw in raw_requests:
            f.write(json.dumps({"request": raw}) + "\n")
        if raw_requests:
            f.write(json.dumps({"event": "drain"}) + "\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_drained(path: str) -> list[dict]:
    """Read journaled raw requests back for ``--serve --resume``.

    Missing file → empty (plain ``--journal`` starts fresh; ``--resume``
    asserts existence at the CLI layer first).  A file that parses but
    is not a serve journal raises ``ValueError`` (fatal 65): silently
    rescoring a batch journal's worth of nothing would be worse.  Torn
    or alien trailing records are skipped, the journal reader's
    torn-tail tolerance applied here."""
    if not os.path.exists(path):
        return []
    requests: list[dict] = []
    with open(path, encoding="utf-8") as f:
        head = f.readline()
        if not head.strip():
            return []
        try:
            header = json.loads(head)
        except json.JSONDecodeError as e:
            raise ValueError(
                f"journal {path!r} is not a serve journal (unreadable "
                f"header: {e}); batch/stream/serve journals are mutually "
                "foreign — pass a fresh --journal path"
            ) from None
        if (
            not isinstance(header, dict)
            or header.get("format") != SERVE_JOURNAL_FORMAT
        ):
            raise ValueError(
                f"journal {path!r} is not a serve journal; batch/stream/"
                "serve journals are mutually foreign — pass a fresh "
                "--journal path"
            )
        for line in f:
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn tail: everything before it is intact
            if isinstance(rec, dict) and isinstance(rec.get("request"), dict):
                requests.append(rec["request"])
    return requests
