"""The serve loop: warm kernels, continuous batching, drain -> 75 (the port
of ``mpi_openmp_cuda_tpu/serve/loop.py``).

One :class:`ServeLoop` owns the run: the admission queue, the pending
window and the scorer, whose kernels stay built and loaded for as long as
the process lives (the point of serving over one-shot batch runs).

A **tick** is the unit of work: pop whatever coalesced in the gather
window, validate each raw request into a :class:`.session.Session` (a
typed error record on failure: the loop outlives bad input), plan the
pooled rows into fixed-shape superblocks, dispatch every block through the
shared :class:`..io.pipeline.ChunkPipeline` (asynchronous, windowed, the
next block's copies staged while the current one computes), then flush
and demux the rows back to their sessions by tag.  Every dispatch rides
the batch CLI's retry/degrade/watchdog machinery.

A tick's host time lies under detail spans (``obs/spans.py``), at most
one a tick or a block: the queue's ``serve.wait`` and ``serve.linger``
(idle), ``serve.intake`` (breaker, fleet pump, queue waits, the SLO
controller), ``serve.journal`` (the two live-journal checkpoints),
``serve.plan`` (admission checks, ``plan_blocks``, the superblock build),
``serve.stage`` (the next block's copies), ``serve.advance``, beside the
dispatch's ``chunk_dispatch`` / ``chunk_prefetch`` / ``chunk_gather`` and
the per-request ``serve.request.parse`` / ``serve.request.emit`` spans.

Threads: socket reader threads only ``json.loads`` and enqueue
(:mod:`.queue`); validation, every host-to-device copy, every launch and
every wait on a CUDA event run on the main loop thread, as do spans,
journal writes and metric mutation.  The telemetry thread only reads
snapshots.

**Drain**: the drain flag (SIGTERM/SIGINT) is checked at tick boundaries
and inside the queue wait (bounded by the clock: at worst one tick late).
On drain, admission closes, the launches in flight finish (their results
are waited for through ``ops/dispatch.py``'s event wait) and their lines
stream out, queued-but-unstarted requests are journaled (a whole-file
atomic serve journal) and told ``{"drained": true}``, and
:class:`DrainInterrupt` surfaces, the CLI's exit 75.  ``--serve --journal
P --resume`` re-admits the journaled requests before any new input.  The
signal handler only sets the flag: no device work happens inside it.

**Steady state**: the run's kernel builds, library loads and per-width
setups (``ops/_build.py::build_count``) are baselined after the first
block; the delta is the ``serve_steady_compiles`` gauge, which must stay
0.  On the card both kernels are loaded before the first tick
(:func:`warm_kernels`).  After a ``--prewarm`` (``aot/prewarm.py``) the
baseline is pinned at tick 0 instead (:meth:`ServeLoop.baseline_steady`):
the first block is held to zero too, and the gauge ``serve_prewarmed``
is 1.

**SLO armor**: admission is a cost-aware token bucket plus the
accept/shed-new/drain-only machine (:mod:`.slo`); per-request deadlines
are checked at admission pricing, at batch planning
(:meth:`ServeLoop._admit_sessions`) and at demux
(:meth:`.session.Session.fill`); a superblock that fails past its whole
retry/degrade ladder is retried once whole and then bisected, so one
poison request is isolated with a typed error while its co-batched
victims re-plan onto clean blocks; and the pipeline's circuit breaker
(:mod:`..resilience.breaker`), ticked here, pins the degraded backend
after repeated primary failures.

**Crash survival** (``kill:serve-tick``): while ``--journal`` is armed the
journal always holds every admitted-but-unanswered raw request, queued
and in flight, rewritten (whole-file atomic) at tick boundaries whenever
that set changes, so a SIGKILL loses nothing and ``--resume`` answers
nothing twice.

**Fleet** (:mod:`.fleet`): with ``--fleet-board`` the loop is the fleet
coordinator.  Planning, admission, SLO armor and demux are unchanged, but
while a worker is live each planned superblock is offered to the
``--fleet-worker`` processes on the board under an expiring lease, and the
tick pumps membership, lease expiry and result collection; with no live
worker every block scores here, as without a fleet.  The coordinator holds
a leader lease and checkpoints its unanswered requests to the board; a
``--fleet-standby`` (:func:`_standby_phase`) takes over when its beat goes
silent and replays them.
"""

from __future__ import annotations

import collections
import json
import os
import socket as socketlib
import struct
import sys
import threading

import numpy as np

from ..io.pipeline import FeedStager, PendingWindow
from ..obs.events import log_line, publish
from ..obs.metrics import gauge as obs_gauge
from ..obs.spans import span
from ..ops._build import build_count
from ..resilience.drain import DrainInterrupt, drain_requested
from ..resilience.faults import InjectedFatalFaultError
from ..resilience.faults import fire as _fault_fire
from ..resilience.faults import scheduled as _fault_scheduled
from ..resilience.policy import KernelUnavailableError
from ..utils.constants import BUF_SIZE_SEQ2
from ..utils.env import env_float, env_int
from .batcher import DEFAULT_BLOCK_ROWS, SuperBlock, plan_blocks
from .clock import ServeClock
from .queue import ADMIT_CLOSED, ADMIT_FULL, ADMIT_OVERLOADED, RequestQueue
from .session import (
    RequestError,
    Responder,
    build_session,
    journal_drained,
    load_drained,
    parse_raw,
)
from .slo import SHED_DRAIN, AdmissionController, RequestCostModel

PROG = "mpi_openmp_cuda_tpu_torch"

#: Upper bound on one queue wait: the drain flag is re-checked at least
#: this often even if no request ever arrives.
_TICK_S = 0.25


class ServeLoop:
    """The serving run's state: queue, window, pipeline, drain plumbing."""

    def __init__(
        self,
        pipeline,
        policy,
        *,
        clock=None,
        journal_path: str | None = None,
        max_depth: int | None = None,
        window_s: float | None = None,
        rows_per_block: int | None = None,
        max_pop: int | None = None,
    ):
        self.pipeline = pipeline
        self.policy = policy
        self.clock = clock or ServeClock()
        self.journal_path = journal_path
        self.window_s = (
            window_s if window_s is not None else env_float("SEQALIGN_SERVE_WINDOW_S", 0.05)
        )
        self.rows_per_block = (
            rows_per_block
            if rows_per_block is not None
            else env_int("SEQALIGN_SERVE_BLOCK_ROWS", DEFAULT_BLOCK_ROWS)
        )
        self.max_pop = max_pop if max_pop is not None else env_int("SEQALIGN_SERVE_MAX_POP", 0)
        self.controller = AdmissionController(
            budget_s=env_float("SEQALIGN_SERVE_COST_BUDGET_S", 4.0),
            shed_wait_s=env_float("SEQALIGN_SERVE_SHED_WAIT_S", 30.0),
            cost_model=RequestCostModel(rows_per_block=self.rows_per_block),
        )
        self.queue = RequestQueue(
            max_depth if max_depth is not None else env_int("SEQALIGN_SERVE_MAX_QUEUE", 256),
            self.clock,
            controller=self.controller,
        )
        self.window = PendingWindow(max(1, env_int("TPU_SEQALIGN_STREAM_DEPTH", 4)), self._finish)
        # Within a tick, block N+1's host-to-device copies are staged
        # while block N computes (_dispatch's ``nxt`` lookahead).
        self.stager = FeedStager(getattr(pipeline, "degrader", None))
        # --check / SEQALIGN_CHECK, as the run's scorer has it.
        self.check = bool(getattr(getattr(getattr(pipeline, "degrader", None),
                                          "scorer", None), "check", False))
        # The pipeline's circuit breaker (None without --degrade): the
        # loop ticks it, so its transitions count ticks, not seconds.
        self.breaker = getattr(pipeline, "breaker", None)
        self._steady_base: int | None = None
        # The fleet coordinator (run_serve attaches one under --fleet-board).
        self.fleet = None
        # Live-journal state: (session, raw) for every in-flight request,
        # plus the last journal body written (no-op rewrites skipped).
        self._inflight: list[tuple] = []
        self._journal_state: str | None = None
        # Answered reply ids (bounded: the deque evicts, the set mirrors
        # it), the fleet leader's idempotency set.
        self._answered: collections.deque = collections.deque(maxlen=4096)
        self._answered_set: set[str] = set()

    # -- ingest (reader threads and the main-thread stdin loop) -----------

    def ingest(self, line: str, responder) -> None:
        """One wire line -> dict -> admission; an error record for a line
        that is not a JSON object, backpressure and drain verdicts relayed
        to the client."""
        line = line.strip()
        if not line:
            return
        try:
            raw = parse_raw(line)
        except RequestError as e:
            publish("serve.request.rejected", reason="malformed", depth=self.queue.depth())
            responder.send({"id": None, "error": str(e)})
            return
        cmd = raw.get("cmd")
        if cmd is not None:
            # Read-only telemetry verbs ({"cmd": "metrics"|"healthz"|
            # "trace"}) answer inline: never queued, never priced.
            self._telemetry(str(cmd), responder)
            return
        rid = raw.get("id")
        if (
            self.fleet is not None
            and self.fleet.leader is not None
            and rid is not None
            and str(rid) in self._answered_set
        ):
            publish("serve.request.duplicate", id=str(rid))
            responder.send({"id": rid, "duplicate": True})
            return
        verdict = self.queue.submit(raw, responder)
        if verdict == ADMIT_FULL:
            responder.send({
                "id": raw.get("id"),
                "error": f"queue full ({self.queue.max_depth} requests queued); "
                "resubmit later",
            })
        elif verdict == ADMIT_OVERLOADED:
            responder.send({
                "id": raw.get("id"),
                "error": "overloaded",
                "retry_after_s": self.controller.retry_after_s(),
            })
        elif verdict == ADMIT_CLOSED:
            responder.send({
                "id": raw.get("id"),
                "error": "server is draining; resubmit elsewhere",
            })

    # -- telemetry (read-only, shared with the HTTP scrape) ----------------

    def status(self) -> dict:
        """Live health snapshot: the ``healthz`` verb and the HTTP
        ``/healthz`` endpoint both render exactly this dict."""
        return {
            "ok": True,
            "queue_depth": self.queue.depth(),
            "shed_state": self.controller.state,
            "breaker_state": getattr(self.breaker, "state", None),
        }

    def _telemetry(self, cmd: str, responder) -> None:
        from ..obs.telemetry import answer_cmd

        responder.send(answer_cmd(cmd, status=self.status()))

    # -- the scoring side --------------------------------------------------

    def _dispatch(self, block, staged=None, nxt=None):
        """Dispatch one superblock asynchronously under its own retry
        budget (the watchdog deadline rides inside the scorer, as in the
        batch CLI).  A failure past the whole retry/degrade ladder
        quarantines the block instead of killing the loop.

        ``staged`` is this block's prestaged feed (or None) and ``nxt``
        the tick's next block: once this dispatch is out, ``nxt``'s
        host-to-device copies are staged to overlap its compute, and the
        handle is returned for the next call.

        With a fleet accepting (a live worker on the board) the block is
        offered instead, under a fresh lease; the pump collects its
        epoch-fenced result.  The poison check stays here either way (the
        bisection needs the session tags, which never cross the board).
        An offer the board cannot take (a failed post) scores the block
        here instead: nothing was leased, so nothing answers it twice."""
        if self.fleet is not None and self.fleet.accepting():
            try:
                self._check_poison(block)
                self._check_block(block)
            except Exception as e:
                self._block_failed(block, e)
                return None
            try:
                self.fleet.offer(block)
            except OSError as e:
                log_line(f"{PROG}: serve: fleet offer failed to post ({e}); "
                         "scoring the superblock on the coordinator")
                self._fleet_fallback(block)
                return None
            publish(
                "serve.batch.dispatch",
                rows=block.real_rows,
                fill=round(block.fill_ratio, 4),
                depth=self.queue.depth(),
                links=block.link_ids(),
            )
            return None  # no local compute to overlap with
        budget = self.policy.new_budget()
        links = block.link_ids()
        try:
            self._check_poison(block)
            self._check_block(block)
            promise = self.pipeline.dispatch(
                block.seq1_codes, block.codes, block.weights, budget,
                links=links, staged=staged,
            )
        except Exception as e:
            self._block_failed(block, e)
            return None
        nstaged = None
        if nxt is not None:
            with span("serve.stage", detail=True):
                nstaged = self.stager.stage(nxt.seq1_codes, nxt.codes, nxt.weights)
        publish(
            "serve.batch.dispatch",
            rows=block.real_rows,
            fill=round(block.fill_ratio, 4),
            depth=self.queue.depth(),
            links=links,
        )
        self.window.push(promise, block, budget)
        return nstaged

    def _finish(self, promise, block, budget) -> None:
        """Materialise one superblock and demux its rows to sessions by
        tag (pad rows carry a ``None`` tag and are dropped)."""
        try:
            rows = self.pipeline.materialise(
                promise, block.seq1_codes, block.codes, block.weights, budget
            )
        except Exception as e:
            self._block_failed(block, e)
            return
        self._demux(rows, block)

    def _demux(self, rows, block) -> None:
        with span("serve.request.emit"):
            for row, tag in zip(rows, block.tags):
                if tag is not None:
                    sess, j = tag
                    sess.fill(j, row)
        if self._steady_base is None:
            # Baseline after the first block: its builds are the warm-up;
            # every later block must reuse what is loaded.
            self._steady_base = build_count()

    # -- poison-request quarantine ----------------------------------------

    def _check_block(self, block) -> None:
        """``--check``: the superblock's launch contract (its row count and
        one L2P bucket, ``analysis/contracts.py::check_serve_block``)
        before any of its launches; the scorer's own hook then checks each
        launch.  A violation fails the block like any scoring error."""
        if self.check:
            from ..analysis.contracts import check_serve_block

            check_serve_block(block, self.rows_per_block)

    def _check_poison(self, block) -> None:
        """Chaos marker: a poisoned session makes every superblock that
        holds it fail fatally (a ValueError: no retry, no degrade), so the
        quarantine bisection is what has to save its co-batched victims."""
        for tag in block.tags:
            if tag is not None and getattr(tag[0], "poisoned", False):
                raise InjectedFatalFaultError(
                    f"poisoned session {tag[0].id!r} co-batched in this superblock"
                )

    def _block_failed(self, block, err) -> None:
        """Quarantine stage 1: a superblock failed past its whole
        retry/degrade ladder.  One synchronous whole-block retry under a
        fresh budget (transient wedges clear); a block that fails twice is
        bisected by session."""
        publish("serve.block.failed", rows=block.real_rows, error=str(err))
        log_line(
            f"{PROG}: serve: superblock failed ({err}); retrying the whole "
            "block before bisection"
        )
        try:
            self._score_block_sync(block)
        except Exception as e:
            self._bisect(block, e)

    def _score_block_sync(self, block) -> None:
        """Score one superblock synchronously under a fresh budget and
        demux: the quarantine path's unit of work."""
        self._check_poison(block)
        self._check_block(block)
        budget = self.policy.new_budget()
        promise = self.pipeline.dispatch(
            block.seq1_codes, block.codes, block.weights, budget, links=block.link_ids(),
        )
        rows = self.pipeline.materialise(
            promise, block.seq1_codes, block.codes, block.weights, budget
        )
        self._demux(rows, block)

    def _fleet_fallback(self, block) -> None:
        """Score a fleet superblock on the coordinator (no live worker, a
        dead-lettered offer, a drain): the same sync score -> retry ->
        bisection quarantine ladder as any failed local block."""
        try:
            self._score_block_sync(block)
        except Exception as e:
            self._block_failed(block, e)

    def _bisect(self, block, err) -> None:
        """Quarantine stage 2: split the failed block's sessions in half
        and score each half on its own padded block, recursing on failure.
        A block of one session's rows alone that fails holds the poison:
        that session gets a typed error and the recursion ends.  One live
        session left in a block that also holds rows of sessions retired
        since (a poison quarantined in an earlier block) is scored on a
        block of its own first: the JAX loop blames it outright, so a
        victim sharing a second block with the poison got the poison's
        error."""
        groups: list[tuple] = []  # (session, [(j, codes), ...]) in order
        index: dict[int, tuple] = {}
        for tag, codes in zip(block.tags, block.codes):
            if tag is None:
                continue
            sess, j = tag
            if sess.closed:
                continue
            g = index.get(id(sess))
            if g is None:
                g = index[id(sess)] = (sess, [])
                groups.append(g)
            g[1].append((j, codes))
        if not groups:
            return
        if len(groups) == 1:
            sess = groups[0][0]
            if any(tag is not None and tag[0] is not sess for tag in block.tags):
                sub = self._subblock(block, groups)
                try:
                    self._score_block_sync(sub)
                except Exception as e:
                    self._bisect(sub, e)
                return
            publish("serve.request.poisoned", id=sess.id)
            log_line(f"{PROG}: serve: quarantined poison request {sess.id!r} ({err})")
            sess.fail(f"poison: superblock failed twice in isolation ({err})")
            return
        mid = (len(groups) + 1) // 2
        for half in (groups[:mid], groups[mid:]):
            sub = self._subblock(block, half)
            try:
                self._score_block_sync(sub)
            except Exception as e:
                self._bisect(sub, e)

    def _subblock(self, block, groups) -> SuperBlock:
        """Re-plan a subset of a failed block's sessions into a fresh
        block of the same shape (``rows_per_block`` rows of the parent's
        bucket)."""
        members = [(sess, j, codes) for sess, rows in groups for (j, codes) in rows]
        pad_len = min(max(c.size for (_, _, c) in members), BUF_SIZE_SEQ2)
        pad = np.ones(pad_len, dtype=np.int8)
        n_pad = max(0, self.rows_per_block - len(members))
        return SuperBlock(
            weights=block.weights,
            seq1_codes=block.seq1_codes,
            codes=[c for (_, _, c) in members] + [pad] * n_pad,
            tags=[(s, j) for (s, j, _) in members] + [None] * n_pad,
            real_rows=len(members),
        )

    def _release_session(self, sess) -> None:
        """Session ``on_close``: return its admission-bucket tokens (the
        bucket refills on completions)."""
        self.controller.release(sess.cost_s)

    def _admit_sessions(self, sessions, now: float) -> list:
        """Deadline/abandonment checkpoint at batch planning: a session
        already past its deadline, or whose modelled wall cannot fit what
        is left of it, is answered with the typed ``deadline`` error
        instead of occupying superblock rows; a session whose client
        vanished is retired silently (its cost is released either way)."""
        live = []
        for sess in sessions:
            if sess.closed:
                continue
            if sess.abandoned:
                sess.abandon()
                continue
            if sess.deadline_t is not None:
                remaining = sess.deadline_t - now
                if remaining <= 0.0 or sess.cost_s > remaining:
                    sess.fail("deadline", estimated_s=round(sess.cost_s, 6))
                    continue
            live.append(sess)
        return live

    def tick(self) -> bool:
        """One loop iteration; returns False once idle with no sources
        left (the stdin/file mode's end)."""
        # kill:serve-tick: SIGKILL at a tick boundary, where the live
        # journal holds exactly the unanswered set.
        _fault_fire("serve_tick")
        if drain_requested():
            self._drain(())
        window_s = 0.0 if self.controller.state == SHED_DRAIN else self.window_s
        items = self.queue.pop_ready(_TICK_S, window_s, self.max_pop, wake=drain_requested)
        if drain_requested():
            # Popped but unstarted at the drain boundary: nothing was
            # dispatched yet, so these journal as queued.
            self._drain(items)
        with span("serve.intake", detail=True):
            if self.breaker is not None:
                self.breaker.tick()
            if self.fleet is not None:
                self.fleet.pump(idle=not items and self.queue.depth() == 0)
            now = self.clock.now()
            if items:
                for item in items:
                    wait = max(0.0, now - item.admitted_t)
                    self.controller.observe_wait(wait)
                    publish("serve.queue.wait", wait_s=round(wait, 6), trace=item.trace_id)
            elif self.queue.depth() == 0:
                self.controller.note_idle()
            self.controller.update_state(now)
        sessions = []
        for item in items:
            try:
                with span("serve.request.parse"):
                    sess = build_session(item, self.clock, on_close=self._release_session)
            except RequestError as e:
                publish("serve.request.rejected", reason="invalid", depth=self.queue.depth())
                item.responder.send({"id": item.raw.get("id"), "error": str(e)})
                self.controller.release(item.cost_s)
                continue
            if _fault_scheduled("poison-session"):
                # Chaos marker: superblocks holding this session fail
                # fatally until the quarantine isolates it.
                sess.poisoned = True
            sessions.append(sess)
            self._inflight.append((sess, item.raw))
        # Journal checkpoint A: popped-but-unanswered requests are now in
        # flight; a death anywhere in this tick keeps them journaled.
        with span("serve.journal", detail=True):
            self._journal_live()
        with span("serve.plan", detail=True):
            live = self._admit_sessions(sessions, now)
            blocks = list(plan_blocks(live, self.rows_per_block)) if live else []
        if live:
            staged = None
            for i, block in enumerate(blocks):
                nxt = blocks[i + 1] if i + 1 < len(blocks) else None
                staged = self._dispatch(block, staged=staged, nxt=nxt)
            self.window.flush()
        with span("serve.advance", detail=True):
            for sess in sessions:
                # Emits the done record of an empty (n == 0) request; a
                # no-op for sessions already completed or failed.
                sess.advance()
        with span("serve.journal", detail=True):
            # Journal checkpoint B: requests answered this tick leave the
            # journal, so a kill at the next tick cannot answer them twice.
            self._journal_live()
            obs_gauge("queue_depth", self.queue.depth())
            obs_gauge("shed_state", self.controller.state)
        return (
            bool(items)
            or not self.queue.idle()
            or (self.fleet is not None and self.fleet.outstanding() > 0)
        )

    def _note_answered(self, rid: str) -> None:
        """Record one answered reply id in the bounded dedupe window."""
        if rid in self._answered_set:
            return
        if len(self._answered) == self._answered.maxlen:
            self._answered_set.discard(self._answered[0])
        self._answered.append(rid)
        self._answered_set.add(rid)

    def _journal_live(self) -> None:
        """Rewrite the serve journal (whole-file atomic) with every
        admitted-but-unanswered raw request, in flight first (older), then
        still queued, skipping the write when nothing changed.  The
        drain's :func:`journal_drained` call stays the last word."""
        kept = []
        for sess, raw in self._inflight:
            if not sess.closed:
                kept.append((sess, raw))
                continue
            if sess.answered:
                rid = raw.get("id")
                if rid is not None:
                    self._note_answered(str(rid))
        self._inflight = kept
        fleet_leader = self.fleet is not None and self.fleet.leader is not None
        if self.journal_path is None and not fleet_leader:
            return
        raws = [raw for (_sess, raw) in self._inflight]
        raws += self.queue.snapshot_raws()
        if fleet_leader:
            self.fleet.checkpoint(raws, self._answered)
        if self.journal_path is None:
            return
        state = json.dumps(raws)
        if state == self._journal_state:
            return
        self._journal_state = state
        journal_drained(self.journal_path, raws)

    # -- drain -------------------------------------------------------------

    def _drain(self, popped) -> None:
        """Close admission, finish the launches in flight, journal the
        leftovers, and raise the resumable preemption (the CLI's 75)."""
        self.queue.close()
        self.window.flush()
        if self.fleet is not None:
            self.fleet.finish_locally()
        leftovers = list(popped) + self.queue.drain_pending()
        for it in leftovers:
            it.responder.send({"id": it.raw.get("id"), "drained": True})
        n = len(leftovers)
        if self.journal_path is not None:
            journal_drained(self.journal_path, [it.raw for it in leftovers])
            raise DrainInterrupt(
                f"serve loop preempted; {n} queued request(s) journaled — rerun "
                f"with --serve --journal {self.journal_path} --resume to finish them"
            )
        raise DrainInterrupt(
            f"serve loop preempted; no --journal, so {n} queued request(s) are "
            "dropped (clients were sent drained notices)"
        )

    def baseline_steady(self) -> None:
        """Pin the steady baseline now, before the first tick (after a
        prewarm), so the first block too must reuse what is built, loaded
        and set up; the gauge ``serve_prewarmed`` says the strict baseline
        is armed."""
        self._steady_base = build_count()
        obs_gauge("serve_prewarmed", 1)

    def record_steady_gauge(self) -> None:
        """Export the builds, loads and setups since the first block (0
        until a block has finished)."""
        base = self._steady_base
        obs_gauge("serve_steady_compiles", 0 if base is None else build_count() - base)


# -- transports --------------------------------------------------------------


def _serve_connection(loop: ServeLoop, conn) -> None:
    """One client connection's reader thread: lines in, queue in; the
    responder (the writer side) is driven from the main loop thread.  The
    connection stays open after the client's EOF so pending results flow;
    a client that disconnects hard just deadens its responder.

    Slow-client armor: a send timeout (SO_SNDTIMEO, not
    ``conn.settimeout``, which would also time out this thread's reads)
    bounds how long a full client socket buffer can stall the emit path;
    a timed-out write raises OSError in ``Responder.send`` and the client
    is classified dead.

    Each connection holds one queue source while its reader lives and its
    responder is healthy; whichever dies first releases it exactly once.
    """
    timeout_s = env_float("SEQALIGN_SERVE_WRITE_TIMEOUT_S", 5.0)
    if timeout_s and timeout_s > 0:
        tv = struct.pack("ll", int(timeout_s), int((timeout_s % 1.0) * 1e6))
        try:
            conn.setsockopt(socketlib.SOL_SOCKET, socketlib.SO_SNDTIMEO, tv)
        except (OSError, ValueError):  # pragma: no cover - platform quirk
            pass
    rfile = conn.makefile("r", encoding="utf-8", newline="\n")
    wfile = conn.makefile("w", encoding="utf-8", newline="\n")
    state = {"released": False}
    release_lock = threading.Lock()

    def _release() -> None:
        with release_lock:
            if state["released"]:
                return
            state["released"] = True
        loop.queue.close_source()

    responder = Responder(wfile, on_dead=_release)
    loop.queue.open_source()
    try:
        for line in rfile:
            loop.ingest(line, responder)
    except (OSError, ValueError):
        pass
    finally:
        _release()


def _accept_loop(loop: ServeLoop, sock) -> None:
    """The listener thread: accept, then a daemon reader per client."""
    while True:
        try:
            conn, _addr = sock.accept()
        except OSError:
            return  # listener closed: the run is over
        threading.Thread(target=_serve_connection, args=(loop, conn), daemon=True).start()


def _standby_phase(loop: ServeLoop, board, leader, out_responder) -> bool:
    """The ``--fleet-standby`` phase: watch the leader's beat until a
    verdict.  True once this process holds the leadership (the caller then
    runs the tick loop as the successor coordinator), False on a clean
    exit (the fleet shut down, or this standby was drained while empty).

    Takeover, all before the first tick: the next generation is claimed
    (inside ``standby_wait``), the successor coordinator built, the
    answered-id set seeded from the dead leader's checkpoint and its
    unanswered requests re-ingested through the normal admission path.
    The answered set makes the replay, and any client redriving its own
    requests afterwards, idempotent."""
    from ..resilience.membership import read_checkpoint
    from .fleet import FleetCoordinator, standby_wait

    verdict, watched = standby_wait(board, leader, loop.clock)
    if verdict != "takeover":
        log_line(f"{PROG}: serve: standby exiting ({verdict}): nothing to take over")
        if verdict == "drain" and loop.queue.depth() > 0:
            loop._drain(())  # raises DrainInterrupt: the CLI's 75
        return False
    publish("leader.takeover", gen=leader.gen, prev=watched, leader=leader.lid)
    obs_gauge("fleet_leader_epoch", leader.gen)
    log_line(f"{PROG}: serve: standby took over as leader gen {leader.gen} "
             f"(gen {watched} went silent)")
    loop.fleet = FleetCoordinator(board, local_score=loop._fleet_fallback,
                                  demux=loop._demux, clock=loop.clock, leader=leader)
    obs_gauge("fleet_workers", 0)
    ckpt = read_checkpoint(board, watched)
    if ckpt is None:
        log_line(f"{PROG}: serve: no readable checkpoint from gen {watched}; "
                 "serving fresh traffic only")
        return True
    for rid in ckpt["answered"]:
        loop._note_answered(str(rid))
    replayed = 0
    loop.queue.open_source()
    try:
        for raw in ckpt["requests"]:
            if not isinstance(raw, dict):
                continue
            rid = raw.get("id")
            if rid is not None and str(rid) in loop._answered_set:
                continue  # the dead leader answered it
            loop.ingest(json.dumps(raw), out_responder)
            replayed += 1
    finally:
        loop.queue.close_source()
    log_line(f"{PROG}: serve: replayed {replayed} unanswered request(s) from gen "
             f"{watched}'s checkpoint ({len(ckpt['answered'])} already answered)")
    # Re-checkpoint under this generation before the first tick: a kill
    # during the takeover must not lose what was just admitted.
    loop._journal_live()
    return True


def warm_kernels(deg) -> None:
    """Build and load both scorer kernels before the first tick when the
    primary backend is ``cuda`` on a card, so no block pays a build or a
    load.  A kernel that cannot be built raises (the CLI's 65), unless
    ``--degrade`` is on: then the warning goes to stderr and the first
    dispatch meets the same error and degrades, visibly."""
    scorer = deg.scorer
    device = getattr(scorer, "device", None)
    if scorer.backend != "cuda" or device is None or device.type != "cuda":
        return
    from ..ops.cuda_scorer import load_kernels

    try:
        load_kernels()
    except KernelUnavailableError as e:
        if not deg.enabled:
            raise
        log_line(f"{PROG}: warning: serve: the kernels are not available ({e})")


def run_serve(args, timer, policy, deg, out_stream=None, prewarmed=False) -> int:
    """CLI entry for ``--serve`` and ``--fleet-standby`` (called with the
    obs plane, faults, the watchdog and the drain guard already armed, and
    the kernels warmed, by ``io.cli.run``).

    Sources: ``--port`` opens a loopback ndjson socket (port 0: the OS
    assigns; the bound port is announced on stderr).  Without a port, or
    with an explicit ``--input``, requests are read line by line from the
    file or stdin on the main thread and the loop runs until the queue
    drains, which makes pipe mode deterministic for tests.  A standby reads
    no pipe: its requests are the dead leader's checkpoint and whatever
    clients connect to its port.

    With ``--fleet-board`` the loop coordinates the fleet as leader of a
    fresh generation (the coordinator) or waits to take one over (the
    standby); a clean completion sweeps the board (``gc_final``) and every
    exit posts the shutdown key that releases the workers.

    ``prewarmed`` (the CLI ran the prewarm) pins the steady baseline at
    tick 0 (:meth:`ServeLoop.baseline_steady`).
    """
    from ..io.parse import open_input
    from ..io.pipeline import ChunkPipeline

    breaker = None
    if deg is not None and deg.enabled:
        from ..resilience.breaker import STATE_CLOSED, CircuitBreaker

        breaker = CircuitBreaker(
            deg,
            threshold=env_int("SEQALIGN_BREAKER_THRESHOLD", 3),
            window_ticks=env_int("SEQALIGN_BREAKER_WINDOW", 16),
            cooldown_ticks=env_int("SEQALIGN_BREAKER_COOLDOWN", 8),
        )
        obs_gauge("breaker_state", STATE_CLOSED)
    loop = ServeLoop(ChunkPipeline(policy, deg, breaker=breaker), policy,
                     journal_path=args.journal)
    if prewarmed:
        loop.baseline_steady()
    standby = bool(getattr(args, "fleet_standby", False))
    board = leader = None
    if getattr(args, "fleet_board", None):
        from ..resilience.membership import LeaderLease, shutdown_key
        from ..resilience.rescue import FileBoard
        from .fleet import FleetCoordinator, lease_ticks_for

        board = FileBoard(args.fleet_board)
        leader = LeaderLease(board, f"c{os.getpid()}", lease_ticks_for())
        if standby:
            log_line(f"{PROG}: serve: standby watching board {args.fleet_board!r} "
                     f"(leader deadline {leader.deadline_ticks} ticks)")
        else:
            # A reused board may hold a finished run's shutdown key, which
            # would retire this run's workers and standbys on sight.
            board.delete(shutdown_key())
            gen = leader.acquire()
            obs_gauge("fleet_leader_epoch", gen)
            loop.fleet = FleetCoordinator(board, local_score=loop._fleet_fallback,
                                          demux=loop._demux, clock=loop.clock,
                                          leader=leader)
            obs_gauge("fleet_workers", 0)
            log_line(f"{PROG}: serve: fleet coordinator on board {args.fleet_board!r} "
                     f"as leader gen {gen} (lease {loop.fleet.lease_ticks} ticks)")
    out_responder = Responder(out_stream or sys.stdout)
    if args.journal:
        resumed = load_drained(args.journal)
        if resumed:
            log_line(
                f"{PROG}: serve journal {args.journal!r}: re-admitting "
                f"{len(resumed)} drained request(s)"
            )
        for raw in resumed:
            loop.ingest(json.dumps(raw), out_responder)

    port = args.port if args.port is not None else env_int("SEQALIGN_SERVE_PORT")
    persistent = port is not None
    telemetry_port = args.telemetry_port
    if telemetry_port is None:
        telemetry_port = env_int("SEQALIGN_TELEMETRY_PORT")
    sock = None
    telem = None
    try:
        if telemetry_port is not None:
            from ..obs.telemetry import TelemetryServer

            telem = TelemetryServer(int(telemetry_port), status=loop.status)
            log_line(f"{PROG}: telemetry on 127.0.0.1:{telem.start()}")
        if persistent:
            sock = socketlib.create_server(("127.0.0.1", int(port)))
            bound = sock.getsockname()[1]
            log_line(f"{PROG}: serving on 127.0.0.1:{bound}")
            loop.queue.open_source()
            threading.Thread(target=_accept_loop, args=(loop, sock), daemon=True).start()
        serving = True
        with timer.phase("serve"):
            if standby:
                serving = _standby_phase(loop, board, leader, out_responder)
            if serving:
                if (not persistent or args.input is not None) and not standby:
                    loop.queue.open_source()
                    try:
                        with open_input(args.input) as stream:
                            for line in stream:
                                loop.ingest(line, out_responder)
                                if drain_requested():
                                    break
                    finally:
                        loop.queue.close_source()
                    # Journal (and, as fleet leader, checkpoint) the freshly
                    # queued raws before the first tick: a leader killed at
                    # its first pump already has them on the board.
                    loop._journal_live()
                while True:
                    alive = loop.tick()
                    if not persistent and not alive:
                        break
        if serving and args.journal:
            # Clean completion: nothing pending, so a later --resume
            # re-admits nothing.
            journal_drained(args.journal, [])
        if serving and loop.fleet is not None:
            # A completed run leaves no offer, claim, result or checkpoint
            # on the board: only the worker registry and the generation
            # record.
            loop.fleet.gc_final()
        timer.report()
        return 0
    finally:
        if loop.fleet is not None:
            loop.fleet.shutdown()
        loop.record_steady_gauge()
        if telem is not None:
            telem.close()
        if sock is not None:
            try:
                sock.close()
            except OSError:  # pragma: no cover - teardown best-effort
                pass
