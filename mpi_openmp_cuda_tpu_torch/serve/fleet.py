"""Elastic serve fleet: coordinator-side dispatch + scoring workers (the
port of ``mpi_openmp_cuda_tpu/serve/fleet.py``).

The serve loop (serve/loop.py) stays the **coordinator** — admission,
SLO armor, ``plan_blocks``, demux, journaling are unchanged — but with
``--fleet-board DIR`` armed, planned superblocks are *offered* on a
:class:`~..resilience.rescue.FileBoard` instead of scored in-process.
N ``--fleet-worker`` processes register on the same board, heartbeat,
claim offers under expiring leases, score them through the shared
:class:`~..io.pipeline.ChunkPipeline` (same retry/degrade ladder as
everywhere else; on a card, the fused and packed Hopper kernels), and post
epoch-stamped results.  The board's keys and payloads are the JAX
package's, so a coordinator of one package drives workers of the other.

The failure model:

* a worker that dies mid-superblock (SIGKILL) stops heartbeating; the
  coordinator's membership deadline declares it dead and re-dispatches
  its held superblocks to a survivor;
* a worker that stalls (claims, never posts) hits the lease deadline —
  same re-dispatch, no death verdict needed;
* a **zombie** (declared dead but still running) may post its result
  late: the post carries the OLD lease epoch, the coordinator fences it
  (counted, never demuxed), so no request is ever double-answered;
* a torn result post reads as missing (resilience/membership.py), so
  the lease expires and the block is re-dispatched;
* with NO live workers, every block — new or orphaned — scores locally
  on the coordinator through the degrade chain.  The fleet is an
  accelerator, never an availability dependency;
* a superblock whose lease keeps expiring does not re-offer forever:
  the fencing epoch doubles as the attempt counter, and past
  ``SEQALIGN_FLEET_MAX_REDISPATCH`` bumps the block takes the typed
  **dead-letter** path — scored locally through the serve loop's
  quarantine ladder (retry → degrade → poison bisection), so a
  poisoned request is *answered* (``{"id", "error": "poisoned"}``),
  never orbited.

**Coordinator failover** extends the same model one layer up.
The coordinator holds a :class:`~..resilience.membership.LeaderLease`:
it claims a fleet **generation** at startup, renews a beat on every
pump tick, stamps its generation into every block id (``g<gen>b<seq>``),
and checkpoints its unanswered requests + answered reply ids to the
board.  A ``--fleet-standby`` process (:func:`standby_wait`) watches
the newest generation's beat with the worker-heartbeat staleness rule;
when the leader goes silent, the standby claims the next generation,
replays the checkpoint, and re-answers only what was never answered —
exactly-once across ``kill -9`` at tick boundaries.  A deposed leader
(one that observes a higher generation) raises
:class:`LeadershipLostError` on its next pump *before* collecting or
demuxing anything, and its late board posts are fenced by generation —
counted by the new leader's board GC, never read.  The GC also keeps
the board bounded: retired-epoch debris and dead generations' keys are
swept each tick past a grace window.
"""

from __future__ import annotations

import collections
import json
import math
import os
import re
import threading

import numpy as np

from ..obs.events import log_line, publish
from ..obs.export import collect_worker_snapshot, post_worker_snapshot
from ..obs.flightrec import dump_fleet_tape
from ..obs.metrics import active_metrics
from ..obs.metrics import gauge as obs_gauge
from ..obs.spans import span
from ..obs.trace import (
    active_trace,
    trace_board_phase,
    trace_clock_offsets,
)
from ..resilience.drain import drain_requested
from ..resilience.faults import fire as _fault_fire
from ..resilience.faults import scheduled as _fault_scheduled
from ..resilience.membership import (
    FLEET_PREFIX,
    OFFER_PREFIX,
    ClockOffsetEstimator,
    LeaseTable,
    Membership,
    board_read_json,
    ckpt_key,
    claim_key,
    heartbeat_key,
    obs_snapshot_key,
    offer_key,
    result_key,
    shutdown_key,
    worker_key,
)
from ..utils.env import env_float, env_int
from .clock import ServeClock

#: Coordinator board-poll cadence: one membership/lease tick per poll.
_POLL_S = 0.05

#: Coordinator obs-gather cadence, in pump ticks: how often live
#: workers' posted observability snapshots are folded into the local
#: registry/tracer.  Snapshots overwrite in place on the board, so a
#: slow gather loses granularity, never correctness.
_OBS_GATHER_TICKS = 5


def lease_ticks_for(lease_s=None, poll_s=_POLL_S) -> int:
    """The one lease-window formula, shared by the coordinator's worker
    leases and the standby's leader-watch deadline — a takeover must
    land within the same window a worker death verdict does."""
    if lease_s is None:
        lease_s = env_float("SEQALIGN_LEASE_S", 2.0)
    return max(2, round(float(lease_s) / float(poll_s)))


def _gen_of(name: str) -> int | None:
    """Parse a ``g<gen>`` key segment (leader/leaderhb/ckpt names)."""
    if not name.startswith("g"):
        return None
    try:
        return int(name[1:])
    except ValueError:
        return None


def _epoch_of(name: str) -> int | None:
    """Parse an ``e<epoch>`` key segment (claim/result leaf names)."""
    if not name.startswith("e"):
        return None
    try:
        return int(name[1:])
    except ValueError:
        return None


def _pause(clock, seconds: float, predicate=None) -> None:
    """Bounded wait through the injectable clock (the ServeClock is the
    one home of blocking waits).  A fresh local Condition per wait —
    nothing ever notifies it, the timeout is the only wake-up, which is
    exactly what a board poll interval needs."""
    cond = threading.Condition()
    with cond:
        clock.block_until(cond, predicate or (lambda: False), seconds)


def _block_traces(block) -> list[str]:
    """The admission-minted trace ids riding a superblock (empty for
    blocks built without tags — unit-test stubs, replayed journals)."""
    fn = getattr(block, "link_traces", None)
    return [str(t) for t in (fn() if fn is not None else ())]


def _block_links(block) -> list[str]:
    """The request ids riding a superblock (same stance as above)."""
    fn = getattr(block, "link_ids", None)
    return [str(r) for r in (fn() if fn is not None else ())]


def _offer_traces(offer: dict) -> list[str]:
    """The trace ids an offer propagated (empty for old-protocol or
    hand-crafted offers — the worker still scores them)."""
    return [str(t) for t in (offer.get("traces") or ())]


def _finite(x) -> float:
    """Coerce one phase delta to a finite float (0.0 for anything
    else) — the board-phase gate requires every row finite."""
    try:
        v = float(x)
    except (TypeError, ValueError):
        return 0.0
    return v if math.isfinite(v) else 0.0


class LeadershipLostError(RuntimeError):
    """This coordinator observed a higher leader generation: a standby
    took over.  The deposed leader must stop — answering anything after
    this point could double a reply the successor is about to give.
    Raised from ``pump()`` before any collect/demux, so the answer
    window of a zombie leader is bounded by one board poll."""


class FleetCoordinator:
    """Coordinator-side fleet state: the membership view, the lease
    table, offer/result board traffic, and the re-dispatch policy.

    Driven entirely from the serve loop's main thread — ``offer()`` at
    dispatch, ``pump()`` once per loop tick — so there is no shared
    mutable state and no locking.  Every decision is tick-counted: one
    ``pump`` that actually polls the board is one tick for membership
    deadlines and lease expiry alike.
    """

    #: Retired blocks kept under the stale-result probe, so a zombie's
    #: late post is still *counted* as fenced after its block finished.
    _RETIRED_PROBE = 64

    def __init__(
        self,
        board,
        *,
        local_score,
        demux,
        clock=None,
        lease_s=None,
        poll_s=_POLL_S,
        leader=None,
        max_redispatch=None,
    ):
        self.board = board
        self.clock = clock or ServeClock()
        self._local_score = local_score
        self._demux = demux
        self.poll_s = float(poll_s)
        self.lease_ticks = lease_ticks_for(lease_s, self.poll_s)
        self.membership = Membership(board, deadline_ticks=self.lease_ticks)
        self.leases = LeaseTable(self.lease_ticks)
        self.expected = env_int("SEQALIGN_FLEET_WORKERS", 0)
        self._full_logged = False
        self.blocks: dict = {}  # bid -> SuperBlock (tags stay local)
        self._seq = 0
        self._tick = 0
        self._last_poll = None
        self._fenced_seen: set[str] = set()
        self._retired = collections.deque(maxlen=self._RETIRED_PROBE)
        # Failover state.  ``leader`` is the held LeaderLease, or
        # None for a leaderless coordinator (unit tests, the in-memory
        # interleave scenarios) — which behaves as generation 0 with no
        # beat, no deposition, and no checkpointing.
        self.leader = leader
        self.gen = (
            leader.gen if leader is not None and leader.gen is not None else 0
        )
        if max_redispatch is None:
            max_redispatch = env_int("SEQALIGN_FLEET_MAX_REDISPATCH", 5)
        self.max_redispatch = int(max_redispatch)
        self.gc_ticks = (
            env_int("SEQALIGN_FLEET_GC_TICKS", 0) or 2 * self.lease_ticks
        )
        self._deposed = False
        self._zombie_leader = False  # chaos: freeze the beat, earn deposition
        self._gc_marks: dict[str, int] = {}  # sweepable key -> tick marked
        self._gc_fenced: set[str] = set()  # stale-gen keys already counted
        self._ckpt_blob: str | None = None  # change-cache for checkpoint()
        # Fleet observability plane: deterministic per-worker
        # clock offsets from offer/claim echo pairs, per-block phase
        # timestamps (overwritten on re-offer — the phase row describes
        # the attempt that actually finished), and the dead workers
        # whose flight-recorder tape was already collected.
        self.offsets = ClockOffsetEstimator()
        self._phase_marks: dict[str, dict] = {}
        self._tapes_collected: set[str] = set()

    # -- dispatch side -----------------------------------------------------

    def accepting(self) -> bool:
        """Offers only make sense with a live worker to claim them; the
        serve loop scores locally otherwise."""
        return self.membership.live_count() > 0

    def outstanding(self) -> int:
        return len(self.blocks)

    def offer(self, block) -> str:
        """Put one planned superblock on the board under a fresh lease.
        Only the scoring payload crosses the board — session tags (live
        object references) stay coordinator-side, keyed by block id.

        Block ids are generation-scoped (``g<gen>b<seq>``): a successor
        leader restarting its sequence at 1 must never collide with the
        dead leader's keys — those are fenced debris, not its namespace.

        The post happens BEFORE any lease state exists: on a board that
        cannot take the write (ENOSPC), the raised OSError propagates to
        the dispatcher with nothing to unwind, and the serve loop's
        quarantine ladder scores the block instead.
        """
        bid = f"g{self.gen}b{self._seq + 1}"
        self._post_offer(bid, 0, block)  # a fresh lease starts at epoch 0
        self._seq += 1
        self.blocks[bid] = block
        self.leases.issue(bid, self._tick)
        return bid

    def _post_offer(self, bid: str, epoch: int, block) -> None:
        """The offer is a WORK UNIT crossing a process boundary, so it
        carries its trace context: the admission-minted
        trace ids and request ids riding this superblock, plus the
        coordinator-clock post time — the first half of the offer/claim
        echo pair the clock-offset estimator feeds on."""
        t_offer = float(self.clock.now())
        self.board.post(
            offer_key(bid),
            json.dumps({
                "bid": bid,
                "epoch": int(epoch),
                "weights": [int(w) for w in block.weights],
                "seq1": np.asarray(block.seq1_codes).tolist(),
                "rows": [np.asarray(c).tolist() for c in block.codes],
                "traces": _block_traces(block),
                "links": _block_links(block),
                "t_offer": t_offer,
            }),
        )
        self._phase_marks[bid] = {"epoch": int(epoch), "t_offer": t_offer}

    # -- the per-tick pump -------------------------------------------------

    def pump(self, idle: bool = False) -> None:
        """One serve-loop tick's worth of fleet work: poll the board at
        most once per ``poll_s`` — membership observe, stale-post
        fencing, result collection, lease expiry → re-dispatch.  When
        the loop is otherwise idle with blocks in flight, sleep out the
        remainder of the poll interval instead of spinning."""
        now = self.clock.now()
        if self._last_poll is not None:
            wait = self.poll_s - (now - self._last_poll)
            if wait > 0:
                if not (idle and self.blocks):
                    return
                _pause(self.clock, wait, drain_requested)
        self._last_poll = self.clock.now()
        self._tick += 1
        tick = self._tick
        # kill:fleet-coordinator rides this fire point: SIGKILL at the
        # pump-tick boundary, after the previous tick's checkpoint
        # landed — the standby-takeover chaos tier.
        _fault_fire("fleet_pump")
        if self.leader is not None:
            if _fault_scheduled("zombie:fleet-leader"):
                self._zombie_leader = True
                log_line(
                    "mpi_openmp_cuda_tpu_torch: fleet: leader "
                    f"gen {self.gen} going zombie — beat frozen (chaos)"
                )
            # Deposition check FIRST, before renew and before any
            # collect/demux: a zombie leader's answer window is one poll.
            if self.leader.deposed():
                self._deposed = True
                publish(
                    "leader.deposed", gen=self.gen, leader=self.leader.lid
                )
                log_line(
                    f"mpi_openmp_cuda_tpu_torch: fleet: leader gen {self.gen} "
                    "deposed by a higher generation; stopping"
                )
                raise LeadershipLostError(
                    f"fleet leader generation {self.gen} was superseded"
                )
            if not self._zombie_leader:
                self.leader.renew()
        joined, died = self.membership.observe(tick)
        for wid in joined:
            log_line(
                f"mpi_openmp_cuda_tpu_torch: fleet: worker {wid} joined "
                f"({self.membership.live_count()} live)"
            )
        if (
            not self._full_logged
            and self.expected
            and self.membership.live_count() >= self.expected
        ):
            self._full_logged = True
            log_line(
                "mpi_openmp_cuda_tpu_torch: fleet: complete "
                f"({self.expected} worker(s) registered)"
            )
        for wid in died:
            log_line(
                f"mpi_openmp_cuda_tpu_torch: fleet: worker {wid} missed its "
                "heartbeat deadline; re-dispatching its superblocks"
            )
            # Tape first, re-dispatch second: the dead worker's last
            # posted snapshot is the only record of what it was doing.
            self._collect_tape(wid)
            for lease in self.membership_held(wid):
                self._redispatch(lease.bid, "worker-dead")
        for bid in list(self.blocks):
            self._collect(bid, tick)
        self._probe_retired()
        for lease in self.leases.expired(tick):
            if lease.bid not in self.blocks:
                continue
            publish(
                "lease.expired",
                block=lease.bid,
                epoch=lease.epoch,
                worker=lease.holder,
            )
            log_line(
                f"mpi_openmp_cuda_tpu_torch: fleet: lease on {lease.bid} "
                f"(epoch {lease.epoch}, holder {lease.holder}) expired; "
                "re-dispatching"
            )
            self._redispatch(lease.bid, "lease-expired")
        self._gc(tick)
        if tick % _OBS_GATHER_TICKS == 0:
            self._gather_obs()
        obs_gauge("fleet_workers", self.membership.live_count())

    def membership_held(self, wid: str):
        return [
            lease for lease in self.leases.held_by(wid)
            if lease.bid in self.blocks
        ]

    def _collect(self, bid: str, tick: int) -> None:
        lease = self.leases.get(bid)
        block = self.blocks[bid]
        self._fence_stale(bid, lease.epoch)
        # The claim first: a worker that claims, scores and posts within
        # one poll interval (the card scores a block in microseconds) must
        # still feed its claim echo to the clock-offset estimator before
        # the block's phase row is written.
        if lease.holder is None:
            claim = board_read_json(
                self.board, claim_key(bid, lease.epoch)
            )
            if claim is not None and claim.get("wid"):
                wid = str(claim["wid"])
                self.leases.note_claim(bid, wid, tick)
                self._note_claim_echo(bid, wid, claim)
        post = board_read_json(self.board, result_key(bid, lease.epoch))
        if post is not None:
            rows = self._valid_rows(post, bid, len(block.codes))
            if rows is not None:
                self.blocks.pop(bid)
                self.leases.retire(bid)
                self._retired.append((bid, int(post["epoch"])))
                self.board.delete(offer_key(bid))
                self._demux(rows, block)
                self._note_phases(bid, post, block)

    def _fence_stale(self, bid: str, current: int) -> None:
        """Probe every PREVIOUS epoch's result key: a post there is a
        zombie's late answer — observed once (event + counter), never
        demuxed.  Exactly-once holds structurally (the demux only ever
        reads the current-epoch key); this makes the fencing visible."""
        for epoch in range(int(current)):
            key = result_key(bid, epoch)
            if key in self._fenced_seen:
                continue
            if self.board.get(key) is None:
                continue
            self._fenced_seen.add(key)
            post = board_read_json(self.board, key) or {}
            publish(
                "lease.fenced",
                block=bid,
                epoch=epoch,
                current=int(current),
                worker=post.get("wid"),
            )
            log_line(
                f"mpi_openmp_cuda_tpu_torch: fleet: fenced stale epoch-{epoch} "
                f"result for {bid} (current epoch {int(current)})"
            )

    def _probe_retired(self) -> None:
        for bid, final_epoch in self._retired:
            self._fence_stale(bid, final_epoch)

    def _valid_rows(self, post: dict, bid: str, n_rows: int):
        """Accept a result post only if it carries the CURRENT lease
        epoch (the fencing predicate) and well-shaped rows.  Anything
        else reads as missing — the lease deadline re-dispatches."""
        try:
            epoch = int(post.get("epoch", -1))
        except (TypeError, ValueError):
            return None
        if not self.leases.admits(bid, epoch):
            return None
        try:
            rows = np.asarray(post.get("rows"), dtype=np.int64)
        except (TypeError, ValueError):
            return None
        if rows.shape != (int(n_rows), 3):
            return None
        return rows

    # -- fleet observability: clock offsets, board phases, gather ----------

    def _note_claim_echo(self, bid: str, wid: str, claim: dict) -> None:
        """Feed the offer/claim echo pair to the clock-offset estimator
        (NTP-style midpoint: the worker's ``t_claim`` echo against this
        clock's post/seen bracket) and remember the claim times for the
        block's eventual phase row.  Old-protocol claims without the
        echo simply contribute nothing — absence over negotiation."""
        marks = self._phase_marks.get(bid)
        if marks is None or "t_claim" not in claim:
            return
        t_seen = float(self.clock.now())
        self.offsets.observe(wid, marks["t_offer"], claim["t_claim"], t_seen)
        marks["wid"] = wid
        marks["t_claim_w"] = claim["t_claim"]
        marks["t_claim_seen"] = t_seen
        trace_clock_offsets(self.offsets.snapshot())

    def _note_phases(self, bid: str, post: dict, block) -> None:
        """One demuxed fleet superblock → one five-phase breakdown row
        on the trace plane (offer-posted → claimed → score-started →
        result-posted → demuxed).  Worker-stamped times are mapped onto
        this clock through the estimated offset; worker-to-worker
        deltas need no mapping (the offset cancels).  Every delta is
        clamped finite and non-negative, and ``total`` is the SUM of
        the four intervals — totals==sums holds by construction."""
        marks = self._phase_marks.pop(bid, None)
        if marks is None:
            return
        wid = str(post.get("wid") or marks.get("wid") or "")
        t_demux = float(self.clock.now())
        off = self.offsets.offset(wid)

        def to_local(t_worker, fallback):
            mapped = (
                self.offsets.to_coordinator(wid, t_worker)
                if t_worker is not None
                else None
            )
            return mapped if mapped is not None else fallback

        t_offer = float(marks["t_offer"])
        t_claim = to_local(
            marks.get("t_claim_w"), marks.get("t_claim_seen", t_offer)
        )
        t_score = to_local(post.get("t_score"), t_claim)
        t_post = to_local(post.get("t_post"), t_score)
        phases = {
            "offer_to_claim": max(0.0, _finite(t_claim - t_offer)),
            "claim_to_score": max(0.0, _finite(t_score - t_claim)),
            "score_to_post": max(0.0, _finite(t_post - t_score)),
            "post_to_demux": max(0.0, _finite(t_demux - t_post)),
        }
        phases = {k: round(v, 9) for k, v in phases.items()}
        phases["total"] = round(sum(phases.values()), 9)
        trace_board_phase({
            "bid": bid,
            "worker": wid,
            "epoch": int(marks.get("epoch", 0)),
            "traces": _block_traces(block),
            "request_ids": _block_links(block),
            "clock_offset_s": round(off, 9) if off is not None else None,
            "phases": phases,
        })

    def _gather_obs(self) -> None:
        """Fold live workers' posted observability snapshots into the
        local planes: metrics into the registry's fleet section (the
        federated ``/metrics`` families), trace events into offset-
        aligned per-worker Perfetto tracks.  Best-effort per worker —
        a missing, torn, or alien snapshot contributes nothing."""
        reg = active_metrics()
        tracer = active_trace()
        if reg is None and tracer is None:
            return
        for wid, view in list(self.membership.workers.items()):
            if not view.alive:
                continue
            snap = collect_worker_snapshot(self.board, wid)
            if snap is None:
                continue
            if reg is not None and isinstance(snap.get("metrics"), dict):
                reg.record_fleet(wid, snap["metrics"])
            if tracer is not None:
                self._merge_track(tracer, wid, snap)

    def _merge_track(self, tracer, wid: str, snap: dict) -> None:
        """Install one worker's trace events as a per-worker track,
        shifted onto this tracer's timeline: worker trace-clock →
        worker board-clock (the snapshot's back-to-back bridge pair) →
        coordinator board-clock (the offer/claim offset estimate) →
        coordinator trace-clock (a local bridge pair, sampled here).
        Without an offset estimate the track is skipped — alignment is
        deterministic or absent, never guessed."""
        trace = snap.get("trace")
        if not isinstance(trace, dict):
            return
        events = trace.get("events")
        if not isinstance(events, list) or not events:
            return
        off = self.offsets.offset(wid)
        if off is None:
            return
        try:
            t_board_w = float(snap["t_board"])
            t_trace_us_w = float(snap["t_trace_us"])
        except (KeyError, TypeError, ValueError):
            return
        shift_us = (
            (t_board_w * 1e6 - t_trace_us_w)
            - off * 1e6
            + (tracer.now_us() - self.clock.now() * 1e6)
        )
        tracer.set_worker_track(wid, events, shift_us)

    def _collect_tape(self, wid: str) -> None:
        """Post-mortem: pull the flight-recorder tape out of a dead
        worker's LAST posted snapshot and dump it locally — the tape a
        SIGKILLed worker could never write itself.  Once per worker;
        the snapshot key itself is swept by GC after the grace window."""
        if wid in self._tapes_collected:
            return
        self._tapes_collected.add(wid)
        snap = collect_worker_snapshot(self.board, wid)
        tape = snap.get("tape") if isinstance(snap, dict) else None
        if not tape:
            return
        path = dump_fleet_tape(wid, tape, "worker-dead")
        if path is not None:
            publish(
                "fleet.tape.collected",
                worker=wid,
                events=len(tape),
                path=path,
            )

    # -- re-dispatch + local fallback --------------------------------------

    def _redispatch(self, bid: str, reason: str) -> None:
        epoch = self.leases.bump(bid, self._tick)
        # The fencing epoch IS the attempt counter: epoch N means N
        # offers already failed.  Past the cap, the block takes the
        # typed dead-letter path — scored locally through the serve
        # loop's quarantine ladder (retry → degrade → poison bisection),
        # so a block no worker can ever finish still gets each of its
        # requests a terminal answer instead of re-offering forever.
        if epoch > self.max_redispatch:
            publish(
                "fleet.deadletter", block=bid, epoch=epoch, reason=reason
            )
            log_line(
                f"mpi_openmp_cuda_tpu_torch: fleet: {bid} exhausted "
                f"{self.max_redispatch} re-dispatch attempts "
                f"(last: {reason}); dead-lettering to the local "
                "quarantine ladder"
            )
            self._finish_local(bid)
            return
        publish("fleet.redispatch", block=bid, epoch=epoch, reason=reason)
        if self.membership.live_count() > 0:
            try:
                self._post_offer(bid, epoch, self.blocks[bid])
            except OSError:
                # Unpostable board (ENOSPC): the lease stays bumped, so
                # the next expiry retries the post — and the attempt cap
                # above still bounds the loop.
                log_line(
                    f"mpi_openmp_cuda_tpu_torch: fleet: re-offer of {bid} "
                    "failed to post; will retry at next lease expiry"
                )
            return
        log_line(
            f"mpi_openmp_cuda_tpu_torch: fleet: no live workers for {bid}; "
            "scoring locally on the coordinator"
        )
        self._finish_local(bid)

    def _finish_local(self, bid: str) -> None:
        """Score one outstanding block on the coordinator through the
        serve loop's sync path (retry → degrade → bisection — the full
        quarantine ladder).  The lease was already bumped, so any
        straggler's later post lands fenced."""
        block = self.blocks.pop(bid)
        self._phase_marks.pop(bid, None)  # local scoring has no phases
        lease = self.leases.get(bid)
        self._retired.append((bid, lease.epoch))
        self.leases.retire(bid)
        self.board.delete(offer_key(bid))
        self._local_score(block)

    def finish_locally(self) -> None:
        """Drain: fence (epoch bump) and locally score every outstanding
        superblock, so in-flight requests finish before the drain
        journal is written and no worker post can land after resume."""
        for bid in list(self.blocks):
            self.leases.bump(bid, self._tick)
            self._finish_local(bid)

    # -- failover: checkpoint + board GC -----------------------------------

    def checkpoint(self, raws, answered) -> None:
        """Post the takeover replay state: every admitted-but-unanswered
        request (raw dicts, replayable through ``ingest``) plus the
        answered reply ids (the successor's idempotency set).  Change-
        cached — a quiet tick costs no board write — and best-effort on
        a sick board: the ``--journal`` file stays authoritative for
        same-process resume; this board copy is the one a STANDBY can
        reach."""
        if self.leader is None:
            return
        blob = json.dumps({
            "gen": self.gen,
            "requests": list(raws),
            "answered": list(answered),
        })
        if blob == self._ckpt_blob:
            return
        try:
            self.board.post(ckpt_key(self.gen), blob)
            self._ckpt_blob = blob
        except OSError:
            pass

    @staticmethod
    def _bid_gen(bid: str) -> int:
        """The leader generation stamped into a block id
        (``g<gen>b<seq>``); ids without a stamp read as generation 0."""
        m = re.match(r"^g(\d+)b", bid)
        return int(m.group(1)) if m else 0

    def _gc_verdict(self, rel: str) -> str:
        """Classify one board key (relative to the fleet root):
        ``keep``, ``sweep`` (delete past the grace window), or ``fence``
        (sweep + count once as a dead generation's fenced post)."""
        parts = rel.split("/")
        kind = parts[0]
        if kind in ("worker", "hb"):
            view = self.membership.workers.get(parts[-1])
            if view is not None and not view.alive:
                return "sweep"  # a dead worker's registration/beat
            return "keep"  # live, or not yet observed (still joining)
        if kind == "obssnap":
            view = self.membership.workers.get(parts[-1])
            if view is not None and not view.alive:
                # Swept only past the grace window (gc_ticks), which is
                # after the death-tick tape collection by construction.
                return "sweep"
            return "keep"  # a live worker's snapshot, overwritten in place
        if kind in ("leader", "leaderhb", "ckpt"):
            gen = _gen_of(parts[-1])
            if gen is not None and gen < self.gen:
                return "sweep"  # a retired generation's record
            return "keep"
        if kind in ("offer", "claim", "result"):
            bid = parts[1] if len(parts) > 1 else ""
            gen = self._bid_gen(bid)
            if gen > self.gen:
                return "keep"  # a successor's namespace: never touch
            if gen < self.gen:
                return "fence"  # dead leader's debris: count, then sweep
            if bid in self.blocks:
                if kind == "offer":
                    return "keep"
                epoch = _epoch_of(parts[-1])
                if epoch is not None and self.leases.admits(bid, epoch):
                    return "keep"  # the live lease's claim/result keys
                return "sweep"  # a fenced previous epoch's debris
            return "sweep"  # retired bid: whatever it left is debris
        return "keep"  # shutdown key, unknown shapes: not GC's business

    def _gc(self, tick: int) -> None:
        """Epoch-aware board GC, one pass per pump tick.  A key first
        classified sweepable at tick T is deleted at T + ``gc_ticks``
        (default two lease windows) — late enough that ``_fence_stale``
        has counted any zombie post and a mid-join worker is not
        confused, early enough that the board stays bounded across
        leader generations."""
        swept = 0
        for key in self.board.keys(FLEET_PREFIX):
            verdict = self._gc_verdict(key[len(FLEET_PREFIX):])
            if verdict == "keep":
                self._gc_marks.pop(key, None)
                continue
            if verdict == "fence" and key not in self._gc_fenced:
                self._gc_fenced.add(key)
                publish("leader.fenced", key=key, gen=self.gen)
                log_line(
                    "mpi_openmp_cuda_tpu_torch: fleet: fenced dead-generation "
                    f"post {key} (current gen {self.gen})"
                )
            mark = self._gc_marks.setdefault(key, tick)
            if tick - mark >= self.gc_ticks:
                self.board.delete(key)
                self._gc_marks.pop(key, None)
                swept += 1
        if swept:
            publish("board.gc", count=swept, gen=self.gen)

    def gc_final(self) -> None:
        """Clean-completion sweep (no grace): everything this run could
        have left on the board EXCEPT the worker registry (workers are
        still alive until the shutdown key lands), the shutdown key,
        and the surviving generations' leader claim + beat — the
        board's monotonic generation record.  This is what makes
        ``make fleet-chaos``'s no-stale-keys gate hold without keeping
        the loop alive for a grace window.

        A zombie's stale post can land in the window between its
        block's retirement and this sweep; probe the retired set one
        last time so such a post is fence-COUNTED before it is
        deleted, never silently swallowed."""
        self._probe_retired()
        swept = 0
        for key in self.board.keys(FLEET_PREFIX):
            parts = key[len(FLEET_PREFIX):].split("/")
            if parts[0] in ("worker", "hb", "shutdown"):
                continue
            if parts[0] in ("leader", "leaderhb"):
                gen = _gen_of(parts[-1])
                if gen is None or gen >= self.gen:
                    continue
            self.board.delete(key)
            swept += 1
        sweep = getattr(self.board, "sweep_orphans", None)
        if sweep is not None:
            swept += int(sweep() or 0)
        if swept:
            publish("board.gc", count=swept, gen=self.gen, final=True)

    def shutdown(self) -> None:
        """End of run: tell workers to exit.  Best-effort — a worker
        that never sees the key still exits on its own drain signal.
        A DEPOSED leader must not post it: the fleet belongs to the
        successor now, and this key would kill ITS workers."""
        if self._deposed:
            return
        try:
            self.board.post(shutdown_key(), "shutdown")
        except OSError:
            pass


def standby_wait(board, leader, clock, poll_s=_POLL_S):
    """The ``--fleet-standby`` watch loop: poll the newest leader
    generation's beat under the membership staleness rule until one of

    * ``("takeover", gen)`` — the watched leader went silent for a full
      deadline and THIS standby won the claim on generation ``gen + 1``
      (``leader`` now holds it; the caller replays gen ``gen``'s
      checkpoint and starts serving);
    * ``("shutdown", None)`` — the fleet completed cleanly (the leader
      posted the shutdown key): exit 0, nothing to take over;
    * ``("drain", None)`` — this standby itself was drain-signalled.

    Losing the takeover race is not an exit: a rival standby won, and
    the watch simply restarts against the new leader's beat.
    """
    tick = 0
    while True:
        if drain_requested():
            return ("drain", None)
        if board.get(shutdown_key()) is not None:
            return ("shutdown", None)
        tick += 1
        if leader.observe(tick):
            watched = leader.watched_gen()
            if leader.try_acquire(watched + 1):
                return ("takeover", watched)
        _pause(clock, poll_s, drain_requested)


class FleetWorker:
    """One scoring worker's loop state (single-threaded, no locks).

    register → heartbeat → scan offers → claim → score → post, forever;
    exits when the coordinator posts the shutdown key or this process
    is drain-signalled.  A superblock whose scoring fails past the
    whole retry/degrade ladder is simply never posted — the
    coordinator's lease expiry re-dispatches it, which is the fleet's
    failure model for sick workers too.
    """

    def __init__(self, board, pipeline, policy, clock=None):
        self.board = board
        self.pipeline = pipeline
        self.policy = policy
        self.clock = clock or ServeClock()
        self.wid = f"w{os.getpid()}"
        self.poll_s = env_float("SEQALIGN_WORKER_HEARTBEAT_S", 0.02)
        self._beat = 0
        self._done: set[tuple[str, int]] = set()
        self._zombie = False  # chaos: freeze heartbeats, earn the verdict
        self._zombie_done = False
        # Observability-snapshot cadence, expressed in heartbeats so the
        # snapshot rides the existing pulse thread (one board write per
        # cadence, overwriting in place — the board holds one snapshot).
        snap_s = env_float("SEQALIGN_FLEET_OBSSNAP_S", 0.25)
        self._snap_beats = max(1, round(snap_s / self.poll_s))

    def register(self) -> None:
        self.board.post(
            worker_key(self.wid),
            json.dumps({"wid": self.wid, "pid": os.getpid()}),
        )
        log_line(
            f"mpi_openmp_cuda_tpu_torch: fleet: worker {self.wid} registered"
        )

    def heartbeat(self) -> None:
        self._beat += 1
        try:
            self.board.post(heartbeat_key(self.wid), str(self._beat))
        except OSError:
            # A board that cannot take the beat (ENOSPC) earns this
            # worker the same death verdict a crash would — the correct
            # outcome, reached without killing the heartbeat thread.
            pass

    def post_obs_snapshot(self) -> None:
        """Post this worker's bounded observability snapshot (metrics +
        recent trace events + the flight-recorder tape) next to its
        heartbeat.  Best-effort, same stance as the beat: a board that
        cannot take the write costs granularity, never the worker.  The
        RuntimeError arm covers snapshotting the registry while the
        scoring thread mutates it (the telemetry module's documented
        lock-free-copy hazard) — the next cadence simply retries."""
        try:
            post_worker_snapshot(
                self.board, self.wid, float(self.clock.now()),
                beat=self._beat,
            )
        except (OSError, RuntimeError):
            pass

    def should_exit(self) -> bool:
        return (
            drain_requested()
            or self.board.get(shutdown_key()) is not None
        )

    def _heartbeat_loop(self, stop) -> None:
        """Daemon-thread heartbeat: liveness must not depend on scoring
        progress — a worker busy compiling its first superblock is
        alive; only a killed (thread dies with the process) or zombie
        (``_zombie`` frozen deliberately) worker goes silent."""
        while not stop.is_set():
            if not self._zombie:
                self.heartbeat()
                if self._beat % self._snap_beats == 0:
                    self.post_obs_snapshot()
            _pause(self.clock, self.poll_s, stop.is_set)

    def run(self) -> int:
        self.register()
        stop = threading.Event()
        pulse = threading.Thread(
            target=self._heartbeat_loop, args=(stop,), daemon=True
        )
        pulse.start()
        try:
            while True:
                if self.should_exit() or self._zombie_done:
                    log_line(
                        "mpi_openmp_cuda_tpu_torch: fleet: worker "
                        f"{self.wid} exiting"
                    )
                    return 0
                if not self.step():
                    _pause(self.clock, self.poll_s, drain_requested)
        finally:
            stop.set()
            # The leader's clean-completion sweep (gc_final) runs BEFORE
            # the shutdown key lands, so a heartbeat-cadence snapshot
            # posted in that window would outlive the run and trip the
            # no-stale-keys gate — the worker retires its own snapshot
            # once the pulse thread has stopped posting.
            pulse.join(timeout=2 * self.poll_s + 1.0)
            try:
                self.board.delete(obs_snapshot_key(self.wid))
            except OSError:
                pass  # advisory: a vanished board costs hygiene, not the run

    def step(self) -> bool:
        """Scan the offer board once; claim and score anything new.
        Returns True if any work was attempted (the run loop only
        pauses on an empty scan)."""
        worked = False
        for key in self.board.keys(OFFER_PREFIX):
            offer = board_read_json(self.board, key)
            if offer is None:
                continue  # torn offer reads as missing
            bid = str(offer.get("bid", ""))
            epoch = offer.get("epoch")
            if not bid or not isinstance(epoch, int):
                continue
            if (bid, epoch) in self._done:
                continue
            if self.board.get(result_key(bid, epoch)) is not None:
                self._done.add((bid, epoch))
                continue
            if self.board.get(claim_key(bid, epoch)) is not None:
                continue  # someone else holds this epoch
            if not self.board.claim(
                claim_key(bid, epoch),
                # t_claim echoes the offer on THIS worker's clock — the
                # second half of the estimator's offer/claim pair.
                json.dumps({
                    "wid": self.wid,
                    "epoch": epoch,
                    "t_claim": float(self.clock.now()),
                }),
            ):
                continue  # lost the race: exactly one winner per epoch
            self._done.add((bid, epoch))
            worked = True
            self._score_claim(offer, bid, epoch)
        return worked

    def _score_claim(self, offer: dict, bid: str, epoch: int) -> None:
        if _fault_scheduled("lease:stall"):
            # Chaos: hold the claim and never score — the coordinator's
            # lease expiry must fence this epoch and re-dispatch.
            log_line(
                f"mpi_openmp_cuda_tpu_torch: fleet: worker {self.wid} stalling "
                f"its lease on {bid} (chaos)"
            )
            return
        # kill:fleet-worker rides this fire point: SIGKILL mid-superblock,
        # after the claim and before any result lands.
        _fault_fire("fleet_score")
        zombie = _fault_scheduled("zombie:fleet-worker")
        t_score = float(self.clock.now())
        publish(
            "fleet.score.start", block=bid, epoch=epoch, worker=self.wid
        )
        try:
            rows = self._score_offer(offer, epoch)
        except Exception as e:
            # advisory: the claim stays leased and lease expiry
            # re-dispatches the superblock (logged and counted below).
            # The claim stays leased: lease expiry re-dispatches the
            # superblock, and a worker must not die on one bad block.  A
            # kernel that fails to build or launch lands here too (on a
            # card the wrapper launches or raises; without --degrade
            # nothing rescores the block elsewhere in this process): it
            # shows on stderr and as the report's fleet_score_failures.
            publish(
                "fleet.score.failed", block=bid, epoch=epoch,
                worker=self.wid, error=str(e),
            )
            log_line(
                f"mpi_openmp_cuda_tpu_torch: fleet: worker {self.wid}: "
                f"superblock {bid} failed ({e}); leaving it to lease "
                "re-dispatch"
            )
            return
        if zombie:
            self._zombie = True  # heartbeats freeze: earn the death verdict
            self._outlive_lease(bid, epoch)
        payload = json.dumps({
            "bid": bid,
            "epoch": int(epoch),
            "wid": self.wid,
            "rows": rows.tolist(),
            # The result is the work unit coming BACK over the board:
            # echo the propagated trace ids and stamp the
            # score/post times for the coordinator's phase breakdown.
            "traces": _offer_traces(offer),
            "t_score": t_score,
            "t_post": float(self.clock.now()),
        })
        if _fault_scheduled("board:torn-post"):
            # Chaos: a writer dying mid-post on a non-atomic board —
            # half the bytes land.  Every reader must treat this as
            # MISSING; the lease expires and the block re-dispatches.
            self.board.post(result_key(bid, epoch), payload[: len(payload) // 2])
            return
        try:
            self.board.post(result_key(bid, epoch), payload)
        except OSError as e:
            # Disk-full mid-post: the key reads as missing (the atomic
            # post never completed), so the lease expiry re-dispatches —
            # the same recovery as a worker death, minus the death.
            log_line(
                f"mpi_openmp_cuda_tpu_torch: fleet: worker {self.wid}: result "
                f"post for {bid} failed ({e}); leaving it to lease "
                "re-dispatch"
            )
            return
        if zombie:
            # The stale post landed (it MUST read as fenced); a declared-
            # dead worker has no further business claiming fresh work.
            self._zombie_done = True

    def _score_offer(self, offer: dict, epoch: int = 0):
        # Host arrays: every (re)dispatch of the pipeline copies them to
        # the device afresh, so a retried attempt never reuses a buffer.
        seq1 = np.asarray(offer["seq1"], dtype=np.int8)
        codes = [np.asarray(r, dtype=np.int8) for r in offer["rows"]]
        weights = [int(w) for w in offer["weights"]]
        budget = self.policy.new_budget()
        # The propagated context: worker-side spans and launch rows are
        # stamped with the ORIGINATING request trace ids plus this
        # worker's identity and lease epoch, so the coordinator's merged
        # timeline links its admission spans to the remote launches.
        links = [str(r) for r in (offer.get("links") or ())]
        ctx = {
            "traces": _offer_traces(offer),
            "worker": self.wid,
            "epoch": int(epoch),
        }
        with span("score.fleet.superblock"):
            promise = self.pipeline.dispatch(
                seq1, codes, weights, budget, links=links, trace_ctx=ctx
            )
            return np.asarray(
                self.pipeline.materialise(
                    promise, seq1, codes, weights, budget
                ),
                dtype=np.int64,
            )

    def _outlive_lease(self, bid: str, epoch: int) -> None:
        """Chaos zombie: sit on the scored result (heartbeats stopped —
        the frozen beat is what earns the death verdict) until the
        coordinator has moved past this epoch, then let the caller post
        it anyway.  The post MUST land fenced, never demuxed."""
        log_line(
            f"mpi_openmp_cuda_tpu_torch: fleet: worker {self.wid} going zombie "
            f"on {bid} epoch {epoch} (chaos)"
        )
        while not self.should_exit():
            offer = board_read_json(self.board, offer_key(bid))
            if offer is None or offer.get("epoch") != epoch:
                return  # fenced (re-offered or finished): post stale now
            _pause(self.clock, self.poll_s, drain_requested)


def run_fleet_worker(args, timer, policy, deg) -> int:
    """CLI entry for ``--fleet-worker`` (``io.cli.run``; the obs plane,
    faults and the drain guard are already armed there, and the kernels
    built and loaded before this worker registers, so its first claim pays
    no build inside a lease)."""
    from ..io.pipeline import ChunkPipeline
    from ..resilience.rescue import FileBoard

    worker = FleetWorker(
        FileBoard(args.fleet_board),
        ChunkPipeline(policy, deg),
        policy,
    )
    with timer.phase("serve"):
        rc = worker.run()
    timer.report()
    return rc
