"""Small-scope interleaving explorer (``interleave``) — pillar four of
the analysis plane.

The fleet protocol's safety net was *tested* by
chaos tiers that sample a handful of schedules.  This module makes the
matrix machine-checked: it runs the **real** protocol state machines —
:class:`~..resilience.membership.Membership`,
:class:`~..resilience.membership.LeaseTable` (``admits`` is the one
acceptance predicate), :class:`~..serve.fleet.FleetCoordinator` over a
real :class:`~..resilience.rescue.MemoryBoard`, and the real
:class:`~..serve.queue.RequestQueue` — under a virtual scheduler that
**exhaustively enumerates every interleaving of protocol events up to a
depth bound**, sleep-set pruned (classic DPOR: a pruned schedule is
Mazurkiewicz-equivalent to an explored one, so safety verdicts are
unaffected).

Event alphabet (the §8.6 failure matrix, one event per row):

* ``tick`` — one coordinator board poll (``FleetCoordinator.pump``):
  membership observe (join/death verdicts), stale-post fencing, result
  collection/demux, lease expiry → re-dispatch.  **Worker death** is
  heartbeat silence — exactly as in production, a SIGKILLed worker is
  indistinguishable from one the scheduler never runs again, so every
  schedule that stops beating a worker explores its death; **lease
  expiry** is ticks elapsing with a lease outstanding (the fencing
  scenario pins ``lease_ticks=1`` so expiry is reachable inside the
  depth bound).
* ``w<i>.beat`` — one heartbeat post (liveness proof).
* ``w<i>.claim`` — scan the offer, race ``board.claim`` on the
  epoch-stamped claim key (exactly-one-winner is asserted).
* ``w<i>.post`` — post the scored result under the claimed epoch.
* ``w<i>.stale`` — the adversarial zombie probe: re-post previously
  scored rows at the CURRENT offer's result key but carrying the stale
  claimed epoch in the payload — the buggy-writer shape
  ``LeaseTable.admits`` exists to fence.  A coordinator that admits
  without the epoch check demuxes it; the invariant catches that (the
  seeded-bug test in tests/test_interleave.py proves it).

The failover scenario (PR 16) extends the alphabet with the
coordinator-level failure modes: ``crash`` (the leader dies ``kill -9``
style, board debris intact), ``sb<i>.tick`` (one standby watch tick —
observe the newest generation's beat, race ``try_acquire`` on verdict,
replay the predecessor's checkpoint on a win), and leader *starvation*
(a leader the scheduler never runs again is the zombie shape — its
deposition on the next pump is explored, not assumed).  Its invariants:
exactly one leader per generation, no reply duplicated across
generations, no reply dropped.

Invariants, checked after every transition and at quiescence:

1. **each offer demuxed exactly once** — never two completions (demux
   or local fallback) for one block id;
2. **a fenced epoch's post is never admitted** — every demuxed row set
   carries exactly the newest epoch ever offered for its block;
3. **a dead worker is never resurrected** — once membership's verdict
   lands, a resumed heartbeat must not flip the worker live again;
4. **no reply is dropped** — from every reachable state, freezing the
   workers and pumping the coordinator drains every outstanding block
   (re-dispatch or local fallback) within a bounded number of ticks.

State is never copied: the explorer replays each event prefix from a
fresh scenario (stateless-replay DFS), so the real classes run with
their real mutation paths and no deepcopy aliasing.  Everything is
deterministic — virtual clock, fixed event order, no randomness — so
the explored-schedule counts are pinned byte-exact in the committed
``concurrency-audit`` golden.
"""

from __future__ import annotations

import contextlib
import io
import json

from ..resilience.membership import (
    OFFER_PREFIX,
    LeaderLease,
    board_read_json,
    claim_key,
    heartbeat_key,
    offer_key,
    read_checkpoint,
    result_key,
    worker_key,
)
from ..resilience.rescue import MemoryBoard
from ..serve.fleet import FleetCoordinator, LeadershipLostError
from ..serve.queue import ADMIT_CLOSED, ADMIT_OK, RequestQueue
from . import InterleaveViolation

#: Quiescence bound: ticks allowed to drain all outstanding blocks once
#: workers freeze.  Death verdicts take ``deadline_ticks`` and expiry
#: ``lease_ticks`` — far below this; hitting the bound IS the
#: dropped-reply violation.
_QUIESCE_TICKS = 50


class VirtualClock:
    """The explorer's ServeClock stand-in: ``now()`` jumps a full poll
    interval per read (every ``pump`` polls — one pump == one tick) and
    ``block_until`` evaluates its predicate exactly once, immediately
    (single-threaded exploration never actually waits)."""

    def __init__(self):
        self._t = 0.0

    def now(self) -> float:
        self._t += 10.0
        return self._t

    def block_until(self, cond, predicate, timeout_s) -> bool:
        return bool(predicate())


class _Recorder:
    """Coordinator callbacks: where demuxed / locally-scored blocks
    land, in completion order."""

    def __init__(self):
        self.demuxed = []  # (block label, rows) in demux order
        self.local = []  # block labels completed via local fallback

    def demux(self, rows, block):
        self.demuxed.append((block.label, rows))

    def local_score(self, block):
        self.local.append(block.label)


class _ModelBlock:
    """The minimal superblock the coordinator's offer path can post:
    one row, so worker results are shape ``(1, 3)`` int64 and carry
    ``(worker idx, epoch, 0)`` as verifiable provenance."""

    def __init__(self):
        self.label = "?"
        self.weights = [1]
        self.seq1_codes = [1]
        self.codes = [[1]]


class _ModelWorker:
    """One worker's local state.  The board verbs and the key schema
    are the REAL ones (resilience/membership.py) — only the scoring is
    modelled (provenance rows instead of an alignment)."""

    def __init__(self, idx: int):
        self.idx = idx
        self.wid = f"mw{idx}"
        self.beats = 0
        self.claimed: dict[str, int] = {}  # bid -> claimed epoch


class _FleetState:
    """One replay's world: the real board/coordinator plus the
    invariant-checking ledgers."""

    def __init__(self):
        self.board = None
        self.coord = None
        self.workers = []
        self.recorder = None
        self.bids = []
        self.ledger = {}  # bid -> newest epoch ever offered
        self.seen_dead = set()
        self.winners = {}  # (bid, epoch) -> wid
        self.checked = 0  # demux records already invariant-checked


class FleetScenario:
    """The lease/epoch protocol under exploration."""

    def __init__(self, name: str, *, workers: int = 2, stale: bool = False,
                 lease_ticks: int | None = None,
                 seed_admit_bug: bool = False):
        self.name = name
        self.n_workers = int(workers)
        self.stale = bool(stale)
        self.lease_ticks = lease_ticks
        self.seed_admit_bug = bool(seed_admit_bug)
        self.invariants = (
            "demux-exactly-once",
            "fenced-epoch-never-admitted",
            "dead-worker-never-resurrected",
            "no-reply-dropped",
        )

    # -- world construction ------------------------------------------------

    def fresh(self) -> _FleetState:
        state = _FleetState()
        state.board = MemoryBoard()
        state.recorder = _Recorder()
        coord = FleetCoordinator(
            state.board,
            local_score=state.recorder.local_score,
            demux=state.recorder.demux,
            clock=VirtualClock(),
            lease_s=2.0,
            poll_s=1.0,  # lease_ticks = deadline_ticks = 2
        )
        if self.lease_ticks is not None:
            coord.leases.lease_ticks = int(self.lease_ticks)
        state.coord = coord
        state.workers = [_ModelWorker(i) for i in range(self.n_workers)]
        for w in state.workers:
            state.board.post(worker_key(w.wid), json.dumps({"wid": w.wid}))
            w.beats = 1
            state.board.post(heartbeat_key(w.wid), str(w.beats))
        coord.pump(idle=True)  # tick 1: every worker joins
        block = _ModelBlock()
        bid = coord.offer(block)
        block.label = bid
        state.bids = [bid]
        state.ledger = {bid: 0}
        if self.seed_admit_bug:
            # The seeded fencing bug the acceptance criteria demand: an
            # admit that ignores the epoch.  Instance-attribute override
            # of the REAL predicate — everything else runs unmodified.
            leases = coord.leases
            coord.leases.admits = (
                lambda bid, epoch, _t=leases: bid in _t._leases
            )
        return state

    # -- the event alphabet ------------------------------------------------

    def enabled(self, state: _FleetState):
        evs = ["tick"]
        board = state.board
        for w in state.workers:
            evs.append(f"w{w.idx}.beat")
            for bid in state.bids:
                offer = board_read_json(board, offer_key(bid))
                epoch = offer.get("epoch") if offer else None
                if (
                    offer is not None
                    and isinstance(epoch, int)
                    and w.claimed.get(bid) != epoch
                    and board.get(claim_key(bid, epoch)) is None
                    and board.get(result_key(bid, epoch)) is None
                ):
                    evs.append(f"w{w.idx}.claim")
                if bid in w.claimed and board.get(
                    result_key(bid, w.claimed[bid])
                ) is None:
                    evs.append(f"w{w.idx}.post")
                if (
                    self.stale
                    and bid in w.claimed
                    and offer is not None
                    and isinstance(epoch, int)
                    and epoch > w.claimed[bid]
                    and board.get(result_key(bid, epoch)) is None
                ):
                    evs.append(f"w{w.idx}.stale")
        return evs

    def execute(self, state: _FleetState, ev: str) -> None:
        if ev == "tick":
            state.coord.pump(idle=True)
            return
        widx, verb = ev.split(".", 1)
        w = state.workers[int(widx[1:])]
        board = state.board
        bid = state.bids[0]
        if verb == "beat":
            w.beats += 1
            board.post(heartbeat_key(w.wid), str(w.beats))
        elif verb == "claim":
            offer = board_read_json(board, offer_key(bid))
            epoch = int(offer["epoch"])
            if board.claim(
                claim_key(bid, epoch),
                json.dumps({"wid": w.wid, "epoch": epoch}),
            ):
                if (bid, epoch) in state.winners:
                    raise InterleaveViolation(
                        f"two claim winners for {bid} epoch {epoch}: "
                        f"{state.winners[(bid, epoch)]} and {w.wid}"
                    )
                state.winners[(bid, epoch)] = w.wid
                w.claimed[bid] = epoch
        elif verb == "post":
            epoch = w.claimed[bid]
            board.post(
                result_key(bid, epoch),
                json.dumps({
                    "bid": bid, "epoch": epoch, "wid": w.wid,
                    "rows": [[w.idx, epoch, 0]],
                }),
            )
        elif verb == "stale":
            # Re-post the rows scored under the OLD claimed epoch at the
            # CURRENT offer's result key: key recomputed, payload stale.
            offer = board_read_json(board, offer_key(bid))
            cur = int(offer["epoch"])
            old = w.claimed[bid]
            board.post(
                result_key(bid, cur),
                json.dumps({
                    "bid": bid, "epoch": old, "wid": w.wid,
                    "rows": [[w.idx, old, 0]],
                }),
            )
        else:
            raise InterleaveViolation(f"unknown event {ev!r} (model bug)")

    # -- invariants --------------------------------------------------------

    def check(self, state: _FleetState, schedule) -> None:
        rec = state.recorder
        for label, rows in rec.demuxed[state.checked:]:
            epoch = int(rows[0][1])
            if epoch != state.ledger[label]:
                raise InterleaveViolation(
                    f"fenced-epoch post ADMITTED: block {label} demuxed "
                    f"rows carrying epoch {epoch}, newest offered epoch "
                    f"is {state.ledger[label]} — LeaseTable.admits must "
                    f"fence it; schedule={list(schedule)}"
                )
        state.checked = len(rec.demuxed)
        done: dict[str, int] = {}
        for label, _rows in rec.demuxed:
            done[label] = done.get(label, 0) + 1
        for label in rec.local:
            done[label] = done.get(label, 0) + 1
        for label, n in done.items():
            if n > 1:
                raise InterleaveViolation(
                    f"block {label} completed {n} times (demux/local) — "
                    f"exactly-once broken; schedule={list(schedule)}"
                )
        for wid, view in state.coord.membership.workers.items():
            if not view.alive:
                state.seen_dead.add(wid)
            elif wid in state.seen_dead:
                raise InterleaveViolation(
                    f"dead worker {wid} RESURRECTED after its death "
                    f"verdict; schedule={list(schedule)}"
                )
        for bid in state.bids:
            offer = board_read_json(state.board, offer_key(bid))
            if offer is not None and isinstance(offer.get("epoch"), int):
                state.ledger[bid] = max(state.ledger[bid], offer["epoch"])

    def finish(self, state: _FleetState, schedule) -> None:
        """Leaf closure: freeze the workers, pump until every block
        drains (death verdicts → re-dispatch → local fallback), then
        require exactly one completion per block."""
        ticks = 0
        while state.coord.blocks and ticks < _QUIESCE_TICKS:
            self.execute(state, "tick")
            self.check(state, schedule)
            ticks += 1
        if state.coord.blocks:
            raise InterleaveViolation(
                f"reply DROPPED: blocks {sorted(state.coord.blocks)} "
                f"still outstanding after {_QUIESCE_TICKS} quiescence "
                f"ticks; schedule={list(schedule)}"
            )
        done: dict[str, int] = {}
        for label, _rows in state.recorder.demuxed:
            done[label] = done.get(label, 0) + 1
        for label in state.recorder.local:
            done[label] = done.get(label, 0) + 1
        for bid in state.bids:
            if done.get(bid, 0) != 1:
                raise InterleaveViolation(
                    f"block {bid} completed {done.get(bid, 0)} times at "
                    f"quiescence (want exactly 1); "
                    f"schedule={list(schedule)}"
                )

    # -- independence (sleep-set pruning) ----------------------------------

    def _actor(self, ev: str) -> str:
        return "coord" if ev == "tick" else ev.split(".", 1)[0]

    def _footprint(self, ev: str):
        if ev == "tick":
            return {"*"}
        _w, verb = ev.split(".", 1)
        if verb == "beat":
            return {f"hb/{_w}"}
        return {"blk"}  # claim/post/stale all race on the block's keys

    def independent(self, a: str, b: str) -> bool:
        if self._actor(a) == self._actor(b):
            return False
        fa, fb = self._footprint(a), self._footprint(b)
        if "*" in fa or "*" in fb:
            return False
        return not (fa & fb)


class _FailoverState:
    """One failover replay's world: the board, every coordinator that
    has ever led (the original plus each takeover's successor), the
    standby leases, and the invariant ledgers."""

    def __init__(self):
        self.board = None
        self.coords = []  # [{coord, rec, lease, gen, halted, answered}]
        self.standbys = []  # [{lease, ticks, taken (coord entry | None)}]
        self.workers = []
        self.crashed = False  # the original leader was killed
        self.gen_winners = {}  # gen -> winning lid (single-leader ledger)
        self.seen_done = {}  # request id -> completion count, cumulative


class FleetFailoverScenario:
    """Coordinator failover (PR 16) under exploration: the REAL
    :class:`~..resilience.membership.LeaderLease`,
    checkpoint/:func:`~..resilience.membership.read_checkpoint` replay,
    and generation fencing, with a leader ``crash`` event in the
    alphabet and TWO standbys racing ``try_acquire`` so the
    single-leader invariant is a genuine race, not a tautology.

    One request (id ``r1``) flows through: the original leader offers
    its superblock and checkpoints (the post-ingest checkpoint the serve
    loop writes before its first tick); any schedule may then kill the
    leader, starve it (the zombie shape — a leader the scheduler never
    runs again is indistinguishable from a hung one), or let it finish.
    A standby whose watch verdict lands claims the next generation,
    replays the predecessor's checkpoint (skipping answered ids), and
    re-offers.  Block labels are REQUEST ids, not bids, so completions
    aggregate across generations — the duplicate check spans every
    coordinator that ever led.
    """

    #: The admitted-request journal this run would checkpoint.
    REQUESTS = ({"id": "r1"},)
    #: Standby watch deadline (ticks) — matches lease_s/poll_s below.
    DEADLINE_TICKS = 2

    def __init__(self, name: str = "fleet-failover", *, standbys: int = 2):
        self.name = name
        self.n_standbys = int(standbys)
        self.invariants = (
            "single-leader-per-generation",
            "no-reply-duplicated",
            "no-reply-dropped",
        )

    # -- world construction ------------------------------------------------

    def _new_leader(self, state: _FailoverState, lease) -> dict:
        rec = _Recorder()
        coord = FleetCoordinator(
            state.board,
            local_score=rec.local_score,
            demux=rec.demux,
            clock=VirtualClock(),
            lease_s=2.0,
            poll_s=1.0,  # lease_ticks = 2, same window as DEADLINE_TICKS
            leader=lease,
        )
        return {
            "coord": coord, "rec": rec, "lease": lease,
            "gen": lease.gen, "halted": False, "answered": set(),
        }

    def fresh(self) -> _FailoverState:
        state = _FailoverState()
        state.board = MemoryBoard()
        lease = LeaderLease(state.board, "lead", self.DEADLINE_TICKS)
        gen = lease.acquire()  # virgin board: wins generation 0
        state.gen_winners[gen] = lease.lid
        cx = self._new_leader(state, lease)
        state.coords.append(cx)
        state.workers = [_ModelWorker(0)]
        for w in state.workers:
            state.board.post(worker_key(w.wid), json.dumps({"wid": w.wid}))
            w.beats = 1
            state.board.post(heartbeat_key(w.wid), str(w.beats))
        cx["coord"].pump(idle=True)  # tick 1: the worker joins
        self._offer_requests(cx, set())
        self._ckpt(cx)  # the post-ingest checkpoint, pre first tick
        state.standbys = [
            {
                "lease": LeaderLease(
                    state.board, f"sb{i}", self.DEADLINE_TICKS
                ),
                "ticks": 0,
                "taken": None,
            }
            for i in range(self.n_standbys)
        ]
        return state

    def _offer_requests(self, cx: dict, answered: set) -> None:
        for raw in self.REQUESTS:
            if raw["id"] in answered:
                continue
            block = _ModelBlock()
            cx["coord"].offer(block)
            block.label = raw["id"]

    def _ckpt(self, cx: dict) -> None:
        unanswered = [
            dict(raw) for raw in self.REQUESTS
            if raw["id"] not in cx["answered"]
        ]
        cx["coord"].checkpoint(unanswered, sorted(cx["answered"]))

    # -- per-coordinator steps ---------------------------------------------

    def _leader_tick(self, state: _FailoverState, cx: dict) -> None:
        """One serve tick of an incumbent: pump (which self-deposes on a
        higher generation BEFORE collecting anything), fold this tick's
        completions into the answered set, checkpoint.  Pump + checkpoint
        are one event — the model's atomicity grain is the tick boundary,
        exactly the exactly-once boundary the fleet protocol documents."""
        try:
            cx["coord"].pump(idle=True)
        except LeadershipLostError:
            cx["halted"] = True
            return
        rec = cx["rec"]
        for label, _rows in rec.demuxed:
            cx["answered"].add(label)
        for label in rec.local:
            cx["answered"].add(label)
        self._ckpt(cx)

    def _sb_tick(self, state: _FailoverState, i: int, schedule) -> None:
        """One standby watch tick; after this standby has taken over, its
        ticks ARE the successor coordinator's serve ticks."""
        sb = state.standbys[i]
        if sb["taken"] is not None:
            self._leader_tick(state, sb["taken"])
            return
        sb["ticks"] += 1
        lease = sb["lease"]
        if not lease.observe(sb["ticks"]):
            return
        watched = lease.watched_gen()
        if watched is None or not lease.try_acquire(watched + 1):
            return  # a rival won this generation; the watch restarts
        gen = lease.gen
        if gen in state.gen_winners:
            raise InterleaveViolation(
                f"TWO leaders for generation {gen}: "
                f"{state.gen_winners[gen]} and {lease.lid} — the claim "
                f"primitive must admit exactly one; "
                f"schedule={list(schedule)}"
            )
        state.gen_winners[gen] = lease.lid
        cx = self._new_leader(state, lease)
        ckpt = read_checkpoint(state.board, watched)
        if ckpt is not None:
            cx["answered"] = set(ckpt["answered"])
        state.coords.append(cx)
        sb["taken"] = cx
        cx["coord"].pump(idle=True)  # tick 1: workers re-join
        self._offer_requests(cx, cx["answered"])
        self._ckpt(cx)  # re-checkpoint under the successor's generation

    def _active(self, state: _FailoverState) -> dict | None:
        live = [cx for cx in state.coords if not cx["halted"]]
        return max(live, key=lambda cx: cx["gen"]) if live else None

    def _completions(self, state: _FailoverState) -> dict:
        done: dict[str, int] = {}
        for cx in state.coords:
            for label, _rows in cx["rec"].demuxed:
                done[label] = done.get(label, 0) + 1
            for label in cx["rec"].local:
                done[label] = done.get(label, 0) + 1
        return done

    def _offers(self, board) -> list:
        out = []
        for key in sorted(board.keys(OFFER_PREFIX)):
            offer = board_read_json(board, key)
            if (
                offer is not None
                and isinstance(offer.get("bid"), str)
                and isinstance(offer.get("epoch"), int)
            ):
                out.append(offer)
        return out

    # -- the event alphabet ------------------------------------------------

    def enabled(self, state: _FailoverState):
        evs = []
        original = state.coords[0]
        if not state.crashed and not original["halted"]:
            evs.append("tick")
            evs.append("crash")
        for i, sb in enumerate(state.standbys):
            if sb["taken"] is None or not sb["taken"]["halted"]:
                evs.append(f"sb{i}.tick")
        board = state.board
        for w in state.workers:
            evs.append(f"w{w.idx}.beat")
            can_claim = can_post = False
            for offer in self._offers(board):
                bid, epoch = offer["bid"], int(offer["epoch"])
                if (
                    w.claimed.get(bid) != epoch
                    and board.get(claim_key(bid, epoch)) is None
                    and board.get(result_key(bid, epoch)) is None
                ):
                    can_claim = True
                if (
                    w.claimed.get(bid) is not None
                    and board.get(result_key(bid, w.claimed[bid])) is None
                ):
                    can_post = True
            if can_claim:
                evs.append(f"w{w.idx}.claim")
            if can_post:
                evs.append(f"w{w.idx}.post")
        return evs

    def execute(self, state: _FailoverState, ev: str, schedule=()) -> None:
        if ev == "tick":
            self._leader_tick(state, state.coords[0])
            return
        if ev == "crash":
            # kill -9: the original leader stops mid-run.  Its board
            # state (offer, claim, beat, checkpoint) stays exactly as
            # posted — that debris is what fencing and GC exist for.
            state.crashed = True
            state.coords[0]["halted"] = True
            return
        actor, verb = ev.split(".", 1)
        if actor.startswith("sb"):
            self._sb_tick(state, int(actor[2:]), schedule)
            return
        w = state.workers[int(actor[1:])]
        board = state.board
        if verb == "beat":
            w.beats += 1
            board.post(heartbeat_key(w.wid), str(w.beats))
        elif verb == "claim":
            # First eligible offer in key order — deterministic, and
            # recomputed here so enabled() and execute() agree.
            for offer in self._offers(board):
                bid, epoch = offer["bid"], int(offer["epoch"])
                if (
                    w.claimed.get(bid) != epoch
                    and board.get(claim_key(bid, epoch)) is None
                    and board.get(result_key(bid, epoch)) is None
                ):
                    if board.claim(
                        claim_key(bid, epoch),
                        json.dumps({"wid": w.wid, "epoch": epoch}),
                    ):
                        w.claimed[bid] = epoch
                    return
        elif verb == "post":
            for bid, epoch in sorted(w.claimed.items()):
                if board.get(result_key(bid, epoch)) is None:
                    board.post(
                        result_key(bid, epoch),
                        json.dumps({
                            "bid": bid, "epoch": epoch, "wid": w.wid,
                            "rows": [[w.idx, epoch, 0]],
                        }),
                    )
                    return
        else:
            raise InterleaveViolation(f"unknown event {ev!r} (model bug)")

    # -- invariants --------------------------------------------------------

    def check(self, state: _FailoverState, schedule) -> None:
        done = self._completions(state)
        for label, n in done.items():
            if n > 1:
                raise InterleaveViolation(
                    f"reply DUPLICATED: request {label} completed {n} "
                    f"times across leader generations — the answered-id "
                    f"replay filter or generation fencing is broken; "
                    f"schedule={list(schedule)}"
                )
        state.seen_done = done

    def finish(self, state: _FailoverState, schedule) -> None:
        """Leaf closure: freeze the worker, then drive whoever should be
        driving — the highest-generation live coordinator if one exists,
        else the next standby's watch — until the request completes and
        the active coordinator drains.  Hitting the bound IS the
        dropped-reply violation; a world with every coordinator halted
        and no standby left is the (worse) leaderless violation."""
        ticks = 0
        while ticks < _QUIESCE_TICKS:
            done = self._completions(state)
            active = self._active(state)
            if (
                all(done.get(raw["id"], 0) == 1 for raw in self.REQUESTS)
                and (active is None or not active["coord"].blocks)
            ):
                return
            if active is not None:
                self._leader_tick(state, active)
            else:
                idle = next(
                    (
                        i for i, sb in enumerate(state.standbys)
                        if sb["taken"] is None
                    ),
                    None,
                )
                if idle is None:
                    raise InterleaveViolation(
                        f"LEADERLESS: every coordinator halted and no "
                        f"standby remains to take over; "
                        f"schedule={list(schedule)}"
                    )
                self._sb_tick(state, idle, schedule)
            self.check(state, schedule)
            ticks += 1
        done = self._completions(state)
        raise InterleaveViolation(
            f"reply DROPPED: completions {done} after {_QUIESCE_TICKS} "
            f"quiescence ticks (want exactly one per request); "
            f"schedule={list(schedule)}"
        )

    # -- independence (sleep-set pruning) ----------------------------------

    def _actor(self, ev: str) -> str:
        if ev in ("tick", "crash"):
            return "lead"
        return ev.split(".", 1)[0]

    def _footprint(self, ev: str):
        if ev == "crash":
            # The crash flips only the original leader's halted flag —
            # it writes nothing to the board, so it commutes with every
            # event except that leader's own tick (actor rule).
            return {"lead"}
        if ev == "tick" or ev.startswith("sb"):
            return {"*"}  # board polls read everything
        _w, verb = ev.split(".", 1)
        if verb == "beat":
            return {f"hb/{_w}"}
        return {"blk"}

    def independent(self, a: str, b: str) -> bool:
        if self._actor(a) == self._actor(b):
            return False
        fa, fb = self._footprint(a), self._footprint(b)
        if "*" in fa or "*" in fb:
            return False
        return not (fa & fb)


class QueueScenario:
    """The RequestQueue under exploration: three submitting clients, the
    popping loop, drain close, and source close, interleaved every way.
    Invariants: every admitted request is delivered exactly once (pop or
    drain), rejected requests never appear, sequence ids are unique,
    depth never exceeds ``max_depth``, and a submit after ``close()``
    is always verdict ``closed``."""

    MAX_DEPTH = 2
    CLIENTS = 3

    def __init__(self, name: str = "request-queue"):
        self.name = name
        self.invariants = (
            "admitted-delivered-exactly-once",
            "rejected-never-delivered",
            "seq-unique",
            "depth-bounded",
            "closed-means-closed",
        )

    def fresh(self):
        state = {
            "queue": RequestQueue(self.MAX_DEPTH, VirtualClock()),
            "tokens": [object() for _ in range(self.CLIENTS)],
            "verdicts": {},  # client idx -> ADMIT_* verdict
            "popped": [],
            "closed": False,
            "close_src_done": False,
        }
        state["queue"].open_source()
        return state

    def enabled(self, state):
        evs = []
        for i in range(self.CLIENTS):
            if i not in state["verdicts"]:
                evs.append(f"s{i}.submit")
        evs.append("pop")
        if not state["closed"]:
            evs.append("close")
        if not state["close_src_done"]:
            evs.append("close_src")
        return evs

    def execute(self, state, ev: str) -> None:
        q = state["queue"]
        if ev == "pop":
            state["popped"].extend(q.pop_ready(0.0, 0.0))
        elif ev == "close":
            state["closed"] = True
            q.close()
        elif ev == "close_src":
            state["close_src_done"] = True
            q.close_source()
        else:
            i = int(ev.split(".", 1)[0][1:])
            was_closed = state["closed"]
            verdict = q.submit({"id": f"c{i}"}, state["tokens"][i])
            state["verdicts"][i] = verdict
            if was_closed and verdict != ADMIT_CLOSED:
                raise InterleaveViolation(
                    f"submit after close() returned {verdict!r}, want "
                    f"{ADMIT_CLOSED!r}"
                )

    def check(self, state, schedule) -> None:
        depth = state["queue"].depth()
        if depth > self.MAX_DEPTH:
            raise InterleaveViolation(
                f"queue depth {depth} exceeds max_depth "
                f"{self.MAX_DEPTH}; schedule={list(schedule)}"
            )

    def finish(self, state, schedule) -> None:
        drained = state["queue"].drain_pending()
        out = list(state["popped"]) + list(drained)
        seqs = [r.seq for r in out]
        if len(set(seqs)) != len(seqs):
            raise InterleaveViolation(
                f"duplicate sequence ids {sorted(seqs)}; "
                f"schedule={list(schedule)}"
            )
        by_token = {}
        for r in out:
            by_token[id(r.responder)] = by_token.get(id(r.responder), 0) + 1
        for i, verdict in state["verdicts"].items():
            n = by_token.get(id(state["tokens"][i]), 0)
            want = 1 if verdict == ADMIT_OK else 0
            if n != want:
                raise InterleaveViolation(
                    f"client {i} verdict {verdict!r} delivered {n} "
                    f"time(s), want {want}; schedule={list(schedule)}"
                )

    def independent(self, a: str, b: str) -> bool:
        return False  # one shared queue: every pair of events conflicts


# -- the explorer ----------------------------------------------------------


def explore(scenario, depth: int) -> dict:
    """Exhaustive sleep-set DFS over ``scenario`` to ``depth`` events.

    Stateless replay: every node rebuilds the world from scratch and
    re-executes its prefix, so the real classes mutate real state with
    no copying.  Returns the stats dict (schedules / transitions /
    pruned / violations); exploration stops at the FIRST violating
    schedule — a model checker's job is the counterexample."""
    stats = {
        "name": scenario.name,
        "depth": int(depth),
        "schedules": 0,
        "transitions": 0,
        "pruned": 0,
        "violations": [],
        "invariants": list(scenario.invariants),
    }

    def recurse(prefix, sleep):
        state = scenario.fresh()
        for ev in prefix:
            scenario.execute(state, ev)
            stats["transitions"] += 1
            scenario.check(state, prefix)
        enabled = scenario.enabled(state)
        if len(prefix) >= depth or not enabled:
            scenario.finish(state, prefix)
            stats["schedules"] += 1
            return
        explored = []
        for ev in enabled:
            if ev in sleep:
                stats["pruned"] += 1
                continue
            child_sleep = {
                s for s in (sleep | set(explored))
                if scenario.independent(s, ev)
            }
            recurse(prefix + [ev], child_sleep)
            explored.append(ev)

    try:
        # The coordinator narrates joins/deaths/redispatches on stderr
        # (obs.events.log_line); thousands of replays must not flood the
        # terminal — the bus itself stays unarmed, nothing else changes.
        with contextlib.redirect_stderr(io.StringIO()):
            recurse([], set())
    except InterleaveViolation as exc:
        stats["violations"].append(str(exc))
    return stats


#: The committed exploration matrix (golden-pinned, >1000 schedules).
#: fleet-races: two workers racing one offer — claim exclusivity,
#:   exactly-once under death/expiry re-dispatch.
#: fleet-fencing: one worker with the adversarial stale re-post enabled
#:   and lease_ticks=1, deep enough that claim → expiry → re-offer →
#:   stale post → collect all fit inside the depth bound.
#: fleet-failover: leader crash/starvation with two standbys racing the
#:   next generation — single-leader-per-generation, checkpoint-replay
#:   exactly-once, takeover within the watch deadline (PR 16).
#: request-queue: admission/pop/close/close-source interleavings.
def scenarios():
    return [
        (FleetScenario("fleet-races", workers=2), 6),
        (
            FleetScenario(
                "fleet-fencing", workers=1, stale=True, lease_ticks=1
            ),
            8,
        ),
        (FleetFailoverScenario(), 6),
        (QueueScenario(), 6),
    ]


def run_all() -> dict:
    """Explore every committed scenario; the concurrency-audit report's
    ``interleave`` section."""
    rows = [explore(scn, depth) for scn, depth in scenarios()]
    return {
        "scenarios": rows,
        "total_schedules": sum(r["schedules"] for r in rows),
        "total_transitions": sum(r["transitions"] for r in rows),
    }


def run_or_raise() -> dict:
    """Driver entry: explore, raise :class:`InterleaveViolation` on any
    violating schedule, return the report section when clean."""
    report = run_all()
    bad = [
        f"[{r['name']}] {v}"
        for r in report["scenarios"]
        for v in r["violations"]
    ]
    if bad:
        raise InterleaveViolation(
            "interleave: protocol invariant violated:\n  "
            + "\n  ".join(bad)
        )
    return report
