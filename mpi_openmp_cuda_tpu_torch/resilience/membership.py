"""Fleet membership: worker registry, heartbeats, epoch-fenced leases (a
copy of ``mpi_openmp_cuda_tpu/resilience/membership.py``, which imports
no JAX; the port keeps its own so that it imports nothing of the JAX
package).

The rescue board (:mod:`.rescue`) is the membership layer of an
*elastic* serve fleet: workers joining and leaving mid-serve.  This
module is the pure bookkeeping the fleet coordinator (serve/fleet.py)
drives once per board poll.  The board's key layout is the JAX
package's byte for byte, so processes of either package share one
board.  It owns three things:

* the **board key schema** under ``seqalign/fleet/`` — registrations,
  heartbeats, superblock offers, lease claims, epoch-stamped results;
* :class:`Membership` — who is alive, decided from heartbeat *change*
  under a tick-counted deadline;
* :class:`LeaseTable` — which worker owns which offered superblock, at
  which fencing epoch, and when a lease has expired.

Two invariants, both inherited from the rescue board's pattern:

* **Torn posts read as missing, never as data.**  Every structured
  record crossing the board goes through :func:`board_read_json`: a
  post that is absent, zero-length, unparsable (a writer killed
  mid-write on a non-atomic board, or the chaos tier's deliberately
  torn ``board:torn-post``), or not a JSON object is indistinguishable
  from no post at all.  The lease deadline then re-dispatches the work
  — a torn result can delay an answer, never corrupt one.
* **Decisions are tick-counted, never wall-clock.**  The
  caller hands ``observe``/``expired`` its own monotonically increasing
  poll-tick number.  A worker is dead when its heartbeat value has not
  *changed* for ``deadline_ticks`` observed ticks; a lease is expired
  ``lease_ticks`` after issue or claim.  Wall time only paces the
  caller's polls, through the injectable serve clock, where tests
  substitute a fake.

**Epoch fencing** is how a zombie — a worker declared dead whose
process is still running — is kept from double-answering a request:
every re-dispatch bumps the lease epoch, claim and result keys embed
the epoch, and :meth:`LeaseTable.admits` is the one acceptance
predicate.  A result posted under any previous epoch lands on the
board, is counted (``lease.fenced``), and is never demuxed.  Death is
terminal: a worker whose heartbeat resumes after the verdict stays
dead — its leases were already re-dispatched — and a restarted process
registers under a new (pid-derived) worker id instead.

**Leader leases** apply the same three disciplines one layer
up, to the coordinator itself.  The fleet **generation** is the
coordinator-level fencing epoch: every coordinator that ever leads this
board wins exactly one generation by claiming ``leader/g<gen>`` through
the board's single-winner ``claim`` primitive, renews a beat value on
every pump tick, and stamps its generation into every block id it
offers.  A ``--fleet-standby`` process watches the newest generation's
beat exactly the way :class:`Membership` watches worker heartbeats —
value *change* under a tick-counted deadline — and on a stale verdict
races ``claim`` on the NEXT generation; the winner replays the dead
leader's board checkpoint (:func:`read_checkpoint`) and every key the
dead leader ever posted is now a fenced lower generation, swept by the
new leader's board GC.  Death is terminal here too: a deposed leader
(one that observes a higher generation claim) must stop answering —
:class:`~..serve.fleet.FleetCoordinator` raises on the next pump.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass

from ..obs.events import publish

#: Board key namespace.  One fleet per board: for FileBoard fleets the
#: board *directory* is the run scope, so no run tag is needed here.
_ROOT = "seqalign/fleet"
FLEET_PREFIX = f"{_ROOT}/"  # everything the board GC may ever sweep
WORKER_PREFIX = f"{_ROOT}/worker/"
OFFER_PREFIX = f"{_ROOT}/offer/"


def worker_key(wid: str) -> str:
    return f"{WORKER_PREFIX}{wid}"


def heartbeat_key(wid: str) -> str:
    return f"{_ROOT}/hb/{wid}"


def offer_key(bid: str) -> str:
    return f"{OFFER_PREFIX}{bid}"


def claim_key(bid: str, epoch: int) -> str:
    return f"{_ROOT}/claim/{bid}/e{int(epoch)}"


def result_key(bid: str, epoch: int) -> str:
    return f"{_ROOT}/result/{bid}/e{int(epoch)}"


def shutdown_key() -> str:
    return f"{_ROOT}/shutdown"


def obs_snapshot_key(wid: str) -> str:
    """One bounded observability snapshot per worker (metrics + recent
    trace events + the flight-recorder tape), overwritten in place —
    the coordinator's federation/merge source and the post-mortem tape
    it collects when the worker is declared dead."""
    return f"{_ROOT}/obssnap/{wid}"


#: Leader-lease key namespace: one claim key per generation (the
#: single-winner record), one beat key per generation (liveness), one
#: checkpoint key per generation (the takeover's replay state).
LEADER_PREFIX = f"{_ROOT}/leader/"


def leader_claim_key(gen: int) -> str:
    return f"{LEADER_PREFIX}g{int(gen)}"


def leader_beat_key(gen: int) -> str:
    return f"{_ROOT}/leaderhb/g{int(gen)}"


def ckpt_key(gen: int) -> str:
    return f"{_ROOT}/ckpt/g{int(gen)}"


def current_generation(board) -> int:
    """The newest leader generation ever claimed on this board (-1 on a
    board no coordinator has led yet).  A scan, not a counter post: the
    claim keys themselves are the authoritative monotonic record, so
    there is no torn-counter state to reconcile after a crash."""
    best = -1
    for key in board.keys(LEADER_PREFIX):
        name = key[len(LEADER_PREFIX):]
        if not name.startswith("g"):
            continue
        try:
            best = max(best, int(name[1:]))
        except ValueError:
            continue
    return best


def board_read_json(board, key: str) -> dict | None:
    """One JSON-object read with the torn-post guarantee: a missing,
    zero-length, unparsable, or non-object post reads as None."""
    raw = board.get(key)
    if raw is None or not raw.strip():
        return None
    try:
        obj = json.loads(raw)
    except (json.JSONDecodeError, ValueError):
        return None
    return obj if isinstance(obj, dict) else None


@dataclass
class WorkerView:
    """Coordinator-side view of one registered worker."""

    wid: str
    beat: int = -1  # last heartbeat VALUE read off the board
    seen_tick: int = 0  # tick that value last changed
    alive: bool = True


class Membership:
    """The worker registry: registrations plus heartbeat staleness.

    ``observe(tick)`` is the whole protocol: scan registration keys (a
    new one is a join), re-read each live worker's heartbeat (a changed
    value proves liveness at this tick; a value frozen for
    ``deadline_ticks`` ticks is a death verdict).  Publishes
    ``worker.join`` / ``worker.dead`` and returns the joined/died ids.
    """

    def __init__(self, board, deadline_ticks: int):
        if deadline_ticks < 1:
            raise ValueError(
                f"membership deadline must be >= 1 tick, got {deadline_ticks}"
            )
        self.board = board
        self.deadline_ticks = int(deadline_ticks)
        self.workers: dict[str, WorkerView] = {}

    def observe(self, tick: int) -> tuple[list[str], list[str]]:
        tick = int(tick)
        joined: list[str] = []
        died: list[str] = []
        for key in self.board.keys(WORKER_PREFIX):
            wid = key[len(WORKER_PREFIX):]
            if not wid or wid in self.workers:
                continue
            if board_read_json(self.board, key) is None:
                continue  # torn registration: not a member (yet)
            self.workers[wid] = WorkerView(wid, seen_tick=tick)
            joined.append(wid)
            publish("worker.join", worker=wid, workers=self.live_count())
        for view in self.workers.values():
            if not view.alive:
                continue
            beat = self._read_beat(view.wid)
            if beat is not None and beat != view.beat:
                view.beat = beat
                view.seen_tick = tick
            elif tick - view.seen_tick >= self.deadline_ticks:
                view.alive = False
                died.append(view.wid)
        for wid in died:
            publish("worker.dead", worker=wid, workers=self.live_count())
        return joined, died

    def _read_beat(self, wid: str) -> int | None:
        raw = self.board.get(heartbeat_key(wid))
        if raw is None or not raw.strip():
            return None
        try:
            return int(raw)
        except ValueError:
            return None  # torn heartbeat reads as missing

    def live(self) -> list[str]:
        return [w.wid for w in self.workers.values() if w.alive]

    def live_count(self) -> int:
        return sum(1 for w in self.workers.values() if w.alive)

    def is_live(self, wid: str) -> bool:
        view = self.workers.get(wid)
        return view is not None and view.alive


@dataclass
class Lease:
    """One superblock's lease: fencing epoch, holder, and the tick its
    expiry clock last (re)started — at issue, claim, or bump."""

    bid: str
    epoch: int = 0
    holder: str | None = None
    since: int = 0


class LeaseTable:
    """Epoch-fenced leases with tick-counted expiry.

    The epoch is the fencing token: every re-dispatch bumps it, claim
    and result posts embed it, and :meth:`admits` — the one acceptance
    predicate — only passes the CURRENT epoch.  A zombie holding epoch
    N cannot double-answer after the coordinator moved to N+1.
    """

    def __init__(self, lease_ticks: int):
        if lease_ticks < 1:
            raise ValueError(
                f"lease must be >= 1 tick, got {lease_ticks}"
            )
        self.lease_ticks = int(lease_ticks)
        self._leases: dict[str, Lease] = {}

    def issue(self, bid: str, tick: int) -> Lease:
        if bid in self._leases:
            raise ValueError(f"lease for block {bid!r} already issued")
        lease = Lease(bid, since=int(tick))
        self._leases[bid] = lease
        return lease

    def get(self, bid: str) -> Lease:
        return self._leases[bid]

    def note_claim(self, bid: str, wid: str, tick: int) -> None:
        lease = self._leases[bid]
        lease.holder = str(wid)
        lease.since = int(tick)  # the expiry clock restarts at the claim

    def bump(self, bid: str, tick: int) -> int:
        """Fence + re-arm: next epoch, no holder, expiry clock reset."""
        lease = self._leases[bid]
        lease.epoch += 1
        lease.holder = None
        lease.since = int(tick)
        return lease.epoch

    def admits(self, bid: str, epoch: int) -> bool:
        """The fencing predicate: does a result carrying ``epoch``
        answer the CURRENT lease?  Retired/unknown blocks admit
        nothing."""
        lease = self._leases.get(bid)
        return lease is not None and int(epoch) == lease.epoch

    def retire(self, bid: str) -> None:
        self._leases.pop(bid, None)

    def expired(self, tick: int) -> list[Lease]:
        tick = int(tick)
        return [
            lease
            for lease in self._leases.values()
            if tick - lease.since >= self.lease_ticks
        ]

    def held_by(self, wid: str) -> list[Lease]:
        return [
            lease for lease in self._leases.values()
            if lease.holder == str(wid)
        ]


class LeaderLease:
    """The coordinator-level lease: exactly one leader per generation.

    Leader side: :meth:`acquire` wins the next free generation (board
    ``claim`` — the same ``os.link`` single-winner primitive worker
    leases ride), :meth:`renew` posts the beat every pump tick, and
    :meth:`deposed` detects a successor (any higher-generation claim).

    Standby side: :meth:`observe` is one watch tick — the same
    change-under-a-tick-counted-deadline liveness rule as worker
    heartbeats (the caller supplies the tick number; wall time
    never decides).  A leader whose beat value has not changed for
    ``deadline_ticks`` observed ticks — including one that died before
    its first beat ever landed — earns a dead verdict, and the standby
    races :meth:`try_acquire` on the NEXT generation.  Losing that race
    is not an error: a rival standby won, and the watch simply restarts
    against the new leader's beat.
    """

    def __init__(self, board, lid: str, deadline_ticks: int):
        if deadline_ticks < 1:
            raise ValueError(
                f"leader deadline must be >= 1 tick, got {deadline_ticks}"
            )
        self.board = board
        self.lid = str(lid)
        self.deadline_ticks = int(deadline_ticks)
        self.gen: int | None = None  # the generation this lease holds
        self._beat = 0
        # Standby watch state: the generation under watch, the last beat
        # value read, and the tick that value last changed.
        self._watch_gen: int | None = None
        self._watch_beat: str | None = None
        self._watch_tick = 0

    # -- leader side -------------------------------------------------------

    def try_acquire(self, gen: int) -> bool:
        """One claim attempt on one specific generation — the standby
        race's unit.  Exactly one claimer wins; the loser keeps
        watching."""
        won = self.board.claim(
            leader_claim_key(gen),
            json.dumps({"lid": self.lid, "gen": int(gen)}),
        )
        if won:
            self.gen = int(gen)
            self.renew()
            publish("leader.elected", leader=self.lid, gen=int(gen))
        return won

    def acquire(self) -> int:
        """Startup acquisition: claim the next free generation.  Bounded
        retries cover the startup race where several coordinators scan
        the same maximum — each retry re-scans, so the loop terminates
        as soon as this process stops losing."""
        for _ in range(64):
            if self.try_acquire(current_generation(self.board) + 1):
                return self.gen
        raise RuntimeError(
            "could not win a fleet leader generation after 64 claim "
            "attempts (a claim storm this deep means the board is sick)"
        )

    def renew(self) -> None:
        """Post the next beat value (leader liveness).  Best-effort on a
        sick board: one missed beat is indistinguishable from a slow
        tick; a board that stays unwritable earns this leader the same
        dead verdict a crash would."""
        self._beat += 1
        try:
            self.board.post(leader_beat_key(self.gen), str(self._beat))
        except OSError:
            pass

    def deposed(self) -> bool:
        """Has any successor generation been claimed?  The deposed
        leader must stop answering — its late posts are fenced by
        generation exactly as a zombie worker's are by epoch."""
        return self.gen is not None and current_generation(self.board) > self.gen

    # -- standby side ------------------------------------------------------

    def watched_gen(self) -> int | None:
        """The generation currently under watch (None before any leader
        has claimed)."""
        return self._watch_gen

    def observe(self, tick: int) -> bool:
        """One standby watch tick; True when the watched leader's beat
        has been frozen (or absent) for ``deadline_ticks`` ticks.  A new
        claim — even mid-countdown — restarts the watch against the new
        generation: the verdict always names the NEWEST leader."""
        tick = int(tick)
        gen = current_generation(self.board)
        if gen < 0:
            # No leader has ever claimed: nothing to succeed.  A standby
            # is a coordinator-in-WAITING; it never seizes a virgin board.
            self._watch_gen = None
            return False
        raw = self.board.get(leader_beat_key(gen))
        beat = raw.strip() if raw is not None and raw.strip() else None
        if gen != self._watch_gen:
            self._watch_gen = gen
            self._watch_beat = beat
            self._watch_tick = tick
            return False
        if beat is not None and beat != self._watch_beat:
            self._watch_beat = beat
            self._watch_tick = tick
            return False
        return tick - self._watch_tick >= self.deadline_ticks


def read_obs_snapshot(board, wid: str) -> dict | None:
    """Read one worker's observability snapshot with the torn-post
    guarantee plus identity validation: a snapshot that is absent,
    torn, or stamped with a DIFFERENT worker id (an alien post — a key
    collision or a confused writer) reads as missing.  Observability is
    best-effort by construction: missing is never fatal."""
    post = board_read_json(board, obs_snapshot_key(wid))
    if post is None:
        return None
    if post.get("wid") != wid:
        return None
    return post


class ClockOffsetEstimator:
    """Deterministic per-worker clock-offset estimates from offer/claim
    echo pairs.

    The coordinator stamps each offer with its own clock (``t_post``),
    the claiming worker echoes its clock (``t_echo``) in the claim
    payload, and the coordinator reads the claim at ``t_seen``.  One
    such pair bounds the worker clock against the coordinator clock the
    way one NTP exchange does: the echo happened somewhere inside
    ``[t_post, t_seen]``, so the midpoint estimate

        ``offset = t_echo - (t_post + t_seen) / 2``

    is wrong by at most half the round trip.  The estimator keeps the
    minimum-RTT pair per worker — the tightest bound seen — which makes
    the estimate a deterministic function of the observed pairs (same
    pairs, same verdict: the change-under-tick discipline of the rest
    of this module, applied to clock alignment).  No clock is read
    here; every timestamp is caller-supplied.
    """

    def __init__(self):
        # wid -> (rtt_s, offset_s) of the best (minimum-RTT) pair.
        self._best: dict[str, tuple[float, float]] = {}

    def observe(self, wid: str, t_post, t_echo, t_seen) -> None:
        """Fold one echo pair in.  Non-numeric or causally impossible
        pairs (``t_seen < t_post``) are dropped — a torn claim must not
        corrupt the estimate."""
        try:
            t_post = float(t_post)
            t_echo = float(t_echo)
            t_seen = float(t_seen)
        except (TypeError, ValueError):
            return
        if not (math.isfinite(t_post) and math.isfinite(t_echo)
                and math.isfinite(t_seen)):
            return
        rtt = t_seen - t_post
        if rtt < 0.0:
            return
        offset = t_echo - (t_post + t_seen) / 2.0
        best = self._best.get(str(wid))
        if best is None or rtt < best[0]:
            self._best[str(wid)] = (rtt, offset)

    def offset(self, wid: str) -> float | None:
        """Worker-minus-coordinator clock offset (seconds), or None
        before any echo pair has been observed for ``wid``."""
        best = self._best.get(str(wid))
        return best[1] if best is not None else None

    def uncertainty(self, wid: str) -> float | None:
        """Half the best pair's round trip: the estimate's error bound."""
        best = self._best.get(str(wid))
        return best[0] / 2.0 if best is not None else None

    def to_coordinator(self, wid: str, t_worker) -> float | None:
        """Map one worker-clock timestamp onto the coordinator clock
        (None while the worker's offset is still unknown)."""
        off = self.offset(wid)
        if off is None:
            return None
        try:
            return float(t_worker) - off
        except (TypeError, ValueError):
            return None

    def snapshot(self) -> dict[str, dict]:
        """JSON-ready per-worker estimates (the run report / bench
        table's ``clock_offsets`` rows)."""
        return {
            wid: {
                "offset_s": round(offset, 9),
                "rtt_s": round(rtt, 9),
            }
            for wid, (rtt, offset) in sorted(self._best.items())
        }


def write_checkpoint(board, gen: int, state: dict) -> None:
    """Post one coordinator state checkpoint (atomic board post).  The
    caller (FleetCoordinator) owns change-detection; OSError is the
    caller's to absorb — a leader that cannot checkpoint keeps serving
    and keeps its --journal authoritative."""
    board.post(ckpt_key(gen), json.dumps(state))


def read_checkpoint(board, gen: int) -> dict | None:
    """Read generation ``gen``'s coordinator checkpoint with the full
    torn-post guarantee plus shape validation: anything that is not a
    JSON object carrying list-valued ``requests``/``answered`` reads as
    missing — a takeover replays nothing rather than garbage."""
    post = board_read_json(board, ckpt_key(gen))
    if post is None:
        return None
    if not isinstance(post.get("requests"), list):
        return None
    if not isinstance(post.get("answered"), list):
        return None
    return post
