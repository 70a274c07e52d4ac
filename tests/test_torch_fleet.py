"""The port's elastic serve fleet against the contract ``tests/test_fleet.py``
pins for the JAX package (its tests, on the port's modules): FileBoard
atomicity and claim races, torn-post reads, tick-counted membership and
lease expiry, epoch fencing, leader leases and the standby takeover, the
board GC, and the coordinator/worker protocol on an in-memory board with
a fake clock.

Then what is the port's own: the two packages' processes on one
``FileBoard`` (a JAX ``--serve --fleet-board`` coordinator with a port
``--fleet-worker --device cpu``, and the reverse), each answering
byte-identically to the JAX fleetless ``--serve`` run; a port coordinator
with a port worker and a standby taking over a killed coordinator; the
offer the board cannot take (scored on the coordinator); a worker without
a card (65); and, on a card, the worker's launches of the fused kernel.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from mpi_openmp_cuda_tpu_torch.obs import arm_observability, disarm_observability
from mpi_openmp_cuda_tpu_torch.resilience.faults import (
    activate_faults,
    deactivate_faults,
)
from mpi_openmp_cuda_tpu_torch.resilience.membership import (
    LeaderLease,
    LeaseTable,
    Membership,
    board_read_json,
    ckpt_key,
    claim_key,
    current_generation,
    heartbeat_key,
    leader_beat_key,
    leader_claim_key,
    offer_key,
    read_checkpoint,
    result_key,
    shutdown_key,
    worker_key,
    write_checkpoint,
)
from mpi_openmp_cuda_tpu_torch.resilience.rescue import FileBoard, MemoryBoard
from mpi_openmp_cuda_tpu_torch.serve.fleet import (
    FleetCoordinator,
    FleetWorker,
    LeadershipLostError,
    lease_ticks_for,
    standby_wait,
)


class FakeClock:
    """ServeClock stand-in: time moves only when a wait consumes it."""

    def __init__(self):
        self.t = 0.0

    def now(self) -> float:
        return self.t

    def block_until(self, cond, predicate, timeout_s: float) -> bool:
        self.t += max(0.0, float(timeout_s))
        return predicate()


class Block:
    """The three superblock fields the fleet protocol reads."""

    def __init__(self, n_rows: int = 2):
        self.weights = [1, -3, -5, -2]
        self.seq1_codes = np.arange(4, dtype=np.int8)
        self.codes = [
            np.full(3, i, dtype=np.int8) for i in range(n_rows)
        ]


class StubPipeline:
    """Deterministic rows: row i scores (i, i, i) — enough to assert
    the demuxed payload came from the worker, not the fallback."""

    def dispatch(self, seq1, codes, weights, budget, **kw):
        return len(codes)

    def materialise(self, promise, seq1, codes, weights, budget):
        return np.stack(
            [np.full(3, i, dtype=np.int64) for i in range(promise)]
        )


class StubPolicy:
    def new_budget(self):
        return object()


@pytest.fixture
def obs_registry():
    registry, _ = arm_observability(lambda: 0.0, lambda: 0.0)
    yield registry
    disarm_observability()


def make_coordinator(board, clock, **kw):
    kw.setdefault("lease_s", 5.0)
    kw.setdefault("poll_s", 1.0)
    collected, fallback = [], []
    coord = FleetCoordinator(
        board,
        local_score=fallback.append,
        demux=lambda rows, block: collected.append((rows, block)),
        clock=clock,
        **kw,
    )
    return coord, collected, fallback


def tick(coord, clock, n: int = 1) -> None:
    """Advance wall time past the poll interval and pump: one call ==
    one membership/lease tick, exactly the coordinator's real cadence."""
    for _ in range(n):
        clock.t += coord.poll_s
        coord.pump()


def enlist(board, wid: str, beat: int = 1) -> None:
    """Register a (simulated) worker and give it a heartbeat value."""
    board.post(worker_key(wid), json.dumps({"wid": wid, "pid": 1}))
    board.post(heartbeat_key(wid), str(beat))


def make_worker(board, wid: str) -> FleetWorker:
    worker = FleetWorker(board, StubPipeline(), StubPolicy(), FakeClock())
    worker.wid = wid  # distinct ids within one test process
    return worker


# -- FileBoard ---------------------------------------------------------------


def test_fileboard_post_get_delete_roundtrip(tmp_path):
    board = FileBoard(str(tmp_path / "board"))
    assert board.get("seqalign/fleet/x") is None
    board.post("seqalign/fleet/x", "hello")
    assert board.get("seqalign/fleet/x") == "hello"
    board.post("seqalign/fleet/x", "rewritten")  # post overwrites
    assert board.get("seqalign/fleet/x") == "rewritten"
    board.delete("seqalign/fleet/x")
    assert board.get("seqalign/fleet/x") is None
    board.delete("seqalign/fleet/x")  # deleting a missing key: no-op


def test_fileboard_zero_length_reads_as_missing(tmp_path):
    board = FileBoard(str(tmp_path / "board"))
    board.post("k", "")
    assert board.get("k") is None


def test_fileboard_claim_exactly_one_winner(tmp_path):
    board = FileBoard(str(tmp_path / "board"))
    assert board.claim("claim/b1/e0", "first") is True
    assert board.claim("claim/b1/e0", "second") is False
    # The loser's attempt must not clobber the winner's value.
    assert board.get("claim/b1/e0") == "first"


def test_fileboard_keys_skip_tmp_files(tmp_path):
    root = tmp_path / "board"
    board = FileBoard(str(root))
    board.post("fleet/worker/w1", "a")
    board.post("fleet/worker/w2", "b")
    board.post("fleet/other", "c")
    # A writer killed mid-post leaves a tmp file behind: never a key.
    (root / "fleet" / "worker" / ".tmp.w3.999").write_text("torn")
    assert board.keys("fleet/worker/") == [
        "fleet/worker/w1", "fleet/worker/w2",
    ]
    assert board.keys("") == [
        "fleet/other", "fleet/worker/w1", "fleet/worker/w2",
    ]


def test_fileboard_keys_never_escape_root(tmp_path):
    root = tmp_path / "board"
    board = FileBoard(str(root))
    (tmp_path / "outside").write_text("secret")
    board.post("../outside", "overwrite-attempt")
    # Traversal parts are dropped: the write landed INSIDE the root and
    # the file outside is untouched.
    assert (tmp_path / "outside").read_text() == "secret"
    assert board.get("outside") == "overwrite-attempt"


# -- torn posts read as missing ----------------------------------------------


@pytest.mark.parametrize("raw", [
    None,  # absent
    "",  # zero-length
    "   ",  # whitespace
    '{"bid": "b1", "epo',  # torn mid-write
    "[1, 2, 3]",  # not an object
    "42",
])
def test_board_read_json_torn_posts_read_as_missing(raw):
    board = MemoryBoard()
    if raw is not None:
        board.post("k", raw)
    assert board_read_json(board, "k") is None


def test_board_read_json_whole_post():
    board = MemoryBoard()
    board.post("k", '{"bid": "b1", "epoch": 0}')
    assert board_read_json(board, "k") == {"bid": "b1", "epoch": 0}


# -- membership --------------------------------------------------------------


def test_membership_join_then_heartbeat_death():
    board = MemoryBoard()
    members = Membership(board, deadline_ticks=3)
    enlist(board, "w1")
    joined, died = members.observe(1)
    assert joined == ["w1"] and died == []
    assert members.is_live("w1") and members.live() == ["w1"]
    # Beats frozen from tick 1: death lands exactly deadline_ticks later.
    _, died = members.observe(2)
    assert died == []
    _, died = members.observe(3)
    assert died == []
    _, died = members.observe(4)
    assert died == ["w1"]
    assert not members.is_live("w1") and members.live_count() == 0


def test_membership_changing_beat_defers_death():
    board = MemoryBoard()
    members = Membership(board, deadline_ticks=2)
    enlist(board, "w1", beat=1)
    members.observe(1)
    for t in range(2, 8):
        board.post(heartbeat_key("w1"), str(t))  # beat keeps changing
        _, died = members.observe(t)
        assert died == []
    assert members.is_live("w1")


def test_membership_death_is_terminal():
    board = MemoryBoard()
    members = Membership(board, deadline_ticks=2)
    enlist(board, "w1")
    members.observe(1)
    _, died = members.observe(3)
    assert died == ["w1"]
    # A zombie's heartbeat resuming after the verdict changes nothing:
    # its leases were already re-dispatched.
    board.post(heartbeat_key("w1"), "999")
    joined, died = members.observe(4)
    assert joined == [] and died == []
    assert not members.is_live("w1")


def test_membership_torn_registration_is_not_a_member():
    board = MemoryBoard()
    members = Membership(board, deadline_ticks=2)
    board.post(worker_key("w1"), '{"wid": "w')  # killed mid-register
    joined, _ = members.observe(1)
    assert joined == []
    enlist(board, "w1")  # the retry lands whole
    joined, _ = members.observe(2)
    assert joined == ["w1"]


# -- leases ------------------------------------------------------------------


def test_lease_epoch_fencing():
    leases = LeaseTable(lease_ticks=3)
    leases.issue("b1", tick=0)
    assert leases.admits("b1", 0)
    assert not leases.admits("b1", 1)
    leases.note_claim("b1", "w1", tick=1)
    assert leases.get("b1").holder == "w1"
    # The re-dispatch bump: the zombie's epoch-0 post is now fenced.
    assert leases.bump("b1", tick=2) == 1
    assert not leases.admits("b1", 0)
    assert leases.admits("b1", 1)
    assert leases.get("b1").holder is None
    leases.retire("b1")
    assert not leases.admits("b1", 1)  # retired blocks admit nothing
    with pytest.raises(KeyError):
        leases.get("b1")


def test_lease_duplicate_issue_rejected():
    leases = LeaseTable(lease_ticks=2)
    leases.issue("b1", tick=0)
    with pytest.raises(ValueError, match="already issued"):
        leases.issue("b1", tick=1)


def test_lease_expiry_clock_restarts_on_claim_and_bump():
    leases = LeaseTable(lease_ticks=3)
    leases.issue("b1", tick=0)
    assert leases.expired(2) == []
    assert [lease.bid for lease in leases.expired(3)] == ["b1"]
    leases.note_claim("b1", "w1", tick=3)  # claim restarts the clock
    assert leases.expired(5) == []
    assert [lease.bid for lease in leases.expired(6)] == ["b1"]
    leases.bump("b1", tick=6)  # so does the re-dispatch bump
    assert leases.expired(8) == []
    assert [lease.bid for lease in leases.expired(9)] == ["b1"]


# -- coordinator x worker (in-memory board, fake clock) ----------------------


def test_coordinator_offer_claim_score_collect(obs_registry):
    board = MemoryBoard()
    clock = FakeClock()
    coord, collected, fallback = make_coordinator(board, clock)
    assert not coord.accepting()  # no workers: the loop scores locally
    worker = make_worker(board, "wa")
    worker.register()
    worker.heartbeat()
    tick(coord, clock)
    assert coord.accepting()
    block = Block(n_rows=2)
    bid = coord.offer(block)
    assert board_read_json(board, offer_key(bid))["epoch"] == 0
    assert coord.outstanding() == 1
    assert worker.step() is True  # claim + score + post
    tick(coord, clock)
    assert coord.outstanding() == 0
    assert fallback == []
    [(rows, got_block)] = collected
    assert got_block is block
    np.testing.assert_array_equal(
        rows, np.array([[0, 0, 0], [1, 1, 1]], dtype=np.int64)
    )
    assert board.get(offer_key(bid)) is None  # offer cleaned off the board
    assert obs_registry.counters["fleet_joins"] == 1
    assert obs_registry.gauges["fleet_workers"] == 1


def test_two_workers_race_exactly_one_wins():
    board = MemoryBoard()
    clock = FakeClock()
    coord, collected, _ = make_coordinator(board, clock)
    wa, wb = make_worker(board, "wa"), make_worker(board, "wb")
    for worker in (wa, wb):
        worker.register()
        worker.heartbeat()
    tick(coord, clock)
    bid = coord.offer(Block())
    assert wa.step() is True  # first scan wins the claim...
    assert wb.step() is False  # ...the loser backs off without posting
    assert json.loads(board.get(claim_key(bid, 0)))["wid"] == "wa"
    tick(coord, clock)
    assert len(collected) == 1


def test_dead_worker_superblocks_redispatch_to_survivor(obs_registry):
    board = MemoryBoard()
    clock = FakeClock()
    coord, collected, fallback = make_coordinator(board, clock)
    enlist(board, "doomed")
    tick(coord, clock)
    bid = coord.offer(Block())
    # The doomed worker claims, then goes silent without posting.
    board.claim(claim_key(bid, 0), json.dumps({"wid": "doomed"}))
    tick(coord, clock)  # coordinator notes the claim
    assert coord.leases.get(bid).holder == "doomed"
    survivor = make_worker(board, "survivor")
    survivor.register()
    survivor.heartbeat()
    tick(coord, clock, n=coord.lease_ticks)  # beats frozen -> verdict
    assert obs_registry.counters["fleet_deaths"] == 1
    assert obs_registry.counters["fleet_redispatches"] == 1
    offer = board_read_json(board, offer_key(bid))
    assert offer["epoch"] == 1  # re-offered at the bumped epoch
    assert survivor.step() is True
    tick(coord, clock)
    assert len(collected) == 1 and fallback == []
    assert coord.outstanding() == 0


def test_all_workers_dead_falls_back_to_local_scoring(obs_registry):
    board = MemoryBoard()
    clock = FakeClock()
    coord, collected, fallback = make_coordinator(board, clock)
    enlist(board, "w1")
    tick(coord, clock)
    block = Block()
    bid = coord.offer(block)
    board.claim(claim_key(bid, 0), json.dumps({"wid": "w1"}))
    tick(coord, clock, n=1 + coord.lease_ticks)  # silence -> death
    assert obs_registry.counters["fleet_deaths"] == 1
    # No survivor to re-offer to: the coordinator scores it itself.
    assert fallback == [block] and collected == []
    assert coord.outstanding() == 0
    assert not coord.accepting()
    assert obs_registry.gauges["fleet_workers"] == 0


def test_lease_expiry_without_claim_redispatches(obs_registry):
    board = MemoryBoard()
    clock = FakeClock()
    coord, _, _ = make_coordinator(board, clock)
    enlist(board, "w1")
    tick(coord, clock)
    bid = coord.offer(Block())
    # The worker stays alive (beats change) but never claims: only the
    # lease deadline — not a death verdict — re-dispatches.
    for t in range(coord.lease_ticks + 1):
        board.post(heartbeat_key("w1"), str(10 + t))
        tick(coord, clock)
    assert obs_registry.counters["fleet_lease_expiries"] == 1
    assert obs_registry.counters.get("fleet_deaths", 0) == 0
    assert board_read_json(board, offer_key(bid))["epoch"] == 1


def test_zombie_stale_epoch_post_is_fenced_never_demuxed(obs_registry):
    board = MemoryBoard()
    clock = FakeClock()
    coord, collected, _ = make_coordinator(board, clock)
    enlist(board, "zombie")
    tick(coord, clock)
    block = Block(n_rows=1)
    bid = coord.offer(block)
    board.claim(claim_key(bid, 0), json.dumps({"wid": "zombie"}))
    tick(coord, clock)
    enlist(board, "fresh")  # the survivor that will score epoch 1
    tick(coord, clock, n=coord.lease_ticks)  # zombie declared dead
    assert board_read_json(board, offer_key(bid))["epoch"] == 1
    # The zombie posts its STALE epoch-0 result — well-formed rows, the
    # right block, just the wrong epoch.  Fenced: counted, not demuxed.
    board.post(result_key(bid, 0), json.dumps({
        "bid": bid, "epoch": 0, "wid": "zombie", "rows": [[9, 9, 9]],
    }))
    board.post(heartbeat_key("fresh"), "2")
    tick(coord, clock)
    assert collected == []
    assert coord.outstanding() == 1
    assert obs_registry.counters["fleet_fenced_posts"] == 1
    # The current-epoch post answers; the fence event stays counted once.
    board.post(result_key(bid, 1), json.dumps({
        "bid": bid, "epoch": 1, "wid": "fresh", "rows": [[1, 2, 3]],
    }))
    board.post(heartbeat_key("fresh"), "3")
    tick(coord, clock)
    [(rows, _)] = collected
    np.testing.assert_array_equal(rows, [[1, 2, 3]])
    tick(coord, clock)
    assert obs_registry.counters["fleet_fenced_posts"] == 1


def test_malformed_result_rows_read_as_missing():
    board = MemoryBoard()
    clock = FakeClock()
    coord, collected, _ = make_coordinator(board, clock)
    enlist(board, "w1")
    tick(coord, clock)
    bid = coord.offer(Block(n_rows=2))
    for bad in (
        {"bid": bid, "epoch": 0, "rows": [[1, 2, 3]]},  # wrong shape
        {"bid": bid, "epoch": 0, "rows": "garbage"},
        {"bid": bid, "epoch": "x", "rows": [[1, 2, 3], [4, 5, 6]]},
    ):
        board.post(result_key(bid, 0), json.dumps(bad))
        board.post(heartbeat_key("w1"), str(id(bad)))
        tick(coord, clock)
        assert collected == [] and coord.outstanding() == 1


def test_finish_locally_drains_and_fences_outstanding_blocks():
    board = MemoryBoard()
    clock = FakeClock()
    coord, collected, fallback = make_coordinator(board, clock)
    enlist(board, "w1")
    tick(coord, clock)
    blocks = [Block(), Block()]
    bids = [coord.offer(b) for b in blocks]
    coord.finish_locally()
    assert fallback == blocks and collected == []
    assert coord.outstanding() == 0
    for bid in bids:
        assert board.get(offer_key(bid)) is None
        assert not coord.leases.admits(bid, 0)  # stragglers land fenced


def test_join_mid_serve_flips_accepting():
    board = MemoryBoard()
    clock = FakeClock()
    coord, collected, _ = make_coordinator(board, clock)
    tick(coord, clock)
    assert not coord.accepting()
    late = make_worker(board, "late")
    late.register()
    late.heartbeat()
    tick(coord, clock)
    assert coord.accepting()  # the next planned block goes to the fleet
    coord.offer(Block(n_rows=1))
    assert late.step() is True
    tick(coord, clock)
    assert len(collected) == 1


# -- worker loop edges -------------------------------------------------------


def test_worker_skips_torn_offers_and_foreign_claims():
    board = MemoryBoard()
    worker = make_worker(board, "wa")
    board.post(offer_key("b1"), '{"bid": "b1", "ep')  # torn offer
    assert worker.step() is False
    board.post(offer_key("b1"), json.dumps({
        "bid": "b1", "epoch": 0, "weights": [1, -3, -5, -2],
        "seq1": [0, 1], "rows": [[1, 2]],
    }))
    board.claim(claim_key("b1", 0), json.dumps({"wid": "other"}))
    assert worker.step() is False  # someone else holds this epoch
    assert board.get(result_key("b1", 0)) is None


def test_worker_exits_on_coordinator_shutdown_key():
    board = MemoryBoard()
    worker = make_worker(board, "wa")
    assert worker.should_exit() is False
    board.post(shutdown_key(), "shutdown")
    assert worker.should_exit() is True


def test_worker_scoring_failure_leaves_redispatch_to_lease(capsys):
    class SickPipeline(StubPipeline):
        def materialise(self, *a, **k):
            raise RuntimeError("boom")

    board = MemoryBoard()
    worker = FleetWorker(board, SickPipeline(), StubPolicy(), FakeClock())
    board.post(offer_key("b1"), json.dumps({
        "bid": "b1", "epoch": 0, "weights": [1, -3, -5, -2],
        "seq1": [0, 1], "rows": [[1, 2]],
    }))
    assert worker.step() is True  # the claim was attempted...
    assert board.get(result_key("b1", 0)) is None  # ...but nothing posted
    assert "leaving it to lease re-dispatch" in capsys.readouterr().err


# -- leader lease + coordinator failover -------------------------------------


def test_lease_ticks_for_shares_the_worker_window():
    assert lease_ticks_for(2.0, 1.0) == 2
    assert lease_ticks_for(5.0, 1.0) == 5
    assert lease_ticks_for(0.01, 0.05) == 2  # floor: never below 2 ticks


def test_leader_lease_single_winner_per_generation():
    board = MemoryBoard()
    a = LeaderLease(board, "a", deadline_ticks=2)
    b = LeaderLease(board, "b", deadline_ticks=2)
    assert current_generation(board) == -1  # virgin board
    assert a.acquire() == 0
    assert b.try_acquire(0) is False  # generation 0 is taken, forever
    assert json.loads(board.get(leader_claim_key(0)))["lid"] == "a"
    assert b.acquire() == 1  # the next free generation
    assert current_generation(board) == 1
    assert a.deposed() is True  # any higher claim deposes
    assert b.deposed() is False


def test_standby_observe_frozen_beat_earns_takeover():
    board = MemoryBoard()
    lead = LeaderLease(board, "lead", deadline_ticks=2)
    lead.acquire()
    sb = LeaderLease(board, "sb", deadline_ticks=2)
    assert not sb.observe(1)  # the watch starts against gen 0
    lead.renew()
    assert not sb.observe(2)  # beat changed: the countdown restarts
    assert not sb.observe(3)  # frozen 1 tick: not yet
    assert sb.observe(4)  # frozen 2 ticks: verdict
    assert sb.try_acquire(sb.watched_gen() + 1) is True
    assert sb.gen == 1 and lead.deposed()


def test_standby_watch_restarts_against_a_new_generation():
    board = MemoryBoard()
    lead = LeaderLease(board, "lead", deadline_ticks=2)
    lead.acquire()
    sb = LeaderLease(board, "sb", deadline_ticks=2)
    assert not sb.observe(1)
    # A rival standby wins generation 1 mid-countdown: the verdict must
    # name the NEWEST leader, so the watch restarts from its beat.
    rival = LeaderLease(board, "rival", deadline_ticks=2)
    assert rival.try_acquire(1) is True
    assert not sb.observe(3)  # reset, even though 2 ticks have passed
    assert sb.watched_gen() == 1
    assert not sb.observe(4)
    assert sb.observe(5)  # the rival's beat froze in turn


def test_checkpoint_roundtrip_and_torn_reads_missing():
    board = MemoryBoard()
    state = {"gen": 0, "requests": [{"id": "r1"}], "answered": ["r0"]}
    write_checkpoint(board, 0, state)
    assert read_checkpoint(board, 0) == state
    board.post(ckpt_key(1), '{"requests": [{"id": "to')  # torn mid-write
    assert read_checkpoint(board, 1) is None
    board.post(ckpt_key(2), json.dumps({"requests": "x", "answered": []}))
    assert read_checkpoint(board, 2) is None  # wrong shape == missing


def test_coordinator_checkpoint_is_change_cached():
    board = MemoryBoard()
    clock = FakeClock()
    lead = LeaderLease(board, "lead", deadline_ticks=2)
    lead.acquire()
    coord, _, _ = make_coordinator(board, clock, leader=lead)
    coord.checkpoint([{"id": "r1"}], [])
    assert read_checkpoint(board, 0)["requests"] == [{"id": "r1"}]
    board.delete(ckpt_key(0))
    coord.checkpoint([{"id": "r1"}], [])  # unchanged: no board write
    assert board.get(ckpt_key(0)) is None
    coord.checkpoint([], ["r1"])  # the answer changes the blob
    assert read_checkpoint(board, 0)["answered"] == ["r1"]


def test_leaderless_coordinator_never_checkpoints():
    board = MemoryBoard()
    coord, _, _ = make_coordinator(board, FakeClock())
    coord.checkpoint([{"id": "r1"}], [])
    assert board.keys("") == []


def test_deposed_leader_stops_before_collecting(obs_registry):
    board = MemoryBoard()
    clock = FakeClock()
    lead = LeaderLease(board, "lead", deadline_ticks=2)
    lead.acquire()
    coord, collected, fallback = make_coordinator(board, clock, leader=lead)
    enlist(board, "w1")
    tick(coord, clock)
    bid = coord.offer(Block(n_rows=1))
    # A perfectly good result lands — and a successor claims generation
    # 1 — both before the next pump.  The deposition check runs FIRST:
    # the zombie leader must never demux that answer.
    board.post(result_key(bid, 0), json.dumps({
        "bid": bid, "epoch": 0, "wid": "w1", "rows": [[1, 2, 3]],
    }))
    rival = LeaderLease(board, "rival", deadline_ticks=2)
    rival.acquire()
    with pytest.raises(LeadershipLostError):
        tick(coord, clock)
    assert collected == [] and fallback == []
    assert obs_registry.counters["fleet_depositions"] == 1
    coord.shutdown()  # deposed: the fleet belongs to the successor now
    assert board.get(shutdown_key()) is None


def test_zombie_leader_marker_freezes_beat_until_deposed(obs_registry):
    board = MemoryBoard()
    clock = FakeClock()
    lead = LeaderLease(board, "lead", deadline_ticks=2)
    lead.acquire()
    coord, _, _ = make_coordinator(board, clock, leader=lead)
    beat = board.get(leader_beat_key(0))
    try:
        activate_faults("zombie:fleet-leader:fail=1")
        tick(coord, clock)
    finally:
        deactivate_faults()
    assert board.get(leader_beat_key(0)) == beat  # renewal skipped
    tick(coord, clock)  # the freeze is sticky past the marker
    assert board.get(leader_beat_key(0)) == beat
    # The standby watch sees the frozen beat, takes over, and the
    # zombie's next pump self-deposes.
    sb = LeaderLease(board, "sb", deadline_ticks=2)
    assert not sb.observe(1) and not sb.observe(2)
    assert sb.observe(3)
    assert sb.try_acquire(sb.watched_gen() + 1) is True
    with pytest.raises(LeadershipLostError):
        tick(coord, clock)


def test_redispatch_cap_dead_letters_to_local_scoring(obs_registry):
    board = MemoryBoard()
    clock = FakeClock()
    coord, collected, fallback = make_coordinator(
        board, clock, max_redispatch=2
    )
    enlist(board, "w1")
    tick(coord, clock)
    block = Block()
    bid = coord.offer(block)
    # The worker stays alive but never claims (a permanently failing
    # offer): every expiry re-offers at a bumped epoch until the cap.
    for t in range(20 * coord.lease_ticks):
        if coord.outstanding() == 0:
            break
        board.post(heartbeat_key("w1"), str(10 + t))
        tick(coord, clock)
    assert fallback == [block] and collected == []
    assert obs_registry.counters["fleet_lease_expiries"] == 3
    assert obs_registry.counters["fleet_redispatches"] == 2
    assert obs_registry.counters["fleet_deadletter"] == 1
    assert board.get(offer_key(bid)) is None  # nothing left to claim
    assert not coord.leases.admits(bid, 3)  # stragglers land fenced


def test_gc_sweeps_dead_generation_debris_counted_once(obs_registry):
    board = MemoryBoard()
    clock = FakeClock()
    # Generation 0 died mid-run: its offer/claim/result debris, leader
    # records, and checkpoint are all still on the board.
    board.post(offer_key("g0b1"), json.dumps({"bid": "g0b1", "epoch": 0}))
    board.post(claim_key("g0b1", 0), json.dumps({"wid": "w9"}))
    board.post(result_key("g0b1", 0), json.dumps({"rows": [[1, 2, 3]]}))
    board.post(leader_claim_key(0), json.dumps({"lid": "dead", "gen": 0}))
    board.post(leader_beat_key(0), "7")
    write_checkpoint(board, 0, {"gen": 0, "requests": [], "answered": []})
    lead = LeaderLease(board, "sb", deadline_ticks=2)
    assert lead.acquire() == 1
    coord, _, _ = make_coordinator(board, clock, leader=lead)
    tick(coord, clock)  # classify + mark; grace window opens
    assert obs_registry.counters["fleet_leader_fenced"] == 3
    assert board.get(offer_key("g0b1")) is not None  # grace: not yet
    tick(coord, clock, n=coord.gc_ticks)
    for key in (
        offer_key("g0b1"),
        claim_key("g0b1", 0),
        result_key("g0b1", 0),
        ckpt_key(0),
        leader_claim_key(0),
        leader_beat_key(0),
    ):
        assert board.get(key) is None, key
    # The run's own generation record survives; fences counted ONCE.
    assert board.get(leader_claim_key(1)) is not None
    assert obs_registry.counters["fleet_leader_fenced"] == 3
    assert obs_registry.counters["fleet_gc_swept"] == 6


def test_gc_keeps_live_state_and_successor_namespace():
    board = MemoryBoard()
    clock = FakeClock()
    lead = LeaderLease(board, "lead", deadline_ticks=2)
    lead.acquire()
    coord, _, _ = make_coordinator(board, clock, leader=lead)
    coord.gc_ticks = 2  # sweep well inside the worker-lease window
    enlist(board, "w1")
    tick(coord, clock)
    bid = coord.offer(Block())
    board.claim(claim_key(bid, 0), json.dumps({"wid": "w1"}))
    # A successor generation's key (as a rejoining standby would see
    # after losing its own leadership): NEVER touched.
    board.post(offer_key("g5b1"), json.dumps({"bid": "g5b1", "epoch": 0}))
    for t in range(2 + coord.gc_ticks):
        board.post(heartbeat_key("w1"), str(10 + t))
        tick(coord, clock)
    assert board.get(offer_key(bid)) is not None  # live offer kept
    assert board.get(claim_key(bid, 0)) is not None  # admitted epoch kept
    assert board.get(worker_key("w1")) is not None  # live worker kept
    assert board.get(offer_key("g5b1")) is not None  # successor kept


def test_gc_final_clears_everything_but_registry_and_generations():
    board = MemoryBoard()
    clock = FakeClock()
    lead = LeaderLease(board, "lead", deadline_ticks=2)
    lead.acquire()
    coord, _, fallback = make_coordinator(board, clock, leader=lead)
    enlist(board, "w1")
    tick(coord, clock)
    coord.offer(Block())
    coord.checkpoint([{"id": "r1"}], [])
    board.post(offer_key("g0b9"), json.dumps({"bid": "g0b9", "epoch": 0}))
    coord.finish_locally()
    coord.gc_final()
    coord.shutdown()
    assert [k for k in board.keys("") if "/offer/" in k] == []
    assert [k for k in board.keys("") if "/ckpt/" in k] == []
    assert board.get(worker_key("w1")) is not None  # w1 exits on its own
    assert board.get(leader_claim_key(0)) is not None  # generation record
    assert board.get(shutdown_key()) is not None


def test_fileboard_enospc_failed_post_reads_missing_no_tmp_leak(tmp_path):
    root = tmp_path / "board"
    board = FileBoard(str(root))
    board.post("seqalign/fleet/ok", "before")
    try:
        activate_faults("board:enospc:fail=1")
        with pytest.raises(OSError):
            board.post("seqalign/fleet/x", "half-written-payload")
    finally:
        deactivate_faults()
    # The failed post is invisible: no key, no torn value, no tmp file.
    assert board.get("seqalign/fleet/x") is None
    assert board.keys("") == ["seqalign/fleet/ok"]
    leftovers = [
        p for p in root.rglob("*")
        if p.is_file() and p.name.startswith(".tmp.")
    ]
    assert leftovers == []
    board.post("seqalign/fleet/x", "whole")  # the retry lands whole
    assert board.get("seqalign/fleet/x") == "whole"


def test_offer_on_unpostable_board_raises_with_no_lease_state():
    class SickBoard(MemoryBoard):
        def post(self, key, value):
            if "/offer/" in key:
                raise OSError(28, "No space left on device")
            super().post(key, value)

    board = SickBoard()
    clock = FakeClock()
    coord, _, _ = make_coordinator(board, clock)
    enlist(board, "w1")
    tick(coord, clock)
    with pytest.raises(OSError):
        coord.offer(Block())
    # Nothing to unwind: the dispatcher's quarantine ladder takes the
    # block, and the coordinator carries no phantom lease.
    assert coord.outstanding() == 0
    tick(coord, clock)  # no stale lease ever expires


def test_standby_wait_sees_clean_shutdown():
    board = MemoryBoard()
    lead = LeaderLease(board, "lead", deadline_ticks=2)
    lead.acquire()
    sb = LeaderLease(board, "sb", deadline_ticks=2)
    board.post(shutdown_key(), "shutdown")
    assert standby_wait(board, sb, FakeClock(), poll_s=0.01) == (
        "shutdown", None,
    )
    assert sb.gen is None  # nothing was taken over


def test_standby_wait_takes_over_a_silent_leader():
    board = MemoryBoard()
    lead = LeaderLease(board, "lead", deadline_ticks=2)
    lead.acquire()
    sb = LeaderLease(board, "sb", deadline_ticks=2)
    verdict = standby_wait(board, sb, FakeClock(), poll_s=0.01)
    assert verdict == ("takeover", 0)
    assert sb.gen == 1 and lead.deposed()


# -- the port's own: loop integration, processes of both packages -----------

import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

import torch  # noqa: E402

from mpi_openmp_cuda_tpu.io import cli as jcli  # noqa: E402
from mpi_openmp_cuda_tpu_torch.io import cli as tcli  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
FIX = REPO / "tests" / "fixtures"
CHAOS_REQS = [
    {"id": "r1", "weights": [1, -3, -5, -2], "seq1": "ACGTACGTACGTACGT",
     "seq2": ["ACGT", "GATTACA"]},
    {"id": "r2", "weights": [1, -3, -5, -2], "seq1": "ACGTACGTACGTACGT",
     "seq2": ["TTTT"]},
]


def _fixture_request(path: Path) -> dict:
    tok = path.read_text().split()
    n = int(tok[5])
    return {"id": path.stem, "weights": [int(t) for t in tok[:4]], "seq1": tok[4],
            "seq2": tok[6:6 + n]}


def _requests() -> list[dict]:
    """Fixture-sized requests: every fixture problem but empty_batch (a
    request of no Seq2, which the JAX serve loop cannot answer) and the
    fleet chaos tier's two requests sharing one superblock."""
    fixtures = [p for p in sorted(FIX.glob("*.txt")) if p.stem != "empty_batch"]
    return [_fixture_request(p) for p in fixtures] + CHAOS_REQS


def _records(text: str, tolerant: bool = False) -> list[dict]:
    out = []
    for line in text.splitlines():
        if not line.strip():
            continue
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError:
            if not tolerant:  # a SIGKILLed coordinator's torn last line
                raise
    return out


def _by_id(records) -> dict:
    got: dict = {}
    for rec in records:
        got.setdefault(rec.get("id"), []).append(json.dumps(rec, sort_keys=True))
    return got


@pytest.fixture
def reqfile(tmp_path):
    path = tmp_path / "reqs.ndjson"
    path.write_text("".join(json.dumps(r) + "\n" for r in _requests()))
    return path


@pytest.fixture
def jax_fleetless(reqfile, capfd, monkeypatch):
    """The JAX package's fleetless ``--serve`` records of ``reqfile``."""
    monkeypatch.setenv("SEQALIGN_BACKOFF_BASE", "0")
    rc = jcli.run(["--serve", "--input", str(reqfile)])
    out = capfd.readouterr().out
    assert rc == 0
    return _by_id(_records(out))


def _env(tmp_path, **extra) -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith("SEQALIGN_")}
    env.update(JAX_PLATFORMS="cpu", SEQALIGN_BACKOFF_BASE="0",
               SEQALIGN_CACHE_DIR=str(tmp_path / "cache"), **extra)
    return env


def _cmd(package: str, *argv) -> list[str]:
    """One CLI process of ``package``; the port's scores on the CPU."""
    dev = ["--device", "cpu"] if package == "mpi_openmp_cuda_tpu_torch" else []
    return [sys.executable, "-m", package, *dev, *argv]


def _spawn(tmp_path, tag, cmd, **env):
    log = open(tmp_path / f"{tag}.log", "w")
    proc = subprocess.Popen(cmd, cwd=REPO, env=_env(tmp_path, **env),
                            stdout=log, stderr=subprocess.STDOUT)
    return proc, log


def _wait_registered(board: Path, n: int, timeout_s: float = 60.0) -> None:
    wdir = board / "seqalign" / "fleet" / "worker"
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if wdir.is_dir() and len([f for f in os.listdir(wdir)
                                  if not f.startswith(".tmp.")]) >= n:
            return
        time.sleep(0.05)
    raise AssertionError(f"{n} worker(s) never registered on {board}")


def _reap(proc, log, timeout_s: float = 30.0) -> int:
    try:
        rc = proc.wait(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        rc = proc.wait()
    log.close()
    return rc


def _fleet_run(tmp_path, reqfile, coordinator: str, worker: str):
    """A ``coordinator`` package's ``--serve --fleet-board`` over a
    ``worker`` package's ``--fleet-worker``: (coordinator records, its
    report, the worker's report, the worker's rc)."""
    board = tmp_path / "board"
    wrep, crep = tmp_path / "worker.json", tmp_path / "coord.json"
    proc, log = _spawn(tmp_path, "worker", _cmd(worker, "--fleet-worker", "--fleet-board",
                                                  str(board), "--metrics-out", str(wrep)))
    try:
        _wait_registered(board, 1)
        run = subprocess.run(
            _cmd(coordinator, "--serve", "--input", str(reqfile), "--fleet-board",
                 str(board), "--metrics-out", str(crep)),
            cwd=REPO, env=_env(tmp_path), capture_output=True, text=True, timeout=120)
    finally:
        wrc = _reap(proc, log)
    assert run.returncode == 0, run.stderr
    assert "Traceback" not in run.stderr
    assert "scoring locally" not in run.stderr  # every block went to the worker
    return (_records(run.stdout), json.loads(crep.read_text()),
            json.loads(wrep.read_text()), wrc)


def test_jax_coordinator_with_a_port_worker(tmp_path, reqfile, jax_fleetless):
    records, crep, wrep, wrc = _fleet_run(
        tmp_path, reqfile, "mpi_openmp_cuda_tpu", "mpi_openmp_cuda_tpu_torch")
    assert _by_id(records) == jax_fleetless
    assert wrc == 0
    assert crep["counters"]["fleet_joins"] == 1
    assert wrep["counters"]["fleet_scores_started"] >= 1
    assert "fleet_score_failures" not in wrep["counters"]


def test_port_coordinator_with_a_jax_worker(tmp_path, reqfile, jax_fleetless):
    records, crep, wrep, wrc = _fleet_run(
        tmp_path, reqfile, "mpi_openmp_cuda_tpu_torch", "mpi_openmp_cuda_tpu")
    assert _by_id(records) == jax_fleetless
    assert wrc == 0
    assert crep["counters"]["fleet_joins"] == 1
    assert wrep["counters"]["fleet_scores_started"] >= 1
    # A completed run leaves only the registry and the generation record.
    left = sorted(k.split("/")[2] for k in FileBoard(str(tmp_path / "board")).keys(""))
    assert set(left) <= {"worker", "hb", "leader", "leaderhb", "shutdown"}


def test_standby_takes_over_a_killed_port_coordinator(tmp_path, reqfile, jax_fleetless):
    """kill:fleet-coordinator at the coordinator's second board poll (its
    superblocks already offered, nothing answered); a port standby wins
    generation 1, replays the checkpoint and answers every request once."""
    board = tmp_path / "board"
    fleet_env = {"SEQALIGN_LEASE_S": "2", "SEQALIGN_FLEET_WORKERS": "1"}
    worker, wlog = _spawn(tmp_path, "worker", _cmd(
        "mpi_openmp_cuda_tpu_torch", "--fleet-worker", "--fleet-board", str(board)),
        **fleet_env)
    srep = tmp_path / "standby.json"
    sout = open(tmp_path / "standby.ndjson", "w+")
    standby = subprocess.Popen(
        _cmd("mpi_openmp_cuda_tpu_torch", "--fleet-standby", "--fleet-board", str(board),
             "--metrics-out", str(srep)),
        cwd=REPO, env=_env(tmp_path, **fleet_env), stdout=sout, stderr=subprocess.PIPE,
        text=True)
    try:
        _wait_registered(board, 1)
        run = subprocess.run(
            _cmd("mpi_openmp_cuda_tpu_torch", "--serve", "--input", str(reqfile),
                 "--fleet-board", str(board), "--faults",
                 "kill:fleet-coordinator:fail=1,after=1"),
            cwd=REPO, env=_env(tmp_path, **fleet_env), capture_output=True, text=True,
            timeout=120)
        _, serr = standby.communicate(timeout=120)
    finally:
        if standby.poll() is None:
            standby.kill()
        wrc = _reap(worker, wlog)
    assert run.returncode == -signal.SIGKILL
    assert standby.returncode == 0, serr
    assert "took over as leader gen 1" in serr and "Traceback" not in serr
    sout.seek(0)
    got = _by_id(_records(run.stdout, tolerant=True) + _records(sout.read()))
    sout.close()
    assert got == jax_fleetless
    assert wrc == 0
    rep = json.loads(srep.read_text())
    assert rep["gauges"]["fleet_leader_epoch"] == 1
    assert rep["counters"]["fleet_takeovers"] == 1


def test_offer_the_board_cannot_take_is_scored_on_the_coordinator(capfd):
    """Where the port departs from the JAX loop: an offer whose post fails
    (ENOSPC) escapes the JAX loop's dispatch and ends the run, against the
    fleet's own contract that the quarantine ladder scores such a block;
    the port scores it on the coordinator, once."""
    from mpi_openmp_cuda_tpu_torch.io.pipeline import ChunkPipeline
    from mpi_openmp_cuda_tpu_torch.ops.dispatch import AlignmentScorer
    from mpi_openmp_cuda_tpu_torch.resilience.degrade import BackendDegrader
    from mpi_openmp_cuda_tpu_torch.resilience.policy import RetryPolicy
    from mpi_openmp_cuda_tpu_torch.serve.loop import ServeLoop

    class SickBoard(MemoryBoard):
        def post(self, key, value):
            if "/offer/" in key:
                raise OSError(28, "No space left on device")
            super().post(key, value)

    class Sink:
        def __init__(self):
            self.records = []

        def send(self, obj):
            self.records.append(obj)

    def serve(with_fleet: bool):
        policy = RetryPolicy()
        deg = BackendDegrader(AlignmentScorer("cuda", device="cpu"),
                              lambda b: AlignmentScorer(b, device="cpu"))
        loop = ServeLoop(ChunkPipeline(policy, deg), policy, window_s=0.0)
        if with_fleet:
            board = SickBoard()
            loop.fleet = FleetCoordinator(board, local_score=loop._fleet_fallback,
                                          demux=loop._demux, poll_s=1e-4, lease_s=60.0)
            enlist(board, "w1")
            loop.fleet.pump()
            assert loop.fleet.accepting()
        sink = Sink()
        for raw in CHAOS_REQS:
            loop.ingest(json.dumps(raw), sink)
        while loop.tick():
            pass
        return sink.records, loop

    records, loop = serve(True)
    assert records == serve(False)[0]
    assert loop.fleet.outstanding() == 0
    assert "fleet offer failed to post" in capfd.readouterr().err

    from mpi_openmp_cuda_tpu.io.pipeline import ChunkPipeline as JChunkPipeline
    from mpi_openmp_cuda_tpu.ops.dispatch import AlignmentScorer as JScorer
    from mpi_openmp_cuda_tpu.resilience.degrade import BackendDegrader as JDegrader
    from mpi_openmp_cuda_tpu.resilience.policy import RetryPolicy as JPolicy
    from mpi_openmp_cuda_tpu.resilience.rescue import MemoryBoard as JBoard
    from mpi_openmp_cuda_tpu.serve.fleet import FleetCoordinator as JCoordinator
    from mpi_openmp_cuda_tpu.serve.loop import ServeLoop as JLoop

    class JSickBoard(JBoard):
        def post(self, key, value):
            if "/offer/" in key:
                raise OSError(28, "No space left on device")
            super().post(key, value)

    policy = JPolicy()
    jloop = JLoop(JChunkPipeline(policy, JDegrader(JScorer(), JScorer)), policy,
                  window_s=0.0)
    board = JSickBoard()
    jloop.fleet = JCoordinator(board, local_score=jloop._fleet_fallback,
                               demux=jloop._demux, poll_s=1e-4, lease_s=60.0)
    enlist(board, "w1")
    jloop.fleet.pump()
    for raw in CHAOS_REQS:
        jloop.ingest(json.dumps(raw), Sink())
    with pytest.raises(OSError, match="No space left"):
        jloop.tick()


def test_fleet_worker_without_a_card_exits_65(tmp_path, monkeypatch, capfd):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("SEQALIGN_CACHE_DIR", str(tmp_path / "cache"))
    rc = tcli.run(["--fleet-worker", "--fleet-board", str(tmp_path / "board")])
    captured = capfd.readouterr()
    assert rc == 65 and captured.out == ""
    assert "no CUDA device" in captured.err
    assert not (tmp_path / "board" / "seqalign" / "fleet" / "worker").exists()


def test_fleet_worker_exit_code_is_the_cli_exit_code(tmp_path, monkeypatch, capfd):
    """The worker's own exit code is the CLI's, as in the JAX CLI."""
    from mpi_openmp_cuda_tpu_torch.serve import fleet as tfleet
    from mpi_openmp_cuda_tpu_torch.serve import loop as tloop

    monkeypatch.setenv("SEQALIGN_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setattr(tloop, "warm_kernels", lambda deg: None)
    monkeypatch.setattr(tfleet, "run_fleet_worker", lambda args, timer, policy, deg: 3)
    rc = tcli.run(["--fleet-worker", "--fleet-board", str(tmp_path / "board"),
                   "--device", "cpu"])
    assert rc == 3 and capfd.readouterr().out == ""


@pytest.mark.gpu
def test_fleet_worker_on_a_card_launches_the_fused_kernel():
    """On a card a FleetWorker's superblock goes through fused_scorer,
    each launch equal to its plain version, and its rows are the
    coordinator's answer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from mpi_openmp_cuda_tpu_torch.io.pipeline import ChunkPipeline
    from mpi_openmp_cuda_tpu_torch.ops import cuda_scorer as cs
    from mpi_openmp_cuda_tpu_torch.ops import dispatch
    from mpi_openmp_cuda_tpu_torch.ops.dispatch import AlignmentScorer
    from mpi_openmp_cuda_tpu_torch.ops.oracle import prefix_best
    from mpi_openmp_cuda_tpu_torch.resilience.degrade import BackendDegrader
    from mpi_openmp_cuda_tpu_torch.resilience.policy import RetryPolicy

    seen = []
    real = cs.fused_scorer

    def fused(state, *finished):
        fresh = (finished[0].clone(), *finished[1:]) if finished else ()
        want = cs.fused_scorer_plain(state, *fresh)
        got = real(state, *finished)
        assert torch.equal(got, want)
        seen.append(state)
        return got

    rng = np.random.default_rng(5)
    block = Block(n_rows=8)
    block.seq1_codes = rng.integers(0, 26, size=600).astype(np.int8)
    block.codes = [rng.integers(0, 26, size=int(n)).astype(np.int8)
                   for n in rng.integers(130, 400, size=8)]
    board, clock = MemoryBoard(), FakeClock()
    coord, collected, fallback = make_coordinator(board, clock)
    policy = RetryPolicy()
    deg = BackendDegrader(AlignmentScorer("cuda", device="cuda"),
                          lambda b: AlignmentScorer(b, device="cuda"))
    worker = FleetWorker(board, ChunkPipeline(policy, deg), policy, FakeClock())
    worker.wid = "wa"
    worker.register()
    worker.heartbeat()
    tick(coord, clock)
    coord.offer(block)
    dispatch.fused_scorer = fused
    try:
        assert worker.step() is True
    finally:
        dispatch.fused_scorer = real
    tick(coord, clock)
    assert seen and fallback == []
    [(rows, _)] = collected
    want = [prefix_best(block.seq1_codes, c, block.weights) for c in block.codes]
    assert [tuple(int(x) for x in r) for r in rows] == want
