"""The port's concurrency verification plane (``mpi_openmp_cuda_tpu_torch/
analysis/{lockgraph,interleave}.py``), case by case against
``tests/test_concurrency.py``; the real tree and the explorer's schedule
counts pinned in ``tests/golden/torch_concurrency_audit.json``
(``scripts/torch_concurrency_audit.py``).  One interleaving run is shared
by the tests that read it.

Three surfaces:

* ``analysis/lockgraph.py`` — seeded snippet trees prove each finding
  kind fires (ordering cycle, blocking-while-locked, cross-class
  acquire/release), and the REAL tree is pinned clean with exactly the
  one blessed ordering edge (queue -> admission controller).
* ``analysis/interleave.py`` — the committed scenarios explore >1000
  schedules with zero invariant violations, and a seeded fencing bug
  (an ``admits`` that ignores the epoch — exactly the bug the lease
  epoch fence exists to stop) is demonstrably caught.
* ``MemoryBoard.claim`` / ``FileBoard.claim`` — N threads race one
  lease key; the single-winner contract must hold on both boards with
  no ``.tmp.`` debris left behind.
"""

from __future__ import annotations

import textwrap
import threading

import pytest

from mpi_openmp_cuda_tpu_torch.analysis import InterleaveViolation, LockGraphError
from mpi_openmp_cuda_tpu_torch.analysis import interleave, lockgraph
from mpi_openmp_cuda_tpu_torch.resilience.rescue import FileBoard, MemoryBoard


def _audit_snippets(tmp_path, files: dict[str, str]) -> dict:
    """Write a snippet package tree and run the lock-graph audit on it."""
    root = tmp_path / "pkg"
    for rel, source in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(source))
    return lockgraph.audit_lock_graph(root)


class TestLockGraphSeeded:
    def test_lock_order_cycle(self, tmp_path):
        report = _audit_snippets(
            tmp_path,
            {
                "serve/ab.py": """
                import threading

                class A:
                    def __init__(self):
                        self._lock = threading.Lock()
                        self._b = B()

                    def hit(self):
                        with self._lock:
                            self._b.poke()

                    def poke(self):
                        with self._lock:
                            pass

                class B:
                    def __init__(self):
                        self._lock = threading.Lock()
                        self._a = A()

                    def hit(self):
                        with self._lock:
                            self._a.poke()

                    def poke(self):
                        with self._lock:
                            pass
                """,
            },
        )
        kinds = {f["kind"] for f in report["findings"]}
        assert "lock-order-cycle" in kinds, report["findings"]

    def test_blocking_reachable_while_locked(self, tmp_path):
        # The finding must fire TRANSITIVELY: the blocking open() sits
        # two calls below the locked region.
        report = _audit_snippets(
            tmp_path,
            {
                "serve/q.py": """
                import threading

                class Q:
                    def __init__(self):
                        self._cond = threading.Condition()
                        self._n = 0

                    def submit(self):
                        with self._cond:
                            self._n += 1
                            self._emit()

                    def _emit(self):
                        self._write()

                    def _write(self):
                        with open("/tmp/x", "w") as fh:
                            fh.write("x")
                """,
            },
        )
        kinds = {f["kind"] for f in report["findings"]}
        assert "blocking-while-locked" in kinds, report["findings"]

    def test_cross_class_acquire_release(self, tmp_path):
        report = _audit_snippets(
            tmp_path,
            {
                "serve/split.py": """
                import threading

                class Owner:
                    def __init__(self):
                        self._lock = threading.Lock()

                    def take(self):
                        self._lock.acquire()

                class Thief:
                    def __init__(self):
                        self._owner = Owner()

                    def free(self):
                        self._owner._lock.release()
                """,
            },
        )
        kinds = {f["kind"] for f in report["findings"]}
        assert "split-acquire-release" in kinds, report["findings"]

    def test_clean_tree_is_clean(self, tmp_path):
        report = _audit_snippets(
            tmp_path,
            {
                "serve/ok.py": """
                import threading

                class OK:
                    def __init__(self):
                        self._cond = threading.Condition()
                        self._items = []

                    def push(self, x):
                        with self._cond:
                            self._items.append(x)
                            self._cond.notify_all()
                """,
            },
        )
        assert report["findings"] == []
        assert "serve/ok.py:OK._cond" in report["locks"]

    def test_run_or_raise_lists_findings(self, tmp_path):
        root = tmp_path / "pkg"
        (root / "serve").mkdir(parents=True)
        (root / "serve" / "bad.py").write_text(
            textwrap.dedent(
                """
                import threading

                class Bad:
                    def __init__(self):
                        self._lock = threading.Lock()

                    def hit(self):
                        with self._lock:
                            with open("/tmp/x") as fh:
                                return fh.read()
                """
            )
        )
        with pytest.raises(LockGraphError) as ei:
            lockgraph.run_or_raise(root)
        assert "blocking-while-locked" in str(ei.value)


class TestLockGraphRealTree:
    def test_real_tree_zero_findings(self):
        report = lockgraph.audit_lock_graph()
        assert report["findings"] == [], report["findings"]

    def test_real_tree_edge_inventory_is_pinned(self):
        # The regression pin for the PR's hoist fixes: the ONLY nesting
        # left is the documented queue -> admission-controller edge.
        # RequestQueue.submit publishing under _cond (the flight
        # recorder's dump I/O beneath the serve lock) and the watchdog
        # monitor publishing under _cond would each re-add an edge (or
        # a finding) here.
        report = lockgraph.audit_lock_graph()
        edges = {(e["src"], e["dst"]) for e in report["edges"]}
        assert edges == {
            (
                "serve/queue.py:RequestQueue._cond",
                "serve/slo.py:AdmissionController._lock",
            )
        }, report["edges"]

    def test_real_tree_lock_inventory_names_the_serve_locks(self):
        report = lockgraph.audit_lock_graph()
        locks = set(report["locks"])
        for expected in (
            "serve/queue.py:RequestQueue._cond",
            "serve/session.py:Responder._lock",
            "obs/flightrec.py:FlightRecorder._lock",
            "obs/trace.py:TraceRecorder._lock",
            "resilience/watchdog.py:Watchdog._cond",
        ):
            assert expected in locks, sorted(locks)


@pytest.fixture(scope="module")
def committed():
    """One run of the committed scenarios, shared by the tests below."""
    return interleave.run_or_raise()


class TestInterleaveCommitted:
    def test_committed_scenarios_clean_and_exhaustive(self, committed):
        report = committed
        assert report["total_schedules"] > 1000
        for row in report["scenarios"]:
            assert row["violations"] == [], row
            assert row["schedules"] > 0

    def test_schedule_count_is_pinned(self, committed):
        import json
        from pathlib import Path

        golden = json.loads(
            (Path(__file__).parent / "golden" / "torch_concurrency_audit.json").read_text())
        assert committed["total_schedules"] == golden["total_schedules"] == 30351
        assert [(r["name"], r["schedules"]) for r in committed["scenarios"]] == [
            (r["name"], r["schedules"]) for r in golden["scenarios"]]

    def test_audit_script_matches_its_golden(self, committed):
        # scripts/torch_concurrency_audit.py's gate, on the shared run.
        import importlib.util
        import json
        from pathlib import Path

        root = Path(__file__).resolve().parent.parent
        spec = importlib.util.spec_from_file_location(
            "torch_concurrency_audit", root / "scripts" / "torch_concurrency_audit.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        report = mod.build_report(committed)
        golden = json.loads(Path(mod.GOLDEN_PATH).read_text())
        assert mod.check(report, golden) == []
        assert golden["edges"] == [
            "serve/queue.py:RequestQueue._cond -> serve/slo.py:AdmissionController._lock"]
        # 11 locks: the feed's FeedRing._lock (ops/feed.py) is a leaf.
        assert len(golden["locks"]) == 11 and golden["findings"] == 0

    def test_seeded_fencing_bug_is_caught(self):
        # The acceptance bug: an `admits` that checks lease EXISTENCE
        # but ignores the epoch.  The zombie re-post (stale payload at
        # the current result key) must then be demuxed, and the
        # fenced-epoch invariant must catch it with a replayable
        # schedule.
        stats = interleave.explore(
            interleave.FleetScenario(
                "seeded-fencing-bug",
                workers=1,
                stale=True,
                lease_ticks=1,
                seed_admit_bug=True,
            ),
            6,
        )
        assert stats["violations"], "seeded fencing bug went undetected"
        msg = stats["violations"][0]
        assert "fenced-epoch" in msg
        assert "schedule=" in msg  # the counterexample replays

    def test_seeded_bug_raises_through_run_or_raise_path(self):
        # Same bug surfaced the way the analyze driver would see it.
        scenario = interleave.FleetScenario(
            "seeded", workers=1, stale=True, lease_ticks=1,
            seed_admit_bug=True,
        )
        stats = interleave.explore(scenario, 6)
        with pytest.raises(InterleaveViolation):
            if stats["violations"]:
                raise InterleaveViolation(stats["violations"][0])

    def test_queue_scenario_catches_lost_admit(self):
        # Sanity that the queue invariants have teeth: drop a popped
        # request on the floor and the exactly-once check must fire.
        scenario = interleave.QueueScenario("queue-lossy")
        orig = scenario.execute

        def lossy(state, ev):
            if ev == "pop":
                state["queue"].pop_ready(0.0, 0.0)  # popped, not recorded
                return
            orig(state, ev)

        scenario.execute = lossy
        stats = interleave.explore(scenario, 4)
        assert stats["violations"], "dropped reply went undetected"
        assert "delivered 0" in stats["violations"][0]


def _race_claim(board, key: str, n_threads: int = 16) -> list[str]:
    """Race ``n_threads`` claimers on one key; return the winner ids."""
    start = threading.Barrier(n_threads)
    wins: list[str] = []
    wins_lock = threading.Lock()

    def worker(wid: str) -> None:
        start.wait()
        if board.claim(key, wid):
            with wins_lock:
                wins.append(wid)

    threads = [
        threading.Thread(target=worker, args=(f"w{i}",))
        for i in range(n_threads)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return wins


class TestConcurrentClaimers:
    @pytest.mark.parametrize("round_", range(8))
    def test_memory_board_single_winner(self, round_):
        board = MemoryBoard()
        wins = _race_claim(board, f"lease/b{round_}/e0")
        assert len(wins) == 1, wins
        # The winner's value is what landed (no torn/overwritten claim).
        assert board.get(f"lease/b{round_}/e0") == wins[0]

    @pytest.mark.parametrize("round_", range(4))
    def test_file_board_single_winner_no_debris(self, tmp_path, round_):
        board = FileBoard(str(tmp_path / "board"))
        wins = _race_claim(board, f"lease/b{round_}/e0")
        assert len(wins) == 1, wins
        assert board.get(f"lease/b{round_}/e0") == wins[0]
        # Losing claimers must clean their tmp files: .tmp. debris is
        # exactly what the keys()/get() torn-post filters skip, and a
        # leak per lost race would grow the board forever.
        debris = [
            p
            for p in (tmp_path / "board").rglob("*")
            if p.is_file() and ".tmp." in p.name
        ]
        assert debris == [], debris

    def test_losers_see_existing_claim(self):
        board = MemoryBoard()
        assert board.claim("k", "first") is True
        assert board.claim("k", "second") is False
        assert board.get("k") == "first"
