"""The port's lost-shard rescue tier against the contract
``tests/test_survival.py`` pins for the JAX package's (its rescue tests,
on the port's modules): the contiguous shard ledger, torn shard posts read
as lost, every rank alive == the oracle, and a lost rank's shard rescored
on the coordinator.

Then what is the port's own: the ``StoreBoard`` on a ``torch.distributed``
TCP store (post, a get whose deadline passes, the claim race, delete), the
rescue over that store with a rank that never posts, the same seeded
inputs with a lost rank through both packages' ``scatter_gather_rescue``
(equal rows, equal to the oracle), and a two-process ``--distributed`` job
with ``SEQALIGN_BEACON_S`` set printing the goldens.
"""

from __future__ import annotations

import datetime
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch.distributed as tdist_mod

from mpi_openmp_cuda_tpu.ops.oracle import prefix_best
from mpi_openmp_cuda_tpu.parallel import distributed as jdist
from mpi_openmp_cuda_tpu.resilience import rescue as jrescue
from mpi_openmp_cuda_tpu.resilience.policy import RetryPolicy as JRetryPolicy
from mpi_openmp_cuda_tpu_torch.io.parse import load_problem
from mpi_openmp_cuda_tpu_torch.ops import _build
from mpi_openmp_cuda_tpu_torch.ops import cuda_scorer as cs
from mpi_openmp_cuda_tpu_torch.ops.dispatch import AlignmentScorer
from mpi_openmp_cuda_tpu_torch.parallel import distributed as dist
from mpi_openmp_cuda_tpu_torch.resilience import rescue
from mpi_openmp_cuda_tpu_torch.resilience.policy import KernelUnavailableError, RetryPolicy

REPO = Path(__file__).resolve().parent.parent
FIX = REPO / "tests" / "fixtures"


@pytest.fixture(autouse=True)
def _quiet_env(monkeypatch):
    monkeypatch.setenv("SEQALIGN_BACKOFF_BASE", "0")
    for var in ("SEQALIGN_DEADLINE_S", "SEQALIGN_DRAIN", "SEQALIGN_BEACON_S"):
        monkeypatch.delenv(var, raising=False)


def _oracle_rows(seq1, seqs, weights) -> np.ndarray:
    return np.asarray([prefix_best(seq1, q, weights) for q in seqs], dtype=np.int32)


# -- the JAX package's rescue tests, on the port ----------------------------


def test_shard_index_sets_contiguous_balanced():
    assert rescue.shard_index_sets(7, 3) == [[0, 1, 2], [3, 4], [5, 6]]
    assert rescue.shard_index_sets(4, 4) == [[0], [1], [2], [3]]
    assert rescue.shard_index_sets(2, 4) == [[0], [1], [], []]
    assert rescue.shard_index_sets(0, 2) == [[], []]
    ledger = rescue.shard_index_sets(103, 5)
    assert [i for part in ledger for i in part] == list(range(103))
    sizes = [len(p) for p in ledger]
    assert max(sizes) - min(sizes) <= 1
    with pytest.raises(ValueError, match=">= 1 worker"):
        rescue.shard_index_sets(10, 0)
    for total, parts in ((7, 3), (103, 5), (1, 8), (64, 2)):
        assert rescue.shard_index_sets(total, parts) == jrescue.shard_index_sets(total, parts)


def test_fetch_shard_rejects_torn_posts():
    board = rescue.MemoryBoard()
    assert rescue.fetch_shard(board, "r", 1, 3) is None  # no beacon: lost
    board.post("seqalign/r/beacon/1", "scored")
    assert rescue.fetch_shard(board, "r", 1, 3) is None  # beacon, no rows
    board.post("seqalign/r/rows/1", "[[1, 2")  # torn JSON
    assert rescue.fetch_shard(board, "r", 1, 3) is None
    board.post("seqalign/r/rows/1", json.dumps([[1, 2, 3]]))  # wrong shape
    assert rescue.fetch_shard(board, "r", 1, 3) is None
    rows = [[1, 2, 3], [4, 5, 6], [7, 8, 9]]
    board.post("seqalign/r/rows/1", json.dumps(rows))
    np.testing.assert_array_equal(
        rescue.fetch_shard(board, "r", 1, 3), np.asarray(rows, np.int32)
    )


def _rescue_problem():
    return load_problem(str(FIX / "stress_small.txt"))


def _kw(board, **extra):
    return dict(policy=RetryPolicy(retries=0), beacon_s=0.1, board=board,
                num_processes=3, backend="cuda", device="cpu", **extra)


def test_rescue_all_workers_alive_matches_oracle():
    problem = _rescue_problem()
    want = AlignmentScorer(backend="oracle").score_codes(
        problem.seq1_codes, problem.seq2_codes, problem.weights
    )
    board = rescue.MemoryBoard()
    # The other ranks post first; they return None and print nothing.
    for pid in (1, 2):
        assert dist.scatter_gather_rescue(
            problem.seq1_codes, problem.seq2_codes, problem.weights,
            process_id=pid, **_kw(board)) is None
    out = dist.scatter_gather_rescue(
        problem.seq1_codes, problem.seq2_codes, problem.weights, process_id=0, **_kw(board))
    np.testing.assert_array_equal(out, want)


def test_rescue_lost_worker_rescored_on_coordinator():
    problem = _rescue_problem()
    want = AlignmentScorer(backend="oracle").score_codes(
        problem.seq1_codes, problem.seq2_codes, problem.weights
    )
    board = rescue.MemoryBoard()
    warnings = []
    # Rank 1 posts; rank 2 died before posting (absence on a MemoryBoard
    # IS a missed beacon deadline, deterministically).
    dist.scatter_gather_rescue(problem.seq1_codes, problem.seq2_codes, problem.weights,
                               process_id=1, **_kw(board, log=warnings.append))
    out = dist.scatter_gather_rescue(problem.seq1_codes, problem.seq2_codes,
                                     problem.weights, process_id=0,
                                     **_kw(board, log=warnings.append))
    np.testing.assert_array_equal(out, want)
    assert any("worker(s) [2]" in w for w in warnings)  # names the lost one
    lost_idx = rescue.shard_index_sets(problem.num_seq2, 3)[2]
    assert any(str(len(lost_idx)) in w and "orphan" in w for w in warnings)


@pytest.fixture
def broken_build(monkeypatch, tmp_path):
    """Kernel launches on CPU tensors go to the kernel, and its build
    fails: nvcc is ``false``, which exits 1."""
    monkeypatch.setattr(cs, "_device_of", lambda state: "cuda")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")
    monkeypatch.setattr(_build, "_libs", {})
    cs._entry.cache_clear()
    yield
    cs._entry.cache_clear()


def test_rescue_kernel_failure_raises(broken_build):
    """The coordinator's rescue of a lost shard does not step to a plain
    backend when its kernel fails: the failure ends the run (the CLI's
    65), as on the batch path."""
    problem = _rescue_problem()
    with pytest.raises(KernelUnavailableError, match="kernel build failed"):
        rescue.rescue_orphans(problem.seq1_codes, problem.seq2_codes[:5], problem.weights,
                              policy=RetryPolicy(retries=2), backend="cuda", device="cpu")


# -- the StoreBoard on a torch.distributed TCP store -------------------------


@pytest.fixture
def store():
    return tdist_mod.TCPStore("127.0.0.1", 0, 1, True,
                              timeout=datetime.timedelta(seconds=30))


def test_store_board_post_get_delete(store):
    board = rescue.StoreBoard(store, timeout_s=5.0)
    board.post("seqalign/r/beacon/0", "scored")
    assert board.get("seqalign/r/beacon/0") == "scored"
    board.post("seqalign/r/beacon/0", "rewritten")  # post overwrites
    assert board.get("seqalign/r/beacon/0", timeout_s=0.1) == "rewritten"
    board.delete("seqalign/r/beacon/0")
    assert board.get("seqalign/r/beacon/0", timeout_s=0.1) is None
    board.delete("seqalign/r/beacon/0")  # deleting a missing key: no-op
    board.post("k", "")  # zero-length reads as missing
    assert board.get("k", timeout_s=0.1) is None
    with pytest.raises(NotImplementedError, match="FileBoard"):
        board.keys("seqalign/")
    with pytest.raises(ValueError, match="> 0"):
        rescue.StoreBoard(store, timeout_s=0)


def test_store_board_get_returns_missing_when_the_deadline_passes(store):
    board = rescue.StoreBoard(store, timeout_s=0.2)
    t0 = time.monotonic()
    assert board.get("seqalign/r/beacon/1") is None
    waited = time.monotonic() - t0
    assert 0.15 <= waited < 5.0
    # A key another client posts while the reader waits is read whole.
    writer = tdist_mod.TCPStore("127.0.0.1", store.port, 1, False,
                                timeout=datetime.timedelta(seconds=30))
    threading.Timer(0.1, lambda: writer.set("seqalign/r/beacon/2", "scored")).start()
    assert board.get("seqalign/r/beacon/2", timeout_s=5.0) == "scored"


def test_store_board_claim_has_exactly_one_winner(store):
    board = rescue.StoreBoard(store, timeout_s=5.0)
    wins = []
    gate = threading.Barrier(8)

    def racer(i):
        gate.wait(5)
        if board.claim("seqalign/fleet/claim/b1/e0", json.dumps({"wid": f"w{i}"})):
            wins.append(i)

    threads = [threading.Thread(target=racer, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert len(wins) == 1
    assert json.loads(board.get("seqalign/fleet/claim/b1/e0")) == {"wid": f"w{wins[0]}"}
    assert board.claim("seqalign/fleet/claim/b1/e0", "late") is False
    board.delete("seqalign/fleet/claim/b1/e0")
    assert board.claim("seqalign/fleet/claim/b1/e0", "after-delete") is True


def test_rescue_over_the_store_with_a_rank_that_never_posts(store):
    problem = _rescue_problem()
    board = rescue.StoreBoard(store, timeout_s=0.3)
    warnings = []
    kw = dict(policy=RetryPolicy(retries=0), beacon_s=0.3, board=board, num_processes=2,
              backend="cuda", device="cpu", log=warnings.append)
    out = dist.scatter_gather_rescue(problem.seq1_codes, problem.seq2_codes,
                                     problem.weights, process_id=0, **kw)
    np.testing.assert_array_equal(
        out, _oracle_rows(problem.seq1_codes, problem.seq2_codes, problem.weights))
    assert any("worker(s) [1]" in w for w in warnings)


# -- both packages over the same seeded inputs -------------------------------


@pytest.mark.parametrize("seed", [2, 19])
def test_port_and_jax_rescue_agree_with_a_lost_rank(seed):
    rng = np.random.default_rng(seed)
    seq1 = rng.integers(1, 27, size=int(rng.integers(120, 300))).astype(np.int8)
    seqs = [rng.integers(1, 27, size=int(n)).astype(np.int8)
            for n in rng.integers(1, 140, size=13)]
    weights = [int(w) for w in rng.integers(1, 12, size=4)]
    lost = 2  # of four ranks: never posts
    got = {}
    for name, mod, board, policy, backend in (
        ("port", dist, rescue.MemoryBoard(), RetryPolicy(retries=0), "cuda"),
        ("jax", jdist, jrescue.MemoryBoard(), JRetryPolicy(retries=0), "xla"),
    ):
        kw = dict(policy=policy, beacon_s=0.1, board=board, num_processes=4,
                  backend=backend, log=lambda _msg: None)
        if mod is dist:
            kw["device"] = "cpu"
        for pid in (1, 3):
            assert mod.scatter_gather_rescue(seq1, seqs, weights, process_id=pid, **kw) is None
        got[name] = mod.scatter_gather_rescue(seq1, seqs, weights, process_id=0, **kw)
        assert board.get(f"seqalign/batch0/beacon/{lost}") is None
    np.testing.assert_array_equal(got["port"], got["jax"])
    np.testing.assert_array_equal(got["port"], _oracle_rows(seq1, seqs, weights))


# -- a two-process job with the beacon tier ----------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("mesh", [[], ["--mesh", "2"]], ids=["batch", "mesh2"])
def test_two_process_beacon_job_prints_the_golden(mesh, tmp_path):
    """Rank 0 prints the golden and rank 1 nothing; rank 0's report holds
    rank 1's host snapshot, which only the beacon tier's store board
    carries between the processes (the collective path posts none)."""
    text = (FIX / "stress_small.txt").read_text()
    reports = [tmp_path / f"rank{rank}.json" for rank in range(2)]
    for _ in range(3):  # a fresh port when the chosen one was taken meanwhile
        port = _free_port()
        procs = []
        for rank in range(2):
            env = {k: v for k, v in os.environ.items() if not k.startswith("SEQALIGN_")}
            env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2",
                       RANK=str(rank), LOCAL_RANK=str(rank), SEQALIGN_BACKOFF_BASE="0",
                       SEQALIGN_BEACON_S="30")
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "mpi_openmp_cuda_tpu_torch", "--device", "cpu",
                 "--distributed", *mesh, "--metrics-out", str(reports[rank])],
                stdin=subprocess.PIPE if rank == 0 else subprocess.DEVNULL,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
                env=env))
        outs = []
        try:
            for rank, p in enumerate(procs):
                outs.append((*p.communicate(input=text if rank == 0 else None,
                                            timeout=120), p.returncode))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        if not any("address already in use" in err.lower() for _, err, _ in outs):
            break
    (out0, err0, rc0), (out1, err1, rc1) = outs
    assert (rc0, rc1) == (0, 0), err0 + err1
    assert out0 == (FIX / "stress_small.out").read_text()
    assert out1 == ""
    assert "missed" not in err0  # no rank was lost
    hosts = json.loads(reports[0].read_text())["hosts"]
    assert sorted(hosts) == ["0", "1"]
    assert hosts["1"]["counters"] == json.loads(reports[1].read_text())["counters"]
