"""``scripts/torch_fleet_trace_smoke.py`` (the port's counterpart of
``scripts/fleet_trace_smoke.py``) on the CPU at the JAX drill's shapes,
and the two faults porting it exposed in the port's fleet plane:

* a superblock carried no ``link_traces`` (the JAX ``SuperBlock`` has
  it), so offers, worker launches and board-phase rows had no trace ids;
* the coordinator read a block's claim only while its result was
  missing, so a worker that claims, scores and posts within one board
  poll (every block on the card; every small block here) fed the
  clock-offset estimator nothing: no clock offsets, no merged per-worker
  track, a zero offer-to-claim phase.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from mpi_openmp_cuda_tpu.serve.batcher import SuperBlock as JaxSuperBlock
from mpi_openmp_cuda_tpu_torch.obs import arm_observability, disarm_observability
from mpi_openmp_cuda_tpu_torch.obs.trace import BOARD_PHASES, active_trace
from mpi_openmp_cuda_tpu_torch.resilience.membership import (
    claim_key,
    heartbeat_key,
    result_key,
    worker_key,
)
from mpi_openmp_cuda_tpu_torch.resilience.rescue import MemoryBoard
from mpi_openmp_cuda_tpu_torch.serve.batcher import SuperBlock
from mpi_openmp_cuda_tpu_torch.serve.fleet import FleetCoordinator

REPO = Path(__file__).resolve().parent.parent
SCRIPT = REPO / "scripts" / "torch_fleet_trace_smoke.py"


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fleet_trace_smoke")
    proc = subprocess.run([sys.executable, str(SCRIPT), "--device", "cpu", "--small"],
                          cwd=REPO, env={**os.environ, "TMPDIR": str(tmp)},
                          capture_output=True, text=True, timeout=300)
    return proc.returncode, proc.stdout.splitlines() + proc.stderr.splitlines()


def test_small_run_is_ok(drill):
    rc, lines = drill
    assert rc == 0, "\n".join(lines)
    assert [x for x in lines if x.startswith("fleet-trace-smoke: OK (")]


def test_record_shows_tracks_phases_and_registrations(drill):
    rec = next(json.loads(x) for x in drill[1] if x.startswith('{"board_phase_rows"'))
    assert rec["scenarios"] == {"fleet-trace": "ok"}
    assert rec["board_phase_rows"] >= 2 and rec["survivor_trace_launches"] >= 1
    assert rec["worker_tracks"] and all(t.startswith("seqalign-worker w")
                                        for t in rec["worker_tracks"])
    assert set(rec["registration_s"]) == {"survivor", "victim"}


def _tags(pairs):
    """Demux tags of (request id, trace id) rows, a pad row between."""
    tags = [(SimpleNamespace(id=rid, trace_id=tid), i) for i, (rid, tid) in enumerate(pairs)]
    return tags[:2] + [None] + tags[2:]


@pytest.mark.parametrize("pairs", [
    [("a", "t1"), ("a", "t1"), ("b", "t2")],
    [("a", ""), ("b", "t7"), ("c", "t3"), ("b", "t7")],
    [("a", "")],
])
def test_superblock_links_the_admission_trace_ids_as_jax_does(pairs):
    fields = dict(weights=[1, -3, -5, -2], seq1_codes=np.arange(4, dtype=np.int8),
                  codes=[np.ones(3, dtype=np.int8)] * (len(pairs) + 1), tags=_tags(pairs),
                  real_rows=len(pairs))
    port, jax = SuperBlock(**fields), JaxSuperBlock(**fields)
    assert port.link_traces() == jax.link_traces()
    assert port.link_ids() == jax.link_ids()


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def now(self):
        return self.t

    def block_until(self, cond, predicate, timeout_s):
        self.t += max(0.0, float(timeout_s))
        return predicate()


class Block:
    weights = [1, -3, -5, -2]
    seq1_codes = np.arange(4, dtype=np.int8)
    codes = [np.full(3, i, dtype=np.int8) for i in range(2)]

    def link_ids(self):
        return ["a", "b"]

    def link_traces(self):
        return ["t1", "t2"]


def test_claim_and_result_in_one_poll_still_feed_the_offset():
    """The worker claims, scores and posts between two board polls (a
    +100 s skewed clock): the coordinator still reads the claim echo
    before it demuxes, so the board-phase row carries a clock offset and
    the trace's ``clock_offsets`` names the worker."""
    arm_observability(lambda: 0.0, lambda: 0.0, with_trace=True, flightrec_depth=16)
    try:
        board, clock, collected = MemoryBoard(), FakeClock(), []
        coord = FleetCoordinator(board, local_score=lambda block: None,
                                 demux=lambda rows, block: collected.append(rows),
                                 clock=clock, lease_s=5.0, poll_s=1.0)
        board.post(worker_key("w1"), json.dumps({"wid": "w1", "pid": 1}))
        board.post(heartbeat_key("w1"), "1")
        clock.t += coord.poll_s
        coord.pump()
        bid = coord.offer(Block())
        board.claim(claim_key(bid, 0),
                    json.dumps({"wid": "w1", "epoch": 0, "t_claim": clock.t + 100.2}))
        board.post(result_key(bid, 0), json.dumps({
            "bid": bid, "epoch": 0, "wid": "w1", "rows": [[0, 0, 0], [1, 1, 1]],
            "traces": ["t1", "t2"], "t_score": clock.t + 100.3, "t_post": clock.t + 100.4}))
        clock.t += coord.poll_s
        coord.pump()
        assert len(collected) == 1
        assert coord.offsets.offset("w1") is not None
        ga = active_trace().gap_attribution()
        (row,) = ga["board_phases"]
        assert row["traces"] == ["t1", "t2"] and row["worker"] == "w1"
        assert isinstance(row["clock_offset_s"], float)
        assert set(row["phases"]) == set(BOARD_PHASES)
        assert "w1" in ga["clock_offsets"]
    finally:
        disarm_observability()


def test_without_a_card_it_exits_non_zero(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device can score")
    proc = subprocess.run([sys.executable, str(SCRIPT), "--small"], cwd=REPO,
                          env={**os.environ, "TMPDIR": str(tmp_path)},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1
    assert "no CUDA device is available" in proc.stderr
    assert proc.stdout == ""
