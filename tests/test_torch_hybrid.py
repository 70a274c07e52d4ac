"""Several mesh slots a process under ``--distributed``: the port's
counterpart of the JAX package's ``devices_per_proc=2`` jobs
(``tests/test_distributed.py``), where a process drives several devices
of one global mesh.

First the pure rules, in this process: the slot map (every process's
local slots, process-major), the owner map, the group plan of each mesh
form, the device rules on one, four and eight cards, the rescue tier's
one shard a process and the ``--check`` hook over every slot's shard.
Then ``gloo`` jobs on the CPU, each process given
``SEQALIGN_HOST_DEVICES=2`` slots: the batch, ring and 2-D meshes
against the goldens, Seq1 past the reference's cap against the oracle,
the partial-mesh and unequal-count refusals, a journal resume, each
slot's collective sequence against the one-process run's (straddling
rows included, three processes of two slots at ``2x3``), and a seeded
batch held to the JAX CLI's ``--mesh 2x2`` stdout byte for byte.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mpi_openmp_cuda_tpu.ops.oracle import prefix_best
from mpi_openmp_cuda_tpu_torch.analysis import collectives
from mpi_openmp_cuda_tpu_torch.io.parse import load_problem
from mpi_openmp_cuda_tpu_torch.models.encoding import decode
from mpi_openmp_cuda_tpu_torch.parallel import distributed as tdist
from mpi_openmp_cuda_tpu_torch.parallel import mesh as tmesh
from mpi_openmp_cuda_tpu_torch.parallel.comm import group_plan
from mpi_openmp_cuda_tpu_torch.resilience import rescue
from mpi_openmp_cuda_tpu_torch.resilience.policy import RetryPolicy
from test_torch_distributed import (
    FIX, REPO, TIMEOUT, _free_port, _gold, _job, _seed_batch_journal, _text,
    _assert_tampered,
)

CPU = torch.device("cpu")
TWO = {"SEQALIGN_HOST_DEVICES": "2"}


def _cuda(*idx):
    return [torch.device(f"cuda:{i}") for i in idx]


# -- the pure rules -------------------------------------------------------------


def _joined(monkeypatch, world: int, rank: int, k: int):
    """This process as rank ``rank`` of a ``world``-process job of ``k``
    slots a process, as ``mesh.py`` sees it."""
    monkeypatch.setattr(tmesh, "process_count", lambda: world)
    monkeypatch.setattr(tmesh, "process_index", lambda: rank)
    monkeypatch.setattr(tmesh, "slots_per_process", lambda: k)


@pytest.mark.parametrize("rank", [0, 1])
def test_slot_map_is_process_major(monkeypatch, rank):
    """Every process's local slots in rank order; this process's own
    devices in its slots, placeholders of the kind in the others."""
    monkeypatch.setenv("SEQALIGN_HOST_DEVICES", "2")
    _joined(monkeypatch, 2, rank, 2)
    assert tmesh.global_devices("cpu") == [CPU] * 4
    monkeypatch.setenv("LOCAL_RANK", str(rank))
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.delenv("SEQALIGN_HOST_DEVICES")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    mine = _cuda(2 * rank, 2 * rank + 1)
    other = [torch.device("cuda")] * 2
    assert tmesh.global_devices("cuda") == (mine + other if rank == 0 else other + mine)
    m = tmesh.make_mesh(device="cuda")
    assert m.size == 4 and m.processes == 2 and m.per_process == 2
    assert [m.device(s) for s in range(2 * rank, 2 * rank + 2)] == mine


def test_slot_map_refuses_a_count_other_than_the_jobs(monkeypatch):
    monkeypatch.setenv("SEQALIGN_HOST_DEVICES", "3")
    _joined(monkeypatch, 2, 0, 2)
    with pytest.raises(RuntimeError, match="drives 3 cpu slots, but the job agreed on 2"):
        tmesh.global_devices("cpu")


@pytest.mark.parametrize("processes, size, owners", [
    (1, 4, [0, 0, 0, 0]),
    (2, 2, [0, 1]),
    (2, 4, [0, 0, 1, 1]),
    (3, 6, [0, 0, 1, 1, 2, 2]),
    (4, 8, [0, 0, 1, 1, 2, 2, 3, 3]),
])
def test_owner_map(processes, size, owners):
    arr = np.empty(size, dtype=object)
    arr[:] = [CPU] * size
    m = tmesh.Mesh(arr, ("batch",), processes=processes)
    assert [m.owner(s) for s in range(size)] == owners


def _mesh(shape, processes):
    size = int(np.prod(shape))
    arr = np.empty(size, dtype=object)
    arr[:] = [CPU] * size
    names = ("batch",) if len(shape) == 1 else ("batch", "seq")
    return tmesh.Mesh(arr.reshape(shape), names, processes=processes)


@pytest.mark.parametrize("shape, processes, plan", [
    ((2,), 2, []),                    # --mesh 2, one slot a process
    ((4,), 2, []),                    # --mesh 4: no all_gather
    ((1, 4), 2, []),                  # seq:4 / 1x4: the row is the whole job
    ((2, 2), 2, []),                  # 2x2: each row on one process
    ((4, 1), 2, []),                  # 4x1: one-slot rows
    ((2, 2), 4, [(0, 1), (2, 3)]),    # 2x2 over four one-slot processes
    ((2, 4), 4, [(0, 1), (2, 3)]),    # 2x4 over four processes of two
    ((2, 3), 3, [(0, 1), (1, 2)]),    # straddling rows: shares 2+1 and 1+2
], ids=["2", "4", "seq:4", "2x2", "4x1", "2x2/4procs", "2x4/4procs", "2x3/3procs"])
def test_group_plan(shape, processes, plan):
    assert group_plan(_mesh(shape, processes)) == plan


@pytest.mark.parametrize("count, override, want, wire", [
    (1, None, [0], "gloo"),
    (1, "2", [0, 0], "gloo"),
    (4, None, [2, 3], "nccl"),
    (4, "3", [2, 3, 2], "nccl"),
    (8, None, [4, 5, 6, 7], "nccl"),
    (8, "2", [4, 5], "nccl"),
])
def test_device_rules(monkeypatch, count, override, want, wire):
    """Local rank 1 of two on a host of ``count`` cards: ``count // 2``
    cards from ``cuda:(1 * k)``, or ``SEQALIGN_HOST_DEVICES`` slots naming
    them in turn; ``nccl`` unless the processes share a card."""
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    if override is None:
        monkeypatch.delenv("SEQALIGN_HOST_DEVICES", raising=False)
    else:
        monkeypatch.setenv("SEQALIGN_HOST_DEVICES", override)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    assert tdist.local_devices("cuda") == _cuda(*want)
    assert tdist.local_device("cuda") == _cuda(want[0])[0]
    assert tdist.transport("cuda") == wire
    assert tdist.local_devices("cpu") == [CPU] * int(override or 1)


def test_rescue_posts_one_shard_a_process_of_two_slots(monkeypatch):
    """The beacon tier keeps one shard a process, scored on its first
    slot: two processes of two slots post two shards, not four, and rank
    0's rows are those of one slot a process."""
    problem = load_problem(str(FIX / "stress_small.txt"))
    args = (problem.seq1_codes, problem.seq2_codes, problem.weights)
    got = {}
    for slots in ("1", "2"):
        monkeypatch.setenv("SEQALIGN_HOST_DEVICES", slots)
        board = rescue.MemoryBoard()
        kw = dict(policy=RetryPolicy(retries=0), beacon_s=5.0, board=board,
                  num_processes=2, backend="cuda", device="cpu", log=lambda _m: None)
        assert tdist.scatter_gather_rescue(*args, process_id=1, **kw) is None
        assert board.keys("seqalign/batch0/rows/") == ["seqalign/batch0/rows/1"]
        got[slots] = tdist.scatter_gather_rescue(*args, process_id=0, **kw)
    np.testing.assert_array_equal(got["2"], got["1"])
    want = [prefix_best(problem.seq1_codes, q, problem.weights) for q in problem.seq2_codes]
    np.testing.assert_array_equal(got["2"], np.asarray(want, dtype=np.int32))


def test_check_hook_validates_every_slots_shard(monkeypatch):
    """``--check`` on a four-slot batch mesh validates all four shards of
    each launch group on every process, its own slots and the others', so a
    violation in any shard stops every rank before an upload."""
    from mpi_openmp_cuda_tpu_torch.analysis import contracts
    from mpi_openmp_cuda_tpu_torch.ops.dispatch import AlignmentScorer, launch_plans
    from mpi_openmp_cuda_tpu_torch.parallel.sharding import BatchSharding

    seen = []
    real = contracts.validate_launch
    monkeypatch.setattr(contracts, "validate_launch",
                        lambda **kw: seen.append(kw["lens"].copy()) or real(**kw))
    sh = BatchSharding.over_devices(devices=[CPU] * 4)
    problem = load_problem(str(FIX / "stress_small.txt"))
    pend = AlignmentScorer("cuda", device="cpu", sharding=sh, check=True).score_codes_async(
        problem.seq1_codes, problem.seq2_codes, problem.weights)
    pend.result()
    _, plans = launch_plans(problem.seq1_codes, problem.seq2_codes, problem.weights,
                            packable=False, min_rows=sh.min_rows, devices=sh.n_devices)
    assert len(seen) == 4 * len(plans)
    assert sum(int((lens > 0).sum()) for lens in seen) == sum(
        1 for c in problem.seq2_codes if c.size)


def test_hybrid_findings_name_a_divergent_slot():
    """The comms audit's hybrid form: the one-process run's own logs pass,
    a slot whose sequence lost its all_gather is named."""
    sh, _, _ = collectives.run_spec("2x2", [CPU] * 4)
    logs = {s: list(seq) for s, seq in sh.comm.slot_log.items()}
    assert collectives.hybrid_findings("2x2", logs) == []
    logs[3] = [op for op in logs[3] if op[0] != "all_gather"]
    found = collectives.hybrid_findings("2x2", logs)
    assert [f["kind"] for f in found] == ["hybrid-divergence"]
    assert "slot 3 issued" in found[0]["detail"]


# -- jobs of two processes of two slots over gloo ---------------------------------


def _ok(outs, want):
    (rc0, out0, err0), (rc1, out1, err1) = outs
    assert (rc0, rc1) == (0, 0), err0 + err1
    assert out0 == want
    assert out1 == ""
    return err0


@pytest.mark.parametrize("mesh, fixture", [
    ([], "mixedcase"),
    (["--mesh", "2x2"], "mixedcase"),
    (["--mesh", "seq:4", "--check"], "equal_len"),
], ids=["default", "2x2", "seq:4-check"])
def test_two_processes_of_two_slots_print_the_golden(mesh, fixture):
    """JAX ``test_two_process_job_coordinator_prints_worker_silent``
    (``devices_per_proc=2``), ``test_two_process_2d_mesh_golden`` and the
    ring across processes (under ``--check``: every ring window
    validated): four global slots, rank 0 prints the golden, rank 1
    nothing."""
    err0 = _ok(_job(*mesh, stdin=_text(fixture), extra=TWO), _gold(fixture))
    assert "2 processes x 2 slots" in err0 and "transport gloo" in err0


def test_ring_past_the_cap_over_four_slots(tmp_path):
    """JAX ``test_two_process_ring_long_context_beyond_cap``'s Seq1 3600
    at ``seq:4`` over two processes of two slots: each slot holds a
    quarter of Seq1, rank 0's rows == the JAX oracle."""
    rng = np.random.default_rng(42)
    seq1 = rng.integers(1, 27, size=3600).astype(np.int8)
    seqs = [rng.integers(1, 27, size=n).astype(np.int8) for n in (80, 700, 3599)]
    text = ("10 2 3 4\n" + decode(seq1) + f"\n{len(seqs)}\n"
            + "\n".join(decode(s) for s in seqs) + "\n")
    want = "".join(f"#{i}: score: {s}, n: {n}, k: {k}\n" for i, (s, n, k) in
                   enumerate(prefix_best(seq1, q, [10, 2, 3, 4]) for q in seqs))
    _ok(_job("--mesh", "seq:4", stdin=text, extra=TWO), want)


def test_partial_mesh_of_the_global_slots_is_refused():
    (rc0, out0, err0), (rc1, out1, err1) = _job("--mesh", "2", stdin=_text("tiny"), extra=TWO)
    assert (rc0, rc1) == (65, 65) and out0 == out1 == ""
    msg = "multi-host jobs must mesh all 4 global devices, got --mesh 2"
    assert msg in err0 and msg in err1


def test_unequal_slot_counts_are_refused(tmp_path):
    """Rank 0 of two slots, rank 1 of one: both exit 65 at the join, never
    a fallback to one slot a process."""
    port = _free_port()
    procs = []
    for rank, slots in ((0, "2"), (1, "1")):
        env = {k: v for k, v in os.environ.items() if not k.startswith("SEQALIGN_")}
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2",
                   RANK=str(rank), LOCAL_RANK=str(rank), SEQALIGN_HOST_DEVICES=slots)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "mpi_openmp_cuda_tpu_torch", "--device", "cpu",
             "--distributed", "--input", str(FIX / "tiny.txt")],
            stdin=subprocess.DEVNULL, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, cwd=REPO, env=env))
    outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    assert [p.returncode for p in procs] == [65, 65], [err for _, err in outs]
    assert all(out == "" for out, _ in outs)
    assert "multi-process initialization failed: every process must drive the same " \
           "number of mesh slots, got [2, 1]" in outs[0][1]


def test_journal_resume_over_four_slots(tmp_path):
    """Rank 0 broadcasts its journal's done set, both processes score the
    rest over their four slots, the journalled rows come out verbatim."""
    problem = load_problem(str(FIX / "mixedcase.txt"))
    journal = tmp_path / "hybrid.jsonl"
    tampered = {1: (4242, 3, 1)}
    _seed_batch_journal(journal, problem, tampered)
    (rc0, out0, err0), (rc1, out1, err1) = _job(
        "--journal", str(journal), "--mesh", "2x2", stdin=_text("mixedcase"), extra=TWO)
    assert (rc0, rc1) == (0, 0), err0 + err1
    assert out1 == ""
    _assert_tampered(out0, tampered)
    assert len(journal.read_text().splitlines()) == 1 + len(problem.seq2_codes)


_SLOT_LOG_SCRIPT = """
import json, sys
sys.path.insert(0, {repo!r})
from mpi_openmp_cuda_tpu_torch.analysis import collectives
from mpi_openmp_cuda_tpu_torch.parallel import distributed
distributed.initialize_distributed("cpu")
out = {{}}
for spec in {specs!r}:
    sh, rows, _ = collectives.run_spec(spec)
    out[spec] = {{"log": {{s: sh.comm.slot_log.get(s, []) for s in sh.comm.local_slots()}},
                 "rows": rows.tolist()}}
print(json.dumps(out))
distributed.shutdown_distributed()
"""


@pytest.mark.parametrize("nproc, specs", [
    (2, ("4", "seq:4", "2x2")),
    (3, ("2x3", "seq:6")),
], ids=["2x2slots", "3x2slots-straddling"])
def test_each_slots_sequence_equals_the_one_process_run(nproc, specs):
    """Every slot of a job of ``nproc`` processes of two slots issues the
    collective sequence of the same slot in the one-process
    ``LocalCollectives`` run, and every process scores the same rows; at
    ``2x3`` over three processes each ``seq`` row straddles two of them
    (shares of two and one slots, gathered padded)."""
    port = _free_port()
    procs = []
    for rank in range(nproc):
        env = {k: v for k, v in os.environ.items() if not k.startswith("SEQALIGN_")}
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(nproc),
                   RANK=str(rank), LOCAL_RANK=str(rank), SEQALIGN_HOST_DEVICES="2")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _SLOT_LOG_SCRIPT.format(repo=str(REPO), specs=specs)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=TIMEOUT)
        assert p.returncode == 0, err
        outs.append(json.loads(out.strip().splitlines()[-1]))
    for spec in specs:
        merged = {int(s): seq for rank_out in outs for s, seq in rank_out[spec]["log"].items()}
        assert sorted(merged) == list(range(2 * nproc))
        assert collectives.hybrid_findings(spec, merged) == [], spec
        _, rows, _ = collectives.run_spec(spec, [CPU] * (2 * nproc))
        assert all(o[spec]["rows"] == rows.tolist() for o in outs), spec


def test_seeded_batch_equals_the_jax_cli_on_a_four_device_mesh(tmp_path, capfd):
    """A seeded batch (Seq1 400, 12 Seq2 of 5-300, weights 10 2 3 4)
    through the JAX CLI in this process on four of the conftest's virtual
    CPU devices at ``--mesh 2x2``, and through the port's two processes of
    two slots at ``--mesh 2x2``: rank 0's stdout equals it byte for byte
    (the rows are integers; the tolerance is none)."""
    from mpi_openmp_cuda_tpu.io import cli as jcli

    rng = np.random.default_rng(2024)
    seq1 = rng.integers(1, 27, size=400).astype(np.int8)
    seqs = [rng.integers(1, 27, size=int(n)).astype(np.int8)
            for n in rng.integers(5, 301, size=12)]
    text = ("10 2 3 4\n" + decode(seq1) + f"\n{len(seqs)}\n"
            + "\n".join(decode(s) for s in seqs) + "\n")
    path = tmp_path / "seeded.txt"
    path.write_text(text)
    assert jcli.run(["--mesh", "2x2", "--input", str(path)]) == 0
    jax_out = capfd.readouterr().out
    assert len(jax_out.splitlines()) == len(seqs)
    _ok(_job("--mesh", "2x2", stdin=text, extra=TWO), jax_out)
