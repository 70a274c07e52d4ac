"""The batch mesh as the benchmark's ``batch-long-mesh4`` cell runs it, on four
CPU slots: the CLI's ``--mesh 4`` against the benchmark's plain reference,
the cell's driver and readers through ``harness.measure``, the driver's
refusal of a window that ran kernels on fewer cards than the cell asks for,
and the mesh's counters."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from mpi_openmp_cuda_tpu_torch import obs as tobs
from mpi_openmp_cuda_tpu_torch.io import cli as tcli
from mpi_openmp_cuda_tpu_torch.parallel import sharding
from seqbench import generate, harness, judge, reference
from seqbench import run as bench_run
from seqbench.devtrace import DeviceTrace
from seqbench.drivers import batch as batch_driver
from seqbench.drivers import batch_mesh

REPO = Path(__file__).resolve().parents[1]
CELL = "batch-long-mesh4"
CONFIG = json.loads((REPO / "seqbench" / "configs" / "spec-batch-mpi4.json").read_text())
NEW_SPANS = ("score.chunk_dispatch.shard_replicate", "score.chunk_dispatch.shard_place",
             "score.chunk_dispatch.shard_launch", "score.chunk_gather.shard_gather")
MESH_METRICS = ("mesh_cards_concurrent", "mesh_place_ms", "mesh_launch_ms", "mesh_gather_ms",
                "mesh_h2d_copies_per_job")
TINY_MESH = {"seq1_len": 60, "seq2_per_job": 10, "seq2_len": [3, 50], "homolog_share": 0.5,
             "homolog_mutation": 0.06, "pool_jobs": 3, "warm_jobs": 1, "check_jobs": 3}


@pytest.fixture
def quiet_env(monkeypatch, tmp_path):
    monkeypatch.setenv("SEQALIGN_HOST_DEVICES", "4")
    monkeypatch.setenv("SEQALIGN_BACKOFF_BASE", "0")
    monkeypatch.setenv("SEQALIGN_CACHE_DIR", str(tmp_path / "cache"))
    for var in ("SEQALIGN_DEADLINE_S", "SEQALIGN_DRAIN", "SEQALIGN_FAULTS",
                "SEQALIGN_FAULT_RETRIES", "SEQALIGN_METRICS", "SEQALIGN_METRICS_OUT",
                "SEQALIGN_TRACE", "SEQALIGN_HEARTBEAT_S", "SEQALIGN_CHECK"):
        monkeypatch.delenv(var, raising=False)
    yield monkeypatch
    tobs.disarm_observability()


def job_text(seed: int, len1: int, n: int, lo: int, hi: int, extra=()) -> str:
    """A seeded job of the benchmark's generator (Seq1 ``len1``, ``n`` Seq2s
    of ``lo``-``hi`` chars), then one Seq2 of each length in ``extra``: the
    Seq1 itself where it is as long, random letters otherwise."""
    traffic = {"seq1_len": len1, "seq2_per_job": n, "seq2_len": [lo, hi], "homolog_share": 0.25,
               "homolog_mutation": 0.06, "pool_jobs": 1}
    weights, seq1, seqs = reference.parse(generate.jobs(seed, CONFIG, traffic)[0].text)
    rng = generate.rng_for(seed, 7)
    seqs += [seq1 if m == len1 else generate.text_of(rng.integers(0, 26, m)) for m in extra]
    return (" ".join(map(str, weights)) + f"\n{seq1}\n{len(seqs)}\n" + "\n".join(seqs) + "\n")


def cli_run(path: Path, capfd, *extra: str) -> str:
    rc = tcli.run(["--input", str(path), "--device", "cpu", "--mesh", "4", *extra])
    out, err = capfd.readouterr()
    assert rc == 0, err
    return out


# (seed, len1, n, lo, hi, extra): N not a multiple of 4 with len2 == len1 and
# len2 > len1; N = 2, which leaves two of the four shards empty; three
# length buckets (128, 256 and the long rows' 384).
JOBS = {
    "ragged": (4294967311, 60, 9, 3, 50, (60, 75)),
    "empty_shard": (11, 40, 1, 5, 30, (40,)),
    "buckets": (2**31 + 5, 300, 70, 3, 250, (300, 320)),
}


@pytest.mark.parametrize("case", sorted(JOBS))
def test_mesh_cli_matches_the_benchmark_reference(case, quiet_env, tmp_path, capfd):
    text = job_text(*JOBS[case])
    path = tmp_path / "job.txt"
    path.write_text(text)
    assert cli_run(path, capfd) == reference.stdout(text)


def _load_conftest():
    path = REPO / "seqbench" / "tests" / "conftest.py"
    spec = importlib.util.spec_from_file_location("seqbench_tests_conftest", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def mesh_root(tmp: Path, traffic: dict = TINY_MESH) -> Path:
    """The seqbench tests' tiny root, plus a four-slot ``batch_mesh`` cell on
    ``spec-batch-mpi4``, added as their ``add_cell`` adds a cell, asking for
    four chips and reporting the metrics ``batch-long-mesh4`` reports."""
    conf = _load_conftest()
    root = conf.make_root(tmp)
    conf.add_cell(root, "tiny-mesh", "spec-batch-mpi4", traffic)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"][-1]["chips"] = 4
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("tiny-mesh")
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))
    return root


def test_the_mesh_cell_measures_on_four_cpu_slots(quiet_env, tmp_path):
    root = mesh_root(tmp_path)
    ctx = harness.context("tiny-mesh", 2**32 + 15, 0.5, True, root=root, device="cpu")
    assert ctx.config["kind"] == "batch_mesh" and ctx.cell["chips"] == 4
    result, run = harness.measure(ctx)
    assert result["correct"], result["checks"]
    assert run.kind == "batch" and run.attempted > 0
    assert result["device"]["platform"] == "cpu" and result["device"]["count"] == 1
    # Every job opened the four new spans.
    assert len(run.spans) == len(run.jobs)
    assert all(set(NEW_SPANS) <= set(s) for s in run.spans)
    # The counters moved over the window: four shard launches a job (one
    # launch group) and one arena a job (the four slots share the one CPU
    # device).
    start, end = run.telemetry["start"], run.telemetry["end"]
    jobs = len(run.jobs)
    assert end["mesh_shard_launches"] - start["mesh_shard_launches"] == 4 * jobs
    assert end["mesh_h2d_copies"] - start["mesh_h2d_copies"] == jobs
    # No card: the device readers and the mesh's readers read nothing.
    assert run.trace["cards"] == {}
    metrics = harness.metrics_of(ctx)
    assert set(MESH_METRICS) <= {m["name"] for m in metrics}
    assert not set(MESH_METRICS) & set(result["metrics"])
    assert {"cli_parse_ms", "launches_per_job"} <= set(result["metrics"])
    assert result["metrics"]["launches_per_job"]["value"] == 0.0


def _events(cards_with_kernels, cards=4):
    """Stub device activity in a window at t = 100..101 s: copies on every
    card, kernels on ``cards_with_kernels``, cards 1 and 2 overlapping."""
    ev = []
    for c in range(cards):
        ev.append((c, 100.1 + 0.01 * c, 100.102 + 0.01 * c, "Memcpy HtoD (Pinned -> Device)"))
        if c in cards_with_kernels:
            ev.append((c, 100.2, 100.3 + 0.05 * (c == 1), "tile_kernel"))
    return ev


class _KinetoEvent:
    def __init__(self, card, start, end, name):
        self._card, self._start, self._end, self._name = card, start, end, name

    def device_type(self):
        return "DeviceType.CUDA"

    def device_index(self):
        return self._card

    def name(self):
        return self._name

    def start_ns(self):
        return int(round(self._start * 1e9))

    def duration_ns(self):
        return int(round((self._end - self._start) * 1e9))


def stub_trace(trace: DeviceTrace, events) -> DeviceTrace:
    """``trace`` over a window at t = 100..101 s whose profiler saw
    ``events``, ``(card, start, end, name)``."""
    results = type("Results", (), {"events": lambda self: [_KinetoEvent(*e) for e in events]})()
    trace._prof = type("Prof", (), {"profiler": type("P", (), {"kineto_results": results})()})()
    trace.t0, trace.t1 = 100.0, 101.0
    return trace


def _stub_card(monkeypatch, events):
    """``run.main`` on a stub host of four cards whose window shows
    ``events``: the batch driver's loop replaced by one that opens and
    closes a trace the mesh driver made, over a stub profiler."""

    def fake_batch_run(ctx):
        trace = batch_driver.DeviceTrace()
        trace.open()
        trace.close()
        summary = stub_trace(trace, events).summary(outside="harness")
        summary["cells"], summary["bytes"] = 10**9, 10**6
        device = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                  "memory_peak_bytes": 1}
        return harness.Run("batch", 1.0, 1.0, attempted=1, failed=0,
                           checks={"wrong_lines": {"value": 0, "limit": 0}}, device=device,
                           jobs=[{"wall_s": 0.01, "cells": 10**9, "bytes": 10**6}],
                           trace=summary, notes=["seqbench: 1 jobs"])

    monkeypatch.setattr(batch_driver, "run", fake_batch_run)
    # This test process holds JAX (the suite's conftest): not the run's doing.
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda i=0: 1000 * (int(i) + 1))
    # run.main puts the configuration's environment into this process's.
    for var in CONFIG["env"]:
        monkeypatch.setenv(var, "1")


ARGV = ["--workload", CELL, "--seed", "4294967311", "--seconds", "1", "--trace", "0"]


def test_a_window_with_kernels_on_one_of_four_cards_is_refused(quiet_env, capsys):
    _stub_card(quiet_env, _events({0}))
    with pytest.raises(SystemExit) as exc:
        bench_run.main(ARGV)
    assert exc.value.code == 1
    out = capsys.readouterr()
    assert out.out == ""
    assert "asks for 4 cards, but only 1 ran kernels" in out.err and "cuda:0" in out.err


def test_a_window_with_kernels_on_four_cards_reports_four(quiet_env, capsys):
    _stub_card(quiet_env, _events({0, 1, 2, 3}))
    assert bench_run.main(ARGV) == 0
    lines = capsys.readouterr().out.splitlines()
    result = json.loads(lines[-1])
    assert result["correct"] and result["device"]["count"] == 4
    assert result["device"]["memory_peak_bytes"] == 4000
    assert "batch_device_cells_per_s" in result["metrics"]
    note = next(ln for ln in lines if ln.startswith("seqbench: cards"))
    assert all(f"cuda:{c} kernels 1 kernel" in note for c in range(4))
    assert "cuda:1 kernels 1 kernel 0.150000 s tile_kernel 0.150000 s" in note


def test_cards_concurrent_reads_the_per_card_split():
    summary = stub_trace(batch_mesh.MeshTrace(), _events({0, 1, 2, 3})).summary()
    # Copies of 2 ms on each card, apart; kernels 100.2-100.3 on cards 0, 2, 3
    # and 100.2-100.35 on card 1: 4 x 0.002 + 0.45 s of card time in 0.158 s.
    assert summary["busy_s"] == pytest.approx(4 * 0.002 + 0.15)
    assert [c["kernels"] for c in summary["cards"].values()] == [1, 1, 1, 1]
    assert [c["tile_kernel_s"] for c in summary["cards"].values()] == pytest.approx(
        [0.1, 0.15, 0.1, 0.1])
    assert summary["cards"]["1"]["busy_s"] == pytest.approx(0.152)
    read = harness._load(REPO / "seqbench" / "metrics" / "mesh_cards_concurrent.py", "r").read
    run = harness.Run("batch", 1.0, 1.0, attempted=1, failed=0, checks={}, device={},
                      trace=summary)
    assert read(run) == pytest.approx((4 * 0.002 + 0.45) / (4 * 0.002 + 0.15))
    assert read(harness.Run("batch", 1.0, 1.0, 1, 0, {}, {}, trace={"busy_s": 0.0})) is None


@pytest.mark.parametrize("seed", [0, 7, 4294967311, 2**33 + 1])
def test_one_checked_job_is_always_of_the_widest_weights(seed):
    """Only ``100 2 3 4`` (tuple 0 of 4) pushes the cell's scores past 2**15:
    one of the ``check_jobs`` drawn is always such a job, the rest as the
    batch driver draws them."""
    checks = batch_mesh.WideChecks(CONFIG["weights"])
    assert checks.wide == {0} and checks.well_formed is judge.well_formed
    picked = checks.sample(seed, range(64), 2)
    assert len(picked) == 2 and any(j % 4 == 0 for j in picked)
    assert checks.sample(seed, [1, 2, 3], 2) == judge.sample(seed, [1, 2, 3], 2)
    assert checks.sample(seed, range(64), 0) == []


CELL_TRAFFIC = json.loads((REPO / "seqbench" / "traffic" / f"{CELL}.json").read_text())


@pytest.mark.parametrize("seed", [4294967311, 2**31 + 11, 3037000493])
def test_16_bit_sums_fail_on_the_cells_own_checked_jobs(seed):
    """The control ``correct`` has to catch: at the cell's own sizes (Seq1
    3000, 256 Seq2s of 1200-1999), the jobs the mesh driver checks, scored
    by the reference in 16-bit sums, are judged wrong on every seed."""
    pool = generate.jobs(seed, CONFIG, CELL_TRAFFIC)
    checked = batch_mesh.WideChecks(CONFIG["weights"]).sample(
        seed, range(len(pool)), int(CELL_TRAFFIC["check_jobs"]))
    assert len(checked) == 2
    texts = {i: pool[i].text for i in checked}
    outs = dict(zip(checked, judge.parallel(
        lambda i: reference.stdout(texts[i], acc=np.int16), checked)))
    checks, wrong = judge.judge_batch(texts, outs, 0, 0)
    assert checks["wrong_lines"]["value"] > 0 and wrong


def test_the_mesh_cells_run_checks_a_job_of_the_widest_weights(quiet_env, tmp_path):
    """A run of the cell's driver draws its checked job through
    :class:`batch_mesh.WideChecks`: with one job checked of eight, it is
    one of the widest tuple's, where the batch driver's own draw on this
    seed (pool job 2) is not."""
    seed = 4294967311
    assert judge.sample(seed, range(8), 1) == [2]
    judged = []

    def spy(texts, outputs, malformed, unstable):
        judged.append(dict(texts))
        return judge_batch(texts, outputs, malformed, unstable)

    judge_batch = judge.judge_batch
    quiet_env.setattr(judge, "judge_batch", spy)
    root = mesh_root(tmp_path, {**TINY_MESH, "pool_jobs": 8, "check_jobs": 1})
    result, _ = harness.measure(harness.context("tiny-mesh", seed, 0.5, False, root=root,
                                                device="cpu"))
    assert result["correct"], result["checks"]
    assert len(judged) == 1 and len(judged[0]) == 1
    (job,) = judged[0]
    assert job % 4 == 0
    assert reference.parse(judged[0][job])[0] == CONFIG["weights"][0] == [100, 2, 3, 4]


def _arena_bytes(len1: int, groups) -> int:
    """The bytes of the one arena a dispatch sends the CPU device the four
    slots share, each segment 256-byte aligned: Seq1 (padded to L1P + the
    widest L2P + 1), the [27, 27] int32 table, then each of four shards'
    uint8 rows and int32 lengths of every launch group, ``(L2P, rows, _)``."""
    def seg(n):
        return -(-n // 256) * 256

    l1p = -(-len1 // 128) * 128
    shards = 4 * sum(seg(-(-b // 4) * l2p) + seg(4 * -(-b // 4)) for l2p, b, _ in groups)
    return seg(l1p + max(l2p for l2p, _, _ in groups) + 1) + seg(27 * 27 * 4) + shards


# (len1, row lengths, launch groups as (L2P, rows, length buckets)): one
# bucket of 10 rows; two buckets of 41 and 39 rows in one group; three of
# 33, 32 and 35 rows in shuffled order in one group (each bucket at least
# MIN_BUCKET_ROWS x 4); and at Seq1 2000 130 short rows kept apart from
# 130 rows of two wide buckets, each group's shards padded by two rows.
COUNTED = {
    "one_bucket": (60, [3 + 4 * i for i in range(10)], [(128, 10, 1)]),
    "two_buckets": (300, [3 + 3 * i for i in range(41)] + [130 + 3 * i for i in range(39)],
                    [(256, 80, 2)]),
    "three_buckets": (400, list(np.random.default_rng(9).permutation(
        [3 + 3 * i for i in range(33)] + [130 + 3 * i for i in range(32)]
        + [260 + 3 * i for i in range(35)])), [(384, 100, 3)]),
    "two_groups": (2000, [3 + i % 60 for i in range(130)] + [1900 + i % 90 for i in range(130)],
                   [(128, 130, 1), (2048, 130, 2)]),
}


@pytest.mark.parametrize("case", sorted(COUNTED))
def test_a_mesh_job_counts_its_shards_and_copies(case, quiet_env, tmp_path, capfd):
    """Every launch group of a job in one arena (the four slots share the
    one CPU device), one launch a group a slot, and one gather; its rows
    are the one-device scorer's and the JAX package's."""
    from mpi_openmp_cuda_tpu.ops.dispatch import AlignmentScorer as JScorer
    from mpi_openmp_cuda_tpu_torch.io.parse import load_problem
    from mpi_openmp_cuda_tpu_torch.ops.dispatch import AlignmentScorer
    from mpi_openmp_cuda_tpu_torch.parallel.comm import LocalCollectives

    len1, lens, groups = COUNTED[case]
    rng = np.random.default_rng(3)
    seqs = [generate.text_of(rng.integers(0, 26, m)) for m in lens]
    text = f"2 2 1 10\n{generate.text_of(rng.integers(0, 26, len1))}\n{len(seqs)}\n"
    path = tmp_path / "job.txt"
    path.write_text(text + "\n".join(seqs) + "\n")
    report = tmp_path / "m.json"
    before = dict(sharding.mesh_counts)
    gathers = []
    real_gather = LocalCollectives.gather
    quiet_env.setattr(LocalCollectives, "gather",
                      lambda self, *a: gathers.append(a) or real_gather(self, *a))
    out = cli_run(path, capfd, "--metrics-out", str(report))
    assert out == reference.stdout(path.read_text())
    assert len(gathers) == 1
    p = load_problem(str(path))
    single = AlignmentScorer("cuda", device="cpu").score_codes(p.seq1_codes, p.seq2_codes,
                                                                p.weights)
    jax_rows = JScorer("xla").score_codes(p.seq1_codes, p.seq2_codes, p.weights)
    assert out == "".join(f"#{i}: score: {s}, n: {n}, k: {k}\n"
                          for i, (s, n, k) in enumerate(single.tolist()))
    assert np.array_equal(single, np.asarray(jax_rows))
    counters = json.loads(report.read_text())["counters"]
    want = {
        "mesh_shard_launches": 4 * len(groups),
        # One arena a dispatch: the four slots share the one CPU device.
        "mesh_h2d_copies": 1,
        "mesh_h2d_bytes": _arena_bytes(len1, groups),
        "mesh_pad_rows": sum(-(-b // 4) * 4 - b for _, b, _ in groups),
        "mesh_fused_buckets": sum(k for _, _, k in groups if k > 1),
    }
    assert {k: counters.get(k, 0) for k in want} == want
    assert {k: sharding.mesh_counts[k] - before[k] for k in want} == want



@pytest.mark.parametrize("prefetched", [False, True])
def test_the_gather_waits_on_the_cards_under_device_wait(prefetched, quiet_env, tmp_path, capfd):
    """The host's block on the cards is ``score.chunk_gather.device_wait``,
    before and apart from ``shard_gather``: on the copies' events where a
    prefetch recorded them, else on one event a card recorded at the
    gather (stubs here: a CPU slot has no CUDA event)."""
    waits = []
    quiet_env.setattr(sharding.ShardedPending, "_card_events", lambda self: ["card"])
    quiet_env.setattr(sharding, "wait_event", waits.append)
    if prefetched:
        # The CLI's batch path gathers with no prefetch: make it take one.
        def result(self, real=sharding.ShardedPending.result):
            self._events = ["copy"]
            return real(self)

        quiet_env.setattr(sharding.ShardedPending, "result", result)
    text = job_text(*JOBS["ragged"])
    path = tmp_path / "job.txt"
    path.write_text(text)
    report = tmp_path / "m.json"
    assert cli_run(path, capfd, "--metrics-out", str(report)) == reference.stdout(text)
    assert waits == (["copy"] if prefetched else ["card"])
    totals = json.loads(report.read_text())["spans"]["totals"]
    assert {"score.chunk_gather.device_wait", "score.chunk_gather.shard_gather"} <= set(totals)


def test_cpu_slots_and_process_jobs_record_no_card_events():
    rows = {s: torch.zeros((2, 3), dtype=torch.int32) for s in range(4)}
    comm = type("Comm", (), {"world": 1})()
    pending = sharding.ShardedPending(comm, rows, [0, 1, 2, 3], np.arange(8))
    assert pending._card_events() == []
    comm.world = 2  # a multi-process job's gather is the collective itself
    assert pending._card_events() == []
