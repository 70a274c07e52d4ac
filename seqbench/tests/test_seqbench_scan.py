"""The scan configuration's pieces on the CPU: the plain PyTorch reference
against the NumPy one, the scan's jobs, the scan driver on a tiny cell (its
check, its counters, and its refusal of a window that streamed nothing),
and the 64-key serve mix."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import REPO
from seqbench import generate, harness, reference, reference_torch, scanjobs

FIXTURES = REPO / "tests" / "fixtures"
WEIGHTS = [(100, 2, 3, 4), (10, 2, 3, 4), (2, 2, 1, 10), (4, 3, 2, 10), (-3, 5, 0, -7)]
TINY_SCAN = {"seq1_len": 300, "seq2_per_job": 40, "seq2_len": [5, 320],
             "seq2_len_law": {"law": "lognormal", "median": 60, "sigma": 0.8},
             "homolog_share": 0.1, "homolog_mutation": 0.06, "pool_jobs": 4, "warm_jobs": 1,
             "check_jobs": 2}


# -- the plain PyTorch reference -------------------------------------------


@pytest.mark.parametrize("name", sorted(p.stem for p in FIXTURES.glob("*.txt")))
def test_reference_torch_gives_the_fixture_goldens(name):
    text = (FIXTURES / f"{name}.txt").read_text()
    assert reference_torch.stdout(text) == (FIXTURES / f"{name}.out").read_text()


@pytest.mark.parametrize("weights", WEIGHTS, ids=lambda w: "_".join(map(str, w)))
@pytest.mark.parametrize("seed", [1, 2**31 + 5])
def test_reference_torch_equals_reference_on_seeded_pairs(seed, weights):
    rng = generate.rng_for(seed, 40)
    for _ in range(6):
        len1 = int(rng.integers(1, 90))
        seq1 = rng.integers(0, 26, len1)
        seqs = []
        for _ in range(int(rng.integers(1, 12))):
            n = int(rng.integers(1, len1 + 4))
            if 0 < n < len1 and rng.random() < 0.3:
                seqs.append(generate.text_of(generate.homolog(rng, seq1, n, 0.1)))
            else:  # a small alphabet now and then: many ties
                seqs.append(generate.text_of(rng.integers(0, int(rng.integers(1, 27)), n)))
        s1 = generate.text_of(seq1)
        assert reference_torch.scores(weights, s1, seqs) == reference.rows(weights, s1, seqs)


@pytest.mark.parametrize("s1,s2", [
    ("ABC", "ABCD"),  # len2 > len1: INT32_MIN
    ("ABC", ""),  # len2 = 0: INT32_MIN
    ("ABC", "ABD"),  # len2 = len1: positional, n = k = 0
    ("AAAA", "AA"),  # ties everywhere: the first offset, k = 0
    ("ABAB", "AB"),
    ("XAYZ", "AZ"),  # the best k is past 0
    ("qwertyuiop", "wErTy"),  # either case
])
def test_reference_torch_edge_cases_equal_reference(s1, s2):
    for weights in WEIGHTS:
        assert reference_torch.scores(weights, s1, [s2]) == reference.rows(weights, s1, [s2])


def test_reference_torch_blocks_of_rows_change_nothing(monkeypatch):
    """Rows of mixed lengths give the same answers in one block and in
    blocks of one row."""
    rng = generate.rng_for(3, 41)
    seq1 = generate.text_of(rng.integers(0, 26, 200))
    seqs = [generate.text_of(rng.integers(0, 26, int(n))) for n in rng.integers(1, 230, 30)]
    whole = reference_torch.scores((10, 2, 3, 4), seq1, seqs)
    monkeypatch.setattr(reference_torch, "BLOCK_ELEMS", 1)
    assert reference_torch.scores((10, 2, 3, 4), seq1, seqs) == whole


def test_reference_torch_int16_wraps_as_reference_does():
    rng = generate.rng_for(8, 42)
    seq1 = rng.integers(0, 26, 700)
    seqs = [generate.text_of(generate.homolog(rng, seq1, 600, 0.02))]
    s1 = generate.text_of(seq1)
    exact = reference_torch.scores((100, 2, 3, 4), s1, seqs)
    wrapped = reference_torch.scores((100, 2, 3, 4), s1, seqs, acc=torch.int16)
    assert exact[0][0] >= 2**15 and wrapped != exact
    assert wrapped == reference.rows((100, 2, 3, 4), s1, seqs, acc=np.int16)


def test_reference_torch_imports_neither_the_program_nor_jax():
    src = (REPO / "seqbench" / "reference_torch.py").read_text()
    imports = [ln for ln in src.splitlines() if ln.startswith(("import ", "from "))]
    assert imports == ["from __future__ import annotations", "import torch"]


# -- the scan's jobs --------------------------------------------------------


def scan_cell():
    ctx = harness.context("scan-stream", 0, 1.0, False)
    return ctx.config, ctx.traffic


def test_scan_jobs_repeat_byte_for_byte_from_the_seed():
    config, traffic = scan_cell()
    traffic = {**traffic, "pool_jobs": 2}
    a = scanjobs.jobs(2**31 + 11, config, traffic)
    assert [j.text for j in a] == [j.text for j in scanjobs.jobs(2**31 + 11, config, traffic)]
    assert [j.text for j in a] != [j.text for j in scanjobs.jobs(12, config, traffic)]


def test_scan_jobs_follow_the_traffic_file():
    config, traffic = scan_cell()
    pool = scanjobs.jobs(2**31 + 11, config, {**traffic, "pool_jobs": 5})
    base = None
    for j, job in enumerate(pool):
        tokens = job.text.split()
        lens = sorted(len(s) for s in tokens[6:])
        assert [int(w) for w in tokens[:4]] == config["weights"][j % 4]
        assert len(tokens[4]) == traffic["seq1_len"] == 2504
        assert int(tokens[5]) == traffic["seq2_per_job"] == len(lens) == job.rows
        assert 5 <= lens[0] and lens[-1] <= 2000
        base = base or lens
        assert lens == base  # every job, every seed: the same lengths
    assert abs(np.mean(base) - 360) < 10 and np.median(base) in range(295, 306)


def test_scan_jobs_hold_the_stated_homolog_share():
    """Exactly ``round(share * N)`` rows align to the query at 80 % or
    more of their chars (a homolog, 6 % replaced) and the rest far below
    (the best alignment's count of equal chars, searched by the reference)."""
    config, traffic = scan_cell()
    traffic = {**traffic, "seq2_per_job": 400, "pool_jobs": 1, "homolog_share": 0.02}
    tokens = scanjobs.jobs(7, config, traffic)[0].text.split()
    same = [r[0] / len(s) for r, s in zip(reference.rows((1, 0, 0, 0), tokens[4], tokens[6:]),
                                           tokens[6:])]
    assert sum(x >= 0.8 for x in same) == 8
    assert sum(x >= 0.5 for x in same) == 8


# -- the scan driver on a tiny cell ----------------------------------------


@pytest.fixture
def scan_root(tiny_root) -> Path:
    (tiny_root / "seqbench" / "traffic" / "tiny-scan.json").write_text(json.dumps(TINY_SCAN))
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny-scan", "config": "scan-swissprot-stream",
                               "traffic": "tiny-scan", "chips": 1, "why": "a CPU test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "scan-stream" in m.get("workloads", []):
            m["workloads"].append("tiny-scan")
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    return tiny_root


def test_a_traced_scan_run_is_correct_and_reads_its_stream(scan_root):
    ctx = harness.context("tiny-scan", 2**31 + 7, 0.5, True, root=scan_root, device="cpu")
    result, run = harness.measure(ctx)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert {"stream_parse_ms", "stream_window_wait_ms"} <= set(result["metrics"])
    # On the CPU no kernel runs: no launch to pad, no device time.
    assert "launch_pad_share" not in result["metrics"]
    start, end = run.telemetry["start"], run.telemetry["end"]
    assert end["stream_chunks"] - start["stream_chunks"] == len(run.jobs)
    # The counter counts the kernels' plain versions here too; the metric
    # reads only where a kernel launched.
    assert end["dispatch_launched_cells"] > start["dispatch_launched_cells"]
    assert all("stream.parse" in s and "stream.window_wait" in s for s in run.spans)


@pytest.mark.parametrize("telemetry,want", [
    ({"start": {"dispatch_launched_cells": 100}, "end": {"dispatch_launched_cells": 500}}, 25.0),
    ({"end": {"dispatch_launched_cells": 300}}, 0.0),
    ({"start": {"dispatch_launched_cells": 7}, "end": {"dispatch_launched_cells": 7}}, None),
    ({"start": {"stream_chunks": 0}, "end": {"stream_chunks": 4}}, None),  # a parent's counters
    ({}, None),  # another driver's run
])
def test_launch_pad_share_reads_the_windows_launched_cells(telemetry, want):
    import importlib

    reader = importlib.import_module("seqbench.metrics.launch_pad_share")
    jobs = [{"cells": 100}, {"cells": 200}]
    run = harness.Run("batch", 1.0, 1.0, 2, 0, {}, {}, jobs=jobs,
                      launches={"fused_scorer": 3, "packed_scorer": 1}, telemetry=telemetry)
    assert reader.read(run) == want
    # No job, or no kernel launched (the CPU's plain versions): nothing.
    for other in ({"jobs": jobs}, {"launches": {"fused_scorer": 1}}):
        assert reader.read(harness.Run("batch", 1.0, 1.0, 0, 0, {}, {}, telemetry=telemetry,
                                       **other)) is None


def test_a_scan_window_that_streamed_nothing_is_no_measurement(scan_root, capsys):
    config = scan_root / "seqbench" / "configs" / "scan-swissprot-stream.json"
    config.write_text(json.dumps({**json.loads(config.read_text()), "cli_args": []}))
    ctx = harness.context("tiny-scan", 5, 0.3, False, root=scan_root, device="cpu")
    with pytest.raises(SystemExit) as stop:
        harness.measure(ctx)
    assert stop.value.code == 1
    out, err = capsys.readouterr()
    assert "{" not in out and "streamed no chunk" in err


def test_a_broken_stream_path_is_not_correct(scan_root, monkeypatch):
    from mpi_openmp_cuda_tpu_torch.io import pipeline

    real = pipeline.ChunkPipeline.materialise

    def materialise(self, *a, **k):
        rows = np.array(real(self, *a, **k))
        rows[0, 0] += 1
        return rows

    monkeypatch.setattr(pipeline.ChunkPipeline, "materialise", materialise)
    ctx = harness.context("tiny-scan", 6, 0.3, False, root=scan_root, device="cpu")
    result, _ = harness.measure(ctx)
    assert not result["correct"]
    assert result["checks"]["wrong_lines"]["value"] > 0 and result["failed"] > 0


def test_the_widest_weights_are_always_checked(scan_root, monkeypatch):
    from seqbench.drivers import scan

    seen = []
    real = scan.ScanChecks.judge_batch

    def judge_batch(self, texts, *a):
        seen.append(sorted(texts))
        return real(self, texts, *a)

    monkeypatch.setattr(scan.ScanChecks, "judge_batch", judge_batch)
    for seed in (1, 2, 3):
        ctx = harness.context("tiny-scan", seed, 0.3, False, root=scan_root, device="cpu")
        harness.measure(ctx)
    assert all(len(keys) == 2 and any(j % 4 == 0 for j in keys) for keys in seen)


# -- the 64-key serve mix ---------------------------------------------------


def test_the_64_key_serve_mix_gives_64_keys_of_the_six_shapes():
    """``seqbench/traffic/serve-distinct-keys.json``: serve-steady's mix
    with each of 64 problems its own key (PERF.md section 7: measured, not
    admitted as a cell)."""
    ctx = harness.context("serve-steady", 2**31 + 9, 1.0, False)
    steady = ctx.traffic
    mix = json.loads((REPO / "seqbench" / "traffic" / "serve-distinct-keys.json").read_text())
    keys = generate.problems(ctx.seed, mix)
    assert len(keys) == 64
    assert len({p["name"] for p, _ in keys}) == 64
    assert len({(tuple(p["weights"]), s.tobytes()) for p, s in keys}) == 64
    shapes = [{k: v for k, v in p.items() if k != "name"} for p, _ in keys]
    fixtures = [{k: v for k, v in p.items() if k != "name"} for p in steady["problems"]]
    assert [shapes.count(f) for f in fixtures] == [11, 11, 11, 11, 10, 10]
    assert shapes[:6] == fixtures  # in turn
    rest = {k: v for k, v in mix.items() if k != "problems"}
    assert rest == {k: v for k, v in steady.items() if k != "problems"}
    reqs = generate.requests(ctx.seed, ctx.config, mix, 640, "r")
    assert len({r.raw["seq1"] for r in reqs}) == 64
