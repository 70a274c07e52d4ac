"""The port's warm plane (``mpi_openmp_cuda_tpu_torch/aot``) on the CPU:
warm-set selection against the dispatch's own launches, the manifest's
round trip and staleness, ``compile_entry``'s calls (a spy: on the CPU
nothing is built or loaded, so ``_build.build_count`` cannot show the
zero-setup property; ``chip_smoke.py`` phase 17 shows it on the card),
and ``--prewarm`` through the CLI, the serve loop and the bench, held to
the goldens and to the JAX CLI.  Every comparison is exact equality.
"""

from __future__ import annotations

import io
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import run_cli_inproc as jax_cli_inproc
from mpi_openmp_cuda_tpu_torch.aot import compile as aot_compile
from mpi_openmp_cuda_tpu_torch.aot.manifest import (
    MANIFEST_KIND,
    build_manifest,
    default_manifest_path,
    load_manifest,
    split_entries,
    write_manifest,
)
from mpi_openmp_cuda_tpu_torch.aot.prewarm import prewarm
from mpi_openmp_cuda_tpu_torch.aot.warmset import (
    FORMULATIONS,
    WarmEntry,
    backend_fingerprint,
    select_warmset,
)
from mpi_openmp_cuda_tpu_torch.io import cli as tcli
from mpi_openmp_cuda_tpu_torch.io.parse import parse_problem
from mpi_openmp_cuda_tpu_torch.models.workload import input3_class_problem, synthetic_codes
from mpi_openmp_cuda_tpu_torch.obs.metrics import validate_report
from mpi_openmp_cuda_tpu_torch.ops import cuda_scorer, dispatch
from mpi_openmp_cuda_tpu_torch.serve.batcher import plan_blocks
from mpi_openmp_cuda_tpu_torch.utils.env import platform_tag

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures"
ROWS_PER_BLOCK = 64


@pytest.fixture
def cache_home(tmp_path, monkeypatch):
    """A throwaway cache home for the port (the suite turns the cache
    home off through ``TPU_SEQALIGN_COMPILE_CACHE``)."""
    home = tmp_path / "cache"
    monkeypatch.delenv("TPU_SEQALIGN_COMPILE_CACHE", raising=False)
    monkeypatch.setenv("SEQALIGN_CACHE_DIR", str(home))
    for var in ("SEQALIGN_PREWARM", "SEQALIGN_SERVE_BLOCK_ROWS", "SEQALIGN_FAULTS",
                "SEQALIGN_DEADLINE_S", "SEQALIGN_DRAIN"):
        monkeypatch.delenv(var, raising=False)
    return home


def tiny_problem():
    """One L2P bucket: the smallest real warm set."""
    return parse_problem(io.StringIO("4 3 2 1\nACGTACGTACGTACGT\n3\nACGT\nGATTACA\nTTT\n"))


def short_rows_problem():
    """The 1024-short-row input of ``chip_smoke.py`` (Seq1 3000, 1024
    Seq2 of 5-64 chars, seed 7)."""
    from mpi_openmp_cuda_tpu_torch.io.parse import Problem
    from mpi_openmp_cuda_tpu_torch.models.encoding import decode

    seq1, seqs = synthetic_codes(3000, 1024, 5, 64, 7)
    return Problem(weights=[10, 2, 3, 4], seq1=decode(seq1), seq2=[decode(s) for s in seqs],
                   seq1_codes=seq1, seq2_codes=seqs)


PROBLEMS = {"input3-class": input3_class_problem, "1024-short-rows": short_rows_problem}


def identity(entry_or_plan) -> tuple:
    """(formulation, l2p, l2s, rows) of a warm entry or a planned launch."""
    if isinstance(entry_or_plan, WarmEntry):
        e = entry_or_plan
        return (e.formulation, e.l2p, e.l2s, e.rows)
    b = entry_or_plan.batch
    form = "cuda-fused" if entry_or_plan.l2s is None else "cuda-packed"
    return (form, b.l2p, entry_or_plan.l2s, b.batch_size)


def launches_of(seq1_codes, seq2_codes, weights):
    return dispatch.plan_launches(seq1_codes, seq2_codes, weights, "cuda")[1]


# -- warm-set selection -------------------------------------------------------


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_warmset_covers_every_planned_launch(name):
    """Every launch ``plan_launches`` makes for the problem has a warm
    entry of its identity, and the entry keeps the launch's Seq1 width."""
    prob = PROBLEMS[name]()
    entries = select_warmset(prob, "cuda", rows_per_block=ROWS_PER_BLOCK)
    by_id = {identity(e): e for e in entries}
    plans = launches_of(prob.seq1_codes, prob.seq2_codes, prob.weights)
    assert plans
    for plan in plans:
        assert identity(plan) in by_id, identity(plan)
        assert by_id[identity(plan)].l1p == plan.batch.l1p
    assert {e.formulation for e in entries} <= set(FORMULATIONS)
    assert len({e.executable_key for e in entries}) == len(entries)
    assert select_warmset(prob, "auto", rows_per_block=ROWS_PER_BLOCK) == entries


def test_serve_block_entries_cover_both_forms():
    """The serve superblock shapes: for every L2P bucket a fused block of
    ``rows_per_block`` rows, and every launch of every block the batcher
    cuts from the problem's rows (so the packed form a block of short
    rows takes)."""
    prob = short_rows_problem()
    seq1, seqs = synthetic_codes(3000, 24, 1200, 1999, 7)
    prob.seq2_codes = prob.seq2_codes[:200] + seqs  # short rows and long buckets
    entries = select_warmset(prob, "cuda", rows_per_block=ROWS_PER_BLOCK)
    have = {identity(e) for e in entries}
    buckets = dispatch.plan_buckets([c.size for c in prob.seq2_codes], packable=False,
                                    min_rows=1)
    assert len(buckets) > 3
    for l2p in buckets:
        assert ("cuda-fused", l2p, None, ROWS_PER_BLOCK) in have
    blocks = plan_blocks([prob], ROWS_PER_BLOCK)
    forms = set()
    for block in blocks:
        for plan in launches_of(block.seq1_codes, block.codes, block.weights):
            assert identity(plan) in have, identity(plan)
            forms.add(identity(plan)[0])
    assert forms == {"cuda-fused", "cuda-packed"}
    assert any(e.source == "serve-block" and e.formulation == "cuda-packed" for e in entries)
    # Without rows_per_block only the problem's own launches are warmed:
    # its hot configs (the cost sheet's top-K) first, then the rest.
    alone = select_warmset(prob, "cuda")
    assert {e.source for e in alone} == {"hot-config", "schedule"}
    assert alone[0].source == "hot-config"


def test_warmset_routes_past_the_int32_window_to_gather():
    """A launch the kernels' window refuses runs gather
    (``dispatch.effective_backend``); its entry says so."""
    prob = parse_problem(io.StringIO("1000000000 1 1 1\nABBAB\n3\nA\nAB\nBA\n"))
    entries = select_warmset(prob, "cuda")
    assert [e.formulation for e in entries] == ["gather"]
    assert [e.formulation for e in select_warmset(tiny_problem(), "mm")] == ["mm"]


def test_warmset_oracle_backend_empty():
    assert select_warmset(tiny_problem(), "oracle") == []


def test_warm_entry_roundtrip_and_refusals():
    e = WarmEntry("cuda-packed", 128, 16, 40, 3072, "serve-block")
    d = e.to_dict()
    assert d["cache_key"] == list(e.cache_key) == ["cuda-packed", 128, 16]
    back = WarmEntry.from_dict(json.loads(json.dumps(d)))
    assert back == e and back.executable_key == e.executable_key
    # l1p sizes the warm launch but does not tell two entries apart.
    assert WarmEntry("cuda-packed", 128, 16, 40, 128).executable_key == e.executable_key
    with pytest.raises(ValueError, match="missing"):
        WarmEntry.from_dict({"formulation": "cuda-fused", "l1p": 128, "l2p": 128})
    with pytest.raises(ValueError, match="packing class"):
        WarmEntry.from_dict({**d, "formulation": "cuda-fused"})


def test_jax_entries_are_refused():
    """A JAX manifest's entry (formulation pallas / xla-*) is never a port
    entry."""
    from mpi_openmp_cuda_tpu.aot.warmset import select_warmset as jax_select

    jax_entries = jax_select(tiny_problem(), "xla")
    assert jax_entries
    for je in jax_entries:
        with pytest.raises(ValueError):
            WarmEntry.from_dict(je.to_dict())


def test_fingerprint_keys_on_the_toolchain_and_device(monkeypatch):
    from mpi_openmp_cuda_tpu_torch.ops import _build

    fp = backend_fingerprint("cpu")
    assert re.fullmatch(r"[0-9a-f]{16}", fp["digest"])
    assert fp["device"] == "cpu" and fp["platform_tag"] == platform_tag("cpu") == "cpu"
    assert fp["torch"] == torch.__version__
    assert backend_fingerprint("cpu") == fp
    real = _build.source_digest
    monkeypatch.setattr(_build, "source_digest", lambda name: "0" + real(name)[1:])
    assert backend_fingerprint("cpu")["digest"] != fp["digest"]


# -- manifest -----------------------------------------------------------------


def _manifest_for(entries, fp):
    return build_manifest([(e, 0.25, 1024) for e in entries], fp)


def test_manifest_roundtrip_and_staleness(tmp_path):
    fp = backend_fingerprint("cpu")
    entries = select_warmset(input3_class_problem(), "cuda", rows_per_block=ROWS_PER_BLOCK)
    path = str(tmp_path / "aot" / "manifest.json")
    report = _manifest_for(entries, fp)
    validate_report(report)
    write_manifest(report, path)
    loaded = load_manifest(path)
    assert loaded is not None and loaded["kind"] == MANIFEST_KIND
    assert loaded["totals"] == {"entries": len(entries), "compile_wall_s": 0.25 * len(entries),
                                "bytes": 1024 * len(entries)}
    fresh, stale = split_entries(loaded, fp["digest"])
    assert fresh == entries and stale == []
    # Another digest (torch, CUDA, card, flags or kernel source changed)
    # makes every entry stale: listed, never replayed.
    fresh2, stale2 = split_entries(loaded, "0" * 16)
    assert fresh2 == [] and len(stale2) == len(entries)


def test_manifest_schema_rejects_corruption(tmp_path):
    report = _manifest_for(select_warmset(tiny_problem(), "cuda"), backend_fingerprint("cpu"))
    report["entries"][0].pop("fingerprint")
    with pytest.raises(ValueError, match="invalid run report"):
        validate_report(report)
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert load_manifest(str(bad)) is None
    bad.write_text(json.dumps(report))
    assert load_manifest(str(bad)) is None
    assert load_manifest(str(tmp_path / "absent.json")) is None


def test_default_manifest_path(cache_home, monkeypatch):
    assert default_manifest_path("cpu") == str(cache_home / "aot" / "cpu.json")
    monkeypatch.setenv("TPU_SEQALIGN_COMPILE_CACHE", "off")
    assert default_manifest_path("cpu") is None


# -- prewarm ------------------------------------------------------------------


def test_prewarm_populates_then_replays(tmp_path):
    path = str(tmp_path / "m.json")
    prob = tiny_problem()
    s1 = prewarm(prob, "cuda", rows_per_block=ROWS_PER_BLOCK, manifest_path=path, device="cpu")
    want = select_warmset(prob, "cuda", rows_per_block=ROWS_PER_BLOCK)
    assert s1["entries"] == s1["compiled"] == len(want) > 0
    assert (s1["replayed"], s1["stale"], s1["failed"], s1["cache_dir"]) == (0, 0, 0, None)
    s2 = prewarm(manifest_path=path, device="cpu")
    assert s2["replayed"] == s2["entries"] == len(want)
    assert (s2["stale"], s2["failed"]) == (0, 0)
    fresh, _ = split_entries(load_manifest(path), backend_fingerprint("cpu")["digest"])
    assert [identity(e) for e in fresh] == [identity(e) for e in want]


def test_prewarm_rewarms_stale_entries(tmp_path):
    """Entries recorded under another fingerprint are re-warmed under the
    current one and written back fresh, as ``stale-rewarm``."""
    path = str(tmp_path / "m.json")
    fp = dict(backend_fingerprint("cpu"))
    fp["digest"] = "f" * 16
    entries = select_warmset(tiny_problem(), "cuda", rows_per_block=ROWS_PER_BLOCK)
    write_manifest(_manifest_for(entries, fp), path)
    summary = prewarm(manifest_path=path, device="cpu")
    assert summary["stale"] == summary["compiled"] == len(entries)
    assert summary["replayed"] == 0
    reloaded = load_manifest(path)
    fresh, stale = split_entries(reloaded, backend_fingerprint("cpu")["digest"])
    assert len(fresh) == len(entries) and stale == []
    assert {e.source for e in fresh} == {"stale-rewarm"}
    assert len(reloaded["stale"]) == len(entries)


def test_jax_manifest_is_never_replayed(tmp_path):
    """A JAX manifest at the same path: another digest, so stale, and its
    entries are dropped (not port entries): nothing replays or warms."""
    from mpi_openmp_cuda_tpu.aot import manifest as jmanifest
    from mpi_openmp_cuda_tpu.aot import warmset as jwarmset

    path = str(tmp_path / "m.json")
    jentries = jwarmset.select_warmset(tiny_problem(), "xla")
    jfp = jwarmset.backend_fingerprint()
    jmanifest.write_manifest(jmanifest.build_manifest([(e, 0.5, None) for e in jentries], jfp),
                             path)
    summary = prewarm(manifest_path=path, device="cpu")
    assert (summary["replayed"], summary["compiled"], summary["entries"]) == (0, 0, 0)
    assert summary["stale"] == len(jentries)
    assert jfp["digest"] != backend_fingerprint("cpu")["digest"]


def test_prewarm_failure_is_advisory(tmp_path, monkeypatch):
    """A failed entry is counted and logged; the rest are warmed and
    written; nothing raises."""
    real = aot_compile.compile_entry
    import mpi_openmp_cuda_tpu_torch.aot.prewarm as aot_prewarm

    def flaky(entry, device=None):
        if entry.formulation == "cuda-packed":
            raise RuntimeError("injected")
        return real(entry, device)

    monkeypatch.setattr(aot_prewarm, "compile_entry", flaky)
    path = str(tmp_path / "m.json")
    prob = tiny_problem()
    summary = prewarm(prob, "cuda", rows_per_block=ROWS_PER_BLOCK, manifest_path=path,
                      device="cpu")
    want = select_warmset(prob, "cuda", rows_per_block=ROWS_PER_BLOCK)
    packed = sum(e.formulation == "cuda-packed" for e in want)
    assert packed and summary["failed"] == packed
    assert summary["compiled"] == len(want) - packed
    assert load_manifest(path)["totals"]["entries"] == len(want) - packed


# -- compile_entry: what dispatch would call -----------------------------------


def _dispatch_launches(prob):
    """(l2p, l2s, rows) of each launch the real dispatch runs for ``prob``
    on the CPU, spied at ``dispatch.run_launch``."""
    seen = []
    real = dispatch.run_launch

    def spy(launch, backend):
        seen.append((launch.state.rows.shape[1], launch.l2s, launch.state.rows.shape[0]))
        return real(launch, backend)

    mp = pytest.MonkeyPatch()
    mp.setattr(dispatch, "run_launch", spy)
    try:
        dispatch.AlignmentScorer("cuda", device="cpu").score_codes(
            prob.seq1_codes, prob.seq2_codes, prob.weights)
    finally:
        mp.undo()
    return seen


@pytest.mark.parametrize("form", ["cuda-fused", "cuda-packed"])
def test_compile_entry_calls_what_dispatch_calls(form, monkeypatch):
    """On the card ``compile_entry`` loads the kernels, opts in the fused
    width (``check_smem``, as ``fused_scorer`` does) and launches through
    ``run_launch`` at the entry's width, class and rows: the calls the
    dispatch makes for the same launch.  The card is stood in for (the
    launch itself runs the plain version on the CPU)."""
    prob = parse_problem(io.StringIO(
        "4 3 2 1\n" + "ACGT" * 100 + "\n10\n" + "\n".join(
            ["ACGTAC", "GATTACA", "TTT", "ACG", "GGGGA", "CATCAT", "AAAA", "CGCG",
             "ACGT" * 40, "TTGA" * 50]) + "\n"))
    dispatched = _dispatch_launches(prob)
    entries = [e for e in select_warmset(prob, "cuda") if e.formulation == form]
    assert len(entries) == 1
    entry = entries[0]
    assert (entry.l2p, entry.l2s, entry.rows) in dispatched

    calls = []
    real_run = dispatch.run_launch
    monkeypatch.setattr(aot_compile, "_on_card", lambda dev: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: calls.append("sync"))
    monkeypatch.setattr(cuda_scorer, "load_kernels", lambda: calls.append("load"))
    monkeypatch.setattr(cuda_scorer, "check_smem",
                        lambda st: calls.append(("smem", st.rows.shape[1])))

    def run_spy(launch, backend):
        calls.append(("launch", backend, launch.state.rows.shape[1], launch.l2s,
                      launch.state.rows.shape[0]))
        return real_run(launch, backend)

    monkeypatch.setattr(dispatch, "run_launch", run_spy)
    wall, nbytes = aot_compile.compile_entry(entry, "cpu")
    smem = [("smem", entry.l2p)] if form == "cuda-fused" else []
    assert calls == ["load", *smem,
                     ("launch", "cuda", entry.l2p, entry.l2s, entry.rows), "sync"]
    assert wall > 0 and nbytes > entry.rows * entry.l2p * 4


def test_compile_entry_on_the_cpu_runs_the_plain_version(monkeypatch):
    """Under ``--device cpu`` nothing is built or loaded: the launch runs
    the plain version at the entry's shape."""
    def refuse():
        raise AssertionError("load_kernels on the CPU")

    monkeypatch.setattr(cuda_scorer, "load_kernels", refuse)
    monkeypatch.setattr(cuda_scorer, "check_smem", refuse)
    entry = WarmEntry("cuda-fused", 256, None, 5, 384)
    launch = aot_compile.synthetic_launch(entry, torch.device("cpu"))
    assert launch.state.rows.shape == (5, 256) and launch.state.l1p == 384
    wall, nbytes = aot_compile.compile_entry(entry, "cpu")
    assert wall > 0 and nbytes > 0


# -- through the entry points -----------------------------------------------------


def _manifest_file(cache_home) -> Path:
    return cache_home / "aot" / "cpu.json"


@pytest.mark.parametrize("name", ["tiny", "mixedcase"])
def test_cli_prewarm_matches_golden_and_jax_cli(name, cache_home, monkeypatch, capfd):
    path = FIXTURES / f"{name}.txt"
    report = cache_home.parent / "report.json"
    rc = tcli.run(["--device", "cpu", "--prewarm", "--input", str(path),
                   "--metrics-out", str(report)])
    cap = capfd.readouterr()
    assert rc == 0, cap.err
    assert cap.out == path.with_suffix(".out").read_text()
    assert re.search(r"prewarmed (\d+)/\1 launch shapes .*failed 0", cap.err), cap.err
    manifest = json.loads(_manifest_file(cache_home).read_text())
    validate_report(manifest)
    assert manifest["totals"]["entries"] > 0
    rep = json.loads(report.read_text())
    assert rep["counters"]["aot.compiled"] == manifest["totals"]["entries"]
    assert "prewarm" in dict(rep["spans"]["phases"])
    # The JAX CLI under --prewarm prints the same bytes (its cache home is
    # off here, as the suite keeps it).
    monkeypatch.setenv("TPU_SEQALIGN_COMPILE_CACHE", "off")
    jax_out, _ = jax_cli_inproc("--prewarm", "--input", str(path), capsys=capfd)
    assert jax_out == cap.out


def test_prewarm_leaves_the_config_gauges_to_the_dispatch(cache_home, capfd):
    """The warm set is planned without recording: the run report's
    ``config_*`` gauges are the batch's own, as without ``--prewarm``."""
    path = FIXTURES / "stress_small.txt"
    gauges = {}
    for flag in ([], ["--prewarm"]):
        report = cache_home.parent / f"report{len(flag)}.json"
        rc = tcli.run(["--device", "cpu", *flag, "--input", str(path),
                       "--metrics-out", str(report)])
        assert rc == 0, capfd.readouterr().err
        g = json.loads(report.read_text())["gauges"]
        gauges[bool(flag)] = {k: v for k, v in g.items() if k.startswith("config_")}
    capfd.readouterr()
    assert gauges[True] == gauges[False] and gauges[False]


def test_env_flag_prewarms_and_malformed_flag_is_usage(cache_home, monkeypatch, capfd):
    path = FIXTURES / "tiny.txt"
    monkeypatch.setenv("SEQALIGN_PREWARM", "1")
    rc = tcli.run(["--device", "cpu", "--input", str(path)])
    cap = capfd.readouterr()
    assert rc == 0 and cap.out == path.with_suffix(".out").read_text()
    assert "prewarmed" in cap.err and _manifest_file(cache_home).exists()
    monkeypatch.setenv("SEQALIGN_PREWARM", "maybe")
    assert tcli.run(["--device", "cpu", "--input", str(path)]) == tcli.EX_USAGE
    assert "SEQALIGN_PREWARM" in capfd.readouterr().err


def test_stream_prewarm_replays_only(cache_home, capfd):
    path = FIXTURES / "stress_small.txt"
    rc = tcli.run(["--device", "cpu", "--prewarm", "--input", str(path)])
    first = capfd.readouterr()
    assert rc == 0, first.err
    entries = json.loads(_manifest_file(cache_home).read_text())["totals"]["entries"]
    rc = tcli.run(["--device", "cpu", "--prewarm", "--stream", "7", "--input", str(path)])
    cap = capfd.readouterr()
    assert rc == 0 and cap.out == path.with_suffix(".out").read_text()
    assert f"prewarmed {entries}/{entries} launch shapes" in cap.err
    assert f"(replayed {entries}, stale 0, failed 0" in cap.err


def test_restarted_serve_prewarm_replays_manifest(cache_home, tmp_path, capfd):
    """A batch --prewarm populates the manifest; a restarted --serve
    --prewarm replays every entry, pins its steady baseline at tick 0
    (serve_prewarmed 1) and stays at zero builds, loads and setups; its
    lines are the batch CLI's."""
    weights = [10, 2, 3, 4]
    seq1 = "ACDEFGHIKLMNPQRSTVWY" * 12
    rng = np.random.default_rng(5)
    alpha = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
    seqs = ["".join(rng.choice(alpha, size=int(n))) for n in rng.integers(4, 60, size=20)]
    seqs += ["".join(rng.choice(alpha, size=int(n))) for n in (150, 170, 200)]
    batch = tmp_path / "batch.txt"
    batch.write_text(" ".join(map(str, weights)) + f"\n{seq1}\n{len(seqs)}\n"
                     + "\n".join(seqs) + "\n")
    rc = tcli.run(["--device", "cpu", "--prewarm", "--input", str(batch)])
    first = capfd.readouterr()
    assert rc == 0, first.err
    entries = json.loads(_manifest_file(cache_home).read_text())["totals"]["entries"]
    assert entries > 0

    reqs = tmp_path / "reqs.ndjson"
    reqs.write_text(json.dumps({"id": "r", "weights": weights, "seq1": seq1, "seq2": seqs})
                    + "\n")
    report = tmp_path / "serve.json"
    rc = tcli.run(["--device", "cpu", "--serve", "--prewarm", "--input", str(reqs),
                   "--metrics-out", str(report)])
    cap = capfd.readouterr()
    assert rc == 0, cap.err
    assert f"prewarmed {entries}/{entries} launch shapes" in cap.err
    assert f"(replayed {entries}, stale 0, failed 0" in cap.err
    rep = json.loads(report.read_text())
    assert rep["gauges"]["serve_prewarmed"] == 1
    assert rep["gauges"]["serve_steady_compiles"] == 0
    assert rep["counters"]["aot.entries"] == entries
    records = [json.loads(line) for line in cap.out.splitlines() if line.strip()]
    lines = [r["line"] for r in records if "line" in r]
    assert "\n".join(lines) + "\n" == first.out


def test_serve_without_prewarm_keeps_the_first_block_baseline(cache_home, tmp_path, capfd):
    reqs = tmp_path / "reqs.ndjson"
    reqs.write_text(json.dumps({"id": "r", "weights": [1, 2, 3, 4], "seq1": "ACGTACGT",
                                "seq2": ["ACGT"]}) + "\n")
    report = tmp_path / "serve.json"
    rc = tcli.run(["--device", "cpu", "--serve", "--input", str(reqs),
                   "--metrics-out", str(report)])
    cap = capfd.readouterr()
    assert rc == 0, cap.err
    assert "prewarmed" not in cap.err
    rep = json.loads(report.read_text())
    assert "serve_prewarmed" not in rep["gauges"]
    assert rep["gauges"]["serve_steady_compiles"] == 0
    assert not _manifest_file(cache_home).exists()


def test_bench_prewarm_record(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("BENCH_") and k != "TPU_SEQALIGN_COMPILE_CACHE"}
    env.update(BENCH_INPUT=str(FIXTURES / "stress_small.txt"), BENCH_REPS="1",
               SEQALIGN_PREWARM="1", SEQALIGN_CACHE_DIR=str(tmp_path))
    proc = subprocess.run(
        [sys.executable, "-m", "mpi_openmp_cuda_tpu_torch.bench", "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=240,
    )
    assert proc.returncode == 0, proc.stderr
    rec = json.loads(proc.stdout.strip())
    validate_report(rec)
    assert rec["prewarmed"] is True
    assert "(prewarmed)" in proc.stderr and "prewarmed" in proc.stderr
    assert (tmp_path / "aot" / "cpu.json").exists()
