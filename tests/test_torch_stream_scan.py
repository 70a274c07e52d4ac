"""The streamed database scan (the ``scan-stream`` cell's deployment) on the
CPU at small sizes: ``--stream`` at chunks 1, 7 and 256 on heavy-tailed scan
inputs is byte-identical to the batch CLI, to the JAX package's ``--stream``
and to the plain PyTorch reference (``seqbench/reference_torch.py``); the
stream's five detail spans cover its ``stream`` phase; ``stream_chunks``,
``stream_window_full`` and ``dispatch_launched_cells`` count what they say,
the last as the kernels' loop bounds set it; and an ``int16`` accumulator
gets the widest weights' scan wrong."""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from mpi_openmp_cuda_tpu.io import cli as jcli
from mpi_openmp_cuda_tpu_torch.io import cli as tcli
from mpi_openmp_cuda_tpu_torch.io import pipeline
from mpi_openmp_cuda_tpu_torch.models.encoding import encode_normalized
from mpi_openmp_cuda_tpu_torch.obs import spans as tspans
from mpi_openmp_cuda_tpu_torch.ops import dispatch
from mpi_openmp_cuda_tpu_torch.utils.profiling import PhaseTimer
from seqbench import generate, reference, reference_torch, scanjobs
from seqbench.roofline import needed_cells

LEN1 = 420
ROWS = 48
LAW = {"law": "lognormal", "median": 60, "sigma": 0.9}
WIDEST = (100, 2, 3, 4)
WEIGHTS = [WIDEST, (2, 2, 1, 10)]
SPANS = ("stream.parse", "stream.stage", "stream.submit", "stream.window_wait",
         "stream.finish")


@pytest.fixture(autouse=True)
def _quiet_env(monkeypatch):
    monkeypatch.setenv("SEQALIGN_BACKOFF_BASE", "0")
    for var in ("SEQALIGN_DEADLINE_S", "SEQALIGN_DRAIN", "SEQALIGN_FAULTS",
                "SEQALIGN_FAULT_RETRIES", "SEQALIGN_METRICS", "SEQALIGN_METRICS_OUT",
                "SEQALIGN_TRACE", "TPU_SEQALIGN_STREAM_DEPTH"):
        monkeypatch.delenv(var, raising=False)


@functools.cache
def scan(weights) -> tuple[str, list[str], list[str]]:
    """A scan job at a CPU's size: ``(stdin text, Seq1, Seq2s)``.  Its
    lengths are the scan law's quantiles (a long tail past 128 chars and a
    few rows of packing classes), shuffled; two rows are homologs of the
    query of 380 chars (past 2**15 at weight 100), one is as long as the
    query and one longer (INT32_MIN)."""
    rng = generate.rng_for(26, 1)
    seq1 = rng.integers(0, 26, LEN1)
    lens = [int(x) for x in rng.permutation(scanjobs.quantile_lengths(ROWS - 4, LAW, 1, 300))]
    seqs = [generate.text_of(rng.integers(0, 26, n)) for n in lens]
    homologs = [generate.text_of(generate.homolog(rng, seq1, 380, 0.06)) for _ in range(2)]
    edges = [generate.text_of(rng.integers(0, 26, n)) for n in (LEN1, LEN1 + 9)]
    for at, s in zip((5, 17, 30, 41), homologs + edges):
        seqs.insert(at, s)
    s1 = generate.text_of(seq1)
    text = " ".join(str(w) for w in weights) + f"\n{s1}\n{len(seqs)}\n" + "\n".join(seqs) + "\n"
    return text, s1, seqs


def cli_out(tmp_path, capfd, *args) -> str:
    path = tmp_path / "scan.txt"
    if not path.exists():
        path.write_text(scan(WIDEST)[0])
    rc = tcli.run(["--input", str(path), "--device", "cpu", *args])
    cap = capfd.readouterr()
    assert rc == 0, cap.err
    return cap.out


def test_the_scan_holds_the_edge_rows():
    """INT32_MIN rows, a row as long as Seq1, scores past 2**15 at the
    widest weights, and chunk boundaries of 7 inside a length bucket."""
    _, s1, seqs = scan(WIDEST)
    rows = reference_torch.scores(WIDEST, s1, seqs)
    lens = [len(s) for s in seqs]
    assert rows[lens.index(LEN1 + 9)] == (reference_torch.INT32_MIN, 0, 0)
    assert rows[lens.index(LEN1)][1:] == (0, 0)
    assert sum(r[0] >= 2**15 for r in rows) == 2
    bucket = [dispatch.round_up(n, 128) for n in lens]
    assert any(bucket[i - 1] == bucket[i] for i in range(7, ROWS, 7))
    assert max(lens[:-1]) > 128 and min(lens) <= 8


@pytest.mark.parametrize("weights", WEIGHTS, ids=["w100", "w2"])
@pytest.mark.parametrize("chunk", [1, 7, 256])
def test_stream_equals_the_batch_cli_and_the_reference(chunk, weights, tmp_path, capfd):
    text, s1, seqs = scan(weights)
    (tmp_path / "scan.txt").write_text(text)
    batch = cli_out(tmp_path, capfd)
    stream = cli_out(tmp_path, capfd, "--stream", str(chunk))
    assert stream == batch
    assert stream == reference_torch.stdout(text)
    # The JAX package streams the same file in the same chunks.
    rc = jcli.run(["--backend", "xla-gather", "--input", str(tmp_path / "scan.txt"),
                   "--stream", str(chunk)])
    cap = capfd.readouterr()
    assert rc == 0, cap.err
    assert stream == cap.out


def _listened(monkeypatch) -> list:
    seen: list = []

    class Listened(PhaseTimer):
        def __init__(self, enabled=False, recorder=None):
            recorder = recorder if recorder is not None else tspans.SpanRecorder()
            recorder.listeners.append(lambda *span: seen.append(span))
            super().__init__(enabled, recorder=recorder)

    monkeypatch.setattr(tcli, "PhaseTimer", Listened)
    return seen


@pytest.mark.parametrize("chunk", [1, 7])
def test_the_stream_spans_cover_the_stream_phase(chunk, monkeypatch, tmp_path, capfd):
    seen = _listened(monkeypatch)
    cli_out(tmp_path, capfd, "--stream", str(chunk))
    (start, dur), = [(s, d) for p, s, d in seen if p == "stream"]
    mine = [(p, s, d) for p, s, d in seen if p in SPANS]
    assert {p for p, _, _ in mine} == set(SPANS)
    assert all(start <= s and s + d <= start + dur for _, s, d in mine)
    # Disjoint, and all of the phase but a few statements a chunk.
    ends = sorted((s, s + d) for _, s, d in mine)
    assert all(a[1] <= b[0] + 1e-9 for a, b in zip(ends, ends[1:]))
    assert sum(d for _, _, d in mine) >= 0.9 * dur
    # The dispatch's own spans keep their paths beside them.
    assert {"stream.chunk_dispatch", "stream.chunk_gather"} <= {p for p, _, _ in seen}
    chunks = -(-ROWS // chunk)
    assert sum(p == "stream.parse" for p, _, _ in mine) == chunks + 1
    assert sum(p == "stream.submit" for p, _, _ in mine) == chunks


@pytest.mark.parametrize("chunk,depth", [(1, 4), (7, 4), (7, 2), (256, 4)])
def test_stream_counters_count_chunks_and_full_windows(chunk, depth, monkeypatch, tmp_path,
                                                       capfd):
    monkeypatch.setenv("TPU_SEQALIGN_STREAM_DEPTH", str(depth))
    before = dict(pipeline.stream_counts)
    cli_out(tmp_path, capfd, "--stream", str(chunk))
    chunks = -(-ROWS // chunk)
    assert pipeline.stream_counts["stream_chunks"] - before["stream_chunks"] == chunks
    assert (pipeline.stream_counts["stream_window_full"] - before["stream_window_full"]
            == max(0, chunks - depth))


def _plans(text: str, chunk: int):
    tokens = text.split()
    weights = [int(t) for t in tokens[:4]]
    seq1 = encode_normalized(tokens[4])
    codes = [encode_normalized(s) for s in tokens[6:]]
    for at in range(0, len(codes), chunk):
        yield from dispatch.launch_plans(seq1, codes[at : at + chunk], weights)[1]


@pytest.mark.parametrize("chunk", [7, 256])
def test_launched_cells_count_every_launch(chunk, tmp_path, capfd):
    """``dispatch_launched_cells`` rises by each launch's cells at its
    padded shapes; every plan's cells are at least its needed cells."""
    text = scan(WIDEST)[0]
    plans = list(_plans(text, chunk))
    total0 = dispatch.dispatch_counts["dispatch_launched_cells"]
    cli_out(tmp_path, capfd, "--stream", str(chunk))
    total = dispatch.dispatch_counts["dispatch_launched_cells"]
    assert total - total0 == sum(p.launched_cells for p in plans)
    for p in plans:
        assert p.launched_cells >= needed_cells(p.len1, p.len2)
    lens = [len(s) for s in scan(WIDEST)[2]]
    assert sum(p.launched_cells for p in plans) > needed_cells(LEN1, lens)


def _loop_bounds(len1: int, lens, l2s) -> int:
    """The cells the kernels' loops walk, block by block and lane by lane
    (csrc/fused_kernels.cuh ``tile_kernel``, csrc/packed_scorer.cu
    ``tile_kernel``)."""
    cells = 0
    ntiles = dispatch.round_up(len1, 128) // 128
    for len2 in lens:
        nvalid = len1 - int(len2)
        chars = (int(len2) + 3) & ~3
        for t in range(ntiles):
            n0 = t * 128
            if t > 0 and n0 >= nvalid:
                continue  # the offset-tile skip
            for lane in range(32):
                nb = n0 + 4 * lane
                if l2s is not None or nb < nvalid or nb == 0:
                    cells += 4 * chars
    return cells


@pytest.mark.parametrize("l2s", [None, 8, 16, 32, 64])
@pytest.mark.parametrize("len1", [1, 130, 420])
def test_kernel_cells_are_the_kernels_loop_bounds(len1, l2s):
    rng = np.random.default_rng(len1 * 7 + (l2s or 0))
    top = l2s or 2 * len1 + 3
    lens = [0, 1, len1, len1 + 1, *rng.integers(1, top + 1, 20)]
    lens = [n for n in lens if l2s is None or n <= l2s]
    assert dispatch.kernel_cells(len1, lens, l2s) == _loop_bounds(len1, lens, l2s)


def test_an_int16_accumulator_gets_the_widest_scan_wrong():
    text, s1, seqs = scan(WIDEST)
    want = reference_torch.stdout(text).splitlines()
    for got in (reference_torch.stdout(text, acc=torch.int16).splitlines(),
                reference.stdout(text, acc=np.int16).splitlines()):
        assert len(got) == len(want) and sum(a != b for a, b in zip(got, want)) >= 2
