"""The port's ``--stream`` and ``--journal`` paths against the goldens and
the JAX CLI: byte-identical stdout on the seven fixtures, journals equal
byte for byte to the JAX CLI's, resume across the two packages in both
directions (a journal the JAX CLI wrote and was stopped after its first
chunk finishes under the port, and the other way round), and the usage
and foreign-journal exits."""

from __future__ import annotations

import io
import json
from pathlib import Path

import numpy as np
import pytest

from mpi_openmp_cuda_tpu.io import cli as jcli
from mpi_openmp_cuda_tpu.io import parse as jparse
from mpi_openmp_cuda_tpu.ops.oracle import prefix_best
from mpi_openmp_cuda_tpu_torch.io import cli as tcli
from mpi_openmp_cuda_tpu_torch.io import parse as tparse
from mpi_openmp_cuda_tpu_torch.utils import journal as tjournal

REPO = Path(__file__).resolve().parent.parent
FIXTURES = sorted((REPO / "tests" / "fixtures").glob("*.txt"), key=lambda p: p.name)
IDS = [p.stem for p in FIXTURES]


@pytest.fixture(autouse=True)
def _quiet_env(monkeypatch):
    monkeypatch.setenv("SEQALIGN_BACKOFF_BASE", "0")
    for var in ("SEQALIGN_DEADLINE_S", "SEQALIGN_DRAIN", "SEQALIGN_FAULTS",
                "SEQALIGN_FAULT_RETRIES"):
        monkeypatch.delenv(var, raising=False)


def port(*args, capfd, rc_want=0):
    rc = tcli.run(["--device", "cpu", *args])
    cap = capfd.readouterr()
    assert rc == rc_want, cap.err
    return cap.out, cap.err


def jax(*args, capfd, rc_want=0):
    rc = jcli.run(["--backend", "xla-gather", *args])
    cap = capfd.readouterr()
    assert rc == rc_want, cap.err
    return cap.out, cap.err


@pytest.mark.parametrize("path", FIXTURES, ids=IDS)
def test_stream_and_journals_match_golden_and_jax(path, tmp_path, capfd):
    gold = path.with_suffix(".out").read_text()
    for chunk in ("1", "3", "64"):
        out, _ = port("--input", str(path), "--stream", chunk, capfd=capfd)
        assert out == gold
    # --stream --journal and batch --journal: stdout == golden, and the
    # journal files equal the JAX CLI's byte for byte.
    for mode in (["--stream", "3"], []):
        tj, jj = tmp_path / f"t{len(mode)}.jsonl", tmp_path / f"j{len(mode)}.jsonl"
        out, _ = port("--input", str(path), *mode, "--journal", str(tj), capfd=capfd)
        assert out == gold
        jout, _ = jax("--input", str(path), *mode, "--journal", str(jj), capfd=capfd)
        assert jout == gold
        assert tj.read_bytes() == jj.read_bytes()
        # A finished journal resumes to the golden with nothing rescored.
        out, _ = port("--input", str(path), *mode, "--journal", str(tj), "--resume",
                      capfd=capfd)
        assert out == gold and tj.read_bytes() == jj.read_bytes()


@pytest.mark.parametrize("path", FIXTURES, ids=IDS)
def test_backends_and_drain_resume_match_golden(path, tmp_path, monkeypatch, capfd):
    """Every backend prints the golden; a pre-armed drain exits 75 with
    nothing on stdout, and --resume from its journal prints the golden.  An
    empty batch has no chunk boundary to drain at and finishes, as the JAX
    CLI does."""
    gold = path.with_suffix(".out").read_text()
    for backend in ("cuda", "mm", "gather"):
        out, _ = port("--input", str(path), "--backend", backend, capfd=capfd)
        assert out == gold
    empty = int(path.read_text().split()[5]) == 0
    for mode in (["--stream", "2"], []):
        j = str(tmp_path / f"d{len(mode)}.jsonl")
        monkeypatch.setenv("SEQALIGN_DRAIN", "1")
        out, err = port("--input", str(path), *mode, "--journal", j, capfd=capfd,
                        rc_want=0 if empty else 75)
        assert out == gold if empty else (out == "" and "drained" in err)
        monkeypatch.delenv("SEQALIGN_DRAIN")
        out, _ = port("--input", str(path), *mode, "--journal", j, "--resume", capfd=capfd)
        assert out == gold


def test_stream_json_sidecar_equals_batch(tmp_path, capfd):
    path = str(REPO / "tests" / "fixtures" / "stress_small.txt")
    port("--input", path, "--json", str(tmp_path / "b.json"), capfd=capfd)
    port("--input", path, "--stream", "4", "--json", str(tmp_path / "s.json"), capfd=capfd)
    assert json.loads((tmp_path / "b.json").read_text()) == json.loads(
        (tmp_path / "s.json").read_text())


def test_resume_without_journal_is_a_usage_error(capfd):
    out, err = port("--input", str(FIXTURES[0]), "--stream", "2", "--resume", capfd=capfd,
                    rc_want=64)
    assert out == "" and "--resume requires --journal" in err


def test_foreign_journals_are_fatal(tmp_path, capfd):
    tiny = str(REPO / "tests" / "fixtures" / "tiny.txt")
    other = str(REPO / "tests" / "fixtures" / "stress_small.txt")
    batch_j, stream_j = str(tmp_path / "b.jsonl"), str(tmp_path / "s.jsonl")
    port("--input", tiny, "--journal", batch_j, capfd=capfd)
    port("--input", tiny, "--stream", "2", "--journal", stream_j, capfd=capfd)
    # Another problem's journal, and each mode's journal under the other.
    for args, msg in (
        (["--input", other, "--journal", batch_j], "different problem"),
        (["--input", other, "--stream", "2", "--journal", stream_j], "different problem"),
        (["--input", tiny, "--stream", "2", "--journal", batch_j], "cannot resume a --stream"),
        (["--input", tiny, "--journal", stream_j], "not a mpi_openmp_cuda_tpu.journal.v1"),
    ):
        out, err = port(*args, capfd=capfd, rc_want=65)
        assert out == "" and msg in err


def _big_input(path: Path) -> str:
    """150 Seq2 of 1..59 chars against a 300-char Seq1; returns the
    oracle's output."""
    rng = np.random.default_rng(5)
    letters = np.array(list("ABCDEFGHIJKLMNOPQRSTUVWXYZ"))
    seq1 = "".join(rng.choice(letters, size=300))
    seqs = ["".join(rng.choice(letters, size=int(n))) for n in rng.integers(1, 60, size=150)]
    path.write_text("\n".join(["3 1 2 4", seq1, str(len(seqs)), *seqs]) + "\n")
    prob = tparse.load_problem(str(path))
    return "".join(
        f"#{i}: score: {s}, n: {n}, k: {k}\n"
        for i, (s, n, k) in enumerate(prefix_best(prob.seq1_codes, q, prob.weights)
                                      for q in prob.seq2_codes))


@pytest.mark.parametrize("mode", [[], ["--stream", "16"]], ids=["batch", "stream"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_cut_after_first_chunk_resumes_in_the_other_package(
        mode, writer, tmp_path, capfd):
    """The writer fails its second journal append (a fault with no
    retries): its journal holds the header and the first chunk.  The other
    package resumes from it and prints the golden; the finished journal
    holds every index once."""
    inp = tmp_path / "big.txt"
    gold = _big_input(inp)
    path = str(tmp_path / "j.jsonl")
    first, second = (jax, port) if writer == "jax" else (port, jax)
    out, err = first("--input", str(inp), *mode, "--journal", path,
                     "--faults", "journal_append:fail=1,after=1", capfd=capfd, rc_want=65)
    assert out == "" and "retry budget exhausted" in err
    lines = Path(path).read_text().splitlines()
    chunk = 16 if mode else tjournal.DEFAULT_CHUNK
    assert len(lines) == 1 + chunk
    out, _ = second("--input", str(inp), *mode, "--journal", path, "--resume", capfd=capfd)
    assert out == gold
    idx = [json.loads(line)["index"] for line in Path(path).read_text().splitlines()[1:]]
    assert sorted(idx) == list(range(150))


def test_fingerprints_and_hashes_equal_jax():
    from mpi_openmp_cuda_tpu.utils import journal as jjournal

    prob = tparse.load_problem(str(REPO / "tests" / "fixtures" / "stress_small.txt"))
    assert tjournal.problem_fingerprint(prob) == jjournal.problem_fingerprint(prob)
    assert tjournal.stream_fingerprint(prob.weights, prob.seq1_codes, 9) == (
        jjournal.stream_fingerprint(prob.weights, prob.seq1_codes, 9))
    assert [tjournal.seq_hash(c) for c in prob.seq2_codes] == [
        jjournal.seq_hash(c) for c in prob.seq2_codes]
    assert (tjournal._FORMAT, tjournal._STREAM_FORMAT) == (
        jjournal._FORMAT, jjournal._STREAM_FORMAT)


@pytest.mark.parametrize("path", FIXTURES, ids=IDS)
def test_stream_header_then_chunks_match_jax(path):
    text = path.read_text()
    th = tparse.parse_stream_header(io.StringIO(text))
    jh = jparse.parse_stream_header(io.StringIO(text))
    assert (th.weights, th.seq1, th.num_seq2) == (jh.weights, jh.seq1, jh.num_seq2)
    np.testing.assert_array_equal(th.seq1_codes, jh.seq1_codes)
    tc, jc = list(th.iter_chunks(2)), list(jh.iter_chunks(2))
    assert [s for s, _ in tc] == [s for s, _ in jc]
    for (_, a), (_, b) in zip(tc, jc):
        assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


def test_stream_truncated_input_emits_nothing(tmp_path, capfd):
    path = tmp_path / "cut.txt"
    path.write_text("1 2 3 4\nABCDEFG\n4\nABC\nBCD\n")
    out, err = port("--input", str(path), "--stream", "1", capfd=capfd, rc_want=65)
    assert out == "" and "declared 4" in err


def test_prestaged_operands_feed_one_dispatch():
    """Feed overlap: the launches ``prestage_codes`` planned and copied
    ahead are the ones the next dispatch of the same operands launches,
    taken once; a retry of that dispatch finds the feed drained and plans
    and copies again."""
    import torch

    from mpi_openmp_cuda_tpu_torch.ops import dispatch as tdispatch

    prob = tparse.load_problem(str(REPO / "tests" / "fixtures" / "stress_small.txt"))
    args = (prob.seq1_codes, prob.seq2_codes, prob.weights)
    scorer = tdispatch.AlignmentScorer(device="cpu")
    staged = scorer.prestage_codes(*args)
    staged_launches = list(staged._launches)
    first = tdispatch.bucket_launches(*args, torch.device("cpu"), staged=staged)
    assert first == staged_launches and staged._launches is None
    again = tdispatch.bucket_launches(*args, torch.device("cpu"), staged=staged)
    assert [b.keys for b in again] == [b.keys for b in first]
    assert all(b.state.rows is not a.state.rows for a, b in zip(first, again))
    got = scorer.score_codes(*args, staged=scorer.prestage_codes(*args))
    assert [tuple(r) for r in got] == [tuple(r) for r in scorer.score_codes(*args)]


@pytest.mark.parametrize("change", ["rows", "weights", "seq1", "backend"])
def test_prestaged_operands_of_other_inputs_are_not_used(change):
    """A feed staged for other operands with the same shapes (the same
    row lengths, max |v| and Seq1 length) is dropped, and the dispatch
    scores its own operands."""
    import torch

    from mpi_openmp_cuda_tpu_torch.ops import dispatch as tdispatch

    prob = tparse.load_problem(str(REPO / "tests" / "fixtures" / "stress_small.txt"))
    seq1, seqs, w = prob.seq1_codes, prob.seq2_codes, list(prob.weights)
    other = (seq1, seqs, w)
    if change == "rows":
        other = (seq1, [np.roll(c, 1) for c in seqs], w)
    elif change == "weights":
        other = (seq1, seqs, [w[0], w[1], w[3], w[2]])
    elif change == "seq1":
        other = (np.roll(seq1, 1), seqs, w)
    scorer = tdispatch.AlignmentScorer(device="cpu",
                                       backend="gather" if change == "backend" else "cuda")
    staged = scorer.prestage_codes(*other)
    stale = list(staged._launches)
    got = tdispatch.bucket_launches(seq1, seqs, w, torch.device("cpu"), staged=staged)
    assert staged._launches is None
    assert all(b.state.rows is not a.state.rows for a in stale for b in got)
    rows = tdispatch.AlignmentScorer(device="cpu").score_codes(
        seq1, seqs, w, staged=scorer.prestage_codes(*other))
    assert [tuple(int(x) for x in r) for r in rows] == [
        prefix_best(seq1, q, w) for q in seqs]