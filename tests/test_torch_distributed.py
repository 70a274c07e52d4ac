"""Multi-process jobs of the port's CLI (``--distributed`` over
``torch.distributed`` with the ``gloo`` backend on the CPU), the spec
being ``tests/test_distributed.py``: two processes join one job over a
localhost rendezvous (torchrun's variables, set here by hand) and run the
CLI; rank 0 reads the input and prints the golden, rank 1 feeds from its
broadcasts and prints nothing.  Covered: the batch, ring and 2-D meshes,
``--journal`` resume across ranks, ``--stream`` with a journal, a parse
failure or a stale journal on rank 0 aborting rank 1 instead of hanging,
Seq1 past the reference's cap, the single-process broadcast no-ops, the
usage refusal of ``--degrade --distributed``, and first kernel builds
from two processes at once.  Every process has its own timeout and every
job a free port, so a hang fails one test and never stalls the suite."""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from mpi_openmp_cuda_tpu.ops.oracle import prefix_best
from mpi_openmp_cuda_tpu_torch.io import cli as tcli
from mpi_openmp_cuda_tpu_torch.io.parse import load_problem
from mpi_openmp_cuda_tpu_torch.models.encoding import decode
from mpi_openmp_cuda_tpu_torch.parallel import distributed as tdist
from mpi_openmp_cuda_tpu_torch.utils import journal as tjournal

REPO = Path(__file__).resolve().parent.parent
FIX = REPO / "tests" / "fixtures"
TIMEOUT = 120  # seconds a process of a job may take
RENDEZVOUS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
              "LOCAL_WORLD_SIZE")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(port: int, rank: int, nproc: int, extra=None) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in RENDEZVOUS and not k.startswith("SEQALIGN_")}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(nproc),
               RANK=str(rank), LOCAL_RANK=str(rank), SEQALIGN_BACKOFF_BASE="0",
               **(extra or {}))
    return env


def _start(args, stdin, nproc, port, extra=None):
    procs = []
    for rank in range(nproc):
        src = stdin if rank == 0 else None
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "mpi_openmp_cuda_tpu_torch", "--device", "cpu",
             "--distributed", *args],
            stdin=subprocess.PIPE if src is not None else subprocess.DEVNULL,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
            env=_env(port, rank, nproc, extra)))
    return procs


def _finish(procs, stdin) -> list[tuple[int, str, str]]:
    outs = []
    try:
        for rank, p in enumerate(procs):
            out, err = p.communicate(input=stdin if rank == 0 else None, timeout=TIMEOUT)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _job(*args, stdin: str, nproc: int = 2, extra=None):
    """Run one job; relaunched on a fresh port when the rendezvous port
    was taken between its choice and its bind."""
    for _ in range(3):
        outs = _finish(_start(args, stdin, nproc, _free_port(), extra), stdin)
        if not any("address already in use" in err.lower() for _, _, err in outs):
            return outs
    return outs


def _text(name: str) -> str:
    return (FIX / f"{name}.txt").read_text()


def _gold(name: str) -> str:
    return (FIX / f"{name}.out").read_text()


@pytest.mark.parametrize("mesh", [[], ["--mesh", "2"], ["--mesh", "seq:2"],
                                  ["--mesh", "2x1"], ["--mesh", "1x2"]],
                         ids=["default", "batch", "seq", "2x1", "1x2"])
def test_two_process_job_coordinator_prints_worker_silent(mesh):
    (rc0, out0, err0), (rc1, out1, err1) = _job(*mesh, stdin=_text("mixedcase"))
    assert rc0 == 0, err0
    assert rc1 == 0, err1
    assert out0 == _gold("mixedcase")
    assert out1 == ""
    assert "transport gloo" in err0


FIXTURES = sorted(p.stem for p in FIX.glob("*.txt"))


@pytest.mark.parametrize("name", FIXTURES)
def test_two_process_goldens_on_every_fixture(name):
    """Every fixture through a two-process job, the meshes taken in turn
    (batch, ring, 2-D both ways): rank 0 prints the golden, rank 1
    nothing."""
    mesh = ["2", "seq:2", "2x1", "1x2"][FIXTURES.index(name) % 4]
    (rc0, out0, err0), (rc1, out1, err1) = _job("--mesh", mesh, stdin=_text(name))
    assert (rc0, rc1) == (0, 0), err0 + err1
    assert out0 == _gold(name) and out1 == ""


def test_four_process_2d_mesh_golden():
    """dp x sp (--mesh 2x2) over four processes: the batch axis splits the
    rows, each seq row gathers its candidates in a group of its own."""
    outs = _job("--mesh", "2x2", stdin=_text("stress_small"), nproc=4)
    assert [rc for rc, _, _ in outs] == [0] * 4, [err for _, _, err in outs]
    assert outs[0][1] == _gold("stress_small")
    assert all(out == "" for _, out, _ in outs[1:])


def test_two_process_partial_mesh_is_refused():
    (rc0, out0, err0), (rc1, _, err1) = _job("--mesh", "1", stdin=_text("tiny"))
    assert (rc0, rc1) == (65, 65) and out0 == ""
    assert "multi-host jobs must mesh all 2 global devices, got --mesh 1" in err0


def _seed_batch_journal(path, problem, rows_by_index):
    """A whole-batch journal whose listed rows are done, with deliberately
    wrong values: output carrying them shows the resume skipped them."""
    with open(path, "w", encoding="utf-8") as f:
        f.write(json.dumps({"format": tjournal._FORMAT,
                            "fingerprint": tjournal.problem_fingerprint(problem),
                            "num_seq2": len(problem.seq2_codes)}) + "\n")
        for i, (s, n, k) in rows_by_index.items():
            f.write(json.dumps({"index": i, "score": s, "n": n, "k": k}) + "\n")


def _assert_tampered(out, tampered):
    want = _gold("mixedcase").splitlines()
    lines = out.splitlines()
    assert len(lines) == len(want)
    for i, line in enumerate(lines):
        if i in tampered:
            s, n, k = tampered[i]
            assert line == f"#{i}: score: {s}, n: {n}, k: {k}", "a journalled row was rescored"
        else:
            assert line == want[i]


@pytest.mark.parametrize("mesh", [[], ["--mesh", "seq:2"]], ids=["batch", "seq"])
def test_two_process_journal_resume_skips_done_rows(tmp_path, mesh):
    """Rank 0 broadcasts its journal's done set; both ranks run the
    reduced schedule; the journalled (tampered) rows come out verbatim."""
    problem = load_problem(str(FIX / "mixedcase.txt"))
    journal = tmp_path / "dist.jsonl"
    tampered = {0: (12345, 6, 7), 2: (-999, 1, 2)}
    _seed_batch_journal(journal, problem, tampered)
    (rc0, out0, err0), (rc1, out1, err1) = _job(
        "--journal", str(journal), "--retries", "2", *mesh, stdin=_text("mixedcase"))
    assert (rc0, rc1) == (0, 0), err0 + err1
    assert out1 == ""
    _assert_tampered(out0, tampered)
    records = journal.read_text().splitlines()
    assert len(records) == 1 + len(problem.seq2_codes)  # rank 0 journalled the rest


def _seed_stream_journal(path, problem, rows_by_index):
    with open(path, "w", encoding="utf-8") as f:
        fp = tjournal.stream_fingerprint(problem.weights, problem.seq1_codes,
                                         len(problem.seq2_codes))
        f.write(json.dumps({"format": tjournal._STREAM_FORMAT, "fingerprint": fp}) + "\n")
        for i, (s, n, k) in rows_by_index.items():
            f.write(json.dumps({"index": i, "h": tjournal.seq_hash(problem.seq2_codes[i]),
                                "score": s, "n": n, "k": k}) + "\n")


@pytest.mark.parametrize("tampered", [{1: (777, 3, 4)}, {2: (555, 1, 2), 3: (-444, 5, 6)}],
                         ids=["one-row", "full-chunk"])
def test_two_process_stream_with_journal_resume(tmp_path, tampered):
    """--stream x --distributed: rank 0 broadcasts each journal-reduced
    chunk (an empty one when the whole chunk is journalled: both ranks
    skip it together)."""
    problem = load_problem(str(FIX / "mixedcase.txt"))
    journal = tmp_path / "dist-stream.jsonl"
    _seed_stream_journal(journal, problem, tampered)
    (rc0, out0, err0), (rc1, out1, err1) = _job(
        "--stream", "2", "--journal", str(journal), stdin=_text("mixedcase"))
    assert (rc0, rc1) == (0, 0), err0 + err1
    assert out1 == ""
    _assert_tampered(out0, tampered)


@pytest.mark.parametrize("mesh", [["--mesh", "2"], ["--mesh", "seq:2"]], ids=["batch", "seq"])
def test_two_process_stream_goldens(mesh):
    (rc0, out0, err0), (rc1, out1, err1) = _job(
        "--stream", "3", *mesh, stdin=_text("stress_small"))
    assert (rc0, rc1) == (0, 0), err0 + err1
    assert out0 == _gold("stress_small") and out1 == ""


def test_two_process_stream_stale_journal_aborts_worker(tmp_path):
    """A journal of another problem on rank 0, found after the stream
    header went out: rank 0 broadcasts an abort and rank 1, waiting on
    the first chunk, exits 65 instead of hanging."""
    journal = tmp_path / "stale.jsonl"
    journal.write_text(json.dumps({"format": tjournal._STREAM_FORMAT,
                                   "fingerprint": "deadbeef"}) + "\n")
    (rc0, out0, err0), (rc1, out1, err1) = _job(
        "--stream", "2", "--journal", str(journal), stdin=_text("mixedcase"))
    assert (rc0, rc1) == (65, 65), err1
    assert out0 == out1 == ""
    assert "different problem" in err0 and "aborting" in err1


@pytest.mark.parametrize("stream", [[], ["--stream", "2"]], ids=["batch", "stream"])
def test_two_process_parse_failure_aborts_worker_instead_of_hanging(stream):
    t0 = time.perf_counter()
    (rc0, out0, err0), (rc1, out1, err1) = _job(*stream, stdin="1 2 3\n")
    assert (rc0, rc1) == (65, 65)
    assert out0 == out1 == ""
    assert "coordinator failed" in err1 and "aborting" in err1
    assert time.perf_counter() - t0 < 60


def test_two_process_broadcast_hang_meets_the_deadline():
    """hang:broadcast on every rank's first broadcast: the watchdog turns
    it into a resumable failure (75) on both, no rank waits forever."""
    (rc0, out0, err0), (rc1, out1, _) = _job(
        "--deadline", "1", "--faults", "hang:broadcast:fail=1", stdin=_text("tiny"))
    assert (rc0, rc1) == (75, 75), err0
    assert out0 == out1 == ""
    assert "deadline" in err0


def test_two_process_ring_long_context_beyond_cap(tmp_path):
    """Seq1 past BUF_SIZE_SEQ1 = 3000 through --mesh seq:2 over two
    processes: each holds half of Seq1, and rank 0 prints the oracle's
    rows."""
    rng = np.random.default_rng(42)
    seq1 = rng.integers(1, 27, size=3600).astype(np.int8)
    seqs = [rng.integers(1, 27, size=n).astype(np.int8) for n in (80, 700, 3599)]
    text = ("10 2 3 4\n" + decode(seq1) + f"\n{len(seqs)}\n"
            + "\n".join(decode(s) for s in seqs) + "\n")
    (rc0, out0, err0), (rc1, out1, err1) = _job("--mesh", "seq:2", stdin=text)
    assert (rc0, rc1) == (0, 0), err0 + err1
    want = "".join(f"#{i}: score: {s}, n: {n}, k: {k}\n" for i, (s, n, k) in
                   enumerate(prefix_best(seq1, q, [10, 2, 3, 4]) for q in seqs))
    assert out0 == want and out1 == ""


@pytest.mark.slow
def test_two_process_kill_mid_batch_then_resume(tmp_path):
    """SIGKILL a two-process job mid-batch, then rerun the same command
    with the same journal: it resumes from the killed run's fsync'd
    records and finishes with the oracle's rows.  Slow: it needs a batch
    long enough (320 pairs on the CPU) to kill between journal chunks."""
    from mpi_openmp_cuda_tpu_torch.ops.oracle import score_batch_oracle

    rng = np.random.default_rng(17)
    seq1 = rng.integers(1, 27, size=900).astype(np.int8)
    seqs = [rng.integers(1, 27, size=int(n)).astype(np.int8)
            for n in rng.integers(350, 800, size=320)]
    text = "10 2 3 4\n{}\n{}\n{}\n".format(decode(seq1), len(seqs),
                                          "\n".join(decode(s) for s in seqs))
    journal = tmp_path / "kill.jsonl"
    procs = _start(["--journal", str(journal)], text, 2, _free_port())
    procs[0].stdin.write(text)
    procs[0].stdin.close()
    deadline = time.time() + TIMEOUT
    records = 0
    while time.time() < deadline and procs[0].poll() is None:
        if journal.exists():
            records = max(0, len(journal.read_text().splitlines()) - 1)
            if records:
                break
        time.sleep(0.1)
    finished_early = procs[0].poll() is not None and records == 0
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait(timeout=TIMEOUT)
        p.stdout.close()
        p.stderr.close()
    if finished_early:
        pytest.skip("the job finished before its first journal chunk")
    assert records >= 1
    (rc0, out0, err0), (rc1, out1, _) = _job("--journal", str(journal), stdin=text)
    assert (rc0, rc1) == (0, 0), err0
    want = score_batch_oracle(seq1, seqs, [10, 2, 3, 4])
    assert out0.splitlines() == [f"#{i}: score: {s}, n: {n}, k: {k}"
                                 for i, (s, n, k) in enumerate(want)]
    assert out1 == ""
    assert len(journal.read_text().splitlines()) - 1 >= max(records, len(seqs))


def test_single_process_broadcast_abort_and_end_semantics():
    """The one-process paths of every broadcast, aborts included."""
    codes = [np.array([1, 2], dtype=np.int8)]
    assert tdist.broadcast_chunk(codes) is codes
    assert tdist.broadcast_chunk(None, end=True) is None
    assert tdist.broadcast_chunk(codes, failed=True) is None
    got = tdist.broadcast_index_set([3, 1, 2])
    assert got.dtype == np.int32 and got.tolist() == [3, 1, 2]
    assert tdist.broadcast_index_set(None).tolist() == []
    assert tdist.broadcast_index_set(None, failed=True).tolist() == []
    meta = ([1, 2, 3, 4], np.array([1], dtype=np.int8), 5)
    assert tdist.broadcast_stream_meta(meta) is meta
    assert tdist.broadcast_stream_meta(None, failed=True) is None
    sentinel = object()
    assert tdist.broadcast_problem(sentinel) is sentinel


def test_transport_and_device_rules(monkeypatch):
    """gloo on the CPU and whenever ranks must share a card; a rank drives
    cuda:(LOCAL_RANK mod device_count)."""
    import torch

    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert tdist.transport("cpu") == "gloo" and tdist.local_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tdist.transport("cuda") == "gloo"
    assert tdist.local_device("cuda") == torch.device("cuda:0")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tdist.transport("cuda") == "nccl"
    assert tdist.local_device("cuda") == torch.device("cuda:3")


def test_degrade_with_distributed_is_a_usage_error(capfd):
    rc = tcli.run(["--device", "cpu", "--distributed", "--degrade", "--input",
                   str(FIX / "tiny.txt")])
    cap = capfd.readouterr()
    assert rc == tcli.EX_USAGE and cap.out == ""
    assert "--distributed cannot be combined with --degrade" in cap.err


def test_distributed_without_a_rendezvous_exits_65(monkeypatch, capfd):
    for var in RENDEZVOUS:
        monkeypatch.delenv(var, raising=False)
    rc = tcli.run(["--device", "cpu", "--distributed", "--input", str(FIX / "tiny.txt")])
    cap = capfd.readouterr()
    assert rc == tcli.EX_FATAL and cap.out == ""
    assert "MASTER_ADDR" in cap.err


_FAKE_NVCC = """#!{python}
import sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
with open({log!r}, "a") as f:
    f.write(out + "\\n")
time.sleep(0.5)
with open(out, "w") as f:
    f.write("built")
print("ptxas info    : Used 40 registers")
"""

_BUILD = """
import sys
from pathlib import Path
from mpi_openmp_cuda_tpu_torch.ops import _build
_build.BUILD_DIR = Path(sys.argv[1])
print(sorted(_build.build(["fused_scorer", "packed_scorer"])))
"""


def test_first_builds_from_two_processes_compile_once(tmp_path):
    """Two processes (the ranks of a job sharing build/torch_kernels) build
    the same kernels at once against a stub compiler: each library is
    compiled once, by one of them, the other waits on the build lock and
    finds it built, and no temporary file is left behind."""
    cuda = tmp_path / "cuda"
    (cuda / "bin").mkdir(parents=True)
    log = tmp_path / "nvcc.log"
    nvcc = cuda / "bin" / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable, log=str(log)))
    nvcc.chmod(0o755)
    build = tmp_path / "build"
    env = {**os.environ, "CUDA_HOME": str(cuda)}
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(build)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [err for _, err in outs]
    built = sorted((out.strip() for out, _ in outs), key=len)
    assert built == ["[]", "['fused_scorer', 'packed_scorer']"]
    compiled = log.read_text().splitlines()
    assert len(compiled) == 2 and all(".tmp" in c for c in compiled)
    libs = sorted(p.name for p in build.iterdir() if p.name != ".lock")
    assert len(libs) == 2 and all(n.endswith(".so") for n in libs)
    assert all((build / n).read_text() == "built" for n in libs)
