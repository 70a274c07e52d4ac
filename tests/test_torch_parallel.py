"""The port's batch sharding (``mpi_openmp_cuda_tpu_torch/parallel/``)
against the JAX package's ``BatchSharding`` on its 8 virtual CPU devices,
the unsharded port and the numpy oracle, exact int32 equality; the mesh
shapes and errors; the asynchronous dispatch; no collective inside the
compute; and ``--mesh`` through the port's CLI on the fixtures.  The
spec is ``tests/test_parallel.py``.  On the CPU a mesh's slots all name
the one CPU device (``SEQALIGN_HOST_DEVICES`` of them through the CLI),
and every launch runs the fused kernel's plain version."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from mpi_openmp_cuda_tpu.ops.dispatch import AlignmentScorer as JScorer
from mpi_openmp_cuda_tpu.ops.oracle import prefix_best
from mpi_openmp_cuda_tpu.parallel.sharding import BatchSharding as JBatchSharding
from mpi_openmp_cuda_tpu_torch.io import cli as tcli
from mpi_openmp_cuda_tpu_torch.models.encoding import encode
from mpi_openmp_cuda_tpu_torch.ops.dispatch import AlignmentScorer
from mpi_openmp_cuda_tpu_torch.parallel import distributed as tdist
from mpi_openmp_cuda_tpu_torch.parallel import mesh as tmesh
from mpi_openmp_cuda_tpu_torch.parallel.comm import LocalCollectives, collectives_for
from mpi_openmp_cuda_tpu_torch.parallel.sharding import BatchSharding, ShardedPending
from mpi_openmp_cuda_tpu_torch.parallel.specs import build_sharding

REPO = Path(__file__).resolve().parent.parent
FIXTURES = sorted((REPO / "tests" / "fixtures").glob("*.txt"), key=lambda p: p.name)
W = [10, 2, 3, 4]
CPU = torch.device("cpu")


def _rows(arr) -> list[tuple[int, int, int]]:
    return [tuple(int(x) for x in r) for r in np.asarray(arr)]


def _sharded(n: int, backend: str = "cuda") -> AlignmentScorer:
    return AlignmentScorer(backend, device="cpu",
                           sharding=BatchSharding.over_devices(devices=[CPU] * n))


def _random(seed: int, len1: int, n: int, hi: int):
    rng = np.random.default_rng(seed)
    seq1 = rng.integers(1, 27, size=len1).astype(np.int8)
    seqs = [rng.integers(1, 27, size=int(rng.integers(1, hi))).astype(np.int8)
            for _ in range(n)]
    return seq1, seqs


def test_host_devices_default_to_one(monkeypatch):
    monkeypatch.delenv("SEQALIGN_HOST_DEVICES", raising=False)
    assert tmesh.global_devices("cpu") == [CPU]
    monkeypatch.setenv("SEQALIGN_HOST_DEVICES", "8")
    assert tmesh.global_devices("cpu") == [CPU] * 8


def test_make_mesh_shapes(monkeypatch):
    monkeypatch.setenv("SEQALIGN_HOST_DEVICES", "8")
    assert tmesh.make_mesh(device="cpu").size == 8
    assert tmesh.make_mesh(4, device="cpu").size == 4
    assert tmesh.make_2d_mesh(4, 2, device="cpu").shape == {"batch": 4, "seq": 2}
    assert tmesh.make_mesh(device="cpu").axis_names == ("batch",)
    # Explicit devices may repeat, as in JAX: a one-card host's mesh.
    m = tmesh.make_mesh(devices=[CPU] * 3)
    assert m.size == 3 and all(m.device(i) == CPU for i in range(3))


@pytest.mark.parametrize(
    "call, match",
    [
        (lambda: tmesh.make_mesh(64, device="cpu"), "requested 64 devices but only 8 available"),
        (lambda: tmesh.make_mesh(0, device="cpu"), "at least 1 device"),
        (lambda: tmesh.make_2d_mesh(4, 4, device="cpu"), "mesh 4x4 needs 16 devices, have 8"),
    ],
)
def test_mesh_errors(call, match, monkeypatch):
    monkeypatch.setenv("SEQALIGN_HOST_DEVICES", "8")
    with pytest.raises(ValueError, match=match):
        call()


@pytest.mark.parametrize("spec", ["0", "seq:x", "2x", "1x2x3", "rows:2", "a:b:c"])
def test_bad_mesh_specs_raise(spec):
    with pytest.raises(ValueError, match="bad --mesh spec"):
        build_sharding(spec, device="cpu")


def test_mesh_specs_build_the_jax_strategies(monkeypatch):
    monkeypatch.setenv("SEQALIGN_HOST_DEVICES", "8")
    assert build_sharding(None) is None
    for spec, kind, shape in [("8", "BatchSharding", {"batch": 8}),
                              ("batch:3", "BatchSharding", {"batch": 3}),
                              ("seq:4", "RingSharding", {"batch": 1, "seq": 4}),
                              ("2x4", "RingSharding", {"batch": 2, "seq": 4})]:
        sh = build_sharding(spec, device="cpu")
        assert type(sh).__name__ == kind and sh.mesh.shape == shape
        assert isinstance(sh.comm, LocalCollectives)


@pytest.mark.parametrize("n_devices", [1, 3, 8])
@pytest.mark.parametrize("n_seqs", [1, 5, 8, 13, 40])
def test_sharded_matches_unsharded_and_oracle(n_seqs, n_devices):
    # Uneven batches exercise the padded remainder (no remainder rank).
    seq1, seqs = _random(n_seqs, 70, n_seqs, 40)
    local = AlignmentScorer("cuda", device="cpu").score_codes(seq1, seqs, W)
    shard = _sharded(n_devices).score_codes(seq1, seqs, W)
    assert np.array_equal(local, shard)
    assert _rows(shard) == [prefix_best(seq1, s, W) for s in seqs]


@pytest.mark.parametrize("n_devices", [1, 3, 8])
def test_sharded_matches_jax_batch_sharding(n_devices):
    seq1, seqs = _random(99, 120, 11, 100)
    want = JScorer("xla", sharding=JBatchSharding.over_devices(n_devices)).score_codes(
        seq1, seqs, W)
    for backend in ("cuda", "gather", "mm"):
        got = _sharded(n_devices, backend).score_codes(seq1, seqs, W)
        assert _rows(got) == _rows(want), backend
    assert _rows(want) == [prefix_best(seq1, s, W) for s in seqs]


def test_sharded_dispatch_is_async():
    """score_codes_async returns before the gather: the pending holds the
    shards' rows as tensors, no gather has run, and ``result`` gives the
    oracle's rows."""
    from mpi_openmp_cuda_tpu_torch.parallel.ring import RingSharding

    seq1, seqs = _random(7, 90, 9, 80)
    want = [prefix_best(seq1, s, W) for s in seqs]
    for sharding in (BatchSharding.over_devices(devices=[CPU] * 8),
                     RingSharding.over_devices(seq=2, batch=2, devices=[CPU] * 4)):
        pend = AlignmentScorer("cuda", device="cpu", sharding=sharding).score_codes_async(
            seq1, seqs, W)
        assert isinstance(pend, ShardedPending)
        assert sharding.comm.counts["gather"] == 0
        rows = [r for _, slot_rows, _, _ in pend.parts for r in slot_rows.values()]
        assert rows and all(isinstance(r, torch.Tensor) for r in rows)
        pend.prefetch()
        assert _rows(pend.result()) == want
        assert sharding.comm.counts["gather"] == 1


def test_sharded_bucketed_dispatch_matches_jax_and_oracle():
    """A bimodal batch on a batch mesh is two sharded dispatches, one a
    length bucket, gathered into input order."""
    rng = np.random.default_rng(21)
    seq1 = rng.integers(1, 27, size=900).astype(np.int8)
    seqs = [rng.integers(1, 27, size=30).astype(np.int8) for _ in range(17)]
    seqs += [rng.integers(1, 27, size=800).astype(np.int8) for _ in range(16)]
    order = rng.permutation(len(seqs))
    seqs = [seqs[i] for i in order]
    pend = _sharded(2).score_codes_async(seq1, seqs, W)
    assert isinstance(pend, ShardedPending) and len(pend.parts) == 2
    got = _rows(pend.result())
    assert got == [prefix_best(seq1, s, W) for s in seqs]
    jax_rows = JScorer("xla", sharding=JBatchSharding.over_devices(2)).score_codes(
        seq1, seqs, W)
    assert got == _rows(jax_rows)


@pytest.mark.parametrize("backend", ["cuda", "gather", "mm"])
def test_batch_compute_calls_no_collective(backend):
    """The batch tier's compute calls no collective at all: the scatter is
    each shard's own rows, the output stays sharded until ``result``,
    whose one gather a bucket is the MPI_Gather analogue."""
    rng = np.random.default_rng(7)
    seq1 = rng.integers(1, 27, size=70).astype(np.int8)
    seqs = [rng.integers(1, 27, size=n).astype(np.int8) for n in (40, 9, 33, 21, 5)]
    sc = _sharded(8, backend)
    pend = sc.score_codes_async(seq1, seqs, W)
    assert dict(sc.sharding.comm.counts) == {}
    pend.result()
    assert dict(sc.sharding.comm.counts) == {"gather": len(pend.parts)} == {"gather": 1}
    # One padded row a shard (5 rows over 8 shards) comes back.
    assert sc.sharding.comm.log == [("gather", 8 * 3)]


def test_each_shard_is_one_launch_of_its_own_rows(monkeypatch):
    """One fused launch a shard, on the shard's contiguous rows."""
    from mpi_openmp_cuda_tpu_torch.ops import dispatch

    seen = []
    real = dispatch.fused_scorer

    def spy(state):
        seen.append(state.lens.tolist())
        return real(state)

    monkeypatch.setattr(dispatch, "fused_scorer", spy)
    seq1 = encode("HELLOWORLDHELLOWORLD")
    seqs = [encode(s) for s in ("HELLO", "WORLD", "LOW", "OWRL", "Z")]
    _sharded(3).score_codes(seq1, seqs, W)
    assert seen == [[5, 5], [3, 4], [1, 0]]


def test_mixed_edge_rows_sharded():
    # equal-length, longer-than-seq1, tiny and empty rows across shards.
    seq1 = encode("HELLOWORLDHELLOWORLD")
    seqs = [encode("HELLOWORLDHELLOWORLD"), encode("HELLOWORLDHELLOWORLDX"),
            encode("A"), encode("OWRL"), encode("Z"), np.zeros(0, dtype=np.int8)]
    local = AlignmentScorer("cuda", device="cpu").score_codes(seq1, seqs, W)
    assert np.array_equal(local, _sharded(8).score_codes(seq1, seqs, W))
    assert _rows(local) == [prefix_best(seq1, s, W) for s in seqs]


def _port_cli(argv, capfd, rc_want=0):
    rc = tcli.run(["--device", "cpu", *argv])
    cap = capfd.readouterr()
    assert rc == rc_want, cap.err
    return cap.out, cap.err


@pytest.mark.parametrize("mesh", ["8", "batch:3", "seq:4", "2x4"])
@pytest.mark.parametrize("path", FIXTURES, ids=[p.stem for p in FIXTURES])
def test_cli_mesh_byte_identical_to_goldens(path, mesh, monkeypatch, capfd):
    monkeypatch.setenv("SEQALIGN_HOST_DEVICES", "8")
    out, _ = _port_cli(["--input", str(path), "--mesh", mesh], capfd)
    assert out == path.with_suffix(".out").read_text()


def test_cli_mesh_stream_and_journal(tmp_path, monkeypatch, capfd):
    monkeypatch.setenv("SEQALIGN_HOST_DEVICES", "4")
    path = REPO / "tests" / "fixtures" / "stress_small.txt"
    gold = path.with_suffix(".out").read_text()
    for mesh in ("4", "2x2"):
        out, _ = _port_cli(["--input", str(path), "--mesh", mesh, "--stream", "3"], capfd)
        assert out == gold
        j = tmp_path / f"{mesh}.jsonl"
        out, _ = _port_cli(["--input", str(path), "--mesh", mesh, "--journal", str(j)], capfd)
        assert out == gold and j.exists()


def test_cli_mesh_larger_than_the_host_exits_65(monkeypatch, capfd):
    monkeypatch.delenv("SEQALIGN_HOST_DEVICES", raising=False)
    path = REPO / "tests" / "fixtures" / "tiny.txt"
    out, err = _port_cli(["--input", str(path), "--mesh", "2"], capfd, tcli.EX_FATAL)
    assert out == "" and "requested 2 devices but only 1 available" in err
    out, err = _port_cli(["--input", str(path), "--mesh", "seq:4"], capfd, tcli.EX_FATAL)
    assert out == "" and "mesh 1x4 needs 4 devices, have 1" in err
    out, err = _port_cli(["--input", str(path), "--mesh", "rows:2"], capfd, tcli.EX_FATAL)
    assert out == "" and "bad --mesh spec" in err


def test_collectives_are_local_in_one_process():
    m = tmesh.make_mesh(devices=[CPU] * 2)
    assert isinstance(collectives_for(m), LocalCollectives)
    assert tdist.process_count() == 1 and tdist.is_coordinator()


def test_distributed_single_process_noop():
    from mpi_openmp_cuda_tpu_torch.io.parse import Problem

    x = np.arange(4)
    assert (tdist.broadcast_from_coordinator(x) == x).all()
    p = Problem(weights=W, seq1="ABC", seq2=["AB"])
    assert tdist.broadcast_problem(p) is p
