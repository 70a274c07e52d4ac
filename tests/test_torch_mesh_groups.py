"""Launch groups on the batch mesh (``ops/schedule.py::plan_fusion_groups``
at the mesh's device count, ``parallel/sharding.py``): on four CPU slots the
``batch-long-mesh4`` cell's job is one launch group, one launch a slot; one
device's plans are the ones it made before the mesh priced groups at a
card's shard; the Seq1 ring still takes the batch as one launch; and a mixed
job's grouped mesh rows equal one device's and the JAX package's, with and
without ``--check``."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mpi_openmp_cuda_tpu.ops.dispatch import AlignmentScorer as JScorer
from mpi_openmp_cuda_tpu_torch.io.parse import load_problem
from mpi_openmp_cuda_tpu_torch.models.encoding import encode_normalized
from mpi_openmp_cuda_tpu_torch.models.workload import input3_class_problem, synthetic_codes
from mpi_openmp_cuda_tpu_torch.ops import dispatch, schedule
from mpi_openmp_cuda_tpu_torch.ops.oracle import prefix_best
from mpi_openmp_cuda_tpu_torch.parallel import sharding
from mpi_openmp_cuda_tpu_torch.parallel.ring import RingSharding
from seqbench import generate, reference

REPO = Path(__file__).resolve().parents[1]
FIX = REPO / "tests" / "fixtures"
CPU = torch.device("cpu")
W = [10, 2, 3, 4]
CONFIG = json.loads((REPO / "seqbench" / "configs" / "spec-batch-mpi4.json").read_text())
TRAFFIC = json.loads((REPO / "seqbench" / "traffic" / "batch-long-mesh4.json").read_text())


def _cell_job(seed: int):
    """The first job the benchmark's generator draws for ``batch-long-mesh4``
    on ``seed``, as codes: Seq1 3000 and 256 Seq2 of 1200-1999 chars."""
    text = generate.jobs(seed, CONFIG, {**TRAFFIC, "pool_jobs": 1})[0].text
    weights, seq1, seqs = reference.parse(text)
    return encode_normalized(seq1), [encode_normalized(q) for q in seqs], weights


def _mesh_deltas(before: dict) -> dict:
    return {k: v - before[k] for k, v in sharding.mesh_counts.items()}


@pytest.mark.parametrize("seed", [4294967311, 2**31 + 5])
def test_the_mesh_cells_job_is_one_launch_group_a_card(seed, monkeypatch):
    """The cell's 256 rows fall into six length buckets; priced at one
    card's shard they form one launch group at L2P 2048, split into four
    shards of 64 rows: four launches a dispatch (was 24), no pad row, six
    buckets folded.  The launches are counted, not run."""
    s1, seqs, w = _cell_job(seed)
    mesh = sharding.BatchSharding.over_devices(devices=[CPU] * 4)
    _, buckets = dispatch.launch_plans(s1, seqs, w, fuse=False, packable=False,
                                       min_rows=mesh.min_rows)
    assert len(buckets) == 6
    launched = []
    monkeypatch.setattr(sharding, "run_launch",
                        lambda launch, backend, done: launched.append(launch) or done)
    before = dict(sharding.mesh_counts)
    dispatch.AlignmentScorer("cuda", device="cpu", sharding=mesh, check=True).score_codes_async(
        s1, seqs, w)
    got = _mesh_deltas(before)
    assert got["mesh_shard_launches"] == 4 and got["mesh_pad_rows"] == 0
    assert got["mesh_fused_buckets"] == 6 and got["mesh_h2d_copies"] == 1
    assert [(b.state.rows.shape, b.row0, b.keys) for b in launched] == [
        ((64, 2048), 0, tuple(p.l2p for p in buckets))] * 4
    assert sorted(i for b in launched for i in b.idx) == list(range(256))


def _sets():
    """The length sets of the one-device check: the fixtures, max-size,
    1024 short rows, input3-class and mixed 5-2000-char batches."""
    out = {}
    for f in sorted(FIX.glob("*.txt")):
        p = load_problem(str(f))
        out[f.stem] = (p.seq1_codes, p.seq2_codes, p.weights)
    out["1024 short rows"] = (*synthetic_codes(3000, 1024, 5, 64, 7), W)
    out["max-size"] = (*synthetic_codes(3000, 64, 1200, 1999, 7), W)
    p = input3_class_problem()
    out["input3-class"] = (p.seq1_codes, p.seq2_codes, p.weights)
    for args in [(3000, 300, 5, 2000, 0), (3000, 300, 5, 2000, 2), (3000, 2000, 5, 2000, 3),
                 (1489, 600, 56, 1489, 5), (2000, 1500, 5, 2000, 6)]:
        out[f"mixed {args}"] = (*synthetic_codes(*args), W)
    return out


_WIDE = tuple(range(384, 2049, 128))
# The launch groups one device planned for each set before the mesh priced
# groups at a card's shard (bucket keys of each launch, in launch order).
ONE_DEVICE = {
    "dup_and_k0": [(32,)],
    "empty_batch": [],
    "equal_len": [(128,)],
    "mixedcase": [(32,)],
    "overlong": [(64,)],
    "stress_small": [(512, 1024)],
    "tiny": [(8,)],
    "1024 short rows": [(8,), (16,), (32,), (64,)],
    "max-size": [(1408, 1536, 1792, 1920, 2048)],
    "input3-class": [(384, 640, 1024, 1152)],
    "mixed (3000, 300, 5, 2000, 0)": [(32,), tuple(range(128, 2049, 128))],
    "mixed (3000, 300, 5, 2000, 2)": [(32,), (64,), tuple(range(128, 2049, 128))],
    "mixed (3000, 2000, 5, 2000, 3)": [(16,), (32,), (64,), (128, 256), _WIDE],
    "mixed (1489, 600, 56, 1489, 5)": [(128, 256), tuple(range(384, 1537, 128))],
    "mixed (2000, 1500, 5, 2000, 6)": [(32,), (64,), (128, 256), _WIDE],
}


@pytest.mark.parametrize("name", sorted(ONE_DEVICE))
def test_one_device_plans_are_unchanged(name):
    """With one device the planner prices every row of a group, as it did
    before: the same partition, and the same launches field by field."""
    s1, seqs, w = _sets()[name]
    _, plans = dispatch.launch_plans(s1, seqs, w)
    assert [p.keys for p in plans] == ONE_DEVICE[name]
    _, ones = dispatch.launch_plans(s1, seqs, w, devices=1)
    assert [(p.keys, p.idx.tolist(), p.l2p, p.l2s) for p in ones] == [
        (p.keys, p.idx.tolist(), p.l2p, p.l2s) for p in plans]
    sizes = [int(c.size) for c in seqs]
    groups = dispatch.plan_buckets(sizes)
    if groups:
        assert schedule.plan_fusion_groups(groups, sizes, s1.size, 1) == (
            schedule.plan_fusion_groups(groups, sizes, s1.size))
    assert schedule.shard_lens([5, 3, 9], 1).tolist() == [5, 3, 9]
    assert schedule.shard_lens([5, 3, 9, 1, 7], 2).tolist() == [1, 5, 9]


def _mixed_job(seed: int = 11, len1: int = 600):
    """Rows over four length buckets (128, 256, 384 and 768 at 165 rows),
    with empty rows, rows of at most 64 chars, a row as long as Seq1 and
    rows longer than it, shuffled."""
    rng = np.random.default_rng(seed)
    lens = ([0] * 8 + list(rng.integers(1, 65, 30)) + list(rng.integers(65, 129, 40))
            + list(rng.integers(129, 257, 40)) + list(rng.integers(257, 385, 40))
            + list(rng.integers(601, 700, 6)) + [len1])
    rng.shuffle(lens)
    s1 = rng.integers(1, 27, len1).astype(np.int8)
    return s1, [rng.integers(1, 27, int(m)).astype(np.int8) for m in lens]


@pytest.mark.parametrize("spec", ["seq:4", "2x2"])
def test_the_rings_plans_are_unchanged(spec, monkeypatch):
    """The Seq1 ring merges every bucket into the widest (``min_rows`` of
    ``sys.maxsize``): one plan of the whole batch, the one it took before,
    and the ring's rows are one device's."""
    seq, batch = (4, 1) if spec == "seq:4" else (2, 2)
    ring = RingSharding.over_devices(seq, batch, devices=[CPU] * 4)
    s1, seqs = _mixed_job(5, 400)
    seen = []
    real = RingSharding.score_async
    monkeypatch.setattr(RingSharding, "score_async",
                        lambda self, plans, *a, **kw: seen.append(plans) or real(
                            self, plans, *a, **kw))
    got = dispatch.AlignmentScorer("cuda", device="cpu", sharding=ring).score_codes(s1, seqs, W)
    (plans,) = seen
    _, want = dispatch.launch_plans(s1, seqs, W, fuse=False, packable=False,
                                    min_rows=sys.maxsize, caps=False)
    assert len(plans) == len(want) == 1
    assert [(p.keys, p.idx.tolist(), p.l2p, p.l2s) for p in plans] == [
        (p.keys, p.idx.tolist(), p.l2p, p.l2s) for p in want]
    assert plans[0].idx.tolist() == list(range(len(seqs)))
    single = dispatch.AlignmentScorer("cuda", device="cpu").score_codes(s1, seqs, W)
    assert np.array_equal(got, single)


@pytest.mark.parametrize("check", [False, True])
def test_a_mixed_jobs_grouped_mesh_rows_equal_one_device_and_jax(check):
    """A job over four length buckets, with empty and short rows, scored on
    four CPU slots in one launch group (shards of 42 rows, three of them
    pads): the rows equal the one-device scorer's, the JAX package's and
    the oracle's, with ``--check`` validating each group shard."""
    s1, seqs = _mixed_job()
    _, buckets = dispatch.launch_plans(s1, seqs, W, fuse=False, packable=False, min_rows=32)
    assert len(buckets) >= 3
    mesh = sharding.BatchSharding.over_devices(devices=[CPU] * 4)
    before = dict(sharding.mesh_counts)
    got = dispatch.AlignmentScorer("cuda", device="cpu", sharding=mesh,
                                   check=check).score_codes(s1, seqs, W)
    deltas = _mesh_deltas(before)
    assert deltas["mesh_shard_launches"] == 4 and deltas["mesh_pad_rows"] == 3
    assert deltas["mesh_fused_buckets"] == len(buckets)
    single = dispatch.AlignmentScorer("cuda", device="cpu").score_codes(s1, seqs, W)
    assert np.array_equal(got, single)
    assert np.array_equal(got, np.asarray(JScorer("xla").score_codes(s1, seqs, W)))
    assert [tuple(int(v) for v in r) for r in got] == [prefix_best(s1, q, W) for q in seqs]
