"""The epilogue in the finish kernels: a scorer launch asked for finished
rows stores each pair's ``(score, n, k)`` at its input position of the
batch's ``[count, 3]`` buffer (``done[dst[b]]``, or ``done[row0 + b]``),
the rows ``cuda_scorer.finish_rows`` makes of the raw ``[B, 4]`` ones
(``csrc/finish_rows.cuh``).

Held here on the CPU, through the plain versions: every edge rule
(``len2 == len1``, ``len2 > len1``, ``len2 == 0``, ``0 < len2 < len1``) of
the fused and each packed class against ``finish_rows`` and a scatter; a
dispatch of launches out of input order; a ``cuda`` dispatch with a
launch routed to ``gather``; the batch mesh's padded shards; the Seq1
ring still given raw ``[B, 4]`` candidates; and the two counters
``epilogue_kernel_rows`` / ``epilogue_torch_rows`` counting every row of
a dispatch once.  On the card (``gpu``): the kernels' finished rows equal
``finish_rows`` of their raw rows, scattered, bit for bit, and a batch
dispatch runs no kernel but the scorers'.  This file imports no JAX, so
its card tests run on a machine without it::

    python3 -c "import sys; sys.path.insert(0, 'tests'); \\
        import test_torch_epilogue as t; t.run_card_tests()"
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mpi_openmp_cuda_tpu_torch.obs import metrics
from mpi_openmp_cuda_tpu_torch.ops import cuda_scorer as cs
from mpi_openmp_cuda_tpu_torch.ops import dispatch
from mpi_openmp_cuda_tpu_torch.ops.oracle import prefix_best
from mpi_openmp_cuda_tpu_torch.ops.values import value_table
from mpi_openmp_cuda_tpu_torch.parallel import ring, sharding
from mpi_openmp_cuda_tpu_torch.utils.constants import INT32_MIN

CPU = torch.device("cpu")
W = [10, 2, 3, 4]
# Past the kernels' int32 window for rows of more than 1073 chars: such a
# launch runs gather inside a cuda dispatch (dispatch.effective_backend).
GATHER_WEIGHTS = [1000000, 1, 1, 1]
SENTINEL = -7  # rows of a buffer no launch writes keep it


def _codes(rng, n):
    return rng.integers(1, 27, size=int(n)).astype(np.int8)


def _edge_problem(width: int, seed: int = 3):
    """Seq1 and rows that hit every rule of the epilogue, all at most
    ``width`` chars: ``len2 == len1`` (twice, one a slice of Seq1),
    ``len2 > len1``, ``len2 == 0``, and searchable rows from 1 char up."""
    rng = np.random.default_rng(seed + width)
    len1 = width - 3
    seq1 = _codes(rng, len1)
    lens = [len1, len1 + 1, width, 0, 1, len1 - 1, max(1, len1 // 2), 2]
    seqs = [_codes(rng, n) for n in lens]
    seqs[0] = seq1.copy()
    seqs.append(seq1[: len1 - 1].copy())
    seqs.append(_codes(rng, len1))
    return seq1, seqs


def _state(seq1, seqs, weights, device):
    batch = dispatch.pad_problem(seq1, seqs)
    return cs.state_from_numpy(batch.seq1ext, batch.len1, batch.seq2, batch.len2,
                               value_table(weights).reshape(-1), device)


def _scorer(l2s):
    """The kernel wrapper of a packing class (None: fused), raw or finished."""
    if l2s is None:
        return cs.fused_scorer
    return lambda st, *finished: cs.packed_scorer(st, l2s, *finished)


def _held_to_finish_rows(st, l2s, device):
    """The finished mode of one wrapper against ``finish_rows`` of its raw
    rows and a scatter: out of input order into a larger buffer, and in
    order from ``row0``; rows no launch writes keep their value."""
    score = _scorer(l2s)
    b = st.rows.shape[0]
    rows = cs.finish_rows(score(st), st.lens, st.len1)
    count = b + 3
    perm = torch.from_numpy(np.random.default_rng(b).permutation(count)[:b]).to(device)
    for dst, row0 in ((perm, 0), (None, 2)):
        want = torch.full((count, 3), SENTINEL, dtype=torch.int32, device=device)
        if dst is None:
            want[row0 : row0 + b] = rows
        else:
            want[dst] = rows
        done = torch.full((count, 3), SENTINEL, dtype=torch.int32, device=device)
        assert score(st, done, dst, row0) is done
        assert torch.equal(done, want), (l2s, dst is None)
    return rows


def _edge_case(l2s):
    def case():
        width = 128 if l2s is None else l2s
        seq1, seqs = _edge_problem(width)
        rows = _held_to_finish_rows(_state(seq1, seqs, W, CPU), l2s, CPU)
        got = [tuple(int(v) for v in r) for r in rows]
        assert got == [prefix_best(seq1, s, W) for s in seqs]
        lens = [s.size for s in seqs]
        assert got[lens.index(0)] == got[lens.index(len(seq1) + 1)] == (INT32_MIN, 0, 0)
    return case


def _short_and_long_batch(seed=12):
    """Rows of every packing class, shuffled, beside fused rows and the
    edge rows: a dispatch of several launches out of input order."""
    rng = np.random.default_rng(seed)
    seq1 = _codes(rng, 296)
    lens = np.concatenate([rng.integers(lo, hi + 1, size=10)
                           for lo, hi in ((5, 8), (9, 16), (17, 32), (33, 64), (130, 250))])
    lens = np.concatenate([lens, [296, 300, 0]])
    rng.shuffle(lens)
    seqs = [_codes(rng, n) for n in lens]
    return seq1, seqs


def _per_launch_reference(launches, count):
    """Each launch's raw rows through ``finish_rows``, scattered by its
    host ``idx``: the path the dispatch took before the finish kernels."""
    out = np.zeros((count, 3), dtype=np.int32)
    for b in launches:
        st = b.state
        raw = cs.fused_scorer(st) if b.l2s is None else cs.packed_scorer(st, b.l2s)
        out[b.idx] = cs.finish_rows(raw, st.lens, st.len1).numpy()
    return out


def _dispatch_out_of_order():
    seq1, seqs = _short_and_long_batch()
    launches = dispatch.bucket_launches(seq1, seqs, W, CPU)
    assert len(launches) >= 3 and all(b.dst is not None for b in launches)
    got = dispatch.AlignmentScorer("cuda", device="cpu").score_codes(seq1, seqs, W)
    assert np.array_equal(got, _per_launch_reference(launches, len(seqs)))
    assert [tuple(int(v) for v in r) for r in got] == [prefix_best(seq1, s, W) for s in seqs]


def _gather_batch():
    rng = np.random.default_rng(21)
    seq1 = _codes(rng, 1300)
    seqs = [_codes(rng, n) for n in (1150, 7, 1190, 30, 0, 12, 5, 40, 19, 9, 64, 33)]
    return seq1, seqs


def _dispatch_gather_route():
    seq1, seqs = _gather_batch()
    launches = dispatch.bucket_launches(seq1, seqs, GATHER_WEIGHTS, CPU)
    routes = [dispatch.effective_backend("cuda", b.maxv, b.state.rows.shape[1], b.max_scored)
              for b in launches]
    assert "gather" in routes and "cuda" in routes
    got = dispatch.AlignmentScorer("cuda", device="cpu").score_codes(seq1, seqs,
                                                                     GATHER_WEIGHTS)
    assert [tuple(int(v) for v in r) for r in got] == [
        prefix_best(seq1, s, GATHER_WEIGHTS) for s in seqs]


def _mesh_padded_shards():
    """Seven rows on three slots: shards of three rows, two of them pads;
    each shard's launch writes its finished rows into its slot's [3, 3]
    buffer (one bucket) from row 0."""
    rng = np.random.default_rng(5)
    seq1 = _codes(rng, 200)
    seqs = [_codes(rng, n) for n in (50, 200, 0, 120, 230, 7, 199)]
    shards = []
    real = sharding.run_launch

    def spy(launch, backend, done):
        assert launch.dst is None and launch.row0 == 0
        out = real(launch, backend, done)
        assert out is done
        shards.append((launch.state.lens.tolist(), tuple(out.shape)))
        return out

    mesh = sharding.BatchSharding.over_devices(devices=[CPU] * 3)
    pads = sharding.mesh_counts["mesh_pad_rows"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sharding, "run_launch", spy)
        got = dispatch.AlignmentScorer("cuda", device="cpu", sharding=mesh).score_codes(
            seq1, seqs, W)
    assert sharding.mesh_counts["mesh_pad_rows"] - pads == 2
    assert [shape for _, shape in shards] == [(3, 3)] * 3
    assert shards[-1][0][1:] == [0, 0]  # the last shard's two pad rows
    single = dispatch.AlignmentScorer("cuda", device="cpu").score_codes(seq1, seqs, W)
    assert np.array_equal(got, single)
    assert [tuple(int(v) for v in r) for r in got] == [prefix_best(seq1, s, W) for s in seqs]


def _ring_raw_candidates():
    """The Seq1 ring's windows carry a block-local Seq1 length: their rows
    are candidates, so the ring asks the kernel for raw [B, 4] rows."""
    rng = np.random.default_rng(6)
    seq1 = _codes(rng, 300)
    seqs = [_codes(rng, n) for n in (40, 299, 300, 0, 310, 150)]
    calls = []
    real = ring.fused_scorer

    def spy(state, *finished):
        out = real(state, *finished)
        calls.append((len(finished), tuple(out.shape)))
        return out

    mesh = ring.RingSharding.over_devices(seq=2, batch=1, devices=[CPU] * 2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ring, "fused_scorer", spy)
        got = dispatch.AlignmentScorer("cuda", device="cpu", sharding=mesh).score_codes(
            seq1, seqs, W)
    assert calls == [(0, (len(seqs), 4))] * 2
    assert [tuple(int(v) for v in r) for r in got] == [prefix_best(seq1, s, W) for s in seqs]


CASES = {
    "fused-edges": _edge_case(None),
    **{f"packed{c}-edges": _edge_case(c) for c in cs.PACK_CLASSES},
    "dispatch-out-of-order": _dispatch_out_of_order,
    "dispatch-gather-route": _dispatch_gather_route,
    "mesh-padded-shards": _mesh_padded_shards,
    "ring-raw-candidates": _ring_raw_candidates,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_finished_rows_land_at_their_input_rows(case):
    CASES[case]()


# -- the counters ----------------------------------------------------------------


def _stub_card(mp):
    """The kernel path on the CPU: the wrappers take the card's branch and
    a fake entry stores the finished rows as the finish kernels do
    (computed here from the raw rows, not through ``finish_rows``)."""

    def entry(fn, state, *extra, done=None, dst=None, row0=0):
        width = extra[0] if extra else state.rows.shape[1]
        raw = cs._kernel_rows(state.seq1ext, state.len1, state.rows[:, :width], state.lens,
                              state.val, state.l1p)
        if done is None:
            return raw
        lens, len1 = state.lens, state.len1
        live = (lens > 0) & (lens < len1)
        score = torch.where(lens == len1, raw[:, 3], torch.where(live, raw[:, 0], INT32_MIN))
        rows = torch.stack([score, raw[:, 1] * live, raw[:, 2] * live], dim=1).int()
        cs.put_rows(done, rows, dst, row0)
        return done

    mp.setattr(cs, "_device_of", lambda st: "cuda")
    mp.setattr(cs, "check_smem", lambda st: 0)
    mp.setattr(cs, "_entry", lambda name: name)
    mp.setattr(cs, "call_entry", entry)


@pytest.mark.parametrize("path", ["plain", "plain-and-gather", "kernel", "kernel-and-gather"])
def test_epilogue_counters_count_every_row_once(path):
    """Every row of a batch dispatch is finished once: in a finish kernel
    (``epilogue_kernel_rows``) or by ``finish_rows`` or an mm/gather route
    (``epilogue_torch_rows``); the plain versions count as the latter."""
    seq1, seqs = _gather_batch() if path.endswith("gather") else _short_and_long_batch()
    weights = GATHER_WEIGHTS if path.endswith("gather") else W
    launches = dispatch.bucket_launches(seq1, seqs, weights, CPU)
    torch_rows = sum(b.idx.size for b in launches if dispatch.effective_backend(
        "cuda", b.maxv, b.state.rows.shape[1], b.max_scored) != "cuda")
    reg = metrics.activate_metrics()
    try:
        with pytest.MonkeyPatch.context() as mp:
            if path.startswith("kernel"):
                _stub_card(mp)
            got = dispatch.AlignmentScorer("cuda", device="cpu").score_codes(seq1, seqs, weights)
        counters = reg.snapshot()["counters"]
    finally:
        metrics.deactivate_metrics()
    kernel, torch_ = (counters.get("epilogue_kernel_rows", 0),
                      counters.get("epilogue_torch_rows", 0))
    assert kernel + torch_ == len(seqs)
    if path.startswith("kernel"):
        assert (kernel, torch_) == (len(seqs) - torch_rows, torch_rows)
    else:
        assert (kernel, torch_) == (0, len(seqs))
    assert [tuple(int(v) for v in r) for r in got] == [prefix_best(seq1, s, weights)
                                                       for s in seqs]


# -- on the card -----------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _batch_long(seed=7):
    """batch-long's shape: Seq1 3000 and 64 rows of 1200-1999 chars."""
    rng = np.random.default_rng(seed)
    seq1 = _codes(rng, 3000)
    return seq1, [_codes(rng, n) for n in rng.integers(1200, 2000, size=64)]


def _batch_short(seed=8):
    """batch-short's shape: Seq1 2976 and 1024 rows of 5-64 chars."""
    rng = np.random.default_rng(seed)
    seq1 = _codes(rng, 2976)
    return seq1, [_codes(rng, n) for n in rng.integers(5, 65, size=1024)]


@pytest.mark.gpu
def test_kernel_finished_rows_equal_finish_rows_scattered_on_the_card():
    """Each kernel's finished rows (fused, packed 8/16/32/64) == the raw
    rows through ``finish_rows`` scattered, bit for bit, on the edge rows
    and at the benchmark's widths, out of order and from ``row0``."""
    dev = _card()
    for l2s in (None, *cs.PACK_CLASSES):
        width = 128 if l2s is None else l2s
        seq1, seqs = _edge_problem(width)
        _held_to_finish_rows(_state(seq1, seqs, W, dev), l2s, dev)
        seq1, seqs = _batch_long() if l2s is None else (
            _batch_short()[0], [s[:l2s] for s in _batch_short()[1]])
        _held_to_finish_rows(_state(seq1, seqs, W, dev), l2s, dev)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_batch_dispatch_runs_only_the_scorer_kernels_on_the_card():
    """A batch dispatch on the card: its launches' tile and finish kernels
    and no PyTorch epilogue kernel; every row counted in
    ``epilogue_kernel_rows``; rows == the oracle."""
    dev = _card()
    from torch.profiler import ProfilerActivity, profile

    scorer = dispatch.AlignmentScorer("cuda", device=dev)
    for seq1, seqs in (_batch_long(), _batch_short()):
        scorer.score_codes(seq1, seqs, W)  # build, load, warm
        torch.cuda.synchronize()
        reg = metrics.activate_metrics()
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                got = scorer.score_codes(seq1, seqs, W)
                torch.cuda.synchronize()
            counters = reg.snapshot()["counters"]
        finally:
            metrics.deactivate_metrics()
        names = {ev.name() for ev in prof.profiler.kineto_results.events()
                 if str(ev.device_type()).endswith("CUDA")
                 and not ev.name().startswith(("Memcpy", "Memset"))}
        assert names and all("tile_kernel" in n or "finish_kernel" in n for n in names), names
        assert counters.get("epilogue_kernel_rows") == len(seqs)
        assert "epilogue_torch_rows" not in counters
        for i in range(0, len(seqs), max(1, len(seqs) // 16)):
            assert tuple(int(v) for v in got[i]) == prefix_best(seq1, seqs[i], W)


def run_card_tests() -> None:
    """The ``gpu`` tests of this file, for a machine whose test suite
    cannot be collected (no JAX for ``tests/conftest.py``)."""
    for test in (test_kernel_finished_rows_equal_finish_rows_scattered_on_the_card,
                 test_batch_dispatch_runs_only_the_scorer_kernels_on_the_card):
        test()
        print(f"ok {test.__name__}", flush=True)
