#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py            # from the root of a checkout

Phases, each fatal on failure (no phase is caught and swallowed):

1. build the four kernels from ``mpi_openmp_cuda_tpu_torch/csrc/`` (one
   nvcc per source, started together) and print each one's ptxas report,
   then the card's name and power limit;
2. every launch the main path makes for the max-size workload (Seq1 3000,
   64 Seq2 of 1200..1999, seed 7; ``dispatch.bucket_launches``, the
   scorer's own bucketing, padding and kernel choice) against its plain
   PyTorch version on the card, exact equality, at the weights 10 2 3 4
   and at max |v| = 127, 128 and 3000; eight pairs against the numpy
   oracle ``prefix_best``; then the fused kernel's seams
   (:func:`seam_problems`: tile edges, ties across tiles and char
   segments, the edge lengths, all-equal weights), every row against its
   plain version and the oracle;
3. the packed kernel against its plain version and the fused kernel,
   exact equality: first its seams (:func:`packed_seam_problems`: each
   class at its boundary lengths, pairs of every length and len2 = 0 in one
   block, len2 = len1 and above, exact ties across lanes, tiles and hyphen
   positions, valid offsets that end mid-tile), every row against the
   oracle too; then the input4-class packed set (Seq1 2976, 30 Seq2 of
   5..64, seed 7) and one batch per class 8/16/32;
4. the main path: launch counts set to 0, then the batch CLI
   (``io.cli.run``) on every ``tests/fixtures/*.txt`` (stdout byte-identical
   to its ``.out``) and on the max-size, input4-class, 1024-short-row and
   input3-class (the bench's workload, its own weights) inputs (checked
   against the oracle); both kernels must have launched;
5. each launch of that run, rebuilt by ``bucket_launches`` from the same
   parsed inputs (their count must equal the launch counts): kernel ==
   plain on the card, then kernel time (CUDA events over back-to-back
   launches), plain-version time and bound, summed per input and per
   kernel into the kernels JSON line; every bucket of that run that the
   packed kernel could take timed with both kernels, the kernel the
   packing rule picked at most 3 % slower than the other (``RULE_SLACK``);
   the bench's one padded launch of the
   input3-class batch (``bench.single_program``) == plain; warm CLI walls,
   the device's busy share of a max-size CLI run and a cProfile of its
   host side;
6. the issue-rate probe (``csrc/issue_probe.cu``): its SASS holds the
   unrolled chains (no op folded away); for each op, kernel == plain
   exactly for a 32-step chain at one full wave of blocks and for one
   block at the rate's long chain (plain on the CPU; ``fma``'s plain
   version rounds once, as ``fmaf`` does, and every fma value must move by
   at least one ulp per step), kernel and plain timed at 4096 steps, then
   the op's rate beside its data-sheet peak (0 or above 105 % fails);
7. the stage ablation (``csrc/ablate_scorer.cu``: the fused scorer's
   kernels, ``csrc/fused_kernels.cuh``, one stage dropped per variant;
   driven through ``scripts/torch_kernel_ablate.py``) on the max-size
   launches:
   its exact variants (``EXACT`` there) == ``fused_scorer`` exactly,
   ``base`` within 5 % of ``fused_scorer``'s time (interleaved fused,
   base, base, fused), then the per-stage table with launch counts set to
   0 before it;
8. the bench path: ``python -m mpi_openmp_cuda_tpu_torch.bench`` on the
   input3-class workload in a subprocess; its one stdout line must
   validate as a bench run report and carry the device, the three probe
   rates, ``floor_us`` and launch counts of the fused scorer and the
   probe > 0 (the bench resets its counts before its first run);
9. launch groups (``ops/schedule.py``), run after phase 5: for every CLI
   input, the planned launches (``bucket_launches``) against one launch a
   bucket (``fuse=False``): each group launch == its plain version, the
   grouped rows == the singleton rows == the oracle (every row of the
   small inputs, eight of the large), and, where the plan groups buckets,
   both schedules timed (planned, singletons, singletons, planned), the
   planned one at most ``RULE_SLACK`` slower; then, at input3-class, the
   one batched ``finish_rows`` epilogue and copy against one a bucket;
10. the ``mm`` and ``gather`` backends on the card: TF32 shown to round
   the mm path's value matrix at :data:`TF32_WEIGHTS` while
   ``matmul_scorer.ieee_fp32`` keeps it exact; on max-size, at the
   weights of phase 2 and at :data:`TF32_WEIGHTS`, both == the fused
   kernel's rows (eight of them == the oracle); every seam row == the
   oracle at max|v| 127, 128 and 3000; both timed on max-size;
11. the robustness path through ``io.cli.run`` on cuda: first each of
   its launches rebuilt at the path's own shapes (every fixture in
   ``--stream`` chunks of 2 rows, stress_small in chunks of 3, max-size
   in the journal's chunks), each held kernel == plain; then, launch
   counts set to 0: ``--stream 2 --journal`` on every fixture, faults
   absorbed by ``--retries``, ``--degrade`` down to ``mm`` and to
   ``gather``, ``SEQALIGN_DRAIN=1`` (75) then ``--resume``, and
   ``--deadline 0.5 --retries 2 --faults hang:dispatch:fail=1``; every
   stdout == its golden (the fixture's ``.out``, the oracle's for
   max-size), and a scorer kernel must have launched;
12. gather routing on cuda (the int32 gate): the gate fault's cases C
   (``1000000000 1 1 1``) and D (a 64-char row beside a 5-char Seq1)
   through the CLI print the JAX package's rows (:data:`GATE_CASES`) and
   the oracle's; max-size at ``700000 1 1 1`` (``L*M < 2^31 <= 2*L*M``)
   runs every launch as gather, shown by zero fused and packed launches
   across its CLI run, its rows == the oracle; one step past the
   admission gate the scorer raises and the CLI exits 65 naming 2^31;
13. the obs plane on cuda: max-size and every fixture through the CLI
   with ``--metrics-out``, ``--trace-out``, ``--profile`` and
   ``--heartbeat 0.01``: stdout == its golden, the report and the trace
   validate, the report's launch counters == the launch-count deltas,
   the ``chunk_gather`` span >= the device time of the run's launches
   (phase 5's CUDA-event times), one trace ``dispatch`` row per launch
   group, each with a modelled wall > 0; ``--trace DIR`` writes a
   ``torch.profiler`` trace that names the fused tile and finish
   kernels; a ``--faults chunk_scoring:fail=1 --retries 2`` run and a
   ``SEQALIGN_DRAIN=1 --journal`` run (75) leave reports whose counters
   match; then the warm max-size CLI wall (min of five) with the plane
   off and with ``--metrics-out``, interleaved, and the span totals of
   the fastest armed run;
14. several devices (``parallel/``) on the one card, every fused launch
   of the phase held == its plain version on a ``window_state`` rebuilt
   from its operands: ``BatchSharding`` over ``[cuda:0] x 4`` on every
   fixture and max-size (launch counts set to 0 first: 4 launches a
   bucket, no collective counted inside the compute, one gather a
   bucket, rows == the single-device rows == the golden), ``--mesh 1``
   through ``io.cli.run`` on the fixtures and a mesh one larger than the
   card count refused (65, the JAX CLI's message); ``RingSharding`` over
   ``[cuda:0] x 8`` as ``seq:8`` (the fixtures, max-size and
   :func:`ring_problems`: the mostly-dead shards, Seq1 6144, Seq1 12288
   with L2P 12288) and as ``2x4`` (fixtures, max-size, mostly-dead): rows
   == golden or oracle, R shifts and one all_gather a shard, 8 window
   launches a dispatch, the ``len1_eff`` range and the largest dynamic
   shared memory printed; two processes of ``--distributed`` on the card
   (``gloo``: the ranks share it) with ``--mesh 2`` and ``--mesh seq:2``
   on mixedcase and max-size (rank 0 == golden, rank 1 silent, both 0)
   and a parse failure on rank 0 (both 65 within 60 s); then max-size's
   warm wall single-device, over ``[cuda:0] x 4`` and over ``seq:8``
   with each path's summed launch time (CUDA events), and a two-process
   job's wall.

In the kernels JSON line, ``launches`` is each kernel's count from one run
of its path, with the counts set to 0 just before it: the CLI run of
phase 4 for the two scorers (``ms``, ``plain_ms`` and ``bound_ms`` are
summed over those same launches, rebuilt in phase 5), the bench run of
phase 8 for the probe (its times: one full-wave launch per op at 4096
steps), and the per-stage table of phase 7 for the ablation kernel (its
times: ``base`` over the max-size launches).  The bench's own count per
scoring run is its record's ``launches``.

The last line of stdout is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import cProfile
import io
import json
import os
import pstats
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PKG = "mpi_openmp_cuda_tpu_torch"

WEIGHTS = [10, 2, 3, 4]
# max |v| = 127, 128 and 3000: the TPU kernel's three feed regimes.
REGIME_WEIGHTS = [[127, 2, 3, 4], [128, 2, 3, 4], [3000, 7, 1, 2]]
# Issue-rate probe: steps per chain of the full-wave kernel == plain check
# and of the kernel-vs-plain timing.
PROBE_CHECK_ITERS = 32
PROBE_TIME_ITERS = 4096
# The ablation's base must time within this share of fused_scorer.
ABLATE_BASE_TOL = 0.05
# The kernel the packing rule picks for a bucket may time at most this share
# slower than the other kernel.
RULE_SLACK = 0.03
# The int32 gate fault's inputs and the JAX package's rows for them
# (``python -m mpi_openmp_cuda_tpu --backend oracle``; ROADMAP Queue 3).
GATE_CASES = {
    "C": ("1000000000 1 1 1\nABBAB\n3\nA\nAB\nBA\n",
          [(1000000000, 0, 0), (2000000000, 0, 0), (2000000000, 1, 1)]),
    "D": ("16777216 1 1 1\nABBAB\n2\nAB\n" + "AB" * 32 + "\n",
          [(33554432, 0, 0), (-2147483648, 0, 0)]),
}
# Max-size at these weights sits between the kernels' window and the gate.
GATHER_WEIGHTS = [700000, 1, 1, 1]
# Span totals phase 13 prints for the warm max-size CLI run.
SPAN_PATHS = ("parse", "setup", "score", "score.chunk_dispatch", "score.chunk_gather",
              "print")


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def input4_problem(np):
    """sb_refit.workloads()['input4-class-packed'] (i8): the fifth draw of
    its seed-7 generator — Seq1 2976, 30 Seq2 of 5..64."""
    rng = np.random.default_rng(7)

    def mk(len1, lens):
        s1 = rng.integers(1, 27, size=len1)
        return s1, [rng.integers(1, 27, size=int(n)) for n in lens]

    mk(1489, rng.integers(56, 1153, size=32))
    mk(3000, rng.integers(1200, 2000, size=64))
    mk(1489, rng.integers(1460, 1490, size=64))
    mk(2976, rng.integers(5, 83, size=30))
    s1, seqs = mk(2976, rng.integers(5, 65, size=30))
    return s1.astype(np.int8), [s.astype(np.int8) for s in seqs]


def seam_problems(np):
    """Inputs that try the seams of ``csrc/fused_scorer.cu``, as (tag, seq1,
    seqs, weights, {row: (field, value)} the oracle's answer must show).
    Fields: 1 = n, 2 = k."""
    rng = np.random.default_rng(23)
    s1 = rng.integers(1, 27, size=700).astype(np.int8)
    skip = np.concatenate([s1[40:290], s1[291:441]])  # a hyphen after 250 chars
    edges = [
        s1[127:427],  # best offset: the last of tile 0 (its redundant edge column)
        s1[128:428],  # the first of tile 1
        s1[383:684], s1[5:338],  # lengths 301, 333: no multiple of 4 or of 6 segments
        skip,
        s1[:1], s1[1:], s1.copy(),  # len2 = 1, len1 - 1, len1
        np.concatenate([s1, s1[:5]]),  # len2 > len1
    ]
    want = {0: (1, 127), 1: (1, 128), 2: (1, 383), 3: (1, 5), 4: (2, 250)}
    out = [("tile edges and edge lengths", s1, edges, WEIGHTS, want)]
    # Seq1 of period 150: offsets 20, 170, ..., 620 tie exactly, in five
    # different tiles; the first must win.
    block = rng.integers(1, 27, size=150).astype(np.int8)
    out.append(("ties across tiles", np.tile(block, 5),
                [block[20:140], np.tile(block, 2)[20:290]], WEIGHTS,
                {0: (1, 20), 1: (1, 20)}))
    # Two letters: ties between offsets and between hyphen positions in
    # different char segments; with all-equal and all-zero weights too.
    lo1 = rng.integers(1, 3, size=700).astype(np.int8)
    lo = [rng.integers(1, 3, size=int(n)).astype(np.int8)
          for n in rng.integers(2, 650, size=24)]
    out.append(("two-letter ties", lo1, lo, [5, 1, 1, 1], {}))
    out.append(("all-equal weights", lo1, lo, [1, 1, 1, 1], {}))
    out.append(("all-zero weights", lo1, lo, [0, 0, 0, 0],
                {i: (f, 0) for i in range(len(lo)) for f in (1, 2)}))
    return out


def packed_seam_problems(np):
    """Inputs that try the seams of ``csrc/packed_scorer.cu``, as (tag, seq1,
    seqs, weights, {row: (field, value)} the oracle's answer must show); every
    row fits a packing class.  Fields: 1 = n, 2 = k."""
    rng = np.random.default_rng(29)
    s1 = rng.integers(1, 27, size=3000).astype(np.int8)
    out = []
    for l2s in (8, 16, 32, 64):  # each class at its boundary lengths
        lens = [l2s, l2s // 2 + 1, l2s, 1, l2s - 1] * 4
        out.append((f"class {l2s} at its boundary lengths", s1,
                    [rng.integers(1, 27, size=n).astype(np.int8) for n in lens],
                    WEIGHTS, {}))
    # Pairs of every length, 0 included, side by side in one block.
    lens = [0, 64, 1, 33, 0, 5, 17, 48, 2, 0, 63, 9, 31, 0, 40, 7]
    out.append(("mixed lengths in one block, len2 = 0 rows", s1,
                [s1[100 + 7 * i: 100 + 7 * i + n] for i, n in enumerate(lens)],
                WEIGHTS, {1: (1, 107), 3: (1, 121)}))
    short = s1[:40]
    out.append(("len2 = len1 and len2 > len1", short,
                [short.copy(), np.concatenate([short, s1[:5]]), s1[3:30], s1[:39]],
                WEIGHTS, {2: (1, 3)}))
    # A run of one letter 61 long at offset 4 * 401 + 3: offsets 1607 and
    # 1608 (lanes 401 % 32 and the next) tie exactly, and at 1607 k = 0 ties
    # every k >= 1.
    run = s1.copy()
    run[1607:1668] = 1
    out.append(("ties across lanes and between k = 0 and k >= 1", run,
                [run[1607:1667], run[1608:1640]], WEIGHTS,
                {0: (1, 1607), 1: (1, 1607)}))
    # Seq1 of period 1000: offsets 30, 1030 and 2030 tie, in tiles 0, 8, 15.
    block = rng.integers(1, 27, size=1000).astype(np.int8)
    out.append(("ties across tiles", np.tile(block, 3),
                [block[30:90], block[30:62], block[30:46]], WEIGHTS,
                {i: (1, 30) for i in range(3)}))
    # The last valid offset, mid-tile (tile 23 holds 2944..3071).
    out.append(("valid offsets end mid-tile", s1,
                [s1[2962:2999], s1[2989:2997], s1[2943:2999]], WEIGHTS,
                {0: (1, 2962), 1: (1, 2989), 2: (1, 2943)}))
    lo1 = rng.integers(1, 3, size=3000).astype(np.int8)
    lo = [rng.integers(1, 3, size=int(n)).astype(np.int8)
          for n in rng.integers(1, 65, size=24)]
    out.append(("two-letter ties", lo1, lo, [5, 1, 1, 1], {}))
    out.append(("all-zero weights", lo1, lo, [0, 0, 0, 0],
                {i: (f, 0) for i in range(len(lo)) for f in (1, 2)}))
    return out


def as_text(np, seq1, seqs, weights) -> str:
    def dec(c):
        return bytes((np.asarray(c) + 64).astype(np.uint8)).decode()

    return "\n".join(
        [" ".join(map(str, weights)), dec(seq1), str(len(seqs))]
        + [dec(s) for s in seqs]
    ) + "\n"


def device_us(torch, fn) -> tuple[dict[str, float], float, float]:
    """Run ``fn`` once under ``torch.profiler``; returns (device time in us
    per kernel name, total device busy us, host wall us).  Empty when the
    profiler sees no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6
    per: dict[str, float] = {}
    busy = 0.0
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = ev.time_range.elapsed_us()
        busy += us
        found = re.search(r"\w*kernel\w*|Memcpy \w+|Memset", ev.name)
        name = found.group(0) if found else ev.name[:40]
        per[name] = per.get(name, 0.0) + us
    return per, busy, wall


def run_cli(cli, argv, err=None) -> tuple[int, bytes, float]:
    """``cli.run(argv)`` in this process with fd 1 captured (and fd 2 into
    the list ``err``, when given); returns (exit code, stdout bytes, wall
    seconds)."""
    sys.stdout.flush()
    sys.stderr.flush()
    fds = (1, 2) if err is not None else (1,)
    saved = [os.dup(fd) for fd in fds]
    caps = [tempfile.TemporaryFile() for _ in fds]
    try:
        for fd, cap in zip(fds, caps):
            os.dup2(cap.fileno(), fd)
        try:
            t0 = time.perf_counter()
            rc = cli.run(argv)
            wall = time.perf_counter() - t0
            sys.stdout.flush()
            sys.stderr.flush()
        finally:
            for fd, old in zip(fds, saved):
                os.dup2(old, fd)
                os.close(old)
        outs = []
        for cap in caps:
            cap.seek(0)
            outs.append(cap.read())
        if err is not None:
            err.append(outs[1].decode(errors="replace"))
        return rc, outs[0], wall
    finally:
        for cap in caps:
            cap.close()


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (REPO / PKG / "csrc").is_dir():
        print(f"chip_smoke: {PKG}/ not found beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from mpi_openmp_cuda_tpu_torch.bench import single_program
    from mpi_openmp_cuda_tpu_torch.io import cli
    from mpi_openmp_cuda_tpu_torch.io.parse import load_problem
    from mpi_openmp_cuda_tpu_torch.models.workload import (
        MAX_SIZE, input3_class_problem, synthetic_codes)
    from mpi_openmp_cuda_tpu_torch.ops import _build, probe
    from mpi_openmp_cuda_tpu_torch.ops import cuda_scorer as cs
    from mpi_openmp_cuda_tpu_torch.ops.costs import bound_ms
    from mpi_openmp_cuda_tpu_torch.ops.dispatch import (
        bucket_launches, choose_rowpack, pad_problem)
    from mpi_openmp_cuda_tpu_torch.ops.oracle import prefix_best
    from mpi_openmp_cuda_tpu_torch.ops.values import max_abs_value, value_table
    from mpi_openmp_cuda_tpu_torch.utils.timing import card_line, time_ms

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    names = ("fused_scorer", "packed_scorer")
    all_kernels = (*names, "issue_probe", "ablate_scorer")

    # -- 1. build + device line ------------------------------------------
    t0 = time.perf_counter()
    reports = _build.build(list(all_kernels))
    log(f"build: {len(all_kernels)} kernels in {time.perf_counter() - t0:.1f} s")
    for name, report in sorted(reports.items()):
        for line in report.splitlines():
            if line.strip():
                log(f"ptxas {name}: {line.strip()}")
    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    max_err = dict.fromkeys(names, 0)

    def kernel_of(launch):
        if launch.l2s is None:
            return "fused_scorer", lambda: cs.fused_scorer(launch.state), (
                lambda: cs.fused_scorer_plain(launch.state))
        return "packed_scorer", lambda: cs.packed_scorer(launch.state, launch.l2s), (
            lambda: cs.packed_scorer_plain(launch.state, launch.l2s))

    def compare(name, got, want):
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
        max_err[name] = max(max_err[name], err)
        if not torch.equal(got, want):
            fail(f"{name} differs from its plain version (max abs err {err})")

    def scored_rows(launches, count):
        """The [count, 3] result rows of ``launches`` in input order, each
        launch held kernel == plain on the way."""
        out = np.zeros((count, 3), dtype=np.int64)
        for launch in launches:
            name, kern, plain = kernel_of(launch)
            raw = kern()
            compare(name, raw, plain())
            st = launch.state
            out[launch.idx] = cs.finish_rows(raw, st.lens, st.len1).cpu().numpy()
        return out

    def check_oracle(seq1, seqs, weights, rows, idx):
        for i in idx:
            want = prefix_best(seq1, seqs[i], weights)
            if tuple(int(x) for x in rows[i]) != want:
                fail(f"pair {i}: {tuple(rows[i])} != oracle {want}")

    # -- 2. the max-size launches vs plain -------------------------------
    seq1_max, seqs_max = synthetic_codes(*MAX_SIZE)
    for weights in [WEIGHTS, *REGIME_WEIGHTS]:
        launches = bucket_launches(seq1_max, seqs_max, weights, dev)
        rows = scored_rows(launches, len(seqs_max))
        check_oracle(seq1_max, seqs_max, weights, rows, range(0, len(seqs_max), 8))
        log(f"max-size, weights {weights} (max|v| "
            f"{max_abs_value(value_table(weights))}): {len(launches)} launches "
            f"{[(b.idx.size, b.state.rows.shape[1], b.l2s) for b in launches]} "
            f"== plain, 8 pairs == oracle")

    for tag, s1, seqs, weights, want in seam_problems(np):
        launches = bucket_launches(s1, seqs, weights, dev)
        if any(b.l2s is not None for b in launches):
            fail(f"seam input {tag!r} reached the packed kernel")
        rows = scored_rows(launches, len(seqs))
        check_oracle(s1, seqs, weights, rows, range(len(seqs)))
        for i, (field, value) in want.items():
            if rows[i][field] != value:
                fail(f"seam input {tag!r}, row {i}: {tuple(rows[i])} does not "
                     f"try its seam (field {field} != {value})")
        log(f"seams, {tag}: {len(seqs)} rows in {len(launches)} launches == "
            f"plain == oracle; k > 0 in {int((rows[:, 2] > 0).sum())} rows")

    # -- 3. packed kernel vs plain at every class ------------------------
    def state_of(seq1, seqs, weights):
        batch = pad_problem(seq1, seqs)
        return cs.state_from_numpy(
            batch.seq1ext, batch.len1, batch.seq2, batch.len2,
            value_table(weights).reshape(-1), dev,
        )

    for tag, s1, seqs, weights, want in packed_seam_problems(np):
        st = state_of(s1, seqs, weights)
        l2s = next(c for c in cs.PACK_CLASSES if c >= st.max_len2)
        raw = cs.packed_scorer(st, l2s)
        compare("packed_scorer", raw, cs.packed_scorer_plain(st, l2s))
        if not torch.equal(raw, cs.fused_scorer(st)):
            fail(f"packed seam {tag!r}: packed_scorer differs from fused_scorer")
        rows = cs.finish_rows(raw, st.lens, st.len1).cpu().numpy()
        check_oracle(s1, seqs, weights, rows, range(len(seqs)))
        for i, (field, value) in want.items():
            if rows[i][field] != value:
                fail(f"packed seam {tag!r}, row {i}: {tuple(rows[i])} does not "
                     f"try its seam (field {field} != {value})")
        log(f"packed seams, {tag}: {len(seqs)} rows, l2s {l2s}, == plain == "
            f"fused == oracle; k > 0 in {int((rows[:, 2] > 0).sum())} rows")

    seq1_4, seqs_4 = input4_problem(np)
    packed_sets = {64: (seq1_4, seqs_4)}
    for l2s, seed in ((8, 81), (16, 82), (32, 83)):
        packed_sets[l2s] = (seq1_4, synthetic_codes(2976, 30, 5, l2s, seed)[1])
    for l2s, (s1, seqs) in sorted(packed_sets.items()):
        for weights in [WEIGHTS, REGIME_WEIGHTS[-1]]:
            st = state_of(s1, seqs, weights)
            raw = cs.packed_scorer(st, l2s)
            compare("packed_scorer", raw, cs.packed_scorer_plain(st, l2s))
            if not torch.equal(raw, cs.fused_scorer(st)):
                fail(f"packed_scorer l2s={l2s} differs from fused_scorer")
            rows = cs.finish_rows(raw, st.lens, st.len1).cpu().numpy()
            check_oracle(s1, seqs, weights, rows, range(0, 30, 4))
        log(f"packed_scorer l2s={l2s} == plain == fused == oracle, 30 pairs")

    # -- 4. main path: the batch CLI -------------------------------------
    fixtures = sorted((REPO / "tests" / "fixtures").glob("*.txt"))
    if len(fixtures) != 7:
        fail(f"expected 7 fixtures, found {len(fixtures)}")
    seq1_k, seqs_k = synthetic_codes(3000, 1024, 5, 64, 7)
    tmp = tempfile.TemporaryDirectory()
    inputs = {f.name: f for f in fixtures}
    prob3 = input3_class_problem()
    big = {"max-size": (seq1_max, seqs_max, WEIGHTS),
           "input4-class": (seq1_4, seqs_4, WEIGHTS),
           "1024 short rows": (seq1_k, seqs_k, WEIGHTS),
           "input3-class": (prob3.seq1_codes, prob3.seq2_codes, prob3.weights)}
    for tag, (s1, seqs, weights) in big.items():
        inputs[tag] = Path(tmp.name) / f"{tag.replace(' ', '-')}.txt"
        inputs[tag].write_text(as_text(np, s1, seqs, weights))
    torch.cuda.synchronize()
    cs.reset_launch_counts()
    outputs = {tag: run_cli(cli, ["--input", str(path)]) for tag, path in inputs.items()}
    counts = dict(cs.launch_counts)
    log(f"main path launch counts: {counts}")
    for f in fixtures:
        rc, out, wall = outputs[f.name]
        if rc != 0 or out != f.with_suffix(".out").read_bytes():
            fail(f"CLI on {f.name}: rc {rc}, stdout differs from {f.stem}.out")
        log(f"cli {f.name}: byte-identical to .out, wall {wall * 1e3:.3f} ms")
    for tag, (s1, seqs, weights) in big.items():
        rc, out, wall = outputs[tag]
        want = "".join(
            f"#{i}: score: {s}, n: {n}, k: {k}\n"
            for i, (s, n, k) in enumerate(prefix_best(s1, q, weights) for q in seqs)
        )
        if rc != 0 or out.decode() != want:
            fail(f"CLI on {tag}: rc {rc}, stdout differs from the oracle")
        inputs[tag].with_suffix(".out").write_text(want)  # phase 11's golden
        log(f"cli {tag}: {len(seqs)} rows == oracle, wall {wall * 1e3:.3f} ms")
    for name in names:
        if counts[name] < 1:
            fail(f"the main path never launched {name}")

    # -- 5. the main path's launches: check, time, bound -----------------
    total = {name: {"n": 0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                    "by": {"bytes": 0.0, "operations": 0.0}} for name in names}
    run_kernel_ms = {}  # per input: device ms of its CLI run's launches
    run_launches = {}  # per input: its CLI run's launch groups
    for tag, path in inputs.items():
        prob = load_problem(str(path))
        launches = bucket_launches(prob.seq1_codes, prob.seq2_codes, prob.weights, dev)
        run_launches[tag] = len(launches)
        per = {name: [0, 0.0, 0.0, 0.0] for name in names}
        for launch in launches:
            name, kern, plain = kernel_of(launch)
            compare(name, kern(), plain())
            ms = time_ms(kern, reps=50)
            plain_ms = time_ms(plain, reps=3)
            b_ms, b_by, b_term = bound_ms(launch.state)
            log(f"launch {tag} {name} rows {launch.idx.size} L2P "
                f"{launch.state.rows.shape[1]} l2s {launch.l2s}: kernel "
                f"{ms:.6f} ms, plain {plain_ms:.6f} ms, bound {b_ms:.6f} ms "
                f"({b_term})")
            for i, x in enumerate((1, ms, plain_ms, b_ms)):
                per[name][i] += x
            tot = total[name]
            tot["n"] += 1
            tot["ms"] += ms
            tot["plain_ms"] += plain_ms
            tot["bound_ms"] += b_ms
            tot["by"][b_by] += b_ms
        run_kernel_ms[tag] = sum(ms for _, ms, _, _ in per.values())
        for name, (n, ms, plain_ms, b_ms) in per.items():
            if n:
                log(f"input {tag} {name}: {n} launches, sum kernel {ms:.6f} ms, "
                    f"plain {plain_ms:.6f} ms, bound {b_ms:.6f} ms [{card}]")
    for name in names:
        if total[name]["n"] != counts[name]:
            fail(f"{name}: the main path launched {counts[name]} times, "
                 f"bucket_launches rebuilt {total[name]['n']}")
    # The packing rule on the card: every bucket of the run that the packed
    # kernel could take, timed with both kernels in turns (packed, fused,
    # fused, packed); the kernel the rule picked may be at most
    # RULE_SLACK slower than the other.
    short_ms = {}
    for tag, path in inputs.items():
        prob = load_problem(str(path))
        for launch in bucket_launches(prob.seq1_codes, prob.seq2_codes, prob.weights, dev):
            st = launch.state
            # The class the packed kernel could take it in (the rule off the card).
            l2s = choose_rowpack(st.rows.shape[1], st.lens.tolist())
            if l2s is None:
                continue
            p0, f0, f1, p1 = (time_ms(fn, reps=50) for fn in (
                lambda: cs.packed_scorer(st, l2s), lambda: cs.fused_scorer(st),
                lambda: cs.fused_scorer(st), lambda: cs.packed_scorer(st, l2s)))
            packed_ms, fused_ms = (p0 + p1) / 2, (f0 + f1) / 2
            if tag == "1024 short rows":
                short_ms[l2s] = packed_ms
            picked, other = ((packed_ms, fused_ms) if launch.l2s is not None
                             else (fused_ms, packed_ms))
            verdict = (f"short bucket {tag} l2s {l2s} rows {launch.idx.size}: packed "
                       f"{packed_ms:.6f} ms, fused {fused_ms:.6f} ms; the rule picked "
                       f"{'packed' if launch.l2s is not None else 'fused'}, "
                       f"{100 * (picked - other) / other:+.2f} % against the other [{card}]")
            log(verdict)
            if picked > (1 + RULE_SLACK) * other:
                fail(f"the packing rule picked the slower kernel: {verdict}")
    log(f"packed kernel on the 1024-short-row class-32 and class-64 buckets: "
        f"{short_ms[32] + short_ms[64]:.6f} ms [{card}]")
    # What one launch for all buckets could gain: the max-size input padded
    # into a single fused launch (64 rows x L2P 2048), timed the same way.
    st_one = state_of(seq1_max, seqs_max, WEIGHTS)
    one_ms = time_ms(lambda: cs.fused_scorer(st_one), reps=50)
    log(f"max-size as one padded fused launch: {one_ms:.6f} ms [{card}]")
    # The bench's single-program launch: input3-class padded into one.
    st_sp = single_program(prob3, dev)
    compare("fused_scorer", cs.fused_scorer(st_sp), cs.fused_scorer_plain(st_sp))
    log(f"input3-class as one padded fused launch {tuple(st_sp.rows.shape)} == plain")

    # The main-path metric: batch wall time per input (parse, pad, copy in,
    # launch, copy out, print), warm, five runs each.
    for tag in big:
        walls = sorted(run_cli(cli, ["--input", str(inputs[tag])])[2] for _ in range(5))
        log(f"cli {tag}: warm walls {[round(w * 1e3, 3) for w in walls]} ms [{card}]")
    # Device busy share of one warm max-size CLI run (the rest is host).
    path = str(inputs["max-size"])
    per_kernel, busy, wall = device_us(torch, lambda: run_cli(cli, ["--input", path]))
    log(f"profile cli max-size: device busy {busy:.3f} us of {wall:.3f} us "
        f"wall ({100 * busy / wall:.2f} %) {per_kernel} [{card}]")
    # Host side of the same run: the port's functions by cumulative time.
    prof = cProfile.Profile()
    prof.runcall(run_cli, cli, ["--input", path])
    text = io.StringIO()
    pstats.Stats(prof, stream=text).sort_stats("cumulative").print_stats(PKG, 12)
    for line in text.getvalue().splitlines():
        if PKG in line or "cumtime" in line:
            log(f"host {line.strip()}")

    # -- 9-11. launch groups, the mm and gather backends, robustness -------
    groups_phase(np, torch, cs, compare, inputs, prefix_best, time_ms, card)
    backends_phase(np, torch, (seq1_max, seqs_max), prefix_best, time_ms, card)
    robust_counts = robustness_phase(torch, cli, cs, compare, fixtures, inputs)
    # -- 12-13. gather routing, the obs plane ------------------------------
    gather_counts = gather_route_phase(np, torch, cli, cs, (seq1_max, seqs_max), prefix_best)
    obs_counts = obs_phase(torch, cli, cs, fixtures, inputs, run_kernel_ms, run_launches, card)
    # -- 14. several devices: batch mesh, the Seq1 ring, two processes ------
    mesh_counts = mesh_phase(np, torch, cli, cs, compare, fixtures, inputs, prefix_best,
                             time_ms, card)
    tmp.cleanup()

    # -- 6-8. the probe, the ablation and the bench path ------------------
    probe_row = probe_phase(torch, probe, time_ms, card)
    abl_row, abl_counts = ablation_phase(
        torch, cs, time_ms, bound_ms,
        bucket_launches(seq1_max, seqs_max, WEIGHTS, dev), card,
    )
    bench_counts = bench_phase(probe)
    paths = {"cli": counts, "robustness": robust_counts, "gather route": gather_counts,
             "obs": obs_counts, **{f"mesh, {k}": v for k, v in mesh_counts.items()},
             "bench": bench_counts, "ablation": abl_counts}
    log(f"launch counts by path: {paths}")
    log(f"total {time.perf_counter() - t_start:.1f} s")

    kernels = []
    for name in names:
        tot = total[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"{PKG}/csrc/{name}.cu",
            "replaces": (
                "mpi_openmp_cuda_tpu/ops/pallas_scorer.py:559"
                if name == "fused_scorer"
                else "mpi_openmp_cuda_tpu/ops/pallas_scorer.py:1120"
            ),
            "launches": counts[name],
            "max_abs_err": max_err[name],
            "ms": tot["ms"],
            "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"],
            "bound_by": max(tot["by"], key=tot["by"].get),
            "library_ms": None,
        })
    kernels.append({**probe_row, "launches": bench_counts["issue_probe"]})
    kernels.append(abl_row)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


def scatter_rows(np, launches, count, backend="cuda"):
    """The [count, 3] host rows of ``launches`` on ``backend`` in input
    order, through the production path's one epilogue and one copy."""
    from mpi_openmp_cuda_tpu_torch.ops.dispatch import BucketedPending, run_launch

    if not launches:
        return np.zeros((0, 3), dtype=np.int32)
    parts = [(b.idx, run_launch(b, backend), b.state.lens) for b in launches]
    len1 = launches[0].state.len1
    return BucketedPending(parts, count, len1, finish=backend == "cuda").result().copy()


def groups_phase(np, torch, cs, compare, inputs, prefix_best, time_ms, card) -> None:
    """Phase 9: the launch groups of every CLI input against one launch a
    bucket: each group launch == its plain version, the grouped rows ==
    the singleton rows == the oracle (sampled on the large inputs), both
    schedules timed (planned, singletons, singletons, planned) and the
    planned one at most RULE_SLACK slower; then, at input3-class, the one
    batched epilogue and copy against one a bucket."""
    from mpi_openmp_cuda_tpu_torch.io.parse import load_problem
    from mpi_openmp_cuda_tpu_torch.ops.dispatch import BucketedPending, bucket_launches
    from mpi_openmp_cuda_tpu_torch.ops.dispatch import run_launch

    dev = torch.device("cuda")
    for tag, path in inputs.items():
        prob = load_problem(str(path))
        s1, seqs, w = prob.seq1_codes, prob.seq2_codes, prob.weights
        planned = bucket_launches(s1, seqs, w, dev)
        single = bucket_launches(s1, seqs, w, dev, fuse=False)
        for b in planned:
            if b.l2s is None and len(b.keys) > 1:
                compare("fused_scorer", cs.fused_scorer(b.state), cs.fused_scorer_plain(b.state))
        got = scatter_rows(np, planned, len(seqs))
        if not np.array_equal(got, scatter_rows(np, single, len(seqs))):
            fail(f"launch groups of {tag} differ from one launch a bucket")
        step = 1 if len(seqs) <= 32 else max(1, len(seqs) // 8)
        for i in range(0, len(seqs), step):
            if tuple(int(x) for x in got[i]) != prefix_best(s1, seqs[i], w):
                fail(f"launch groups of {tag}, row {i}: {tuple(got[i])} != oracle")
        shape = [b.keys for b in planned]
        if shape == [b.keys for b in single]:
            log(f"groups {tag}: {len(single)} launches, no group of two buckets "
                f"planned; rows == oracle")
            continue

        def run(launches):
            def go():
                for b in launches:
                    run_launch(b, "cuda")
            return go

        p0, s0, s1_, p1 = (time_ms(run(ls), reps=30) for ls in (planned, single, single,
                                                                    planned))
        p_ms, s_ms = (p0 + p1) / 2, (s0 + s1_) / 2
        verdict = (f"groups {tag}: {len(single)} launches -> {len(planned)} "
                   f"{shape}; planned {p_ms:.6f} ms, singletons {s_ms:.6f} ms "
                   f"({100 * (p_ms - s_ms) / s_ms:+.2f} %) [{card}]")
        log(verdict)
        if p_ms > (1 + RULE_SLACK) * s_ms:
            fail(f"the planned launch groups are slower: {verdict}")

    # One epilogue and one copy for the batch against one a bucket.
    prob = load_problem(str(inputs["input3-class"]))
    n = len(prob.seq2_codes)
    for name, fuse in (("planned", True), ("singletons", False)):
        launches = bucket_launches(prob.seq1_codes, prob.seq2_codes, prob.weights, dev,
                                   fuse=fuse)
        parts = [(b.idx, run_launch(b, "cuda"), b.state.lens) for b in launches]
        len1 = launches[0].state.len1
        pins = [torch.empty((b.idx.size, 3), dtype=torch.int32, pin_memory=True)
                for b in launches]

        def per_bucket():
            for (_, raw, lens), pin in zip(parts, pins):
                pin.copy_(cs.finish_rows(raw, lens, len1), non_blocking=True)

        def batched():
            BucketedPending(parts, n, len1, finish=True)._start_copy()

        a0, b0, b1, a1 = (time_ms(fn, reps=30) for fn in (per_bucket, batched, batched,
                                                            per_bucket))
        log(f"epilogue input3-class, {name} ({len(launches)} launches): one a bucket "
            f"{(a0 + a1) / 2:.6f} ms, one batched {(b0 + b1) / 2:.6f} ms [{card}]")


# max |v| 4093: above TF32's 11 significant bits, inside the fp32 window at
# L2P 2048 (2 * 2048 * 4093 < 2^24).
TF32_WEIGHTS = [4093, 2047, 1021, 3001]


def backends_phase(np, torch, max_size, prefix_best, time_ms, card) -> None:
    """Phase 10: the mm and gather backends on the card against the fused
    kernel and the oracle on max-size (every row against the kernel, every
    eighth against the oracle) and every seam row against the oracle, at
    the weights 10 2 3 4, max|v| 127, 128 and 3000 and at a table TF32
    would round (shown to round under TF32, so exact results prove IEEE
    fp32 in force); then both timed on max-size."""
    from mpi_openmp_cuda_tpu_torch.ops import matmul_scorer
    from mpi_openmp_cuda_tpu_torch.ops.dispatch import (
        bucket_launches, effective_backend, run_launch)
    from mpi_openmp_cuda_tpu_torch.ops.values import value_table

    dev = torch.device("cuda")
    seq1, seqs = max_size
    # The mm path's two products on max-size's Seq1 and a 2048-char row at
    # the TF32_WEIGHTS table: under TF32 they round, under ieee_fp32 they
    # equal the exact value matrix val[s2[i], s1[j]].
    val = torch.from_numpy(value_table(TF32_WEIGHTS)).to(dev)
    s1t = torch.from_numpy(seq1.astype(np.int64)).to(dev)
    s2t = torch.from_numpy(np.resize(seqs[0], 2048).astype(np.int64)).to(dev)
    exact = val[s2t][:, s1t].float()
    eye = torch.eye(27, device=dev)

    def products():
        a_right = torch.matmul(val.float(), eye[s1t].T)
        return torch.matmul(eye[s2t], a_right)

    mm = torch.backends.cuda.matmul
    new_api = hasattr(mm, "fp32_precision")
    prev = mm.fp32_precision if new_api else mm.allow_tf32
    try:
        if new_api:
            mm.fp32_precision = "tf32"
        else:
            mm.allow_tf32 = True
        tf32 = products()
    finally:
        if new_api:
            mm.fp32_precision = prev
        else:
            mm.allow_tf32 = prev
    with matmul_scorer.ieee_fp32():
        ieee = products()
    torch.cuda.synchronize()
    rounded = int((tf32 != exact).sum())
    if not torch.equal(ieee, exact) or rounded == 0:
        fail(f"TF32 check: IEEE products exact {torch.equal(ieee, exact)}, TF32 "
             f"rounded {rounded} of {exact.numel()} (want exact and > 0)")
    log(f"TF32 rounds {rounded} of the {exact.numel()} values of the mm path's "
        f"value matrix at weights {TF32_WEIGHTS}; under matmul_scorer.ieee_fp32 "
        "every value is exact")
    for weights in [WEIGHTS, *REGIME_WEIGHTS, TF32_WEIGHTS]:
        ref = scatter_rows(np, bucket_launches(seq1, seqs, weights, dev), len(seqs))
        for i in range(0, len(seqs), 8):
            if tuple(int(x) for x in ref[i]) != prefix_best(seq1, seqs[i], weights):
                fail(f"fused_scorer on max-size, weights {weights}, row {i} != oracle")
        for backend in ("mm", "gather"):
            launches = bucket_launches(seq1, seqs, weights, dev, backend=backend)
            got = scatter_rows(np, launches, len(seqs), backend)
            if not np.array_equal(got, ref):
                fail(f"{backend} on max-size, weights {weights}: differs from fused_scorer")
            routes = sorted({effective_backend(backend, b.maxv, b.state.rows.shape[1])
                             for b in launches})
            log(f"{backend} max-size, weights {weights}: {len(launches)} launches "
                f"(formulations {routes}) == fused_scorer (8 rows of it == oracle)")
    for tag, s1, sq, _, _ in seam_problems(np):
        for weights in REGIME_WEIGHTS:
            want = [prefix_best(s1, q, weights) for q in sq]
            for backend in ("mm", "gather"):
                got = scatter_rows(np, bucket_launches(s1, sq, weights, dev,
                                                       backend=backend), len(sq), backend)
                if [tuple(int(x) for x in r) for r in got] != want:
                    fail(f"{backend} on seam input {tag!r}, weights {weights} != oracle")
        log(f"mm, gather: seams {tag!r} == oracle at max|v| 127, 128, 3000")
    for backend in ("mm", "gather"):
        launches = bucket_launches(seq1, seqs, WEIGHTS, dev, backend=backend)
        ms = time_ms(lambda: [run_launch(b, backend) for b in launches], reps=3)
        log(f"{backend} max-size: {len(launches)} launches {ms:.6f} ms (plain path) [{card}]")


def robustness_phase(torch, cli, cs, compare, fixtures, inputs) -> dict[str, int]:
    """Phase 11: the robustness path through ``io.cli.run`` on cuda.  First
    every launch of the path is rebuilt, as its dispatch plans it, at its
    own shapes (the --stream chunks of 2 and 3 rows, with their one-row
    leftovers, and the journal's chunks) and held kernel == plain; then
    the launch counts are set to 0 and the CLI runs: --stream with
    --journal on every fixture, retries that absorb injected faults,
    --degrade down to mm and to gather, a drain (75) and its --resume, and
    an injected hang that the deadline turns into a retry; every output
    == the fixture's .out (or the oracle's).  Returns the path's launch
    counts."""
    from mpi_openmp_cuda_tpu_torch.io.parse import load_problem
    from mpi_openmp_cuda_tpu_torch.ops.dispatch import bucket_launches
    from mpi_openmp_cuda_tpu_torch.utils.journal import DEFAULT_CHUNK

    dev = torch.device("cuda")
    big = inputs["max-size"]
    tiny = next(f for f in fixtures if f.stem == "stress_small")
    chunkings = [(f, 2) for f in fixtures] + [(tiny, 3), (big, DEFAULT_CHUNK)]
    held = {"fused_scorer": 0, "packed_scorer": 0}
    for path, size in chunkings:
        prob = load_problem(str(path))
        s1, seqs, w = prob.seq1_codes, prob.seq2_codes, prob.weights
        for start in range(0, len(seqs), size):
            for b in bucket_launches(s1, seqs[start:start + size], w, dev):
                if b.l2s is None:
                    name, got, want = ("fused_scorer", cs.fused_scorer(b.state),
                                       cs.fused_scorer_plain(b.state))
                else:
                    name, got, want = ("packed_scorer", cs.packed_scorer(b.state, b.l2s),
                                       cs.packed_scorer_plain(b.state, b.l2s))
                compare(name, got, want)
                held[name] += 1
    log(f"robustness path launches rebuilt chunk by chunk == plain: {held} "
        f"({len(chunkings)} inputs, --stream chunks of 2 and 3, journal chunks "
        f"of {DEFAULT_CHUNK})")
    os.environ["SEQALIGN_BACKOFF_BASE"] = "0"
    jdir = tempfile.TemporaryDirectory()
    torch.cuda.synchronize()
    cs.reset_launch_counts()

    def expect(tag, argv, path, want_err=(), rc_want=0, want_out=True):
        err = []
        rc, out, _ = run_cli(cli, argv, err)
        gold = Path(path).with_suffix(".out")
        if rc != rc_want or (want_out and out != gold.read_bytes()) or (
                not want_out and out):
            fail(f"robustness {tag}: rc {rc} (want {rc_want}), stdout "
                 f"{'differs' if out else 'empty'}; stderr: {err[0][-800:]}")
        missing = [w for w in want_err if w not in err[0]]
        if missing:
            fail(f"robustness {tag}: stderr lacks {missing}: {err[0][-800:]}")
        log(f"robustness {tag}: rc {rc}" + (", stdout == .out" if want_out else ""))

    for f in fixtures:
        j = os.path.join(jdir.name, f"{f.stem}.jsonl")
        expect(f"--stream 2 --journal {f.name}",
               ["--input", str(f), "--stream", "2", "--journal", j], f)
    expect("--retries 2, chunk_scoring:fail=2 (max-size)",
           ["--input", str(big), "--retries", "2", "--faults", "chunk_scoring:fail=2"],
           big, ["retrying"])
    expect("--stream 3 --retries 2, chunk_dispatch:fail=1;chunk_scoring:fail=1",
           ["--input", str(tiny), "--stream", "3", "--retries", "2",
            "--faults", "chunk_dispatch:fail=1;chunk_scoring:fail=1"], tiny)
    expect("--degrade to mm (max-size)",
           ["--input", str(big), "--retries", "1", "--degrade",
            "--faults", "chunk_scoring:fail=2"], big, ["degrading to 'mm'"])
    expect("--degrade to gather (max-size)",
           ["--input", str(big), "--retries", "1", "--degrade",
            "--faults", "chunk_scoring:fail=4"], big, ["degrading to 'gather'"])
    j = os.path.join(jdir.name, "drain.jsonl")
    os.environ["SEQALIGN_DRAIN"] = "1"
    try:
        expect("SEQALIGN_DRAIN=1 --journal (max-size)",
               ["--input", str(big), "--journal", j], big, ["drained"], rc_want=75,
               want_out=False)
    finally:
        del os.environ["SEQALIGN_DRAIN"]
    expect("--journal --resume after the drain (max-size)",
           ["--input", str(big), "--journal", j, "--resume"], big)
    expect("--deadline 0.5 --retries 2, hang:dispatch:fail=1",
           ["--input", str(tiny), "--deadline", "0.5", "--retries", "2",
            "--faults", "hang:dispatch:fail=1"], tiny, ["watchdog deadline"])
    counts = dict(cs.launch_counts)
    log(f"robustness path launch counts: {counts}")
    if counts["fused_scorer"] < 1 or counts["packed_scorer"] < 1:
        fail(f"the robustness path never launched a scorer kernel: {counts}")
    jdir.cleanup()
    del os.environ["SEQALIGN_BACKOFF_BASE"]
    return counts


def rows_text(rows) -> str:
    return "".join(f"#{i}: score: {s}, n: {n}, k: {k}\n" for i, (s, n, k) in enumerate(rows))


def gather_route_phase(np, torch, cli, cs, max_size, prefix_best) -> dict[str, int]:
    """Phase 12: launches past the kernels' int32 window run the gather
    formulation on the card, and the admission gate still refuses past
    ``len2 * max|v| < 2^31``.  Returns the phase's launch counts (all
    from cases C and D; the max-size run must add none)."""
    from mpi_openmp_cuda_tpu_torch.io.parse import load_problem
    from mpi_openmp_cuda_tpu_torch.ops import bounds
    from mpi_openmp_cuda_tpu_torch.ops.dispatch import (
        AlignmentScorer, bucket_launches, effective_backend)

    dev = torch.device("cuda")
    tmp = tempfile.TemporaryDirectory()
    torch.cuda.synchronize()
    cs.reset_launch_counts()
    for case, (text, want) in GATE_CASES.items():
        path = Path(tmp.name) / f"case{case}.txt"
        path.write_text(text)
        prob = load_problem(str(path))
        oracle = [prefix_best(prob.seq1_codes, q, prob.weights) for q in prob.seq2_codes]
        err = []
        rc, out, _ = run_cli(cli, ["--input", str(path)], err)
        if rc != 0 or out.decode() != rows_text(want) or oracle != want:
            fail(f"gate case {case}: rc {rc}, stdout {out.decode()!r} (want the JAX "
                 f"rows {want}, oracle {oracle}); stderr {err[0][-400:]}")
        log(f"gate case {case}: rows == the JAX package's == oracle, launches so far "
            f"{dict(cs.launch_counts)}")
    counts = dict(cs.launch_counts)

    seq1, seqs = max_size
    scored = max(int(q.size) for q in seqs if 0 < q.size <= seq1.size)
    m = GATHER_WEIGHTS[0]
    if not scored * m < 2**31 <= 2 * scored * m:
        fail(f"max-size at {GATHER_WEIGHTS}: L*M {scored * m} is not in [2^31/2, 2^31)")
    launches = bucket_launches(seq1, seqs, GATHER_WEIGHTS, dev)
    routes = {effective_backend("cuda", b.maxv, b.state.rows.shape[1], b.max_scored)
              for b in launches}
    if routes != {"gather"}:
        fail(f"max-size at {GATHER_WEIGHTS}: launches route to {routes}, want gather")
    path = Path(tmp.name) / "max-size-gather.txt"
    path.write_text(as_text(np, seq1, seqs, GATHER_WEIGHTS))
    before = dict(cs.launch_counts)
    rc, out, wall = run_cli(cli, ["--input", str(path)])
    delta = {k: cs.launch_counts[k] - before[k] for k in before}
    want = rows_text(prefix_best(seq1, q, GATHER_WEIGHTS) for q in seqs)
    if rc != 0 or out.decode() != want:
        fail(f"max-size at {GATHER_WEIGHTS}: rc {rc}, stdout differs from the oracle")
    if any(delta.values()):
        fail(f"max-size at {GATHER_WEIGHTS} launched kernels {delta}; want gather only")
    log(f"max-size at {GATHER_WEIGHTS} (L {scored}, L*M {scored * m} < 2^31 <= 2*L*M): "
        f"{len(launches)} launches, all gather, kernel launch delta {delta}, "
        f"{len(seqs)} rows == oracle, wall {wall * 1e3:.3f} ms")

    past = [bounds.max_admitted_value(scored) + 1, 1, 1, 1]
    try:
        AlignmentScorer().score_codes(seq1, seqs, past)
    except ValueError as e:
        if "2^31" not in str(e):
            fail(f"past the gate: {e}")
    else:
        fail(f"max-size at {past} was admitted past L*M < 2^31")
    path.write_text(as_text(np, seq1, seqs, past))
    err = []
    rc, out, _ = run_cli(cli, ["--input", str(path)], err)
    if rc != 65 or out or "2^31" not in err[0]:
        fail(f"CLI past the gate: rc {rc}, stdout {len(out)} bytes, stderr {err[0][-300:]}")
    log(f"max-size at {past}: the scorer raises and the CLI exits 65 naming 2^31")
    tmp.cleanup()
    return counts


def obs_phase(torch, cli, cs, fixtures, inputs, kernel_ms, n_launches, card) -> dict[str, int]:
    """Phase 13: the CLI on cuda with the obs plane armed.  Returns the
    launch counts of its runs over max-size and the fixtures."""
    from mpi_openmp_cuda_tpu_torch.obs.metrics import validate_report

    tmp = tempfile.TemporaryDirectory()
    os.environ["SEQALIGN_CACHE_DIR"] = tmp.name  # flight-recorder dumps
    os.environ["SEQALIGN_BACKOFF_BASE"] = "0"
    names = tuple(cs.launch_counts)
    torch.cuda.synchronize()
    cs.reset_launch_counts()
    report, trace = Path(tmp.name) / "run.json", Path(tmp.name) / "trace.json"
    for tag in [f.name for f in fixtures] + ["max-size"]:
        path = inputs[tag]
        before = dict(cs.launch_counts)
        err = []
        rc, out, wall = run_cli(cli, ["--input", str(path), "--metrics-out", str(report),
                                      "--trace-out", str(trace), "--profile",
                                      "--heartbeat", "0.01"], err)
        delta = {k: cs.launch_counts[k] - before[k] for k in names}
        if rc != 0 or out != path.with_suffix(".out").read_bytes():
            fail(f"obs {tag}: rc {rc}, stdout differs from its golden: {err[0][-400:]}")
        rec, tr = json.loads(report.read_text()), json.loads(trace.read_text())
        validate_report(rec)
        validate_report(tr)
        got = {k: rec["counters"].get(f"{k}_launches", 0) for k in names}
        if got != delta:
            fail(f"obs {tag}: report launch counters {got} != launch-count deltas {delta}")
        gather_ms = rec["spans"]["totals"].get("score.chunk_gather", 0.0) * 1e3
        if gather_ms < kernel_ms[tag]:
            fail(f"obs {tag}: chunk_gather {gather_ms:.6f} ms < the launches' device "
                 f"time {kernel_ms[tag]:.6f} ms: the span did not wait for the device")
        rows = tr["gap_attribution"]["launches"]
        dispatch = [e for e in tr["traceEvents"] if e["name"] == "dispatch"]
        if len(dispatch) != len(rows) or len(rows) != n_launches[tag] or any(
                r["modelled_s"] <= 0 for r in rows):
            fail(f"obs {tag}: {len(dispatch)} dispatch rows, {len(rows)} gap rows, want "
                 f"{n_launches[tag]} with a modelled wall > 0: {rows}")
        if "[profile]" not in err[0]:
            fail(f"obs {tag}: no [profile] report on stderr")
        log(f"obs {tag}: stdout == golden, report + trace valid, launches {delta} == "
            f"report, chunk_gather {gather_ms:.6f} ms >= device {kernel_ms[tag]:.6f} ms, "
            f"{len(rows)} dispatch rows, modelled "
            f"{[round(r['modelled_s'] * 1e3, 6) for r in rows]} ms, measured "
            f"{[round(r['measured_s'] * 1e3, 6) for r in rows]} ms, heartbeat lines "
            f"{err[0].count('[obs] ')}, wall {wall * 1e3:.3f} ms [{card}]")
    counts = dict(cs.launch_counts)

    big = str(inputs["max-size"])
    prof_dir = Path(tmp.name) / "prof"
    # --trace as a user runs it, in a process of its own.
    proc = subprocess.run(
        [sys.executable, "-m", PKG, "--input", big, "--trace", str(prof_dir)],
        cwd=REPO, capture_output=True, timeout=300,
    )
    traces = list(prof_dir.glob("trace-*.json"))
    if proc.returncode != 0 or len(traces) != 1 or (
            proc.stdout != inputs["max-size"].with_suffix(".out").read_bytes()):
        fail(f"--trace: rc {proc.returncode}, {len(traces)} trace files in {prof_dir}, "
             f"stderr {proc.stderr.decode()[-400:]}")
    kernels = {e.get("name", "") for e in json.loads(traces[0].read_text())["traceEvents"]
               if e.get("cat") == "kernel"}
    fused = [k for k in kernels if "fused::" in k]
    if not any("tile_kernel" in k for k in fused) or not any(
            "finish_kernel" in k for k in fused):
        fail(f"--trace: the torch.profiler trace names no fused tile and finish kernels: "
             f"{sorted(kernels)}")
    log(f"--trace max-size: torch.profiler trace names {sorted(k[:60] for k in fused)}")

    err = []
    rc, out, _ = run_cli(cli, ["--input", big, "--faults", "chunk_scoring:fail=1",
                               "--retries", "2", "--metrics-out", str(report)], err)
    c = json.loads(report.read_text())
    if rc != 0 or out != inputs["max-size"].with_suffix(".out").read_bytes() or (
            c["exit_code"], c["counters"].get("faults_injected"),
            c["counters"].get("retry_attempts")) != (0, 1, 1):
        fail(f"obs faults run: rc {rc}, report {c['exit_code']} {c['counters']}")
    log(f"obs --faults chunk_scoring:fail=1 --retries 2: exit 0, counters {c['counters']}")
    os.environ["SEQALIGN_DRAIN"] = "1"
    try:
        rc, out, _ = run_cli(cli, ["--input", big, "--journal",
                                   str(Path(tmp.name) / "drain.jsonl"),
                                   "--metrics-out", str(report)], [])
    finally:
        del os.environ["SEQALIGN_DRAIN"]
    c = json.loads(report.read_text())
    dispatched = c["counters"].get("chunks_dispatched", 0) + sum(
        c["counters"].get(f"{k}_launches", 0) for k in names)
    if rc != 75 or out or c["exit_code"] != 75 or dispatched:
        fail(f"obs drain run: rc {rc}, report {c['exit_code']} {c['counters']}")
    log(f"obs SEQALIGN_DRAIN=1 --journal: exit 75, report exit_code 75, counters "
        f"{c['counters']}")

    # The warm max-size CLI wall with the plane off and on, interleaved.
    walls = {"off": [], "on": []}
    totals = []
    for _ in range(5):
        walls["off"].append(run_cli(cli, ["--input", big])[2])
        walls["on"].append(run_cli(cli, ["--input", big, "--metrics-out", str(report)])[2])
        totals.append(json.loads(report.read_text())["spans"]["totals"])
    best = min(range(5), key=walls["on"].__getitem__)
    for key, ws in walls.items():
        log(f"obs max-size warm CLI wall, plane {key}: min {min(ws) * 1e3:.3f} ms of "
            f"{[round(w * 1e3, 3) for w in ws]} [{card}]")
    log(f"obs max-size span totals of the fastest armed run: "
        f"{ {p: round(totals[best].get(p, 0.0) * 1e3, 3) for p in SPAN_PATHS} } ms [{card}]")
    del os.environ["SEQALIGN_CACHE_DIR"], os.environ["SEQALIGN_BACKOFF_BASE"]
    tmp.cleanup()
    return counts


def ring_problems(np) -> dict:
    """The Seq1 ring's own inputs beyond the fixtures and max-size, as the
    JAX package's ring tests make them: the mostly-dead-shards case (Seq1
    205 over seq:8: Bs 128, shards 2-7 hold no valid offset), Seq1 6144
    with 4 Seq2 of 100-2500 and Seq1 12288 with Seq2 of 300, 3500 and
    12280 (past both of the reference's caps; L2P 12288)."""
    rng = np.random.default_rng(0)
    seq1 = rng.integers(1, 4, size=205).astype(np.int8)
    dead = [rng.integers(1, 4, size=int(n)).astype(np.int8)
            for n in rng.integers(1, 160, size=6)]
    dead += [seq1.copy(), rng.integers(1, 4, size=240).astype(np.int8)]
    rng = np.random.default_rng(1)
    s6 = rng.integers(1, 27, size=6144).astype(np.int8)
    q6 = [rng.integers(1, 27, size=int(n)).astype(np.int8)
          for n in rng.integers(100, 2500, size=4)]
    rng = np.random.default_rng(2)
    s12 = rng.integers(1, 27, size=12288).astype(np.int8)
    q12 = [rng.integers(1, 27, size=n).astype(np.int8) for n in (300, 3500, 12280)]
    return {"mostly-dead shards": (seq1, dead, [2, 1, 1, 1]),
            "Seq1 6144": (s6, q6, WEIGHTS), "Seq1 12288": (s12, q12, WEIGHTS)}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_job(argv, stdin_path, nproc=2, timeout=120) -> list:
    """One ``--distributed`` job of ``nproc`` processes of the CLI on this
    host (torchrun's variables set by hand), rank 0 reading
    ``stdin_path``; returns the started processes."""
    port = free_port()
    procs = []
    for rank in range(nproc):
        env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
               "WORLD_SIZE": str(nproc), "RANK": str(rank), "LOCAL_RANK": str(rank),
               "LOCAL_WORLD_SIZE": str(nproc)}
        with open(stdin_path if rank == 0 else os.devnull, "rb") as stdin:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", PKG, "--distributed", *argv], stdin=stdin,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, cwd=REPO))
    return procs


def finish_job(procs, timeout=120) -> list[tuple[int, bytes, bytes]]:
    """``(exit code, stdout, stderr)`` of each process of a job; a process
    still running after ``timeout`` seconds is killed and fails."""
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        fail(f"a --distributed job did not finish in {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def mesh_phase(np, torch, cli, cs, compare, fixtures, inputs, prefix_best, time_ms,
               card) -> dict[str, dict[str, int]]:
    """Phase 14: several devices.  Returns the launch counts of its paths."""
    from mpi_openmp_cuda_tpu_torch.io.parse import load_problem
    from mpi_openmp_cuda_tpu_torch.ops import dispatch
    from mpi_openmp_cuda_tpu_torch.ops.costs import bound_ms
    from mpi_openmp_cuda_tpu_torch.ops.dispatch import AlignmentScorer, bucket_launches
    from mpi_openmp_cuda_tpu_torch.parallel import ring as ring_mod
    from mpi_openmp_cuda_tpu_torch.parallel.ring import RingSharding, ring_plan
    from mpi_openmp_cuda_tpu_torch.parallel.sharding import BatchSharding

    dev0 = torch.device("cuda:0")
    tmp = tempfile.TemporaryDirectory()
    probs = {}
    for f in fixtures:
        p = load_problem(str(f))
        probs[f.name] = (p.seq1_codes, p.seq2_codes, p.weights)
    p = load_problem(str(inputs["max-size"]))
    probs["max-size"] = (p.seq1_codes, p.seq2_codes, p.weights)
    ring_only = ring_problems(np)

    def want_rows(tag, s1, seqs, w):
        if tag in inputs:
            gold = inputs[tag].with_suffix(".out").read_text()
        else:
            gold = rows_text(prefix_best(s1, q, w) for q in seqs)
        return gold

    # Every fused launch of the phase's paths, held against the plain
    # version on a window_state rebuilt from its operands' bytes.
    seen = []
    real = cs.fused_scorer

    def checked(state):
        raw = real(state)
        ws = cs.window_state(state.seq1ext.cpu().numpy(), state.len1,
                             state.rows.cpu().numpy(), state.lens.cpu().numpy(),
                             state.val.cpu().numpy().reshape(-1), state.rows.device)
        compare("fused_scorer", raw, cs.fused_scorer_plain(ws))
        seen.append(state)
        return raw

    def spy(on: bool):
        dispatch.fused_scorer = ring_mod.fused_scorer = checked if on else real

    single = AlignmentScorer("cuda", device=dev0)
    single_rows = {tag: single.score_codes(*args) for tag, args in probs.items()}

    # -- 1. batch sharding over [cuda:0] x 4 ----------------------------------
    b4 = BatchSharding.over_devices(devices=[dev0] * 4)
    sc4 = AlignmentScorer("cuda", device=dev0, sharding=b4)
    torch.cuda.synchronize()
    cs.reset_launch_counts()
    spy(True)
    try:
        want_launches = 0
        batch_states = {}
        for tag, (s1, seqs, w) in probs.items():
            if not seqs:
                continue
            b4.comm.reset_counts()
            first = len(seen)
            pend = sc4.score_codes_async(s1, seqs, w)
            if b4.comm.counts:
                fail(f"batch mesh {tag}: collectives inside the compute: {dict(b4.comm.counts)}")
            rows = pend.result()
            batch_states[tag] = seen[first:]
            parts = len(pend.parts)
            want_launches += 4 * parts
            if dict(b4.comm.counts) != {"gather": parts}:
                fail(f"batch mesh {tag}: collectives {dict(b4.comm.counts)}, want "
                     f"{parts} gathers and nothing else")
            if rows_text(rows) != want_rows(tag, s1, seqs, w) or not np.array_equal(
                    rows, single_rows[tag]):
                fail(f"batch mesh {tag}: rows differ from the single-device rows or the golden")
            log(f"batch mesh [cuda:0]x4 {tag}: {len(seqs)} rows == single device == "
                f"golden, {parts} buckets x 4 shard launches == plain, collectives "
                f"{dict(b4.comm.counts)} (none in the compute)")
    finally:
        spy(False)
    batch_counts = dict(cs.launch_counts)
    if batch_counts["fused_scorer"] != want_launches or batch_counts["packed_scorer"]:
        fail(f"batch mesh launch counts {batch_counts}, want {want_launches} fused")
    seen.clear()
    for f in fixtures:
        rc, out, _ = run_cli(cli, ["--input", str(f), "--mesh", "1"])
        if rc != 0 or out != f.with_suffix(".out").read_bytes():
            fail(f"cli --mesh 1 {f.name}: rc {rc}, stdout differs from the golden")
    n = torch.cuda.device_count()
    err = []
    rc, out, _ = run_cli(cli, ["--input", str(fixtures[0]), "--mesh", str(n + 1)], err)
    msg = f"requested {n + 1} devices but only {n} available"
    if rc != 65 or out or msg not in err[0]:
        fail(f"cli --mesh {n + 1}: rc {rc}, stderr {err[0][-300:]} (want 65, {msg!r})")
    log(f"cli --mesh 1 on {len(fixtures)} fixtures == golden; --mesh {n + 1}: 65, {msg!r}")

    # -- 2. the Seq1 ring over [cuda:0] x 8 -----------------------------------
    rings = {"seq:8": RingSharding.over_devices(seq=8, devices=[dev0] * 8),
             "2x4": RingSharding.over_devices(seq=4, batch=2, devices=[dev0] * 8)}
    ring_inputs = {**probs, **ring_only}
    torch.cuda.synchronize()
    cs.reset_launch_counts()
    spy(True)
    ring_states = {}
    try:
        for mesh, rs in rings.items():
            scr = AlignmentScorer("cuda", device=dev0, sharding=rs)
            for tag, (s1, seqs, w) in ring_inputs.items():
                if not seqs:
                    continue
                if mesh == "2x4" and tag in ring_only and tag != "mostly-dead shards":
                    continue
                rs.comm.reset_counts()
                first = len(seen)
                rows = scr.score_codes(s1, seqs, w)
                if rows_text(rows) != want_rows(tag, s1, seqs, w):
                    fail(f"ring {mesh} {tag}: rows differ from the golden/oracle")
                st = seen[first:]
                l1p = -(-s1.size // 128) * 128
                l2p = -(-max(q.size for q in seqs) // 128) * 128
                bs, r_steps = ring_plan(l1p, l2p, rs.sp, True)
                want = {"shift": r_steps * 8, "all_gather": 8, "gather": 1}
                # Each shift moves one Bs block and each all_gather the [sp,
                # bl, 4] candidates: nothing moves Seq1 whole.
                bl = -(-len(seqs) // rs.dp)
                sizes = {k: {e for kk, e in rs.comm.log if kk == k} for k in want}
                if dict(rs.comm.counts) != want or len(st) != 8 or sizes["shift"] != {bs} or (
                        sizes["all_gather"] != {rs.sp * bl * 4}):
                    fail(f"ring {mesh} {tag}: collectives {dict(rs.comm.counts)} (want {want}), "
                         f"elements {sizes}, {len(st)} window launches (want 8)")
                effs = [x.len1 for x in st]
                smem = max(cs.check_smem(x) for x in st)
                ring_states[(mesh, tag)] = st
                log(f"ring {mesh} {tag}: {len(seqs)} rows == golden/oracle; Bs {bs}, R "
                    f"{r_steps}, L2P {l2p}, 8 window launches == plain on window_state, "
                    f"len1_eff {min(effs)}..{max(effs)}, dynamic smem {smem} B a block")
    finally:
        spy(False)
    ring_counts = dict(cs.launch_counts)
    if ring_counts["fused_scorer"] != 8 * len(ring_states):
        fail(f"ring launch counts {ring_counts}, want {8 * len(ring_states)} fused")
    all_eff = [x.len1 for sts in ring_states.values() for x in sts]
    all_l2p = [x.rows.shape[1] for sts in ring_states.values() for x in sts]
    log(f"ring windows: {len(all_eff)} launches, len1_eff {min(all_eff)}..{max(all_eff)} "
        f"(Bs up to {max(x.l1p for sts in ring_states.values() for x in sts)}), L2P up to "
        f"{max(all_l2p)}, largest dynamic smem "
        f"{max(cs.check_smem(x) for sts in ring_states.values() for x in sts)} B")

    # -- 3. two processes on the one card -------------------------------------
    big = inputs["max-size"]
    small = next(f for f in fixtures if f.stem == "mixedcase")
    report = Path(tmp.name) / "rank0.json"
    jobs = {}
    for mesh in ("2", "seq:2"):
        for path in (small, big):
            extra = ["--metrics-out", str(report)] if (mesh, path) == ("2", big) else []
            jobs[(mesh, path.name)] = (launch_job(["--mesh", mesh, *extra], path), path)
    bad = Path(tmp.name) / "bad.txt"
    bad.write_text("1 2 3\n")
    t0 = time.perf_counter()
    jobs[("abort", "bad")] = (launch_job(["--mesh", "2"], bad), None)
    for key, (procs, path) in jobs.items():
        outs = finish_job(procs, timeout=60 if path is None else 120)
        (rc0, out0, err0), (rc1, out1, err1) = outs
        if path is None:
            if (rc0, rc1) != (65, 65) or out0 or out1 or b"aborting" not in err1:
                fail(f"2-process parse failure: rc {rc0}/{rc1}, stderr {err1[-300:]!r}")
            log(f"2-process parse failure on rank 0: both ranks exit 65 within "
                f"{time.perf_counter() - t0:.1f} s, rank 1 'aborting'")
            continue
        if rc0 or rc1 or out0 != path.with_suffix(".out").read_bytes() or out1:
            fail(f"2-process --mesh {key[0]} {key[1]}: rc {rc0}/{rc1}, rank 1 stdout "
                 f"{len(out1)} bytes; stderr {err0[-400:]!r} {err1[-400:]!r}")
        log(f"2-process --distributed --mesh {key[0]} {key[1]}: rank 0 stdout == golden, "
            f"rank 1 silent, both exit 0")
    rec = json.loads(report.read_text())
    dist_counts = {k: rec["counters"].get(f"{k}_launches", 0) for k in cs.launch_counts}
    if dist_counts["fused_scorer"] < 1:
        fail(f"the 2-process max-size job's rank 0 launched no fused kernel: {dist_counts}")
    log(f"2-process --mesh 2 max-size, rank 0's launches {dist_counts}, transport "
        f"{rec['gauges'].get('distributed_transport')}")

    # -- 4. times --------------------------------------------------------------
    s1, seqs, w = probs["max-size"]
    ring8 = AlignmentScorer("cuda", device=dev0, sharding=rings["seq:8"])
    walls = {}
    for name, sc in (("single", single), ("[cuda:0]x4", sc4), ("seq:8", ring8)):
        ws = []
        for _ in range(5):
            t0 = time.perf_counter()
            sc.score_codes(s1, seqs, w)
            ws.append(time.perf_counter() - t0)
        walls[name] = ws
    kern = {"single": [b.state for b in bucket_launches(s1, seqs, w, dev0)],
            "[cuda:0]x4": batch_states["max-size"],
            "seq:8": ring_states[("seq:8", "max-size")]}
    for name in walls:
        ms = sum(time_ms(lambda x=x: cs.fused_scorer(x), reps=20) for x in kern[name])
        b_ms = sum(bound_ms(x)[0] for x in kern[name])
        log(f"max-size {name}: warm wall min {min(walls[name]) * 1e3:.3f} ms of "
            f"{[round(x * 1e3, 3) for x in walls[name]]}, {len(kern[name])} launches "
            f"summing {ms:.6f} ms of device time, bound {b_ms:.6f} ms [{card}]")
    procs = launch_job(["--mesh", "2"], big)
    t0 = time.perf_counter()
    (rc0, out0, _), (rc1, _, _) = finish_job(procs)
    wall = time.perf_counter() - t0
    if rc0 or rc1 or out0 != big.with_suffix(".out").read_bytes():
        fail("2-process --mesh 2 max-size (timed): wrong exit or stdout")
    log(f"2-process --distributed --mesh 2 max-size job wall {wall:.3f} s, process "
        f"start to exit [{card}]")
    tmp.cleanup()
    return {"batch mesh": batch_counts, "ring": ring_counts, "2-process rank 0": dist_counts}


def sass_ops(lib: Path, nvcc: str) -> dict[str, dict[str, int]]:
    """{kernel symbol: {opcode: count}} from ``cuobjdump -sass`` of a built
    library (the toolkit's cuobjdump, beside nvcc)."""
    tool = Path(nvcc).with_name("cuobjdump")
    proc = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=120)
    if proc.returncode != 0:
        fail(f"cuobjdump -sass {lib.name}: exit {proc.returncode}: {proc.stderr[-500:]}")
    funcs: dict[str, dict[str, int]] = {}
    ops: dict[str, int] = {}
    for line in proc.stdout.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            ops = funcs.setdefault(head.group(1), {})
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if ins:
            ops[ins.group(1)] = ops.get(ins.group(1), 0) + 1
    return funcs


def probe_phase(torch, probe, time_ms, card) -> dict:
    """Phase 6; returns the issue_probe row of the kernels line (without
    its launches, which the bench path counts)."""
    from mpi_openmp_cuda_tpu_torch.ops import _build
    from mpi_openmp_cuda_tpu_torch.ops.costs import HBM_BYTES_PER_S, PEAK_PER_S

    dev = torch.device("cuda")
    # The chains must survive compilation: each op's SASS holds CHAINS x
    # UNROLL instructions of the op (IMAD exactly: IMAD.MOV and friends
    # are moves and shifts).
    want_op = {"fma": "FFMA", "arith": "IMAD", "lookup": "LDS"}
    funcs = sass_ops(_build._target("issue_probe"), _build._nvcc())
    for k, op in enumerate(probe.OPS):
        sym = next((f for f in funcs if f"issue_probe_kernelILi{k}E" in f), None)
        if sym is None:
            fail(f"issue_probe: no SASS for the {op} kernel in {sorted(funcs)}")
        hist = funcs[sym]
        opcode = want_op[op]
        n_op = hist.get(opcode, 0) if opcode == "IMAD" else sum(
            v for key, v in hist.items() if key.split(".")[0] == opcode)
        top = sorted(hist.items(), key=lambda kv: -kv[1])[:8]
        log(f"sass issue_probe {op}: {n_op} {opcode} (need >= "
            f"{probe.CHAINS * probe.UNROLL}); top opcodes {top}")
        if n_op < probe.CHAINS * probe.UNROLL:
            fail(f"issue_probe {op}: the compiler shortened the chains")
    row = {"name": "issue_probe", "route": "cuda",
           "source": "mpi_openmp_cuda_tpu_torch/csrc/issue_probe.cu",
           "replaces": "bench.py:389", "max_abs_err": 0.0, "ms": 0.0,
           "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": "operations",
           "library_ms": None}

    def check(op, init, iters, perm, plain_dev) -> int:
        """Kernel == plain (run on ``plain_dev``) bit for bit for ``iters``
        steps; returns the fewest ulps an fma value moved."""
        got = probe.issue_probe(op, init, iters, perm).cpu()
        want = probe.issue_probe_plain(
            op, init.to(plain_dev), iters, perm.to(plain_dev)).cpu()
        if not torch.equal(got, want):
            fail(f"issue_probe {op}, {iters} steps: {int((got != want).sum())} of "
                 f"{got.numel()} words differ from the plain version")
        return int((got.long() - init.cpu().long()).min())

    for op in probe.OPS:
        init, perm = probe.probe_operands(op, dev)
        moved = check(op, init, PROBE_CHECK_ITERS, perm, dev)
        # One block at the rate's long chain, its plain version on the CPU.
        hi = probe.long_iters(op, init.numel() // probe.CHAINS)
        one = torch.from_numpy(probe.probe_init(op, probe.THREADS)).to(dev)
        moved = min(moved, check(op, one, hi, perm, "cpu"))
        if op == "fma" and moved < PROBE_CHECK_ITERS:
            fail(f"issue_probe fma: a value moved only {moved} ulps, too few to "
                 "tell a wrong chain from the right one")
        n = init.numel() * PROBE_TIME_ITERS
        ms = time_ms(lambda: probe.issue_probe(op, init, PROBE_TIME_ITERS, perm), reps=10)
        plain_ms = time_ms(
            lambda: probe.issue_probe_plain(op, init, PROBE_TIME_ITERS, perm), reps=1)
        # Elements over the op's peak; each word read once and written once.
        b_ms = max(n / PEAK_PER_S[op], 8 * init.numel() / HBM_BYTES_PER_S) * 1e3
        row["ms"] += ms
        row["plain_ms"] += plain_ms
        row["bound_ms"] += b_ms
        rate = probe.issue_probe_gelems(op, dev)
        log(f"probe {op}: {init.numel() // probe.CHAINS} threads x {probe.CHAINS} "
            f"chains, {PROBE_CHECK_ITERS} steps == plain; one block, {hi} steps "
            f"== plain" + (f" (every value moved >= {moved} ulps)" if op == "fma" else "")
            + f"; {PROBE_TIME_ITERS} steps: kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, "
            f"bound {b_ms:.6f} ms; rate {rate / 1e9:.3f} Gelem/s = "
            f"{100 * rate / PEAK_PER_S[op]:.2f} % of the data-sheet peak "
            f"{PEAK_PER_S[op] / 1e9:.1f} [{card}]")
    return row


def ablation_phase(torch, cs, time_ms, bound_ms, launches, card):
    """Phase 7; returns (the ablate_scorer row, the ablation path's launch
    counts)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_kernel_ablate", REPO / "scripts" / "torch_kernel_ablate.py")
    abl = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(abl)
    err = abl.check_variants(launches)
    log(f"ablation: {', '.join(abl.EXACT)} == fused_scorer on the "
        f"{len(launches)} max-size launches; every variant ran")

    def fused():
        for b in launches:
            cs.fused_scorer(b.state)

    f0, b0, b1, f1 = (time_ms(fn, reps=20) for fn in (
        fused, lambda: abl.run_all(launches, "base"),
        lambda: abl.run_all(launches, "base"), fused))
    f_ms, b_ms = (f0 + f1) / 2, (b0 + b1) / 2
    log(f"ablation base {b_ms:.6f} ms vs fused_scorer {f_ms:.6f} ms "
        f"({100 * (b_ms - f_ms) / f_ms:+.2f} %) [{card}]")
    if abs(b_ms - f_ms) > ABLATE_BASE_TOL * f_ms:
        fail(f"ablation base is {b_ms:.6f} ms, fused_scorer {f_ms:.6f} ms: "
             f"more than {ABLATE_BASE_TOL:.0%} apart")
    abl.launch_counts["ablate_scorer"] = 0
    rows = abl.table(abl.time_variants(launches, abl.VARIANTS, passes=3, reps=20))
    counts = dict(abl.launch_counts)
    if counts["ablate_scorer"] < 1:
        fail("the ablation path never launched ablate_scorer")
    for r in rows:
        log(f"ablation {r['variant']:9s} {r['ms']:.6f} ms, base {r['base_ms']:.6f} ms, "
            f"stage share {100 * r['stage_share']:+.2f} % [{card}]")
    plain_ms = time_ms(lambda: [cs.fused_scorer_plain(b.state) for b in launches], reps=1)
    bounds = [bound_ms(b.state) for b in launches]
    by = {}
    for ms, kind, _ in bounds:
        by[kind] = by.get(kind, 0.0) + ms
    return {"name": "ablate_scorer", "route": "cuda",
            "source": "mpi_openmp_cuda_tpu_torch/csrc/ablate_scorer.cu",
            "replaces": "scripts/kernel_ablate.py:98",
            "launches": counts["ablate_scorer"], "max_abs_err": err,
            "ms": b_ms, "plain_ms": plain_ms,
            "bound_ms": sum(ms for ms, _, _ in bounds),
            "bound_by": max(by, key=by.get), "library_ms": None}, counts


def bench_phase(probe) -> dict[str, int]:
    """Phase 8; returns the bench path's launch counts per kernel."""
    from mpi_openmp_cuda_tpu_torch.obs.metrics import validate_report

    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(BENCH_REPS="2", BENCH_ATTEMPTS="2")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", f"{PKG}.bench"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=600,
    )
    for line in proc.stderr.splitlines():
        if line.strip():
            log(f"bench stderr: {line}")
    if proc.returncode != 0:
        fail(f"the bench exited {proc.returncode}")
    lines = [line for line in proc.stdout.splitlines() if line.strip()]
    if len(lines) != 1:
        fail(f"the bench printed {len(lines)} stdout lines, want exactly 1")
    log(f"bench record ({time.perf_counter() - t0:.1f} s): {lines[0]}")
    rec = json.loads(lines[0])
    validate_report(rec)
    want = ["device", "floor_us", "value", "kernel_launches"] + [
        f"issue_probe_{op}_gelems" for op in probe.OPS]
    missing = [k for k in want if rec.get(k) is None]
    if rec.get("kind") != "bench" or missing:
        fail(f"bench record: kind {rec.get('kind')!r}, missing {missing}")
    counts = rec["kernel_launches"]
    for name in ("fused_scorer", "issue_probe"):
        if not counts.get(name, 0) > 0:
            fail(f"the bench path never launched {name}")
    log(f"bench: {rec['launches']} launches per scoring run; launches in the "
        f"whole bench run (warm-ups, timed repeats and probes included): {counts}")
    return counts


if __name__ == "__main__":
    sys.exit(main())
