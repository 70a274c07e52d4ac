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
   probe > 0 (the bench resets its counts before its first run).

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


def run_cli(cli, argv) -> tuple[int, bytes, float]:
    """``cli.run(argv)`` in this process with fd 1 captured; returns
    (exit code, stdout bytes, wall seconds)."""
    sys.stdout.flush()
    saved = os.dup(1)
    with tempfile.TemporaryFile() as cap:
        os.dup2(cap.fileno(), 1)
        try:
            t0 = time.perf_counter()
            rc = cli.run(argv)
            wall = time.perf_counter() - t0
            sys.stdout.flush()
        finally:
            os.dup2(saved, 1)
            os.close(saved)
        cap.seek(0)
        return rc, cap.read(), wall


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
        log(f"cli {tag}: {len(seqs)} rows == oracle, wall {wall * 1e3:.3f} ms")
    for name in names:
        if counts[name] < 1:
            fail(f"the main path never launched {name}")

    # -- 5. the main path's launches: check, time, bound -----------------
    total = {name: {"n": 0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                    "by": {"bytes": 0.0, "operations": 0.0}} for name in names}
    for tag, path in inputs.items():
        prob = load_problem(str(path))
        launches = bucket_launches(prob.seq1_codes, prob.seq2_codes, prob.weights, dev)
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
    tmp.cleanup()

    # -- 6-8. the probe, the ablation and the bench path ------------------
    probe_row = probe_phase(torch, probe, time_ms, card)
    abl_row, abl_counts = ablation_phase(
        torch, cs, time_ms, bound_ms,
        bucket_launches(seq1_max, seqs_max, WEIGHTS, dev), card,
    )
    bench_counts = bench_phase(probe)
    paths = {"cli": counts, "bench": bench_counts, "ablation": abl_counts}
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
