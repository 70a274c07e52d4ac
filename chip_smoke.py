#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py            # from the root of a checkout

Phases, each fatal on failure (no phase is caught and swallowed):

1. build both kernels from ``mpi_openmp_cuda_tpu_torch/csrc/`` (one nvcc per
   source, started together) and print each one's ptxas report, then the
   card's name and power limit;
2. every launch the main path makes for the max-size workload (Seq1 3000,
   64 Seq2 of 1200..1999, seed 7; ``dispatch.bucket_launches``, the
   scorer's own bucketing, padding and kernel choice) against its plain
   PyTorch version on the card, exact equality, at the weights 10 2 3 4
   and at max |v| = 127, 128 and 3000; eight pairs against the numpy
   oracle ``prefix_best``;
3. the packed kernel against its plain version and the fused kernel at
   the input4-class packed set (Seq1 2976, 30 Seq2 of 5..64, seed 7) and
   one batch per class 8/16/32, exact equality;
4. the main path: launch counts set to 0, then the batch CLI
   (``io.cli.run``) on every ``tests/fixtures/*.txt`` (stdout byte-identical
   to its ``.out``) and on the max-size, input4-class and 1024-short-row
   inputs (checked against the oracle); both kernels must have launched;
5. each launch of that run, rebuilt by ``bucket_launches`` from the same
   parsed inputs (their count must equal the launch counts): kernel ==
   plain on the card, then kernel time (CUDA events over back-to-back
   launches), plain-version time and bound, summed per input and per
   kernel into the kernels JSON line; warm CLI walls, the device's busy
   share of a max-size CLI run and a cProfile of its host side.

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

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM 3.35 TB/s; 67 TFLOP/s
# fp32 off the tensor cores = 132 SMs x 128 fp32 lanes x 2 (fma) x
# 1.98 GHz.  An SM issues int32 on 64 lanes, and its shared memory
# (LSU/MIO pipe, beside the int pipe) serves 32 words per clock.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
SMEM_WORDS_PER_S = 132 * 32 * 1.98e9
# Per needed (offset, char) cell: about six int32 ops (t1 add, delta sub,
# G add, compare, select, loop step) and two value-table lookups.
INT_OPS_PER_CELL = 6
LOOKUPS_PER_CELL = 2
# Cycles of torch.cuda._sleep (about 10 ms) that keep the card busy while
# the host queues a timed loop, so the loop times the device, not the
# host's launch rate.
SLEEP_CYCLES = 20_000_000
WEIGHTS = [10, 2, 3, 4]
# max |v| = 127, 128 and 3000: the TPU kernel's three feed regimes.
REGIME_WEIGHTS = [[127, 2, 3, 4], [128, 2, 3, 4], [3000, 7, 1, 2]]


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def max_size_problem(np):
    """bench_table.synthetic_max: Seq1 3000, 64 Seq2 of 1200..1999, seed 7."""
    rng = np.random.default_rng(7)
    seq1 = rng.integers(1, 27, size=3000)
    lens = rng.integers(1200, 2000, size=64)
    seqs = [rng.integers(1, 27, size=int(n)) for n in lens]
    return seq1.astype(np.int8), [s.astype(np.int8) for s in seqs]


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


def short_problem(np, len1, count, lo, hi, seed):
    rng = np.random.default_rng(seed)
    s1 = rng.integers(1, 27, size=len1).astype(np.int8)
    return s1, [
        rng.integers(1, 27, size=int(n)).astype(np.int8)
        for n in rng.integers(lo, hi + 1, size=count)
    ]


def as_text(np, seq1, seqs, weights) -> str:
    def dec(c):
        return bytes((np.asarray(c) + 64).astype(np.uint8)).decode()

    return "\n".join(
        [" ".join(map(str, weights)), dec(seq1), str(len(seqs))]
        + [dec(s) for s in seqs]
    ) + "\n"


def needed_cells(len1, lens) -> int:
    """(offset, char) cells the data needs: valid offsets x chars."""
    return sum(max(len1 - int(n), 0) * int(n) for n in lens if 0 < int(n) < len1)


def bound_ms(state) -> tuple[float, str, str]:
    """(least time in ms, "bytes" or "operations", the binding term): the
    larger of the bytes (each input read once, the [B, 4] output written
    once) over HBM, the int32 ops over the int issue rate and the table
    lookups over the shared-memory rate, for the cells this data needs."""
    nbytes = 4 * (
        state.seq1ext.numel() + state.rows.numel() + state.lens.numel()
        + state.val.numel() + 4 * state.rows.shape[0]
    )
    cells = needed_cells(state.len1, state.lens.tolist())
    terms = {
        "hbm bytes": nbytes / HBM_BYTES_PER_S,
        "int32 issue": INT_OPS_PER_CELL * cells / INT32_OPS_PER_S,
        "smem lookups": LOOKUPS_PER_CELL * cells / SMEM_WORDS_PER_S,
    }
    term = max(terms, key=terms.get)
    return terms[term] * 1e3, "bytes" if term == "hbm bytes" else "operations", term


def time_ms(torch, fn, reps: int) -> float:
    """Device ms per call of ``fn``: one warm call, then ``reps`` calls
    queued behind a sleeping kernel and timed by CUDA events, so the calls
    run back to back on the card whatever the host's launch rate."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card_line() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi exit {smi.returncode}: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


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
    from mpi_openmp_cuda_tpu_torch.io import cli
    from mpi_openmp_cuda_tpu_torch.io.parse import load_problem
    from mpi_openmp_cuda_tpu_torch.ops import _build
    from mpi_openmp_cuda_tpu_torch.ops import cuda_scorer as cs
    from mpi_openmp_cuda_tpu_torch.ops.dispatch import bucket_launches, pad_problem
    from mpi_openmp_cuda_tpu_torch.ops.oracle import prefix_best
    from mpi_openmp_cuda_tpu_torch.ops.values import max_abs_value, value_table

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    names = ("fused_scorer", "packed_scorer")

    # -- 1. build + device line ------------------------------------------
    t0 = time.perf_counter()
    reports = _build.build(list(names))
    log(f"build: both kernels in {time.perf_counter() - t0:.1f} s")
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
    seq1_max, seqs_max = max_size_problem(np)
    for weights in [WEIGHTS, *REGIME_WEIGHTS]:
        launches = bucket_launches(seq1_max, seqs_max, weights, dev)
        rows = scored_rows(launches, len(seqs_max))
        check_oracle(seq1_max, seqs_max, weights, rows, range(0, len(seqs_max), 8))
        log(f"max-size, weights {weights} (max|v| "
            f"{max_abs_value(value_table(weights))}): {len(launches)} launches "
            f"{[(b.idx.size, b.state.rows.shape[1], b.l2s) for b in launches]} "
            f"== plain, 8 pairs == oracle")

    # -- 3. packed kernel vs plain at every class ------------------------
    def state_of(seq1, seqs, weights):
        batch = pad_problem(seq1, seqs)
        return cs.state_from_numpy(
            batch.seq1ext, batch.len1, batch.seq2, batch.len2,
            value_table(weights).reshape(-1), dev,
        )

    seq1_4, seqs_4 = input4_problem(np)
    packed_sets = {64: (seq1_4, seqs_4)}
    for l2s, seed in ((8, 81), (16, 82), (32, 83)):
        packed_sets[l2s] = (seq1_4, short_problem(np, 2976, 30, 5, l2s, seed)[1])
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
    seq1_k, seqs_k = short_problem(np, 3000, 1024, 5, 64, 7)
    tmp = tempfile.TemporaryDirectory()
    inputs = {f.name: f for f in fixtures}
    big = {"max-size": (seq1_max, seqs_max), "input4-class": (seq1_4, seqs_4),
           "1024 short rows": (seq1_k, seqs_k)}
    for tag, (s1, seqs) in big.items():
        inputs[tag] = Path(tmp.name) / f"{tag.replace(' ', '-')}.txt"
        inputs[tag].write_text(as_text(np, s1, seqs, WEIGHTS))
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
    for tag, (s1, seqs) in big.items():
        rc, out, wall = outputs[tag]
        want = "".join(
            f"#{i}: score: {s}, n: {n}, k: {k}\n"
            for i, (s, n, k) in enumerate(prefix_best(s1, q, WEIGHTS) for q in seqs)
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
            ms = time_ms(torch, kern, reps=50)
            plain_ms = time_ms(torch, plain, reps=3)
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
    # What one launch for all buckets could gain: the max-size input padded
    # into a single fused launch (64 rows x L2P 2048), timed the same way.
    st_one = state_of(seq1_max, seqs_max, WEIGHTS)
    one_ms = time_ms(torch, lambda: cs.fused_scorer(st_one), reps=50)
    log(f"max-size as one padded fused launch: {one_ms:.6f} ms [{card}]")

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


if __name__ == "__main__":
    sys.exit(main())
