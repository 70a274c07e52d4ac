"""Benchmark harness of the port: one JSON run report on stdout.

    python -m mpi_openmp_cuda_tpu_torch.bench               # on the card
    python -m mpi_openmp_cuda_tpu_torch.bench --device cpu  # plain versions

Metric: **equivalent brute-force character comparisons per second per
chip** (:func:`brute_force_elements`, the reference algorithm's cost
model) over the device time of one scoring run of the workload, on the
card.  The workload is ``BENCH_INPUT`` (an input file) or else the
input3-class synthetic problem (``models/workload.py``); ``BENCH_WEIGHTS``
(``"w1,w2,w3,w4"``) overrides its weights, ``BENCH_BACKEND`` is ``cuda``
(default) or ``oracle``.

The record, ``wrap_report("bench", ...)``, exactly one stdout line:

* ``metric``, ``value`` (elements/s over ``device_wall_us``; null off the
  card), ``unit``;
* ``device_wall_us``: device time of one run of the batch's launches
  (``dispatch.bucket_launches``, built once: one a launch group), each
  writing its finished rows into the batch's one buffer, and the copy
  back to pinned memory,
  ``DEVICE_REPS`` runs back to back behind a
  sleeping kernel, CUDA events (``utils.timing.time_ms``); the attempt
  recorded is chosen by the GEMM-probe gate below;
* ``e2e_first_run_s``: host clock around the first ``score_codes`` call
  of the process, which includes building the kernels with ``nvcc`` when
  the build directory holds none for this source; ``e2e_warm_s``: median
  host clock around ``score_codes`` over ``BENCH_REPS`` warm runs (parse
  excluded; host-to-device copies, launches and the copy back included);
  ``cold_start_s``: process start to the first result;
* ``prewarmed``: whether ``SEQALIGN_PREWARM`` ran the warm plane
  (``aot/prewarm.py``, with the workload as its problem) before the first
  run, so that ``e2e_first_run_s`` and ``cold_start_s`` are those of a
  prewarmed process (its launches are in ``kernel_launches``);
* ``formulation``: on the card the route the run's launches took
  (:func:`launch_routes`: ``cuda``, or ``gather`` where a launch's own
  longest scored row breaks the kernels' int32 window), one name when
  every launch took the same route, else each route with its count in
  launch order (``"cuda*2+gather*1"``) beside ``routes``, the same runs
  as a list, and ``floor_launches``, the positions of the launches the
  floor and bound count; ``plain`` on the CPU; ``oracle``;
  ``launches`` (launches per run) and ``kernel_launches`` (launches per
  kernel during this bench, probes included);
* ``device`` and ``power_limit_w`` (``nvidia-smi``), or ``"cpu"``;
* ``feed_overlap``: whether the CLI stages its copies in on a side
  stream (``io/pipeline.py::feed_overlap_enabled``), a setting two
  records must share to be compared;
* on the card: ``gemm_probe_bf16_tflops`` (the lower of the two bf16
  ``torch.matmul`` probes bracketing the recorded attempt),
  ``probe_quiet_ref_tflops`` and ``probe_gated`` where the card has a
  quiet reference, ``gemm_probe_i8_tops`` (``torch._int_mm``), the
  issue-rate probe's ``issue_probe_{fma,arith,lookup}_gelems``, and the
  floor: ``floor_us`` = the largest of int ops at the measured ``arith``
  rate, lookups at the measured ``lookup`` rate and bytes at the HBM rate
  (``ops/costs.py``), with ``floor_by`` and ``wall_vs_floor``; the same
  for the whole batch padded into one fused launch (``*_single_program``,
  its own measured wall); and ``bound_us`` / ``bound_by`` /
  ``wall_vs_bound``, the same counts at the data-sheet peaks.  The floor
  and the bound count only the launches routed to a kernel, and are null
  when none is; the single-program fields are null when the padded batch
  is outside the kernels' window (``bounds.kernel_fits``), where the
  fused kernel would not be exact.

Off the card the record says ``"device": "cpu"`` and carries no probe,
floor or rate field.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
import typing

# Process-start anchor for cold_start_s.
_T0 = time.perf_counter()

import numpy as np  # noqa: E402
import torch  # noqa: E402

from .utils.env import env_int, env_str  # noqa: E402

PROG = "mpi_openmp_cuda_tpu_torch.bench"

# Quiet-card bf16 GEMM probe (TFLOP/s) per device name, the gate's
# reference: an NVIDIA H100 80GB HBM3 at a 700.00 W power limit read
# 787-792 in three runs of this bench (PERF.md); 791 is their median.
# Unknown cards record their probes but are not gated.
QUIET_BF16_BY_KIND = {"NVIDIA H100 80GB HBM3": 791.0}
# An attempt whose two bracketing probes both read at least this share of
# the quiet reference ran on a quiet card.
PROBE_GATE_FRACTION = 0.9
GEMM_N = 4096
GEMM_REPS = 50
# Timed runs of the batch per device-wall reading: their few hundred
# launches stay within the device's launch queue, so the host's launch
# rate cannot pace them.
DEVICE_REPS = 10
# Data-sheet dense tensor-core peaks (H100 SXM): a probe above 105 % of
# its peak is a broken reading.
GEMM_PEAK_TFLOPS = {"bf16": 989.0, "i8": 1979.0}


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def brute_force_elements(len1: int, lens2: list[int]) -> int:
    """Reference cost model: per pair, (L1-L2) offsets x L2 mutants x L2
    chars (equal-length pairs: L2 comparisons, one candidate)."""
    total = 0
    for l2 in lens2:
        if l2 > len1:
            continue
        if l2 == len1:
            total += l2
        else:
            total += (len1 - l2) * l2 * l2
    return total


def load_workload():
    """(problem, name): ``BENCH_INPUT`` if set, else the input3-class
    synthetic problem; ``BENCH_WEIGHTS`` overrides the weights, validated
    as the stdin contract validates them."""
    from .io.parse import _parse_header_tokens, load_problem
    from .models.workload import INPUT3_CLASS_NAME, input3_class_problem

    path = env_str("BENCH_INPUT")
    if path:
        problem, name = load_problem(path), os.path.basename(path)
    else:
        problem, name = input3_class_problem(), INPUT3_CLASS_NAME
    w = env_str("BENCH_WEIGHTS")
    if w:
        toks = w.replace(",", " ").split()
        if len(toks) != 4:
            raise ValueError(f"BENCH_WEIGHTS needs 4 weights, got {toks}")
        problem.weights, _, _ = _parse_header_tokens(toks + ["A", "0"])
        name += f"+w={','.join(str(x) for x in problem.weights)}"
    return problem, name


def pick_backend() -> str:
    backend = env_str("BENCH_BACKEND")
    if backend not in ("cuda", "oracle"):
        raise ValueError(f"BENCH_BACKEND must be cuda or oracle, got {backend!r}")
    return backend


# ---- device-health probe ----------------------------------------------------


def gemm_probe_tflops(feed: str = "bf16", device="cuda", reps: int = GEMM_REPS) -> float:
    """Achieved TFLOP/s (TOP/s for ``i8``) of ``reps`` back-to-back
    4096^3 products on the card: ``torch.matmul`` in bf16, or
    ``torch._int_mm`` int8 x int8 -> int32.  A reference point for the
    card's state independent of this package (a library product, outside
    any kernel the port writes)."""
    from .utils.timing import time_ms

    dev = torch.device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"the GEMM probe measures a CUDA device, got {dev}")
    n = GEMM_N
    gen = torch.Generator().manual_seed(0)
    if feed == "bf16":
        a = (torch.randn(n, n, generator=gen) / (2 * n**0.5)).to(dev, torch.bfloat16)
        b = (torch.randn(n, n, generator=gen) / (2 * n**0.5)).to(dev, torch.bfloat16)
        out = torch.empty(n, n, dtype=torch.bfloat16, device=dev)

        def fn():
            torch.matmul(a, b, out=out)

    elif feed == "i8":
        a = torch.randint(-4, 5, (n, n), generator=gen, dtype=torch.int8).to(dev)
        b = torch.randint(-4, 5, (n, n), generator=gen, dtype=torch.int8).to(dev).t()

        def fn():
            torch._int_mm(a, b)

    else:
        raise ValueError(f"unknown GEMM probe feed {feed!r}")
    ms = time_ms(fn, reps)
    return 2 * n**3 / (ms / 1e3) / 1e12


def probe_or_none(feed: str = "bf16") -> float | None:
    """The GEMM probe, or None when it fails or reads above 105 % of the
    data-sheet peak (a broken reading)."""
    try:
        t = gemm_probe_tflops(feed)
    except RuntimeError as e:
        log(f"WARNING: GEMM probe failed ({e})")
        return None
    if t > 1.05 * GEMM_PEAK_TFLOPS[feed]:
        log(f"WARNING: {feed} probe at {t:.0f} TFLOP/s is above the data-sheet "
            "peak, discarding")
        return None
    return t


class Attempt(typing.NamedTuple):
    """One bracketed measurement: a device wall and the bf16 probes taken
    just before and after it (None: the probe failed or did not run)."""

    wall: float
    p0: float | None
    p1: float | None

    @property
    def pmin(self) -> float | None:
        """The worse of the two bracketing probes, when both ran."""
        if self.p0 is None or self.p1 is None:
            return None
        return min(self.p0, self.p1)


def run_attempts(measure, probe, *, gate, max_attempts, sleep=time.sleep, log=None) -> list[Attempt]:
    """Repeat probe-bracketed measurements until one lands on a quiet card
    (``Attempt.pmin >= gate``), ``max_attempts`` are spent, or both
    bracketing probes fail.  ``gate`` None (a card without a quiet
    reference) takes one ungated attempt.  Exponential backoff between
    attempts (5 s doubling, capped at 60 s)."""
    attempts: list[Attempt] = []
    rounds = max_attempts if gate is not None else 1
    for att in range(rounds):
        p0 = probe() if probe is not None else None
        w = measure()
        p1 = probe() if probe is not None else None
        a = Attempt(w, p0, p1)
        attempts.append(a)
        if log is not None:
            log(att, rounds, a)
        if gate is None or (a.pmin is not None and a.pmin >= gate):
            break
        if p0 is None and p1 is None:
            break
        if att < rounds - 1:
            sleep(min(5.0 * 2.0**att, 60.0))
    return attempts


def interleaved_gated_rounds(measure, probe, *, gate, max_attempts, sleep=time.sleep,
                             log=None):
    """:func:`run_attempts` for an interleaved measurement of several
    variants (every variant measured inside one bracketed window, so
    their ratios survive a neighbour's drift): ``measure()`` returns any
    result.  Returns ``(result, Attempt, gated)`` of the attempt
    :func:`select_attempt` picks (every ``wall`` is 0: the first gated
    attempt, else the closest to quiet)."""
    results = []

    def timed():
        results.append(measure())
        return 0.0

    attempts = run_attempts(timed, probe, gate=gate, max_attempts=max_attempts,
                            sleep=sleep, log=log)
    chosen, gated = select_attempt(attempts, gate)
    return results[next(i for i, a in enumerate(attempts) if a is chosen)], chosen, gated


def select_attempt(attempts, gate) -> tuple[Attempt, bool]:
    """(the attempt to record, whether it was gated): the fastest gated
    attempt; else the attempt closest to quiet (highest bracketing-probe
    minimum); else, with no attempt fully probed, the median wall."""
    gated = [a for a in attempts if gate is not None and a.pmin is not None and a.pmin >= gate]
    if gated:
        return min(gated, key=lambda a: a.wall), True
    probed = [a for a in attempts if a.pmin is not None]
    if probed:
        return max(probed, key=lambda a: a.pmin), False
    by_wall = sorted(attempts, key=lambda a: a.wall)
    return by_wall[(len(by_wall) - 1) // 2], False


def probe_record_fields(attempt: Attempt, gated: bool, gate, quiet_ref, on_card: bool,
                        n_attempts: int) -> tuple[dict, str | None]:
    """The probe fields of the record for the chosen attempt, plus an
    optional warning line.  An ungated record says ``probe_gated: false``
    and carries no estimate of the quiet-card value."""
    rec: dict = {}
    warn = None
    if attempt.pmin is not None:
        rec["gemm_probe_bf16_tflops"] = attempt.pmin
        if quiet_ref:
            rec["probe_quiet_ref_tflops"] = quiet_ref
        if gate is not None:
            rec["probe_gated"] = bool(gated)
            if not gated:
                warn = (
                    f"WARNING: no quiet window in {n_attempts} attempts (closest "
                    f"probe {attempt.pmin:.0f} < {gate:.0f} TFLOP/s): recorded the "
                    "closest-to-quiet attempt"
                )
    elif on_card:
        rec["probe_failed"] = True
    return rec, warn


def probe_gate(device) -> tuple[bool, float | None, float | None]:
    """(on the card, quiet reference, gate) for ``device``."""
    on_card = torch.device(device).type == "cuda"
    quiet_ref = QUIET_BF16_BY_KIND.get(torch.cuda.get_device_name(device)) if on_card else None
    gate = quiet_ref * PROBE_GATE_FRACTION if quiet_ref else None
    return on_card, quiet_ref, gate


def attempt_logger(on_card: bool):
    def _log(att, rounds, a):
        probes = (f" probes {a.p0 if a.p0 is not None else float('nan'):.0f}/"
                  f"{a.p1 if a.p1 is not None else float('nan'):.0f} TFLOP/s"
                  if on_card else "")
        log(f"attempt {att + 1}/{rounds}: device wall {a.wall * 1e6:.3f} us{probes}")

    return _log


# ---- device timing and floor -----------------------------------------------


def launch_routes(launches, backend: str = "cuda") -> list[str]:
    """The formulation each launch runs on ``backend``, as
    ``dispatch.run_launch`` routes it (``dispatch.effective_backend`` on
    the launch's max |value|, width and longest scored row)."""
    from .ops.dispatch import effective_backend

    return [effective_backend(backend, b.maxv, b.state.rows.shape[1], b.max_scored)
            for b in launches]


def route_fields(routes: list[str]) -> dict:
    """``formulation``: the one route of ``routes``; when they differ,
    each run of one route with its length, in launch order
    (``"cuda*2+gather*1"``), beside ``routes`` (the same runs as
    ``[route, launches]`` pairs) and ``floor_launches`` (the positions of
    the launches routed to a kernel: those the floor and bound count)."""
    runs: list[list] = []
    for route in routes:
        if runs and runs[-1][0] == route:
            runs[-1][1] += 1
        else:
            runs.append([route, 1])
    if len({r for r, _ in runs}) <= 1:
        return {"formulation": runs[0][0] if runs else "cuda"}
    return {"formulation": "+".join(f"{r}*{n}" for r, n in runs), "routes": runs,
            "floor_launches": [i for i, r in enumerate(routes) if r == "cuda"]}


FLOOR_KEYS = ("floor_us", "floor_by", "wall_vs_floor")
BOUND_KEYS = ("bound_us", "bound_by", "wall_vs_bound")
SINGLE_PROGRAM_KEYS = ("wall_us_single_program", "floor_us_single_program",
                       "floor_by_single_program", "wall_vs_floor_single_program")


def kernel_floor_fields(launches, routes, rates: dict, wall_s: float) -> dict:
    """The floor (at the measured ``rates``) and the bound (at the
    data-sheet peaks) of the launches ``routes`` sends to a kernel, each
    with its ratio to ``wall_s``; every field null when no launch is."""
    from .ops.costs import INT32_OPS_PER_S, SMEM_WORDS_PER_S, binding, floor_terms
    from .ops.costs import schedule_counts

    kernel = [b for b, route in zip(launches, routes) if route == "cuda"]
    if not kernel:
        return dict.fromkeys(FLOOR_KEYS + BOUND_KEYS)
    counts = schedule_counts(kernel)
    sec, by = binding(floor_terms(counts, INT32_OPS_PER_S, SMEM_WORDS_PER_S))
    return {**floor_fields(counts, rates, wall_s),
            "bound_us": sec * 1e6, "bound_by": by, "wall_vs_bound": wall_s / sec}


def schedule_run(launches):
    """One run of the batch on the device as the production path makes
    it: every launch, each writing its finished rows into the batch's one
    buffer, then its one copy to pinned host memory
    (``dispatch.launch_batch``)."""
    from .ops.dispatch import launch_batch

    count = sum(b.idx.size for b in launches)
    device = launches[0].state.rows.device

    def run():
        launch_batch(launches, "cuda", count, device)._start_copy()

    return run


def single_program(problem, device):
    """The whole batch padded into one fused launch (every row at the
    widest bucket's L2P), or None when the padded batch is outside the
    kernels' window (``bounds.kernel_fits``): ``fused_scorer`` checks
    only its width and shared memory, so it is never asked there."""
    from .ops.bounds import kernel_fits
    from .ops.cuda_scorer import state_from_numpy
    from .ops.dispatch import max_scored, pad_problem
    from .ops.values import max_abs_value, value_table

    batch = pad_problem(problem.seq1_codes, problem.seq2_codes)
    val_flat = value_table(problem.weights).reshape(-1)
    if not kernel_fits(max_abs_value(val_flat), max_scored(batch)):
        return None
    return state_from_numpy(
        batch.seq1ext, batch.len1, batch.seq2, batch.len2, val_flat, device,
    )


def floor_fields(counts, rates: dict, wall_s: float, suffix: str = "") -> dict:
    """``floor_us``, ``floor_by`` and ``wall_vs_floor`` (plus ``suffix``)
    of ``counts`` at the measured ``rates`` (elements/s by probe op)."""
    from .ops.costs import binding, floor_terms

    sec, by = binding(floor_terms(counts, rates["arith"], rates["lookup"]))
    return {f"floor_us{suffix}": sec * 1e6, f"floor_by{suffix}": by,
            f"wall_vs_floor{suffix}": wall_s / sec}


def device_fields(problem, launches, routes, device) -> dict:
    """The on-card fields: the gated device wall, the probes, the floor
    and the bound (of the launches ``routes`` sends to a kernel)."""
    from .ops.costs import state_counts
    from .ops.cuda_scorer import score_rows
    from .ops.probe import OPS, issue_probe_gelems
    from .utils.timing import card_line, power_limit_w, time_ms

    on_card, quiet_ref, gate = probe_gate(device)
    run = schedule_run(launches)
    attempts = run_attempts(
        lambda: time_ms(run, DEVICE_REPS) / 1e3,
        probe_or_none,
        gate=gate,
        max_attempts=max(1, env_int("BENCH_ATTEMPTS")),
        log=attempt_logger(on_card),
    )
    chosen, gated = select_attempt(attempts, gate)
    wall = chosen.wall
    elements = brute_force_elements(
        problem.seq1_codes.size, [c.size for c in problem.seq2_codes]
    )
    card = card_line()
    rec: dict = {
        "value": elements / wall,
        "device_wall_us": wall * 1e6,
        "device": card.rsplit(",", 1)[0].strip(),
        "power_limit_w": power_limit_w(card),
    }
    fields, warn = probe_record_fields(chosen, gated, gate, quiet_ref, on_card, len(attempts))
    rec.update(fields)
    if warn:
        log(warn)
    i8 = probe_or_none("i8")
    if i8 is not None:
        rec["gemm_probe_i8_tops"] = i8
    rates = {op: issue_probe_gelems(op, device) for op in OPS}
    for op in OPS:
        rec[f"issue_probe_{op}_gelems"] = rates[op] / 1e9
    fields = kernel_floor_fields(launches, routes, rates, wall)
    rec.update({k: fields[k] for k in FLOOR_KEYS})
    st = single_program(problem, device)
    if st is None:
        rec.update(dict.fromkeys(SINGLE_PROGRAM_KEYS))
    else:
        sp_wall = time_ms(lambda: score_rows(st), DEVICE_REPS) / 1e3
        rec["wall_us_single_program"] = sp_wall * 1e6
        rec.update(floor_fields(state_counts(st), rates, sp_wall, "_single_program"))
    rec.update({k: fields[k] for k in BOUND_KEYS})
    return rec


def comms_record(problem) -> dict:
    """The comms audit's inventory totals (``analysis/collectives.py``, the
    mesh forms on ``[cpu] x N``) and the workload's modelled scaling rows,
    which wait for a four-chip cell to be measured."""
    from .analysis.collectives import inventory_totals
    from .analysis.costmodel import schedule_cost_sheet

    comms = schedule_cost_sheet(problem)["comms"] or {}
    return {**inventory_totals(), "measured": False,
            "link_gbytes_s": comms.get("link_gbytes_s"),
            "scaling": comms.get("scaling", [])}


def donation_record(problem) -> dict:
    """Eager PyTorch has no buffer donation: the staging pass's counts
    (``analysis/dataflow.py``) and the workload's large operands, each
    pinned live (``analysis/traceaudit.py``)."""
    from .analysis.dataflow import audit_dataflow
    from .analysis.traceaudit import audit_schedule

    counts = audit_dataflow()["counts"]
    don = audit_schedule(problem)["donation"]
    return {"donation_supported": False, "large_buffers": don["large_buffers"],
            "pinned_live": len(don["pinned_live"]), "restage_paths": counts["restage_paths"],
            "findings": counts["findings"]}


def ranges_record() -> dict:
    """The bounds certificate's headline numbers beside the measured ones
    (``analysis/ranges.py``: every constant of ``ops/bounds.py``
    re-derived from Hopper numerics): a drifted window shows up in the
    bench record, not only in ``scripts/torch_ranges_audit.py``.  Host
    arithmetic only."""
    from .analysis.ranges import certify

    counts = certify()["counts"]
    return {"constants_ok": counts["constants_ok"], "constants": counts["constants"],
            "findings": counts["findings"]}


def exitflow_record() -> dict:
    """The failure-path certificate's headline numbers
    (``analysis/exitflow.py``): the sink inventory, raise sites, broad
    handlers, advisory markers and findings.  Host AST walking only."""
    from .analysis.exitflow import audit_exitflow

    report = audit_exitflow()
    counts = report["counts"]
    return {
        "sinks": dict(report["sinks"]),
        "raise_sites": counts["raise_sites"],
        "production_raises": counts["production_raises"],
        "broad_handlers": counts["broad_handlers"],
        "advisory_markers": counts["advisory_markers"],
        "findings": counts["findings"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=PROG, description="Benchmark the port; "
                                 "one JSON run report on stdout.")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device to score on (default cuda; cpu only when asked for)")
    args = ap.parse_args(argv)

    from .io.pipeline import feed_overlap_enabled
    from .obs.metrics import wrap_report
    from .ops import cuda_scorer, probe
    from .ops.dispatch import AlignmentScorer, bucket_launches, resolve_device
    from .utils.env import env_flag

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"{PROG}: error: {e}", file=sys.stderr)
        return 1
    problem, workload = load_workload()
    backend = pick_backend()
    scorer = AlignmentScorer(backend, device=device)
    cuda_scorer.reset_launch_counts()
    probe.reset_launch_counts()
    prewarmed = False
    if env_flag("SEQALIGN_PREWARM"):
        try:
            from .aot.prewarm import prewarm

            prewarm(problem=problem, backend=backend, device=device)
            prewarmed = True
        except Exception as e:
            # advisory: the bench then measures a cold first run.
            log(f"WARNING: prewarm failed ({e})")

    def run():
        return scorer.score_codes(problem.seq1_codes, problem.seq2_codes, problem.weights)

    t0 = time.perf_counter()
    first = run()
    first_run_s = time.perf_counter() - t0
    cold_start_s = time.perf_counter() - _T0
    walls = []
    for _ in range(env_int("BENCH_REPS")):
        t0 = time.perf_counter()
        out = run()
        walls.append(time.perf_counter() - t0)
        if not np.array_equal(out, first):
            raise RuntimeError("nondeterministic bench run")

    launches = (
        bucket_launches(problem.seq1_codes, problem.seq2_codes, problem.weights, device)
        if backend == "cuda" else []
    )
    on_card = device.type == "cuda" and backend == "cuda"
    record: dict = {
        "metric": f"equivalent brute-force char comparisons/s/chip, {workload}",
        "value": None,
        "unit": "elements/s/chip",
        "e2e_first_run_s": first_run_s,
        "e2e_warm_s": statistics.median(walls) if walls else None,
        "cold_start_s": cold_start_s,
        "prewarmed": prewarmed,
        "formulation": backend if backend == "oracle" else "plain",
        "launches": len(launches),
        "device": "cpu" if device.type == "cpu" else torch.cuda.get_device_name(device),
        "feed_overlap": feed_overlap_enabled(),
    }
    if on_card:
        from .analysis.costmodel import predicted_wall_us

        routes = launch_routes(launches, backend)
        record.update(route_fields(routes))
        record.update(device_fields(problem, launches, routes, device))
        record["predicted_device_wall_us"] = predicted_wall_us(problem, backend)
        if record["predicted_device_wall_us"] is not None:
            record["predicted_vs_measured"] = (record["predicted_device_wall_us"]
                                               / record["device_wall_us"])
    record["kernel_launches"] = {**cuda_scorer.launch_counts, **probe.launch_counts}
    # The certificates ride every record (never fatal): a drifted bound or
    # a new unclassified raise lands beside the numbers it would corrupt.
    for section, make in (("ranges", ranges_record), ("exitflow", exitflow_record),
                          ("comms", lambda: comms_record(problem)),
                          ("donation", lambda: donation_record(problem))):
        try:
            record[section] = make()
        except Exception as e:
            # advisory: a diagnostic section; the measurement stands.
            log(f"WARNING: {section} section failed ({e})")
    print(json.dumps(wrap_report("bench", record)), flush=True)
    log(f"backend={backend} device={record['device']} workload={workload} "
        f"launches={len(launches)} e2e_first_run={first_run_s:.3f}s "
        f"cold_start={cold_start_s:.3f}s{' (prewarmed)' if prewarmed else ''}"
        + (f" formulation={record['formulation']} "
           f"device_wall={record['device_wall_us']:.3f}us "
           f"floor={record['floor_us']}us ({record['floor_by']}) "
           f"bound={record['bound_us']}us "
           f"predicted={record['predicted_device_wall_us']}us" if on_card else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
