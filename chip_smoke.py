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
   (``scripts/torch_conformance.py::seam_problems``: tile edges, ties
   across tiles and char segments, the edge lengths, all-equal weights),
   every row against its plain version and the oracle;
3. the packed kernel against its plain version and the fused kernel,
   exact equality: first its seams (``scripts/torch_conformance.py::
   packed_seam_problems``: each
   class at its boundary lengths, pairs of every length and len2 = 0 in one
   block, len2 = len1 and above, exact ties across lanes, tiles and hyphen
   positions, valid offsets that end mid-tile), every row against the
   oracle too; then the input4-class packed set (Seq1 2976, 30 Seq2 of
   5..64, seed 7; ``models/workload.py::input4_problem``) and one batch
   per class 8/16/32;
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
   probe > 0 (the bench resets its counts before its first run); its
   one launch reads ``formulation`` ``cuda`` with every floor, bound and
   single-program field set;
9. launch groups (``ops/schedule.py``), run after phase 5: for every CLI
   input, the planned launches (``bucket_launches``) against one launch a
   bucket (``fuse=False``): each group launch == its plain version, the
   grouped rows == the singleton rows == the oracle (every row of the
   small inputs, eight of the large), and, where the plan groups buckets,
   both schedules timed (planned, singletons, singletons, planned), the
   planned one at most ``RULE_SLACK`` slower; then, at input3-class, the
   rows the finish kernels store at their input rows == the raw rows
   through ``finish_rows`` and a scatter, both timed;
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
   launch group, no collective counted inside the compute, one gather a
   dispatch, one arena a dispatch (the slots share the card), rows ==
   the single-device rows == the golden), ``--mesh 1``
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
   and a parse failure on rank 0 (both 65 within 60 s); then two
   processes of two slots each (``SEQALIGN_HOST_DEVICES=2``: four global
   slots of the one card) with no ``--mesh``, ``--mesh 4``, ``seq:4`` and
   ``2x2`` on mixedcase and max-size (rank 0 == golden, rank 1 silent,
   both 0), ``seq:4`` on :func:`ring_problems`' Seq1 6144 (rank 0 == the
   oracle), ``--mesh 2`` refused (both 65, the JAX CLI's message), and
   each rank's ``--metrics-out`` report of the ``--mesh 4`` max-size job
   counting two fused launches a launch group, its two slots'; then max-size's
   warm wall single-device, over ``[cuda:0] x 4`` and over ``seq:8``
   with each path's summed launch time (CUDA events), and the walls,
   process start to exit, of a two-process ``--mesh 2`` job and of the
   two-process, four-slot ``--mesh 4`` job;
15. the serve plane (``serve/``, ``load/``): (a) a ``ServeLoop`` in this
   process on ``cuda:0``, launch counts set to 0 just before it, takes 25
   requests in one tick (8 of max-size's rows each from 8 requests, 16
   requests of 64 rows of the 1024-short-row problem, one input3-class
   request under its own weights): every line == the batch CLI's == the
   oracle's, every launch == its plain version (a spy on
   ``dispatch.fused_scorer``/``packed_scorer``), both kernels launched,
   ``serve_steady_compiles`` 0, fewer superblocks than the same requests
   take one at a time; then each launch timed and bounded; (b) ``--serve
   --port 0 --telemetry-port 0 --metrics-out`` in a subprocess: 16
   concurrent loopback clients of max-size-class requests (lines ==
   the batch CLI), ``/healthz`` and ``/metrics`` scraped mid-run, fewer
   dispatches than clients; (c) open-loop load on the same server
   (``load/``): a burst calibrates the saturation rate, then a poisson
   schedule at twice it for :data:`SERVE_LOAD_S` seconds; the survival
   gates pass and the ``serve-load`` record validates, its percentiles
   printed with the card line; SIGTERM -> 75, the run report flushed and
   valid; (d) armor through ``io.cli.run``: ``--degrade --retries 3
   --faults chunk_scoring:fail=3`` opens the breaker (``mm`` pinned),
   probes and closes it, lines right; ``poison-session`` isolated by
   bisection, its co-batched requests right;
16. the fleet and the rescue tier (``serve/fleet.py``,
   ``resilience/{membership,rescue}.py``): (a) phase 15a's 25 requests
   through a ``ServeLoop`` coordinator on ``cuda:0`` with two
   ``FleetWorker`` threads over a ``FileBoard``, launch counts set to 0
   just before: every superblock scored by a worker (none on the
   coordinator), every line == the batch CLI == the oracle, every worker
   launch == its plain version (a spy), both kernels launched,
   ``serve_steady_compiles`` 0, and after ``gc_final`` the board holds
   only the registry, the shutdown key and the generation record; each
   launch timed and bounded; (b) processes on the card, four scenarios at
   once, each on its own board, over max-size-class ``load.workload``
   requests: clean (``--serve --port 0 --telemetry-port 0 --fleet-board``
   with two ``--fleet-worker``; four requests of 64 short rows too, over
   sockets; SIGTERM -> 75), kill-worker (``kill:fleet-worker``; the death
   verdict re-dispatches at a bumped epoch to the survivor), zombie-fence
   (``zombie:fleet-worker``; its stale post fenced, never demuxed) and
   coordinator-kill (``kill:fleet-coordinator``; a ``--fleet-standby``
   takes over and replays the checkpoint): every request answered once,
   its records == a fleetless ``--serve`` run's, each worker's report
   with fused launches (packed ones for the short rows), the
   coordinator's report valid, no Traceback; (c) beside (b), two-process
   ``--distributed --mesh 2`` jobs with ``SEQALIGN_BEACON_S`` (mixedcase,
   stress_small, max-size: rank 0 == golden, rank 1 silent, and rank 0's
   report holding rank 1's snapshot with its kernel launches, which only
   the beacon tier's store board carries between the ranks), then
   ``scatter_gather_rescue`` in this process with ``num_processes=2``
   where rank 1 never posts: its max-size rows rescored on ``cuda:0`` ==
   the oracle;
17. the warm plane (``aot/``) and the native driver ``final_torch``:
   (a) a fresh ``--prewarm`` process on max-size with a throwaway
   ``SEQALIGN_CACHE_DIR``: rows == the oracle, the manifest valid with
   entries, none failed, every entry under the card's fingerprint digest,
   and the run report's fused and packed launch counts == one launch a
   warm entry of each kernel plus the batch's own launches; (b) a fresh
   ``--serve --port 0 --prewarm`` process on the same cache answers one
   request (8 max-size rows and 64 short rows: both kernels): every
   manifest entry replayed, ``serve_prewarmed`` 1 and
   ``serve_steady_compiles`` 0 counted from tick 0, its lines == the batch
   CLI's; the time to the first answer printed beside that of the same
   server without ``--prewarm``; (c) the manifest's digests rewritten, a
   ``--prewarm --stream`` run re-warms every entry as ``stale-rewarm``
   and writes them back under the card's digest; (d) ``make final_torch``,
   then every fixture, max-size, and the fixtures under
   ``TPU_SEQALIGN_MESH=4`` and ``seq:8`` (``SEQALIGN_HOST_DEVICES=8``:
   eight slots of the one card) through the binary on the card, eight at
   once, byte-identical to their goldens; ``native_bridge.score_strided``
   in this process on max-size and the 1024-short-row input (counts set to
   0 just before: both kernels launch), bytes == the oracle's triples; the
   binary with ``CUDA_VISIBLE_DEVICES=`` exits non-zero with its
   diagnostic and no stdout;
18. ``--check`` (``analysis/``): (a) the fixtures, max-size, input3-class
   and the 1024 short rows through the CLI without and with ``--check``
   (stdout == the goldens, the launch counts equal, every checked launch
   == its plain version by a spy), then with ``SEQALIGN_CHECK=1`` a serve
   tick in this process (8 max-size and 64 short rows twice each, lines ==
   the batch CLI's) and ``--mesh 2`` / ``--mesh seq:2`` max-size runs
   (``SEQALIGN_HOST_DEVICES=2``), each against its unchecked run; (b)
   max-size's warm CLI wall without and with ``--check``, min of five
   each (and min and median over 20 each), interleaved, beside the hook's
   own host time on the same batch; (c) one seeded violation a gate on the card, each
   raising its subclass with no kernel launch after it: a packing class
   narrower than a live row (and the same through the CLI: rc 65 and the
   JAX CLI's stderr shape), a launch group holding a key wider than its
   L2P, a ring window at L2P 85120 past the card's shared-memory opt-in
   limit, and a Seq2 code 27; (d) the shared-memory audit over the whole
   chooser space against the card's ``shared_memory_per_block_optin``
   (== the kernel library's own query), the model == ``fused_scorer_smem``
   at every L2P to 12288, and each kernel's registers and static shared
   memory (``cudaFuncGetAttributes``) held against the model;
19. the last analysis tiers (``analysis/{costmodel,traceaudit,recompile,
   collectives,dataflow}.py``): (a) the fixtures, max-size, input3-class
   and the 1024 short rows through the CLI, counts set to 0 before each:
   the ``launch_counts`` deltas == ``schedule.fused_schedule_config``'s
   ``declared_launches`` by kernel, stdout == the goldens, and the launch
   audit's traced dispatch on the card (stubbed launches, the operands on
   the card) with no finding; (b) the cost sheet against the card: each
   launch's ``model_kernel_us`` beside its CUDA-event time, and the sheet's
   ``predicted_wall_us`` over the bench's ``device_wall_us`` of the same
   launches (diagnostic; fails only when the sheet's launch count differs
   from the card's); (c) ``assert_compiles(0)`` around a warm CLI run of
   each input, a serve tick, ``--mesh 2`` and ``--mesh seq:2``; (d) the
   comms audit's forms ``2x2`` and ``seq:4`` on ``[cuda:0] x 4``: the
   card's ``comm.log`` == ``tests/golden/torch_comms_audit.json``'s, the
   slots' sequences equal, every operand on its slot's device, rows ==
   the CPU run's; (e) the staged feed under a retry (``--retries 1
   --faults chunk_scoring:fail=1``, feed overlap on), batch and
   ``--stream 16``: stdout == the golden, ``feed_prestage_hits`` == the
   first attempts' launches, one more upload than staged feeds (the
   retried chunk re-uploads from the host); and, under
   ``torch.cuda.set_sync_debug_mode("warn")``, the synchronising calls
   between a batch's first launch and its epilogue copy (diagnostic);
20. the installed port (the packaging layer and ``ops/_build.py``'s build
   directory): a wheel built from a copy of the checkout (``pip wheel
   --no-index --no-deps --no-build-isolation``), installed into a venv
   chained to this interpreter's site-packages by a ``.pth`` file; with
   ``PYTHONPATH`` and ``TPU_SEQALIGN_COMPILE_CACHE`` removed, a fresh
   ``SEQALIGN_CACHE_DIR`` and a foreign working directory, (a) the
   ``tpu-seqalign-torch`` console script under ``--profile --metrics-out``
   on 8 max-size rows and 64 short rows (both kernels): stdout == the
   checkout's == the oracle, its report's launch counts == the checkout's
   run of the same input, ``recompiles`` 2, the fused and packed libraries
   under ``$SEQALIGN_CACHE_DIR/torch_kernels`` with the checkout's source
   digests, stderr naming that directory; then the same run again:
   ``recompiles`` 0; its cold and warm walls printed with the card line;
   then two cold processes at once on another fresh cache home, both
   right, ``recompiles`` 2 between them (the build lock);
   (b) the console script on the seven fixtures and max-size and ``python
   -m mpi_openmp_cuda_tpu_torch`` on mixedcase, four processes at a time:
   stdout == the goldens, each report's launches == the checkout's,
   ``recompiles`` 0; beside them the README's library example, run as
   written (cuda), prints ``[[40, 4, 2]]``; and no file under the venv's
   site-packages created after the install;
21. the measurement scripts, each in a process of its own: (a)
   ``scripts/torch_conformance.py`` in full (every backend, route, regime,
   both kernels' seams and the seeded sweep == the oracle) exits 0, its
   wall printed; (b) ``scripts/torch_bench_table.py --procs 2 --rows
   input3-class,gather``: each row's table line and spread, and the four
   bench records it ran: the two at input3-class's own weights read
   ``cuda`` with every floor, bound and single-program field set, the
   two at ``1000000,1,1,1`` (the port's bench at those weights) read
   ``gather`` with those fields null; (c) ``scripts/torch_stream_bench.py``
   at ``STREAM_BENCH_ROUNDS=1``: its one JSON line parses, with ``e2e_s``
   for batch, ``--stream 32`` and ``--stream 32 --journal`` from
   byte-identical outputs;
22. the serve and fleet drills (:data:`DRILL_GROUPS`), each
   ``scripts/torch_<drill>.py`` at full size in a process of its own, the
   drills of a group at once and the groups one after the other: the
   metrics smoke, serve chaos, trace smoke and fleet trace smoke, then
   fleet chaos (its lease-bound survivors on a quiet host), then the load
   smoke (its open-loop timings alone on the host); every output line is
   logged, each drill must exit 0 with every scenario of its JSON record
   ``ok``, its wall printed with the card line; the records' kernel
   launches (read from the drills' own run reports) must count both
   scorers, and the load smoke's plateau, 2x and 5x goodput and p99
   latency, refit scale and budget and b1/b2 p99 queue wait are printed.

In the kernels JSON line, ``launches`` is each kernel's count from one run
of its path, with the counts set to 0 just before it: for the two scorers
the CLI run of phase 4 plus the in-process serve run of phase 15 plus the
in-process fleet of phase 16a (``ms``, ``plain_ms`` and ``bound_ms`` are
summed over those same launches, the CLI's rebuilt in phase 5, the serve
and fleet runs' as their spies saw them), the bench run of
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
import signal
import statistics
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
# Phase 15's open-loop load: max-size-class requests (Seq1 3000, 4-8 Seq2
# of 1200-2000, two problem keys); a burst of SERVE_CAL_N requests at
# once calibrates the saturation rate (its goodput), then a poisson
# schedule at twice that rate for SERVE_LOAD_S seconds, at most
# SERVE_LOAD_MAX requests.
SERVE_LOAD = dict(problem_keys=2, seq1_len=3000, len_mix=((1200, 2000, 1.0),),
                  pairs_per_request=(4, 8))
SERVE_CAL_N = 256
SERVE_LOAD_S = 10.0
SERVE_LOAD_MAX = 8000
# Phase 22's drills (scripts/torch_<drill>.py): the groups run one after the
# other, the drills of a group at once.
DRILL_GROUPS = (("metrics_smoke", "serve_chaos", "trace_smoke", "fleet_trace_smoke"),
                ("fleet_chaos",), ("load_smoke",))
DRILL_TIMEOUT_S = 400
# Span totals phase 13 prints for the warm max-size CLI run.
SPAN_PATHS = ("parse", "setup", "score", "score.chunk_dispatch", "score.chunk_gather",
              "print")


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def load_script(name: str):
    """``scripts/<name>.py`` as a module: the one copy of what the script
    shares with this test (the conformance check's seam inputs, the
    ablation's wrapper)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


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
        MAX_SIZE, input3_class_problem, input4_problem, synthetic_codes)
    from mpi_openmp_cuda_tpu_torch.ops import _build, probe
    from mpi_openmp_cuda_tpu_torch.ops import cuda_scorer as cs
    from mpi_openmp_cuda_tpu_torch.ops.costs import bound_ms
    from mpi_openmp_cuda_tpu_torch.ops.dispatch import (
        bucket_launches, choose_rowpack, pad_problem)
    from mpi_openmp_cuda_tpu_torch.ops.oracle import prefix_best
    from mpi_openmp_cuda_tpu_torch.ops.values import max_abs_value, value_table
    from mpi_openmp_cuda_tpu_torch.utils.timing import card_line, time_ms

    conformance = load_script("torch_conformance")
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

    for tag, s1, seqs, weights, want in conformance.seam_problems():
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

    for tag, s1, seqs, weights, want in conformance.packed_seam_problems():
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

    seq1_4, seqs_4 = input4_problem()
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
    # -- 15. the serve plane --------------------------------------------------
    serve_counts, serve_totals, serve_reqs = serve_phase(np, torch, cli, cs, compare, inputs,
                                                         time_ms, card)
    # -- 16. the fleet and the rescue tier ------------------------------------
    fleet_counts, fleet_totals, rescue_counts = fleet_phase(
        np, torch, cli, cs, compare, inputs, serve_reqs, prefix_best, time_ms, card)
    # -- 17. the warm plane and the native driver -----------------------------
    warm_counts = warm_phase(np, torch, cli, cs, fixtures, inputs, card)
    # -- 18. --check: the launch contracts on the card -------------------------
    check_counts = check_phase(np, torch, cli, cs, compare, fixtures, inputs, card)
    # -- 19. the cost sheet, the launch audit, builds, comms, the staged feed --
    analysis_counts = analysis_phase(np, torch, cli, cs, fixtures, inputs, time_ms, card)
    # -- 20. the installed port: a wheel, its console script, a cache home -----
    installed_counts = installed_phase(cli, cs, inputs, prefix_best, card)
    tmp.cleanup()

    # -- 6-8. the probe, the ablation and the bench path ------------------
    probe_row = probe_phase(torch, probe, time_ms, card)
    abl_row, abl_counts = ablation_phase(
        torch, cs, time_ms, bound_ms,
        bucket_launches(seq1_max, seqs_max, WEIGHTS, dev), card,
    )
    bench_counts = bench_phase(probe)
    # -- 21. the measurement scripts ---------------------------------------
    scripts_phase(card)
    # -- 22. the serve and fleet drills --------------------------------------
    drill_counts = drills_phase(card)
    paths = {"cli": counts, "serve": serve_counts, "fleet": fleet_counts,
             "rescue": rescue_counts, "robustness": robust_counts,
             "gather route": gather_counts,
             "obs": obs_counts, **{f"mesh, {k}": v for k, v in mesh_counts.items()},
             **warm_counts, "check": check_counts, "analysis": analysis_counts,
             "installed": installed_counts, "drills": drill_counts,
             "bench": bench_counts, "ablation": abl_counts}
    log(f"launch counts by path: {paths}")
    log(f"total {time.perf_counter() - t_start:.1f} s")

    kernels = []
    for name in names:
        tot = total[name]
        for extra in (serve_totals, fleet_totals):
            for key in ("ms", "plain_ms", "bound_ms"):
                tot[key] += extra[name][key]
            for key, ms in extra[name]["by"].items():
                tot["by"][key] += ms
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"{PKG}/csrc/{name}.cu",
            "replaces": (
                "mpi_openmp_cuda_tpu/ops/pallas_scorer.py:559"
                if name == "fused_scorer"
                else "mpi_openmp_cuda_tpu/ops/pallas_scorer.py:1120"
            ),
            "launches": counts[name] + serve_counts[name] + fleet_counts[name],
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
    order, through the production path: every launch's finished rows
    written at their input rows of one buffer, and one copy."""
    from mpi_openmp_cuda_tpu_torch.ops.dispatch import launch_batch

    if not launches:
        return np.zeros((0, 3), dtype=np.int32)
    device = launches[0].state.rows.device
    return launch_batch(launches, backend, count, device).result().copy()


def launch_rows(out, state, finished):
    """A launch's rows: its raw [B, 4] rows, or, in finished mode, its
    finished rows in the dispatch's buffer (at ``dst``, or from ``row0``)."""
    if not finished:
        return out
    done, dst, row0 = finished
    return done[dst] if dst is not None else done[row0 : row0 + state.rows.shape[0]]


def plain_rows(cs, state, l2s, finished):
    """What :func:`launch_rows` must equal: the plain version's raw rows,
    through ``finish_rows`` in finished mode."""
    raw = cs.fused_scorer_plain(state) if l2s is None else cs.packed_scorer_plain(state, l2s)
    return cs.finish_rows(raw, state.lens, state.len1) if finished else raw


def groups_phase(np, torch, cs, compare, inputs, prefix_best, time_ms, card) -> None:
    """Phase 9: the launch groups of every CLI input against one launch a
    bucket: each group launch == its plain version, the grouped rows ==
    the singleton rows == the oracle (sampled on the large inputs), both
    schedules timed (planned, singletons, singletons, planned) and the
    planned one at most RULE_SLACK slower; then, at input3-class, the
    finished rows the finish kernels store at their input rows against the
    raw rows, one PyTorch epilogue and a scatter (the path before them):
    equal, and both timed."""
    from mpi_openmp_cuda_tpu_torch.io.parse import load_problem
    from mpi_openmp_cuda_tpu_torch.ops.dispatch import bucket_launches, launch_batch
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

    # The batch's finished rows: stored by the finish kernels, against the
    # raw rows, one PyTorch epilogue and a scatter.
    prob = load_problem(str(inputs["input3-class"]))
    n = len(prob.seq2_codes)
    for name, fuse in (("planned", True), ("singletons", False)):
        launches = bucket_launches(prob.seq1_codes, prob.seq2_codes, prob.weights, dev,
                                   fuse=fuse)
        order = torch.from_numpy(np.concatenate([b.idx for b in launches])).to(dev)
        lens = torch.cat([b.state.lens for b in launches])
        len1 = launches[0].state.len1

        def torch_epilogue():
            raw = torch.cat([cs.fused_scorer(b.state) if b.l2s is None
                             else cs.packed_scorer(b.state, b.l2s) for b in launches])
            out = torch.empty((n, 3), dtype=torch.int32, device=dev)
            out[order] = cs.finish_rows(raw, lens, len1)
            return out

        def in_kernel():
            return launch_batch(launches, "cuda", n, dev).rows

        compare("fused_scorer", in_kernel(), torch_epilogue())
        a0, b0, b1, a1 = (time_ms(fn, reps=30) for fn in (torch_epilogue, in_kernel,
                                                            in_kernel, torch_epilogue))
        log(f"epilogue input3-class, {name} ({len(launches)} launches): PyTorch epilogue "
            f"and scatter {(a0 + a1) / 2:.6f} ms, in the finish kernels "
            f"{(b0 + b1) / 2:.6f} ms [{card}]")


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
    for tag, s1, sq, _, _ in load_script("torch_conformance").seam_problems():
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


def launch_job(argv, stdin_path, nproc=2, rank_argv=None, env=None) -> list:
    """One ``--distributed`` job of ``nproc`` processes of the CLI on this
    host (torchrun's variables set by hand, ``env`` added), rank 0 reading
    ``stdin_path``, each rank given ``rank_argv(rank)`` after ``argv``
    when that is set; returns the started processes."""
    port = free_port()
    procs = []
    for rank in range(nproc):
        env_r = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                 "WORLD_SIZE": str(nproc), "RANK": str(rank), "LOCAL_RANK": str(rank),
                 "LOCAL_WORLD_SIZE": str(nproc), **(env or {})}
        with open(stdin_path if rank == 0 else os.devnull, "rb") as stdin:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", PKG, "--distributed", *argv,
                 *(rank_argv(rank) if rank_argv else ())], stdin=stdin,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env_r, cwd=REPO))
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


#: Two slots a process: a two-process job's four global slots on the card.
HYBRID_ENV = {"SEQALIGN_HOST_DEVICES": "2"}


def hybrid_jobs(np, dispatch, cs, small, big, big_problem, long_problem, long_want,
                tmpdir) -> dict[str, dict[str, int]]:
    """Phase 14's jobs of two processes of two slots each: the goldens at no
    ``--mesh``, ``4``, ``seq:4`` and ``2x2``, the ring past the cap, the
    partial-mesh refusal, and each rank's launches at ``--mesh 4`` on
    max-size (returned by rank)."""
    long_in = Path(tmpdir) / "seq1_6144.txt"
    long_in.write_text(as_text(np, *long_problem))
    reports = [Path(tmpdir) / f"hybrid{rank}.json" for rank in range(2)]
    jobs = {}
    for mesh in (None, "4", "seq:4", "2x2"):
        for path in (small, big):
            argv = [] if mesh is None else ["--mesh", mesh]
            argv_r = (lambda rank: ["--metrics-out", str(reports[rank])]) if (
                (mesh, path) == ("4", big)) else None
            jobs[(mesh or "none", path.name)] = (
                launch_job(argv, path, rank_argv=argv_r, env=HYBRID_ENV),
                path.with_suffix(".out").read_bytes())
    jobs[("seq:4", long_in.name)] = (launch_job(["--mesh", "seq:4"], long_in, env=HYBRID_ENV),
                                     long_want.encode())
    jobs[("2", "refused")] = (launch_job(["--mesh", "2"], small, env=HYBRID_ENV), None)
    refusal = b"multi-host jobs must mesh all 4 global devices, got --mesh 2"
    for (mesh, name), (procs, want) in jobs.items():
        (rc0, out0, err0), (rc1, out1, err1) = finish_job(procs)
        if want is None:
            if (rc0, rc1) != (65, 65) or out0 or out1 or refusal not in err0 or (
                    refusal not in err1):
                fail(f"2x2-slot --mesh 2: rc {rc0}/{rc1}, stderr {err0[-300:]!r}")
            log(f"2 processes x 2 slots, --mesh 2: both exit 65, {refusal.decode()!r}")
            continue
        if rc0 or rc1 or out0 != want or out1 or b"2 processes x 2 slots" not in err0:
            fail(f"2 processes x 2 slots --mesh {mesh} {name}: rc {rc0}/{rc1}, rank 1 "
                 f"stdout {len(out1)} bytes; stderr {err0[-400:]!r} {err1[-400:]!r}")
        log(f"2 processes x 2 slots (4 global slots on the card) --mesh {mesh} {name}: "
            f"rank 0 stdout == {'oracle' if name == long_in.name else 'golden'}, rank 1 "
            f"silent, both exit 0")
    # The four-slot mesh's launch groups (``_dispatch_sharded``'s plan).
    groups = len(dispatch.launch_plans(*big_problem, packable=False,
                                       min_rows=dispatch.MIN_BUCKET_ROWS * 4, devices=4)[1])
    counts = {}
    for rank, path in enumerate(reports):
        rec = json.loads(path.read_text())
        got = {k: rec["counters"].get(f"{k}_launches", 0) for k in cs.launch_counts}
        if got["fused_scorer"] != 2 * groups or got["packed_scorer"]:
            fail(f"2 processes x 2 slots --mesh 4 max-size, rank {rank}'s launches {got}, "
                 f"want {2 * groups} fused (2 slots x {groups} launch groups)")
        counts[f"2x2-slot rank {rank}"] = got
    log(f"2 processes x 2 slots --mesh 4 max-size: launches {counts}, 2 a group over "
        f"{groups} launch groups, {rec['gauges'].get('distributed_slots')} global slots, "
        f"transport {rec['gauges'].get('distributed_transport')}")
    return counts


def mesh_phase(np, torch, cli, cs, compare, fixtures, inputs, prefix_best, time_ms,
               card) -> dict[str, dict[str, int]]:
    """Phase 14: several devices.  Returns the launch counts of its paths."""
    from mpi_openmp_cuda_tpu_torch.io.parse import load_problem
    from mpi_openmp_cuda_tpu_torch.ops import dispatch
    from mpi_openmp_cuda_tpu_torch.ops.costs import bound_ms
    from mpi_openmp_cuda_tpu_torch.ops.dispatch import AlignmentScorer, bucket_launches
    from mpi_openmp_cuda_tpu_torch.parallel import ring as ring_mod
    from mpi_openmp_cuda_tpu_torch.parallel.ring import RingSharding, ring_plan
    from mpi_openmp_cuda_tpu_torch.parallel import sharding as sharding_mod
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

    def checked(state, *finished):
        out = real(state, *finished)
        ws = cs.window_state(state.seq1ext.cpu().numpy(), state.len1,
                             state.rows.cpu().numpy(), state.lens.cpu().numpy(),
                             state.val.cpu().numpy().reshape(-1), state.rows.device)
        compare("fused_scorer", launch_rows(out, state, finished),
                plain_rows(cs, ws, None, finished))
        seen.append(state)
        return out

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
            arenas = sharding_mod.mesh_counts["mesh_h2d_copies"]
            pend = sc4.score_codes_async(s1, seqs, w)
            if b4.comm.counts:
                fail(f"batch mesh {tag}: collectives inside the compute: {dict(b4.comm.counts)}")
            rows = pend.result()
            batch_states[tag] = seen[first:]
            parts = len(dispatch.launch_plans(s1, seqs, w, packable=False,
                                              min_rows=b4.min_rows, devices=4)[1])
            want_launches += 4 * parts
            arenas = sharding_mod.mesh_counts["mesh_h2d_copies"] - arenas
            if dict(b4.comm.counts) != {"gather": 1} or arenas != 1:
                fail(f"batch mesh {tag}: collectives {dict(b4.comm.counts)}, {arenas} arenas, "
                     "want one gather, nothing else, and one arena")
            if rows_text(rows) != want_rows(tag, s1, seqs, w) or not np.array_equal(
                    rows, single_rows[tag]):
                fail(f"batch mesh {tag}: rows differ from the single-device rows or the golden")
            log(f"batch mesh [cuda:0]x4 {tag}: {len(seqs)} rows == single device == "
                f"golden, {parts} launch groups x 4 shard launches == plain, one arena, "
                f"collectives {dict(b4.comm.counts)} (none in the compute)")
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

    # -- 3b. two processes of two slots each: four global slots ------------
    hybrid_counts = hybrid_jobs(np, dispatch, cs, small, big, probs["max-size"],
                                ring_only["Seq1 6144"],
                                want_rows("Seq1 6144", *ring_only["Seq1 6144"]), tmp.name)

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
    for what, mesh, env in (("2 processes x 1 slot", "2", None),
                            ("2 processes x 2 slots", "4", HYBRID_ENV)):
        t0 = time.perf_counter()
        (rc0, out0, _), (rc1, _, _) = finish_job(launch_job(["--mesh", mesh], big, env=env))
        wall = time.perf_counter() - t0
        if rc0 or rc1 or out0 != big.with_suffix(".out").read_bytes():
            fail(f"{what} --mesh {mesh} max-size (timed): wrong exit or stdout")
        log(f"{what} --distributed --mesh {mesh} max-size job wall {wall:.3f} s, process "
            f"start to exit [{card}]")
    tmp.cleanup()
    return {"batch mesh": batch_counts, "ring": ring_counts, "2-process rank 0": dist_counts,
            **hybrid_counts}


class _Sink:
    """A serve responder collecting every record it is sent."""

    def __init__(self):
        self.records = []

    def send(self, obj):
        self.records.append(obj)


def _lines_of(records) -> dict:
    got: dict = {}
    for rec in records:
        if "line" in rec:
            got.setdefault(rec["id"], []).append(rec["line"])
    return got


def _renumbered(lines, start, count) -> list[str]:
    """Lines ``start .. start + count`` of a batch stdout, numbered from 0
    as a request of those rows gets them."""
    return [f"#{j}:" + line.split(":", 1)[1] for j, line in enumerate(lines[start:start + count])]


def serve_phase(np, torch, cli, cs, compare, inputs, time_ms, card):
    """Phase 15: the serve plane on the card.  Returns ``(counts, totals,
    reqs)``: the in-process run's launch counts (set to 0 just before it),
    the kernel, plain and bound ms summed over its launches, and its 25
    requests with the batch CLI's lines of each (phase 16 serves them
    again)."""
    import threading
    import urllib.request

    from mpi_openmp_cuda_tpu_torch.io.parse import load_problem
    from mpi_openmp_cuda_tpu_torch.io.pipeline import ChunkPipeline
    from mpi_openmp_cuda_tpu_torch.load import arrival, driver, gates, replay, workload
    from mpi_openmp_cuda_tpu_torch.load.report import serve_load_record
    from mpi_openmp_cuda_tpu_torch.obs import arm_observability, disarm_observability
    from mpi_openmp_cuda_tpu_torch.obs.metrics import validate_report
    from mpi_openmp_cuda_tpu_torch.ops import _build, dispatch
    from mpi_openmp_cuda_tpu_torch.ops.costs import bound_ms
    from mpi_openmp_cuda_tpu_torch.ops.dispatch import AlignmentScorer
    from mpi_openmp_cuda_tpu_torch.resilience.degrade import BackendDegrader
    from mpi_openmp_cuda_tpu_torch.resilience.policy import RetryPolicy
    from mpi_openmp_cuda_tpu_torch.serve.batcher import plan_blocks
    from mpi_openmp_cuda_tpu_torch.serve.clock import ServeClock
    from mpi_openmp_cuda_tpu_torch.serve.loop import ServeLoop, warm_kernels
    from mpi_openmp_cuda_tpu_torch.serve.queue import QueuedRequest
    from mpi_openmp_cuda_tpu_torch.serve.session import build_session

    t_phase = time.perf_counter()
    probs, batch_lines = {}, {}
    for tag in ("max-size", "1024 short rows", "input3-class"):
        probs[tag] = load_problem(str(inputs[tag]))
        rc, out, _ = run_cli(cli, ["--input", str(inputs[tag])])
        gold = inputs[tag].with_suffix(".out").read_text()  # the oracle's (phase 4)
        if rc != 0 or out.decode() != gold:
            fail(f"serve: the batch CLI on {tag} differs from the oracle")
        batch_lines[tag] = out.decode().splitlines()

    def request(rid, tag, start, count):
        p = probs[tag]
        return ({"id": rid, "weights": list(p.weights), "seq1": p.seq1,
                 "seq2": p.seq2[start:start + count]},
                _renumbered(batch_lines[tag], start, count))

    reqs = [request(f"max{i}", "max-size", 8 * i, 8) for i in range(8)]
    reqs += [request(f"short{i}", "1024 short rows", 64 * i, 64) for i in range(16)]
    reqs += [request("foreign", "input3-class", 0, 32)]

    def check_lines(records, want, what):
        got = _lines_of(records)
        for rid, lines in want.items():
            if got.get(rid) != lines:
                fail(f"serve {what}: request {rid} lines differ from the batch CLI's")
            if {"id": rid, "done": True, "n": len(lines)} not in records:
                fail(f"serve {what}: request {rid} has no done record")

    # -- a. ServeLoop in process on cuda:0, every launch held == plain ------
    seen = []
    real = {"fused_scorer": cs.fused_scorer, "packed_scorer": cs.packed_scorer}

    def fused(state, *finished):
        out = real["fused_scorer"](state, *finished)
        compare("fused_scorer", launch_rows(out, state, finished),
                plain_rows(cs, state, None, finished))
        seen.append(("fused_scorer", state, None))
        return out

    def packed(state, l2s, *finished):
        out = real["packed_scorer"](state, l2s, *finished)
        compare("packed_scorer", launch_rows(out, state, finished),
                plain_rows(cs, state, l2s, finished))
        seen.append(("packed_scorer", state, l2s))
        return out

    policy = RetryPolicy()
    deg = BackendDegrader(AlignmentScorer("cuda", device="cuda"),
                          lambda b: AlignmentScorer(b, device="cuda"))
    warm_kernels(deg)
    loop = ServeLoop(ChunkPipeline(policy, deg), policy)
    sink = _Sink()
    registry, _ = arm_observability()
    dispatch.fused_scorer, dispatch.packed_scorer = fused, packed
    try:
        torch.cuda.synchronize()
        cs.reset_launch_counts()
        t0 = time.perf_counter()
        for raw, _ in reqs:
            loop.ingest(json.dumps(raw), sink)
        while loop.tick():
            pass
        wall = time.perf_counter() - t0
        counts = dict(cs.launch_counts)
        loop.record_steady_gauge()
        snap = registry.snapshot()
    finally:
        dispatch.fused_scorer, dispatch.packed_scorer = real["fused_scorer"], real["packed_scorer"]
        disarm_observability()
    check_lines(sink.records, {raw["id"]: want for raw, want in reqs}, "in process")
    blocks = snap["counters"].get("serve_batches", 0)
    steady = snap["gauges"].get("serve_steady_compiles")
    log(f"serve in process: {len(reqs)} requests (3 problem keys) in {blocks} superblocks, "
        f"{len(seen)} launches {counts}, every line == the batch CLI == the oracle, "
        f"serve_steady_compiles {steady}, wall {wall * 1e3:.3f} ms [{card}]")
    for name in counts:
        if counts[name] < 1:
            fail(f"serve: the superblocks never launched {name}")
        if counts[name] != sum(1 for n, _, _ in seen if n == name):
            fail(f"serve: {name} launch count {counts[name]} != the spied launches")
    if steady != 0:
        fail(f"serve: serve_steady_compiles {steady} != 0")
    # Coalescing: the tick's blocks against the blocks the same requests
    # take one at a time, and the max-size key's blocks against its
    # requests.  (Not all blocks against all requests: the foreign
    # request alone spans 9 length buckets, and each full short request
    # is a block of its own.)
    def n_blocks(raws):
        items = [QueuedRequest(raw, None, 0.0, i + 1) for i, raw in enumerate(raws)]
        return len(plan_blocks([build_session(it, ServeClock()) for it in items],
                               loop.rows_per_block))

    alone = sum(n_blocks([raw]) for raw, _ in reqs)
    max_blocks = n_blocks([raw for raw, _ in reqs if raw["id"].startswith("max")])
    log(f"serve coalescing: {blocks} superblocks for {len(reqs)} requests; one request "
        f"at a time they take {alone}; the 8 max-size requests share {max_blocks}")
    if not (blocks == n_blocks([raw for raw, _ in reqs]) and blocks < alone
            and max_blocks < 8):
        fail(f"serve: {blocks} superblocks, {alone} one request at a time, "
             f"{max_blocks} for the 8 max-size requests (no coalescing)")
    if _build.build_count() != loop._steady_base:
        fail("serve: a build, load or setup happened after the first block")
    totals = {name: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                     "by": {"bytes": 0.0, "operations": 0.0}} for name in counts}
    for name, state, l2s in seen:
        kern = ((lambda st=state: real["fused_scorer"](st)) if l2s is None
                else (lambda st=state, c=l2s: real["packed_scorer"](st, c)))
        plain = ((lambda st=state: cs.fused_scorer_plain(st)) if l2s is None
                 else (lambda st=state, c=l2s: cs.packed_scorer_plain(st, c)))
        b_ms, b_by, _ = bound_ms(state)
        tot = totals[name]
        tot["ms"] += time_ms(kern, reps=50)
        tot["plain_ms"] += time_ms(plain, reps=3)
        tot["bound_ms"] += b_ms
        tot["by"][b_by] += b_ms
    shapes = sorted({(n, tuple(st.rows.shape), c) for n, st, c in seen})
    log(f"serve launch shapes (kernel, rows x L2P, class): {shapes}")
    for name, tot in totals.items():
        log(f"serve launches {name}: {counts[name]}, sum kernel {tot['ms']:.6f} ms, "
            f"plain {tot['plain_ms']:.6f} ms, bound {tot['bound_ms']:.6f} ms [{card}]")

    # -- b. a --serve subprocess: sockets, telemetry, SIGTERM -> 75 ---------
    tmp = tempfile.TemporaryDirectory()
    report = Path(tmp.name) / "serve.json"
    proc = _Proc("serve", ["--serve", "--port", "0", "--telemetry-port", "0",
                           "--metrics-out", str(report)], tmp.name)
    try:
        t0 = time.perf_counter()
        ports = {}
        for what in ("serving", "telemetry"):
            hit = proc.wait_for(rf"{what} on 127\.0\.0\.1:(\d+)", 120)
            if hit is None:
                fail("serve subprocess never announced its ports: " + proc.stderr()[-3000:])
            ports[what] = int(hit[1].group(1))
        log(f"serve subprocess up in {time.perf_counter() - t0:.1f} s: ports {ports}")
        base = f"http://127.0.0.1:{ports['telemetry']}"
        socket_reqs = [request(f"c{i}", "max-size", 4 * i, 4) for i in range(16)]
        results, failures = {}, []
        gate = threading.Barrier(len(socket_reqs) + 1)

        def client(raw):
            try:
                buf = ask(ports["serving"], raw, timeout=60, gate=gate)
                results[raw["id"]] = [json.loads(x) for x in buf.decode().splitlines() if x]
            except BaseException as e:  # reported on the main thread
                failures.append(e)

        threads = [threading.Thread(target=client, args=(raw,), daemon=True)
                   for raw, _ in socket_reqs]
        for t in threads:
            t.start()
        gate.wait(30)
        t0 = time.perf_counter()
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        with urllib.request.urlopen(f"{base}/metrics", timeout=30) as resp:
            mid = resp.read().decode()
        for t in threads:
            t.join(120)
        wall = time.perf_counter() - t0
        if failures or len(results) != len(socket_reqs):
            fail(f"serve sockets: {len(results)} of {len(socket_reqs)} clients answered "
                 f"({failures[:2]})")
        check_lines([r for recs in results.values() for r in recs],
                    {raw["id"]: want for raw, want in socket_reqs}, "over sockets")
        if not health.get("status", {}).get("ok") or "# TYPE seqalign_" not in mid:
            fail(f"serve telemetry mid-run: healthz {health}, /metrics {mid[:200]!r}")
        with urllib.request.urlopen(f"{base}/metrics", timeout=30) as resp:
            after = resp.read().decode()

        def prom(text, name):
            found = re.search(rf"^seqalign_{name}_total (\S+)$", text, re.M)
            return float(found.group(1)) if found else 0.0

        dispatched = prom(after, "chunks_dispatched")
        log(f"serve sockets: {len(socket_reqs)} concurrent clients of max-size-class "
            f"requests, every line == the batch CLI, wall {wall * 1e3:.3f} ms; mid-run "
            f"healthz {health['status']}; chunks_dispatched {dispatched:g}, "
            f"serve_requests {prom(after, 'serve_requests'):g} [{card}]")
        if not 0 < dispatched < len(socket_reqs):
            fail(f"serve sockets: {dispatched:g} dispatches for {len(socket_reqs)} requests")

        # -- c. open-loop load against the same server ----------------------
        cal = driver.drive("127.0.0.1", ports["serving"], replay.build_schedule(
            arrival.arrival_times("burst", SERVE_CAL_N, 4000.0, seed=7),
            workload.synth_requests(SERVE_CAL_N, seed=8, id_prefix="cal", **SERVE_LOAD)),
            clients=16, grace_s=60.0)
        problems = gates.survival_problems(cal, phase="calibrate")
        sat = max(1.0, cal.goodput_rps)
        rate = 2.0 * sat
        n = int(min(SERVE_LOAD_MAX, max(64, rate * SERVE_LOAD_S)))
        sched = replay.build_schedule(
            arrival.arrival_times("poisson", n, rate, seed=7),
            workload.synth_requests(n, seed=9, id_prefix="q", **SERVE_LOAD))
        t0 = time.perf_counter()
        over = driver.drive("127.0.0.1", ports["serving"], sched, clients=16, grace_s=120.0)
        log(f"serve load: calibration {cal.counts()} goodput {sat:.3f} req/s; poisson "
            f"{n} requests at {rate:.3f} req/s over {sched[-1][0]:.3f} s: {over.counts()}, "
            f"drive wall {time.perf_counter() - t0:.3f} s")
        problems += gates.survival_problems(over, phase="2x")
        if problems:
            fail(f"serve load survival gates: {problems[:4]}")
    finally:
        proc.proc.send_signal(signal.SIGTERM)
        rc = proc.finish(120)
    if rc != 75:
        fail(f"serve subprocess: SIGTERM -> {rc}, want 75: " + proc.stderr()[-3000:])
    rep = json.loads(report.read_text())
    validate_report(rep)
    if rep.get("exit_code") != 75 or rep["gauges"].get("serve_steady_compiles") != 0:
        fail(f"serve report: exit_code {rep.get('exit_code')}, "
             f"serve_steady_compiles {rep['gauges'].get('serve_steady_compiles')}")
    record = serve_load_record(over, rep, process="poisson", rate_rps=rate, seed=7,
                               clients=16, plateau_rps=sat)
    validate_report(record)
    log(f"serve subprocess: SIGTERM -> 75, report valid; its launches "
        f"{ {k: v for k, v in rep['counters'].items() if k.endswith('_launches')} }")
    log(f"serve-load record: {json.dumps(record, sort_keys=True)}")
    lat, wait = record["latency_s"], record["queue_wait_s"]
    log(f"serve-load: goodput {record['goodput_rps']} req/s at {record['offered_rps']} "
        f"offered; latency p50 {lat['p50']} s p99 {lat['p99']} s; queue wait p50 "
        f"{wait['p50']} s p99 {wait['p99']} s [{card}]")

    # -- d. armor on the card: the breaker, then a poison session ----------
    armor = [request(f"a{i}", "input3-class", 8 * i, 8) for i in range(4)]
    reqfile = Path(tmp.name) / "armor.ndjson"
    reqfile.write_text("".join(json.dumps(raw) + "\n" for raw, _ in armor))
    os.environ.update(SEQALIGN_SERVE_MAX_POP="1", SEQALIGN_BREAKER_COOLDOWN="1",
                      SEQALIGN_BACKOFF_BASE="0")
    try:
        areport = Path(tmp.name) / "armor.json"
        before = dict(cs.launch_counts)
        err = []
        rc, out, _ = run_cli(cli, ["--serve", "--input", str(reqfile), "--degrade",
                                   "--retries", "3", "--faults", "chunk_scoring:fail=3",
                                   "--metrics-out", str(areport)], err)
        records = [json.loads(x) for x in out.decode().splitlines() if x]
        if rc != 0:
            fail(f"serve breaker run: rc {rc}: {err[0][-2000:]}")
        check_lines(records, {raw["id"]: want for raw, want in armor}, "breaker")
        c = json.loads(areport.read_text())["counters"]
        fused_delta = cs.launch_counts["fused_scorer"] - before["fused_scorer"]
        log(f"serve breaker: chunk_scoring:fail=3 -> breaker opens {c.get('breaker_opens')}, "
            f"half-opens {c.get('breaker_half_opens')}, closes {c.get('breaker_closes')}; "
            f"lines == the batch CLI; fused launches {fused_delta}")
        if not (c.get("breaker_opens") == 1 and "pinned" in err[0] and "'mm'" in err[0]
                and c.get("breaker_closes") == 1 and fused_delta > 0):
            fail(f"serve breaker: counters {c}; stderr {err[0][-1500:]}")
        os.environ["SEQALIGN_SERVE_MAX_POP"] = "0"
        err = []
        rc, out, _ = run_cli(cli, ["--serve", "--input", str(reqfile), "--faults",
                                   "poison-session:fail=1,after=1"], err)
        records = [json.loads(x) for x in out.decode().splitlines() if x]
        poisoned = [r for r in records if "poison" in str(r.get("error", ""))]
        if rc != 0 or [r["id"] for r in poisoned] != ["a1"]:
            fail(f"serve poison: rc {rc}, poisoned {poisoned}")
        check_lines(records, {raw["id"]: want for raw, want in armor if raw["id"] != "a1"},
                    "poison")
        log("serve poison: a1 isolated by bisection with a typed error, a0/a2/a3 == "
            "the batch CLI")
    finally:
        for var in ("SEQALIGN_SERVE_MAX_POP", "SEQALIGN_BREAKER_COOLDOWN"):
            os.environ.pop(var, None)
    tmp.cleanup()
    log(f"serve phase: {time.perf_counter() - t_phase:.1f} s")
    return counts, totals, reqs


def ask(port, raw, timeout=120.0, gate=None) -> bytes:
    """One serve client: connect to ``port``, wait on ``gate`` (a barrier)
    when given, send the request ``raw`` and read its records until its
    ``done`` or ``error`` record or the server's close."""
    import socket

    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as conn:
        if gate is not None:
            gate.wait(30)
        conn.sendall((json.dumps(raw) + "\n").encode())
        buf = b""
        while b'"done"' not in buf and b'"error"' not in buf:
            chunk = conn.recv(1 << 16)
            if not chunk:
                break
            buf += chunk
    return buf


class _Proc:
    """One CLI subprocess of the port, its stderr lines stamped with
    ``time.perf_counter()`` as they arrive (and kept for the logs), its
    stdout in a file."""

    def __init__(self, tag, argv, tmpdir, env=None):
        import threading

        self.tag = tag
        self.out_path = Path(tmpdir) / f"{tag}.out"
        self._out = open(self.out_path, "w+b")
        self.lines: list[tuple[float, str]] = []
        self.proc = subprocess.Popen(
            [sys.executable, "-m", PKG, *argv], cwd=REPO, stdin=subprocess.DEVNULL,
            stdout=self._out, stderr=subprocess.PIPE, text=True,
            env={**os.environ, **(env or {})})
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for line in self.proc.stderr:
            self.lines.append((time.perf_counter(), line))

    def first(self, pattern):
        """``(time, match)`` of the first stderr line matching, else None."""
        for t, line in list(self.lines):
            found = re.search(pattern, line)
            if found:
                return t, found
        return None

    def wait_for(self, pattern, timeout):
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            hit = self.first(pattern)
            if hit is not None:
                return hit
            if self.proc.poll() is not None:
                break
            time.sleep(0.02)
        return self.first(pattern)

    def finish(self, timeout=60.0) -> int:
        """Wait the process out (killing it past ``timeout``); its exit code."""
        try:
            rc = self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            rc = self.proc.wait(30)
        self._reader.join(10)
        return rc

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(30)

    def stdout(self) -> str:
        self._out.flush()
        self._out.seek(0)
        return self._out.read().decode(errors="replace")

    def stderr(self) -> str:
        return "".join(line for _, line in self.lines)


def _records_by_id(text, tolerant=False) -> dict:
    """ndjson records -> per-id transcripts, each record serialised with
    sorted keys (the exactly-once and byte-identical comparison unit);
    ``tolerant`` skips a torn line (a SIGKILLed coordinator's last)."""
    out: dict = {}
    for line in text.splitlines():
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            if tolerant:
                continue
            raise
        out.setdefault(rec.get("id"), []).append(json.dumps(rec, sort_keys=True))
    return out


def _board_left(board_dir) -> list[str]:
    """What a completed fleet left on its board, beside the worker
    registry, the shutdown beacon and the generation record."""
    root = Path(board_dir) / "seqalign" / "fleet"
    keep = ("worker", "hb", "leader", "leaderhb", "shutdown")
    left = []
    for path in root.rglob("*"):
        if path.is_file():
            rel = path.relative_to(root)
            if path.name.startswith(".tmp.") or rel.parts[0] not in keep:
                left.append(str(rel))
    return sorted(left)


def fleet_phase(np, torch, cli, cs, compare, inputs, serve_reqs, prefix_best, time_ms,
                card):
    """Phase 16: the fleet and the rescue tier on the card.  Returns
    ``(counts, totals, rescue_counts)``: the in-process fleet's launch
    counts (set to 0 just before it), the kernel, plain and bound ms summed
    over those launches, and the in-process rescue's launch counts."""
    import threading

    from mpi_openmp_cuda_tpu_torch.io.parse import load_problem
    from mpi_openmp_cuda_tpu_torch.io.pipeline import ChunkPipeline
    from mpi_openmp_cuda_tpu_torch.load import workload
    from mpi_openmp_cuda_tpu_torch.obs import arm_observability, disarm_observability
    from mpi_openmp_cuda_tpu_torch.obs.metrics import validate_report
    from mpi_openmp_cuda_tpu_torch.ops import _build, dispatch
    from mpi_openmp_cuda_tpu_torch.ops.costs import bound_ms
    from mpi_openmp_cuda_tpu_torch.ops.dispatch import AlignmentScorer
    from mpi_openmp_cuda_tpu_torch.parallel.distributed import scatter_gather_rescue
    from mpi_openmp_cuda_tpu_torch.resilience.degrade import BackendDegrader
    from mpi_openmp_cuda_tpu_torch.resilience.membership import LeaderLease
    from mpi_openmp_cuda_tpu_torch.resilience.policy import RetryPolicy
    from mpi_openmp_cuda_tpu_torch.resilience.rescue import FileBoard, MemoryBoard
    from mpi_openmp_cuda_tpu_torch.serve.fleet import (
        FleetCoordinator, FleetWorker, lease_ticks_for)
    from mpi_openmp_cuda_tpu_torch.serve.loop import ServeLoop, warm_kernels

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    policy = RetryPolicy()

    def degrader():
        return BackendDegrader(AlignmentScorer("cuda", device="cuda"),
                               lambda b: AlignmentScorer(b, device="cuda"))

    # -- a. an in-process fleet: a ServeLoop coordinator, two worker threads --
    seen = []  # (kernel, state, class, rows, finished), appended from the workers
    real = {"fused_scorer": cs.fused_scorer, "packed_scorer": cs.packed_scorer}

    def fused(state, *finished):
        out = real["fused_scorer"](state, *finished)
        seen.append(("fused_scorer", state, None, out, finished))
        return out

    def packed(state, l2s, *finished):
        out = real["packed_scorer"](state, l2s, *finished)
        seen.append(("packed_scorer", state, l2s, out, finished))
        return out

    board_dir = Path(tmp.name) / "board-a"
    board = FileBoard(str(board_dir))
    deg = degrader()
    warm_kernels(deg)
    loop = ServeLoop(ChunkPipeline(policy, deg), policy)
    fallback = []

    def local_score(block):
        fallback.append(block)
        loop._fleet_fallback(block)

    leader = LeaderLease(board, "c-smoke", lease_ticks_for())
    leader.acquire()
    loop.fleet = FleetCoordinator(board, local_score=local_score, demux=loop._demux,
                                  clock=loop.clock, leader=leader)
    workers = []
    for wid in ("wa", "wb"):
        worker = FleetWorker(board, ChunkPipeline(policy, degrader()), policy)
        worker.wid = wid
        workers.append(worker)
    sink = _Sink()
    registry, _ = arm_observability()
    dispatch.fused_scorer, dispatch.packed_scorer = fused, packed
    threads = [threading.Thread(target=w.run, daemon=True) for w in workers]
    try:
        torch.cuda.synchronize()
        cs.reset_launch_counts()
        for t in threads:
            t.start()
        deadline = time.perf_counter() + 60
        while loop.fleet.membership.live_count() < 2:
            if time.perf_counter() > deadline:
                fail("fleet in process: the two worker threads never joined")
            loop.fleet.pump(idle=True)
        t0 = time.perf_counter()
        for raw, _ in serve_reqs:
            loop.ingest(json.dumps(raw), sink)
        while loop.tick():
            if time.perf_counter() - t0 > 120:
                fail("fleet in process: the superblocks were not answered in 120 s")
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = dict(cs.launch_counts)
        loop.record_steady_gauge()
        snap = registry.snapshot()
        loop.fleet.gc_final()
        loop.fleet.shutdown()
        for t in threads:
            t.join(30)
    finally:
        dispatch.fused_scorer, dispatch.packed_scorer = real["fused_scorer"], real["packed_scorer"]
        disarm_observability()
    if any(t.is_alive() for t in threads):
        fail("fleet in process: a worker thread did not exit on the shutdown key")
    got = _lines_of(sink.records)
    for raw, want in serve_reqs:
        if got.get(raw["id"]) != want:
            fail(f"fleet in process: request {raw['id']} lines differ from the batch CLI's")
        if {"id": raw["id"], "done": True, "n": len(want)} not in sink.records:
            fail(f"fleet in process: request {raw['id']} has no done record")
    c = snap["counters"]
    blocks = c.get("serve_batches", 0)
    steady = snap["gauges"].get("serve_steady_compiles")
    for name, state, l2s, out, finished in seen:  # each worker launch == its plain version
        compare(name, launch_rows(out, state, finished), plain_rows(cs, state, l2s, finished))
    log(f"fleet in process: {len(serve_reqs)} requests in {blocks} superblocks over 2 "
        f"worker threads on a FileBoard, {c.get('fleet_scores_started', 0)} scored by the "
        f"workers, {len(fallback)} on the coordinator; {len(seen)} launches {counts} each "
        f"== plain; every line == the batch CLI == the oracle; serve_steady_compiles "
        f"{steady}; wall {wall * 1e3:.3f} ms [{card}]")
    if fallback or c.get("fleet_scores_started", 0) < blocks or blocks < 1:
        fail(f"fleet in process: {len(fallback)} superblocks scored on the coordinator, "
             f"{c.get('fleet_scores_started', 0)} by workers, of {blocks}")
    for name in counts:
        if counts[name] < 1:
            fail(f"fleet in process: the workers never launched {name}")
        if counts[name] != sum(1 for n, *_ in seen if n == name):
            fail(f"fleet in process: {name} count {counts[name]} != the spied launches")
    if steady != 0 or _build.build_count() != loop._steady_base:
        fail(f"fleet in process: serve_steady_compiles {steady}, or a build, load or "
             "setup after the first block")
    left = _board_left(board_dir)
    if left:
        fail(f"fleet in process: the board kept {left} after gc_final")
    totals = {name: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                     "by": {"bytes": 0.0, "operations": 0.0}} for name in counts}
    per_launch = []
    for name, state, l2s, *_ in seen:
        kern = ((lambda st=state: real["fused_scorer"](st)) if l2s is None
                else (lambda st=state, k=l2s: real["packed_scorer"](st, k)))
        plain = ((lambda st=state: cs.fused_scorer_plain(st)) if l2s is None
                 else (lambda st=state, k=l2s: cs.packed_scorer_plain(st, k)))
        b_ms, b_by, _ = bound_ms(state)
        ms = time_ms(kern, reps=50)
        per_launch.append(ms)
        tot = totals[name]
        tot["ms"] += ms
        tot["plain_ms"] += time_ms(plain, reps=3)
        tot["bound_ms"] += b_ms
        tot["by"][b_by] += b_ms
    for name, tot in totals.items():
        log(f"fleet worker launches {name}: {counts[name]}, sum kernel {tot['ms']:.6f} ms, "
            f"plain {tot['plain_ms']:.6f} ms, bound {tot['bound_ms']:.6f} ms [{card}]")
    log(f"fleet worker launch times: min {min(per_launch):.6f} ms, max "
        f"{max(per_launch):.6f} ms over {len(per_launch)} launches [{card}]")

    # -- b. processes on the card: the clean fleet and three chaos scenarios --
    # -- c. the rescue tier: two-process beacon jobs over gloo ---------------
    short = [raw for raw, _ in serve_reqs if raw["id"].startswith("short")][:4]
    chaos = workload.synth_requests(6, seed=16, id_prefix="f", **SERVE_LOAD)
    reqfile = Path(tmp.name) / "fleet.ndjson"
    reqfile.write_text("".join(json.dumps(r) + "\n" for r in chaos))
    clean_reqs = chaos + short
    cleanfile = Path(tmp.name) / "clean.ndjson"
    cleanfile.write_text("".join(json.dumps(r) + "\n" for r in clean_reqs))
    base = {}
    for tag, path in (("chaos", reqfile), ("clean", cleanfile)):
        rc, out, _ = run_cli(cli, ["--serve", "--input", str(path)])
        if rc != 0:
            fail(f"fleet: the fleetless --serve baseline of {tag} exited {rc}")
        base[tag] = _records_by_id(out.decode())
    problems: list[str] = []
    walls: dict[str, float] = {}
    procs: list[_Proc] = []
    env0 = {"SEQALIGN_BACKOFF_BASE": "0.01", "SEQALIGN_CACHE_DIR": str(Path(tmp.name) / "cache")}

    def spawn(tag, *argv, env=None):
        p = _Proc(tag, argv, tmp.name, env={**env0, **(env or {})})
        procs.append(p)
        return p

    def wait_registered(board_dir, n, timeout=90.0):
        wdir = Path(board_dir) / "seqalign" / "fleet" / "worker"
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            if wdir.is_dir() and len([f for f in os.listdir(wdir)
                                      if not f.startswith(".tmp.")]) >= n:
                return True
            time.sleep(0.05)
        return False

    def report_of(path):
        try:
            rep = json.loads(Path(path).read_text())
            validate_report(rep)
            return rep
        except (OSError, ValueError) as e:
            problems.append(f"report {path}: {e}")
            return {"counters": {}, "gauges": {}}

    def worker_gate(tag, rep, want_packed=False):
        c = rep["counters"]
        if c.get("fused_scorer_launches", 0) < 1 or c.get("fleet_scores_started", 0) < 1:
            problems.append(f"{tag}: worker report shows no fused launch or no score: {c}")
        if want_packed and c.get("packed_scorer_launches", 0) < 1:
            problems.append(f"{tag}: worker report shows no packed launch: {c}")
        if c.get("fleet_score_failures"):
            problems.append(f"{tag}: {c['fleet_score_failures']} superblocks failed to score")

    def coordinator_gates(tag, proc, rc, records, want, report, want_rc=0):
        if rc != want_rc:
            problems.append(f"{tag}: coordinator exit {rc}, want {want_rc}: "
                            f"{proc.stderr()[-1500:]}")
        if records != want:
            problems.append(f"{tag}: records are not the fleetless run's, each once")
        rep = report_of(report)
        if rep["gauges"].get("shed_state") != "accept":
            problems.append(f"{tag}: shed_state {rep['gauges'].get('shed_state')!r}")
        return rep

    def pipe_coordinator(tag, board_dir, faults=None, env=None):
        argv = ["--serve", "--input", str(reqfile), "--fleet-board", str(board_dir),
                "--metrics-out", str(Path(tmp.name) / f"{tag}.coord.json")]
        if faults:
            argv += ["--faults", faults]
        return spawn(f"{tag}.coord", *argv, env=env)

    def scenario_clean():
        tag = "clean"
        bdir = Path(tmp.name) / f"{tag}.board"
        reps = [Path(tmp.name) / f"{tag}.w{i}.json" for i in range(2)]
        ws = [spawn(f"{tag}.w{i}", "--fleet-worker", "--fleet-board", str(bdir),
                    "--metrics-out", str(reps[i])) for i in range(2)]
        crep = Path(tmp.name) / f"{tag}.coord.json"
        coord = spawn(f"{tag}.coord", "--serve", "--port", "0", "--telemetry-port", "0",
                      "--fleet-board", str(bdir), "--metrics-out", str(crep))
        hit = coord.wait_for(r"serving on 127\.0\.0\.1:(\d+)", 120)
        if hit is None or not coord.wait_for(r"telemetry on", 10):
            problems.append(f"{tag}: coordinator never announced its ports")
            return
        port = int(hit[1].group(1))
        deadline = time.perf_counter() + 120
        while len(re.findall(r"fleet: worker \S+ joined", coord.stderr())) < 2:
            if time.perf_counter() > deadline:
                problems.append(f"{tag}: the workers never joined")
                return
            time.sleep(0.05)
        t0 = time.perf_counter()
        answers: dict = {}

        def client(raw):
            answers[raw["id"]] = ask(port, raw).decode()

        clients = [threading.Thread(target=client, args=(raw,), daemon=True)
                   for raw in clean_reqs]
        for t in clients:
            t.start()
        for t in clients:
            t.join(120)
        walls[tag] = time.perf_counter() - t0
        coord.proc.send_signal(signal.SIGTERM)
        rc = coord.finish(120)
        wrcs = [w.finish(60) for w in ws]
        records = _records_by_id("".join(answers.values()))
        # A persistent server stops on SIGTERM: the drain's 75.
        coordinator_gates(tag, coord, rc, records, base["clean"], crep, want_rc=75)
        if wrcs != [0, 0]:
            problems.append(f"{tag}: worker exits {wrcs}")
        wr = [report_of(r) for r in reps]
        for i, rep in enumerate(wr):
            worker_gate(f"{tag}.w{i}", rep)
        if sum(r["counters"].get("packed_scorer_launches", 0) for r in wr) < 1:
            problems.append(f"{tag}: no worker launched the packed kernel for the short rows")
        log(f"fleet clean: {len(clean_reqs)} requests over sockets to --serve --port 0 "
            f"--telemetry-port 0 --fleet-board with 2 --fleet-worker processes, each record "
            f"== the fleetless run's, once; wall {walls[tag] * 1e3:.3f} ms; SIGTERM -> {rc}; "
            f"worker launches {[{k: v for k, v in r['counters'].items() if k.endswith('_launches')} for r in wr]} "
            f"[{card}]")

    def scenario_kill_worker():
        tag = "kill-worker"
        bdir = Path(tmp.name) / f"{tag}.board"
        doomed = spawn(f"{tag}.doomed", "--fleet-worker", "--fleet-board", str(bdir),
                       "--faults", "kill:fleet-worker:fail=1")
        srep = Path(tmp.name) / f"{tag}.survivor.json"
        # The survivor scans the board every 0.25 s, the doomed worker every
        # 0.02 s: the doomed one claims a superblock (and dies inside it).
        survivor = spawn(f"{tag}.survivor", "--fleet-worker", "--fleet-board", str(bdir),
                         "--metrics-out", str(srep),
                         env={"SEQALIGN_WORKER_HEARTBEAT_S": "0.25"})
        if not wait_registered(bdir, 2):
            problems.append(f"{tag}: the workers never registered")
            return
        t_kill = []
        threading.Thread(target=lambda: (doomed.proc.wait(), t_kill.append(
            time.perf_counter())), daemon=True).start()
        t0 = time.perf_counter()
        coord = pipe_coordinator(tag, bdir, env={"SEQALIGN_LEASE_S": "2"})
        rc = coord.finish(180)
        walls[tag] = time.perf_counter() - t0
        drc, src = doomed.finish(30), survivor.finish(60)
        rep = coordinator_gates(tag, coord, rc, _records_by_id(coord.stdout()), base["chaos"],
                                Path(tmp.name) / f"{tag}.coord.json")
        c = rep["counters"]
        if drc != -signal.SIGKILL or src != 0:
            problems.append(f"{tag}: doomed exit {drc} (want SIGKILL), survivor exit {src}")
        if c.get("fleet_deaths", 0) < 1 or c.get("fleet_redispatches", 0) < 1:
            problems.append(f"{tag}: deaths {c.get('fleet_deaths')}, re-dispatches "
                            f"{c.get('fleet_redispatches')}")
        worker_gate(f"{tag}.survivor", report_of(srep))
        died = coord.first(r"missed its heartbeat deadline")
        redispatch = (died[0] - t_kill[0]) if died and t_kill else float("nan")
        log(f"fleet kill-worker: kill:fleet-worker SIGKILLed the claiming worker; death "
            f"verdict and re-dispatch {redispatch:.3f} s after its death (lease 2 s), "
            f"deaths {c.get('fleet_deaths')}, re-dispatches {c.get('fleet_redispatches')}; "
            f"records == fleetless, once; wall {walls[tag] * 1e3:.3f} ms [{card}]")

    def scenario_zombie():
        tag = "zombie-fence"
        bdir = Path(tmp.name) / f"{tag}.board"
        zrep = Path(tmp.name) / f"{tag}.zombie.json"
        zombie = spawn(f"{tag}.zombie", "--fleet-worker", "--fleet-board", str(bdir),
                       "--faults", "zombie:fleet-worker:fail=1", "--metrics-out", str(zrep))
        if not wait_registered(bdir, 1):
            problems.append(f"{tag}: the zombie never registered")
            return
        t0 = time.perf_counter()
        coord = pipe_coordinator(tag, bdir, env={"SEQALIGN_LEASE_S": "1",
                                                 "SEQALIGN_FLEET_WORKERS": "1"})
        rc = coord.finish(180)
        walls[tag] = time.perf_counter() - t0
        zrc = zombie.finish(60)
        rep = coordinator_gates(tag, coord, rc, _records_by_id(coord.stdout()), base["chaos"],
                                Path(tmp.name) / f"{tag}.coord.json")
        c = rep["counters"]
        stale = bdir / "seqalign" / "fleet" / "result" / "g0b1" / "e0"
        if zrc != 0 or c.get("fleet_deaths", 0) < 1 or c.get("fleet_redispatches", 0) < 1:
            problems.append(f"{tag}: zombie exit {zrc}, deaths {c.get('fleet_deaths')}, "
                            f"re-dispatches {c.get('fleet_redispatches')}")
        if c.get("fleet_fenced_posts", 0) < 1 and not stale.exists():
            problems.append(f"{tag}: the zombie's stale post was neither fenced nor left")
        worker_gate(f"{tag}.zombie", report_of(zrep))
        log(f"fleet zombie-fence: the zombie's stale epoch-0 post fenced "
            f"{c.get('fleet_fenced_posts', 0)} time(s) (or left on the board: "
            f"{stale.exists()}), never demuxed; records == fleetless, once; wall "
            f"{walls[tag] * 1e3:.3f} ms [{card}]")

    def scenario_coordinator_kill():
        tag = "coordinator-kill"
        bdir = Path(tmp.name) / f"{tag}.board"
        env = {"SEQALIGN_LEASE_S": "2", "SEQALIGN_FLEET_WORKERS": "1"}
        wrep = Path(tmp.name) / f"{tag}.w.json"
        worker = spawn(f"{tag}.w", "--fleet-worker", "--fleet-board", str(bdir),
                       "--metrics-out", str(wrep), env=env)
        srep = Path(tmp.name) / f"{tag}.standby.json"
        standby = spawn(f"{tag}.standby", "--fleet-standby", "--fleet-board", str(bdir),
                        "--metrics-out", str(srep), env=env)
        if not wait_registered(bdir, 1) or not standby.wait_for(r"standby watching", 90):
            problems.append(f"{tag}: the worker or the standby never came up")
            return
        t0 = time.perf_counter()
        coord = pipe_coordinator(tag, bdir, faults="kill:fleet-coordinator:fail=1,after=1",
                                 env=env)
        crc = coord.finish(120)
        t_dead = time.perf_counter()
        src = standby.finish(180)
        walls[tag] = time.perf_counter() - t0
        wrc = worker.finish(60)
        got = _records_by_id(coord.stdout(), tolerant=True)
        for rid, recs in _records_by_id(standby.stdout()).items():
            got.setdefault(rid, []).extend(recs)
        if crc != -signal.SIGKILL or src != 0 or wrc != 0:
            problems.append(f"{tag}: coordinator exit {crc} (want SIGKILL), standby {src}, "
                            f"worker {wrc}: {standby.stderr()[-1500:]}")
        if got != base["chaos"]:
            problems.append(f"{tag}: coordinator + standby records are not the fleetless "
                            "run's, each once")
        rep = report_of(srep)
        if rep["gauges"].get("fleet_leader_epoch") != 1 or rep["counters"].get(
                "fleet_takeovers", 0) != 1:
            problems.append(f"{tag}: standby report {rep['gauges'].get('fleet_leader_epoch')}"
                            f" {rep['counters'].get('fleet_takeovers')}")
        worker_gate(f"{tag}.w", report_of(wrep))
        took = standby.first(r"took over as leader gen 1")
        takeover = (took[0] - t_dead) if took else float("nan")
        left = _board_left(bdir)
        if left:
            problems.append(f"{tag}: the board kept {left} after the standby's gc_final")
        log(f"fleet coordinator-kill: the coordinator SIGKILLed at its second board poll; "
            f"the standby took over {takeover:.3f} s after its death (lease 2 s), replayed "
            f"the checkpoint, every record == fleetless, once; board swept; wall "
            f"{walls[tag] * 1e3:.3f} ms [{card}]")

    os.environ["SEQALIGN_BEACON_S"] = "60"
    try:
        # Each rank writes a report: rank 0's `hosts` section holds rank
        # 1's snapshot, which only the beacon tier's store board carries.
        jobs = {tag: launch_job(["--mesh", "2"], inputs[tag], rank_argv=lambda rank, tag=tag: [
                    "--metrics-out", str(Path(tmp.name) / f"beacon-{tag}-{rank}.json")])
                for tag in ("mixedcase.txt", "stress_small.txt", "max-size")}
    finally:
        os.environ.pop("SEQALIGN_BEACON_S")
    scenarios = (scenario_clean, scenario_kill_worker, scenario_zombie,
                 scenario_coordinator_kill)

    def guarded(fn):
        try:
            fn()
        except Exception as e:  # reported on the main thread, which fails
            problems.append(f"{fn.__name__}: {type(e).__name__}: {e}")

    t0 = time.perf_counter()
    runs = [threading.Thread(target=guarded, args=(fn,), daemon=True) for fn in scenarios]
    try:
        for t in runs:
            t.start()
        for t in runs:
            t.join(300)
        job_outs = {tag: finish_job(procs_, timeout=120) for tag, procs_ in jobs.items()}
    finally:
        for p in procs:
            p.kill()
    if any(t.is_alive() for t in runs):
        problems.append("a fleet scenario did not finish in 300 s")
    for p in procs:
        if "Traceback" in p.stderr():
            problems.append(f"{p.tag}: Traceback on stderr: {p.stderr()[-1500:]}")
    if problems:
        fail("fleet processes: " + "; ".join(problems[:6]))
    log(f"fleet processes: 4 scenarios in parallel, {len(procs)} processes on the card, "
        f"{time.perf_counter() - t0:.1f} s; walls {({k: round(v, 3) for k, v in walls.items()})} s")
    for tag, outs in job_outs.items():
        want = inputs[tag].with_suffix(".out").read_bytes()
        (rc0, out0, err0), (rc1, out1, err1) = outs
        if (rc0, rc1) != (0, 0) or out0 != want or out1 != b"" or b"missed" in err0:
            fail(f"beacon job {tag}: exits {(rc0, rc1)}, stdout == golden {out0 == want}: "
                 f"{err0.decode(errors='replace')[-800:]}{err1.decode(errors='replace')[-800:]}")
        reports = [json.loads((Path(tmp.name) / f"beacon-{tag}-{rank}.json").read_text())
                   for rank in range(2)]
        hosts = reports[0].get("hosts", {})
        rank1 = hosts.get("1", {}).get("counters", {})
        launched = {k: rank1.get(f"{k}_launches", 0) for k in ("fused_scorer", "packed_scorer")}
        if (sorted(hosts) != ["0", "1"] or rank1 != reports[1]["counters"]
                or not sum(launched.values())):
            fail(f"beacon job {tag}: rank 0's report does not hold rank 1's snapshot with "
                 f"its kernel launches (hosts {sorted(hosts)}, rank 1 counters {rank1})")
        log(f"beacon job {tag}: rank 0 == golden, rank 1 silent; rank 1's snapshot in rank "
            f"0's report over the store board, its launches {launched}")

    # -- c. a lost rank's shard rescored on cuda:0 ---------------------------
    prob = load_problem(str(inputs["max-size"]))
    want = np.array([prefix_best(prob.seq1_codes, q, prob.weights) for q in prob.seq2_codes],
                    dtype=np.int32)
    warnings: list[str] = []
    torch.cuda.synchronize()
    cs.reset_launch_counts()
    t0 = time.perf_counter()
    rows = scatter_gather_rescue(
        prob.seq1_codes, prob.seq2_codes, prob.weights, policy=policy, beacon_s=0.1,
        backend="cuda", device="cuda", board=MemoryBoard(), process_id=0, num_processes=2,
        log=warnings.append)
    rescue_wall = time.perf_counter() - t0
    rescue_counts = dict(cs.launch_counts)
    if not np.array_equal(rows, want) or not any("worker(s) [1]" in w for w in warnings):
        fail(f"rescue in process: rows == oracle {np.array_equal(rows, want)}; {warnings}")
    if rescue_counts["fused_scorer"] < 2:
        fail(f"rescue in process: launches {rescue_counts} (own shard and the orphans "
             "on the fused kernel)")
    log(f"rescue in process: rank 1 never posted; its {len(prob.seq2_codes) // 2} orphaned "
        f"max-size rows rescored on cuda:0 == the oracle; launches {rescue_counts}; wall "
        f"{rescue_wall * 1e3:.3f} ms [{card}]")
    tmp.cleanup()
    log(f"fleet phase: {time.perf_counter() - t_phase:.1f} s")
    return counts, totals, rescue_counts


def _triples(np, out_text) -> bytes:
    """The ``(score, n, k)`` rows of a CLI stdout as the native ABI's
    little-endian int32 triples."""
    rows = re.findall(r"^#\d+: score: (-?\d+), n: (-?\d+), k: (-?\d+)$", out_text, re.M)
    return np.array(rows, dtype="<i4").tobytes()


def _group_matrix(np, groups) -> bytes:
    """``native/main.cpp::build_group_matrix``: a 729-byte 0/1 blob."""
    mat = np.zeros((27, 27), dtype=np.int8)
    for group in groups:
        for a in group:
            for b in group:
                mat[ord(a) - 64, ord(b) - 64] = 1
    return mat.tobytes()


def warm_phase(np, torch, cli, cs, fixtures, inputs, card) -> dict[str, dict[str, int]]:
    """Phase 17: the warm plane and the native driver on the card.  Returns
    the launch counts of the prewarm path (its warm entries' launches in
    the populating run) and of the native path (the in-process bridge
    calls, counts set to 0 just before them)."""
    from concurrent.futures import ThreadPoolExecutor

    from mpi_openmp_cuda_tpu_torch import native_bridge
    from mpi_openmp_cuda_tpu_torch.aot.manifest import load_manifest
    from mpi_openmp_cuda_tpu_torch.aot.warmset import backend_fingerprint
    from mpi_openmp_cuda_tpu_torch.io.parse import load_problem
    from mpi_openmp_cuda_tpu_torch.models.groups import (
        CONSERVATIVE_GROUPS, SEMI_CONSERVATIVE_GROUPS)
    from mpi_openmp_cuda_tpu_torch.obs.metrics import validate_report
    from mpi_openmp_cuda_tpu_torch.ops.dispatch import plan_launches
    from mpi_openmp_cuda_tpu_torch.utils.env import platform_tag

    t_phase = time.perf_counter()
    names = ("fused_scorer", "packed_scorer")
    tmp = tempfile.TemporaryDirectory()
    cache = Path(tmp.name) / "cache"
    env = {"SEQALIGN_CACHE_DIR": str(cache)}
    manifest = cache / "aot" / f"{platform_tag('cuda')}.json"
    digest = backend_fingerprint("cuda")["digest"]
    max_in = inputs["max-size"]
    max_out = max_in.with_suffix(".out").read_text()
    shape_line = (r"prewarmed (\d+)/(\d+) launch shapes in ([\d.]+)s \(replayed (\d+), "
                  r"stale (\d+), failed (\d+)")

    # -- a. populate: a fresh process prewarms on max-size ---------------------
    report_a = Path(tmp.name) / "populate.json"
    proc = _Proc("populate", ["--prewarm", "--input", str(max_in),
                              "--metrics-out", str(report_a)], tmp.name, env)
    rc = proc.finish(300)
    if rc != 0 or proc.stdout() != max_out:
        fail(f"prewarm populate: rc {rc}, stdout == oracle {proc.stdout() == max_out}: "
             + proc.stderr()[-3000:])
    rep = json.loads(report_a.read_text())
    validate_report(rep)
    man = load_manifest(str(manifest))
    if man is None or not man["entries"]:
        fail(f"prewarm populate: no valid manifest with entries at {manifest}")
    entries = man["entries"]
    n = len(entries)
    if man["fingerprint"]["digest"] != digest or {e["fingerprint"] for e in entries} != {digest}:
        fail(f"prewarm populate: manifest digests {man['fingerprint']['digest']} / "
             f"{ {e['fingerprint'] for e in entries} }, the card's {digest}")
    c = rep["counters"]
    hit = re.search(shape_line, proc.stderr())
    if (c.get("aot.failed", 0) or c.get("aot.compiled") != n or c.get("aot.entries") != n
            or hit is None or hit.group(1, 2, 6) != (str(n), str(n), "0")):
        fail(f"prewarm populate: counters {c}, stderr {proc.stderr()[-1500:]}")
    warm = {"fused_scorer": sum(e["formulation"] == "cuda-fused" for e in entries),
            "packed_scorer": sum(e["formulation"] == "cuda-packed" for e in entries)}
    prob = load_problem(str(max_in))
    batch = dict.fromkeys(names, 0)
    for plan in plan_launches(prob.seq1_codes, prob.seq2_codes, prob.weights, "cuda")[1]:
        batch["fused_scorer" if plan.l2s is None else "packed_scorer"] += 1
    got = {name: c.get(f"{name}_launches", 0) for name in names}
    if any(got[k] != warm[k] + batch[k] for k in names) or sum(warm.values()) != n:
        fail(f"prewarm populate: report launches {got}, warm entries {warm} + the batch's "
             f"launches {batch}")
    prewarm_wall = rep["gauges"]["prewarm_wall_s"]
    shapes = sorted((e["formulation"], e["l2p"], e["l2s"], e["rows"]) for e in entries)
    log(f"prewarm populate: max-size == oracle; {n} entries, failed 0, every entry under "
        f"the card's digest {digest}; launches {got} = warm {warm} + batch {batch}; "
        f"prewarm wall {prewarm_wall:.6f} s [{card}]")
    log(f"prewarm entries (formulation, L2P, l2s, rows): {shapes}")

    # -- b. restart: --serve --prewarm answers from a replayed manifest -------
    seq1_k = load_problem(str(inputs["1024 short rows"]))
    raw = {"id": "w", "weights": list(prob.weights), "seq1": prob.seq1,
           "seq2": prob.seq2[:8] + seq1_k.seq2[:64]}
    both = Path(tmp.name) / "both.txt"
    both.write_text(" ".join(map(str, prob.weights)) + f"\n{prob.seq1}\n{len(raw['seq2'])}\n"
                    + "\n".join(raw["seq2"]) + "\n")
    rc, out, _ = run_cli(cli, ["--input", str(both)])
    want = out.decode().splitlines()
    if rc != 0 or len(want) != 72:
        fail(f"restart: the batch CLI on the request's rows: rc {rc}")

    def first_answer(tag, argv):
        report = Path(tmp.name) / f"{tag}.json"
        t0 = time.perf_counter()
        p = _Proc(tag, ["--serve", "--port", "0", "--metrics-out", str(report), *argv],
                  tmp.name, env)
        try:
            hit = p.wait_for(r"serving on 127\.0\.0\.1:(\d+)", 180)
            if hit is None:
                fail(f"restart {tag}: no port announced: " + p.stderr()[-3000:])
            t_up = hit[0]
            t_ask = time.perf_counter()
            buf = ask(int(hit[1].group(1)), raw, timeout=120)
            t_answer = time.perf_counter()
        finally:
            p.proc.send_signal(signal.SIGTERM)
            rc = p.finish(120)
        records = [json.loads(x) for x in buf.decode().splitlines() if x]
        if rc != 75 or _lines_of(records).get("w") != want or \
                {"id": "w", "done": True, "n": 72} not in records:
            fail(f"restart {tag}: rc {rc} (want 75 on SIGTERM), lines == the batch CLI "
                 f"{_lines_of(records).get('w') == want}: " + p.stderr()[-2000:])
        rep = json.loads(report.read_text())
        validate_report(rep)
        if tag.startswith("restart"):
            hit = re.search(shape_line, p.stderr())
            g = rep["gauges"]
            if hit is None or hit.group(1, 2, 4, 5, 6) != (str(n),) * 3 + ("0", "0") or \
                    g.get("serve_prewarmed") != 1 or g.get("serve_steady_compiles") != 0:
                fail(f"{tag}: prewarm line {hit and hit.group(0)}, want replayed {n}; "
                     f"gauges serve_prewarmed {g.get('serve_prewarmed')}, "
                     f"serve_steady_compiles {g.get('serve_steady_compiles')}")
            launched = {k: rep["counters"].get(f"{k}_launches", 0) for k in names}
            if min(launched.values()) < 1:
                fail(f"{tag}: the request did not run both kernels: {launched}")
        wall = rep["gauges"].get("prewarm_wall_s")
        return (f"{tag}: up {t_up - t0:.6f} s"
                + (f" (prewarm {wall:.6f} s)" if wall is not None else "")
                + f", first answer {t_answer - t0:.6f} s after "
                f"start ({t_answer - t_ask:.6f} s after the request), "
                f"serve_steady_compiles {rep['gauges'].get('serve_steady_compiles')}, "
                f"launches { {k: rep['counters'].get(f'{k}_launches', 0) for k in names} }")

    # In turns, so neither side has the host's caches to itself.
    walls = [first_answer(tag, argv) for tag, argv in (
        ("cold 1", []), ("restart 1", ["--prewarm"]), ("restart 2", ["--prewarm"]),
        ("cold 2", []))]
    log(f"restart --serve --prewarm: replayed {n}/{n}, serve_prewarmed 1 and "
        f"serve_steady_compiles 0 from tick 0, 72 lines == the batch CLI, both kernels; "
        f"without --prewarm (cold) beside it, the same build dir: {'; '.join(walls)} "
        f"[{card}]")

    # -- c. stale: another digest re-warms every entry ------------------------
    man = json.loads(manifest.read_text())
    man["fingerprint"]["digest"] = "0" * 16
    for e in man["entries"]:
        e["fingerprint"] = "0" * 16
    manifest.write_text(json.dumps(man))
    saved = os.environ.get("SEQALIGN_CACHE_DIR")
    os.environ["SEQALIGN_CACHE_DIR"] = str(cache)
    try:
        err = []
        m = len(man["entries"])
        rc, out, _ = run_cli(cli, ["--prewarm", "--stream", "64", "--input", str(max_in)],
                             err)
    finally:
        if saved is None:
            os.environ.pop("SEQALIGN_CACHE_DIR")
        else:
            os.environ["SEQALIGN_CACHE_DIR"] = saved
    hit = re.search(shape_line, err[0])
    new = load_manifest(str(manifest))
    if rc != 0 or out.decode() != max_out or hit is None or \
            hit.group(1, 2, 4, 5, 6) != (str(m), str(m), "0", str(m), "0"):
        fail(f"stale: rc {rc}, prewarm line {hit and hit.group(0)}: {err[0][-1500:]}")
    if new is None or len(new["entries"]) != m or len(new["stale"]) != m or \
            {(e["fingerprint"], e["source"]) for e in new["entries"]} != {(digest, "stale-rewarm")}:
        fail("stale: the manifest was not written back fresh as stale-rewarm")
    log(f"stale: digest rewritten -> {m}/{m} entries re-warmed as stale-rewarm and "
        f"written back under {digest}; --stream 64 max-size == oracle")

    # -- d. the native driver -------------------------------------------------
    mk = subprocess.run(["make", "final_torch"], cwd=REPO, capture_output=True, text=True,
                        timeout=300)
    if mk.returncode != 0:
        fail(f"make final_torch: {mk.stdout[-2000:]} {mk.stderr[-2000:]}")
    binary = str(REPO / "final_torch")
    base = {k: v for k, v in os.environ.items() if not k.startswith("TPU_SEQALIGN_")}
    base["TPU_SEQALIGN_PYROOT"] = str(REPO)
    jobs = [(f.name, f, f.with_suffix(".out").read_text(), {}) for f in fixtures]
    jobs.append(("max-size", max_in, max_out, {}))
    for mesh in ("4", "seq:8"):
        jobs += [(f"{f.name} mesh {mesh}", f, f.with_suffix(".out").read_text(),
                  {"TPU_SEQALIGN_MESH": mesh, "SEQALIGN_HOST_DEVICES": "8"})
                 for f in fixtures]

    def run_native(job):
        tag, path, golden, extra = job
        t0 = time.perf_counter()
        with open(path) as stdin:
            res = subprocess.run([binary], stdin=stdin, capture_output=True, text=True,
                                 env={**base, **extra}, timeout=300)
        return tag, res, golden, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=8) as pool:
        results = list(pool.map(run_native, jobs))
    for tag, res, golden, wall in results:
        if res.returncode != 0 or res.stdout != golden:
            fail(f"final_torch {tag}: rc {res.returncode}, stdout == golden "
                 f"{res.stdout == golden}: {res.stderr[-2000:]}")
    walls = {tag: round(wall, 3) for tag, _, _, wall in results}
    log(f"final_torch on the card: {len(jobs)} runs byte-identical (7 fixtures, max-size "
        f"== oracle, the fixtures under TPU_SEQALIGN_MESH=4 and seq:8 on 8 slots of the "
        f"card); walls (8 at once) {walls} s [{card}]")

    mat1 = _group_matrix(np, CONSERVATIVE_GROUPS)
    mat2 = _group_matrix(np, SEMI_CONSERVATIVE_GROUPS)
    torch.cuda.synchronize()
    cs.reset_launch_counts()
    for tag in ("max-size", "1024 short rows"):
        p = load_problem(str(inputs[tag]))
        stride = max(len(s) for s in p.seq2) + 1
        buf = b"".join(s.upper().encode().ljust(stride, b"\0") for s in p.seq2)
        t0 = time.perf_counter()
        got_bytes = native_bridge.score_strided(
            p.seq1.upper().encode(), buf, stride, len(p.seq2), mat1, mat2,
            tuple(p.weights), "auto", "", "cuda")
        wall = time.perf_counter() - t0
        if got_bytes != _triples(np, inputs[tag].with_suffix(".out").read_text()):
            fail(f"native bridge {tag}: bytes differ from the oracle's triples")
        log(f"native bridge {tag}: {len(p.seq2)} rows, one call, bytes == the oracle's "
            f"triples, wall {wall * 1e3:.3f} ms [{card}]")
    native = dict(cs.launch_counts)
    if min(native[k] for k in names) < 1:
        fail(f"native bridge: launches {native}, both kernels must run")
    with open(next(f for f in fixtures if f.name == "tiny.txt")) as stdin:
        res = subprocess.run([binary], stdin=stdin, capture_output=True, text=True,
                             env={**base, "CUDA_VISIBLE_DEVICES": ""}, timeout=300)
    if res.returncode == 0 or res.stdout or "torch_backend: error" not in res.stderr \
            or "no CUDA device" not in res.stderr:
        fail(f"final_torch without a card: rc {res.returncode}, stdout {res.stdout!r}, "
             f"stderr {res.stderr[-1000:]}")
    log(f"native bridge launches {native}; final_torch with CUDA_VISIBLE_DEVICES= and no "
        f"TPU_SEQALIGN_DEVICE: rc {res.returncode}, no stdout, its diagnostic")
    tmp.cleanup()
    log(f"warm and native phase: {time.perf_counter() - t_phase:.1f} s")
    return {"prewarm": warm, "native": native}


def check_phase(np, torch, cli, cs, compare, fixtures, inputs, card) -> dict[str, int]:
    """Phase 18: ``--check`` on the card.  (a) the fixtures, max-size,
    input3-class and the 1024 short rows through the CLI with ``--check``,
    a serve tick in this process and ``--mesh 2`` / ``--mesh seq:2`` runs
    with ``SEQALIGN_CHECK=1``: stdout == the goldens, launch counts == the
    unchecked runs', every checked launch == its plain version (a spy);
    (b) max-size's warm CLI wall with and without ``--check``; (c) one
    seeded violation a gate, each raising its subclass with no launch
    after it, and one through the CLI (rc 65, the JAX CLI's stderr shape);
    (d) the shared-memory and register audit against the card's own
    attributes.  Returns the checked runs' launch counts."""
    import dataclasses

    from mpi_openmp_cuda_tpu_torch.analysis import (
        OperandViolation, RowpackViolation, SmemBudgetError, SuperblockViolation,
        smem)
    from mpi_openmp_cuda_tpu_torch.io.parse import load_problem
    from mpi_openmp_cuda_tpu_torch.io.pipeline import ChunkPipeline
    from mpi_openmp_cuda_tpu_torch.ops import dispatch
    from mpi_openmp_cuda_tpu_torch.ops.dispatch import AlignmentScorer
    from mpi_openmp_cuda_tpu_torch.parallel.ring import RingSharding
    from mpi_openmp_cuda_tpu_torch.resilience.degrade import BackendDegrader
    from mpi_openmp_cuda_tpu_torch.resilience.policy import RetryPolicy
    from mpi_openmp_cuda_tpu_torch.serve.loop import ServeLoop, warm_kernels

    t_phase = time.perf_counter()
    dev = torch.device("cuda:0")
    tags = [f.name for f in fixtures] + ["max-size", "input3-class", "1024 short rows"]
    gold = {t: inputs[t].with_suffix(".out").read_bytes() for t in tags}
    real = {"fused_scorer": dispatch.fused_scorer, "packed_scorer": dispatch.packed_scorer}
    seen = []

    def fused(state, *finished):
        out = real["fused_scorer"](state, *finished)
        compare("fused_scorer", launch_rows(out, state, finished),
                plain_rows(cs, state, None, finished))
        seen.append("fused_scorer")
        return out

    def packed(state, l2s, *finished):
        out = real["packed_scorer"](state, l2s, *finished)
        compare("packed_scorer", launch_rows(out, state, finished),
                plain_rows(cs, state, l2s, finished))
        seen.append("packed_scorer")
        return out

    def spy(on: bool):
        if on:
            dispatch.fused_scorer, dispatch.packed_scorer = fused, packed
        else:
            dispatch.fused_scorer = real["fused_scorer"]
            dispatch.packed_scorer = real["packed_scorer"]

    def counted(fn):
        torch.cuda.synchronize()
        cs.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, dict(cs.launch_counts)

    # -- a. the CLI with --check == without, the launches == plain -----------
    check_counts = dict.fromkeys(cs.launch_counts, 0)
    for tag in tags:
        argv = ["--input", str(inputs[tag])]
        (rc0, out0, _), base = counted(lambda: run_cli(cli, argv))
        spy(True)
        try:
            seen.clear()
            (rc, out, _), got = counted(lambda: run_cli(cli, ["--check", *argv]))
        finally:
            spy(False)
        if rc0 != 0 or rc != 0 or out != gold[tag] or out0 != gold[tag]:
            fail(f"check: {tag}: rc {rc0}/{rc}, stdout differs from the golden")
        if got != base or len(seen) != sum(got.values()):
            fail(f"check: {tag}: launches {got} with --check, {base} without "
                 f"({len(seen)} spied)")
        for name, n in got.items():
            check_counts[name] += n
    log(f"check cli: {len(tags)} inputs byte-identical with --check, launches "
        f"{check_counts} == the unchecked runs', every one == plain")

    # In process with SEQALIGN_CHECK=1: a serve tick, then two meshes.
    os.environ["SEQALIGN_CHECK"] = "1"
    try:
        probs = {t: load_problem(str(inputs[t])) for t in ("max-size", "1024 short rows")}
        lines = {t: gold[t].decode().splitlines() for t in probs}
        reqs = [({"id": f"m{i}", "weights": list(probs["max-size"].weights),
                  "seq1": probs["max-size"].seq1,
                  "seq2": probs["max-size"].seq2[8 * i:8 * i + 8]},
                 _renumbered(lines["max-size"], 8 * i, 8)) for i in range(2)]
        reqs += [({"id": f"s{i}", "weights": list(probs["1024 short rows"].weights),
                   "seq1": probs["1024 short rows"].seq1,
                   "seq2": probs["1024 short rows"].seq2[64 * i:64 * i + 64]},
                  _renumbered(lines["1024 short rows"], 64 * i, 64)) for i in range(2)]

        def serve_tick(check):
            policy = RetryPolicy()
            scorer = AlignmentScorer("cuda", device="cuda", check=check)
            deg = BackendDegrader(scorer, lambda b: AlignmentScorer(b, device="cuda"))
            warm_kernels(deg)
            loop = ServeLoop(ChunkPipeline(policy, deg), policy)
            if loop.check != bool(check if check is not None else True):
                fail(f"check: the serve loop's check is {loop.check}")
            sink = _Sink()
            for raw, _ in reqs:
                loop.ingest(json.dumps(raw), sink)
            def drain():
                while loop.tick():
                    pass

            _, counts = counted(drain)
            got = _lines_of(sink.records)
            for raw, want in reqs:
                if got.get(raw["id"]) != want:
                    fail(f"check: serve request {raw['id']} differs from the batch CLI")
            return counts

        base = serve_tick(False)
        spy(True)
        try:
            seen.clear()
            got = serve_tick(None)  # SEQALIGN_CHECK=1
        finally:
            spy(False)
        if got != base or len(seen) != sum(got.values()) or min(got.values()) < 1:
            fail(f"check: serve tick launches {got} with the check, {base} without")
        for name, n in got.items():
            check_counts[name] += n
        log(f"check serve tick (SEQALIGN_CHECK=1): {len(reqs)} requests == the batch "
            f"CLI, launches {got} == unchecked, every one == plain")

        os.environ["SEQALIGN_HOST_DEVICES"] = "2"
        try:
            for mesh in ("2", "seq:2"):
                argv = ["--mesh", mesh, "--input", str(inputs["max-size"])]
                os.environ["SEQALIGN_CHECK"] = "0"
                (rc0, out0, _), base = counted(lambda: run_cli(cli, argv))
                os.environ["SEQALIGN_CHECK"] = "1"
                (rc, out, _), got = counted(lambda: run_cli(cli, argv))
                if rc0 or rc or out != gold["max-size"] or out0 != out:
                    fail(f"check: --mesh {mesh}: rc {rc0}/{rc}, stdout differs")
                if got != base or got["fused_scorer"] < 2:
                    fail(f"check: --mesh {mesh}: launches {got}, unchecked {base}")
                for name, n in got.items():
                    check_counts[name] += n
                log(f"check --mesh {mesh} (SEQALIGN_CHECK=1): max-size == golden, "
                    f"launches {got} == unchecked")
        finally:
            os.environ.pop("SEQALIGN_HOST_DEVICES", None)
    finally:
        os.environ.pop("SEQALIGN_CHECK", None)

    # -- b. the check's added wall: max-size, warm, min of five --------------
    path = str(inputs["max-size"])
    off, on = [], []
    for i in range(40):
        checked = i % 4 in (1, 2)  # off, on, on, off, ...
        rc, _, wall = run_cli(cli, (["--check"] if checked else []) + ["--input", path])
        if rc:
            fail(f"check: max-size wall run rc {rc}")
        (on if checked else off).append(wall)
    log(f"check wall max-size: off {min(off[:5]) * 1e3:.3f} ms, --check "
        f"{min(on[:5]) * 1e3:.3f} ms (min of five each; "
        f"{(min(on[:5]) - min(off[:5])) * 1e3:+.3f} ms); over {len(off)} runs each: "
        f"min {min(off) * 1e3:.3f} / {min(on) * 1e3:.3f} ms, median "
        f"{statistics.median(off) * 1e3:.3f} / {statistics.median(on) * 1e3:.3f} ms [{card}]")
    # The hook alone on the same batch: validate_plans over max-size's
    # planned launches on the card, host clock, 200 calls.
    prob = load_problem(path)
    val_flat, plans = dispatch.launch_plans(prob.seq1_codes, prob.seq2_codes, prob.weights)
    dispatch._validate(val_flat, plans, "cuda", dev)
    t0 = time.perf_counter()
    for _ in range(200):
        dispatch._validate(val_flat, plans, "cuda", dev)
    hook_ms = (time.perf_counter() - t0) / 200 * 1e3
    log(f"check hook max-size: {hook_ms:.6f} ms a batch ({len(plans)} launch "
        f"group(s), host) [{card}]")

    # -- c. one seeded violation a gate: its subclass, no launch after ------
    def seeded(what, exc, fn):
        torch.cuda.synchronize()
        cs.reset_launch_counts()
        try:
            fn()
        except exc as e:
            torch.cuda.synchronize()
            if any(cs.launch_counts.values()):
                fail(f"check: {what}: launches {cs.launch_counts} after the violation")
            log(f"check seeded {what}: {type(e).__name__}, no launch: {str(e)[:160]}")
            return
        fail(f"check: {what}: no {exc.__name__} raised")

    checked_scorer = AlignmentScorer("cuda", device=dev, check=True)
    p_short = load_problem(str(inputs["1024 short rows"]))
    p_max = load_problem(str(inputs["max-size"]))
    choose = dispatch.choose_rowpack
    dispatch.choose_rowpack = lambda l2p, lens: (8 if choose(l2p, lens) else None)
    try:
        seeded("class narrower than a live row", RowpackViolation,
               lambda: checked_scorer.score_codes(p_short.seq1_codes, p_short.seq2_codes,
                                                  p_short.weights))
        err = []
        rc, out, _ = run_cli(cli, ["--check", "--input", str(inputs["1024 short rows"])], err)
        msg = err[0].strip().splitlines()[-1] if err and err[0].strip() else ""
        if rc != 65 or out or not msg.startswith(
                "mpi_openmp_cuda_tpu_torch: error: scoring: retry budget exhausted "
                "after 1 attempts (rowpack class l2s=8"):
            fail(f"check: the CLI's seeded violation: rc {rc}, stderr {msg!r}")
        log(f"check seeded violation through the CLI: rc 65, {msg[:120]}")
    finally:
        dispatch.choose_rowpack = choose
    plans = dispatch.launch_plans

    def wide_key(*a, **k):
        val_flat, got = plans(*a, **k)
        return val_flat, [dataclasses.replace(p, keys=p.keys + (p.batch.l2p + 128,))
                          if p.l2s is None else p for p in got]

    dispatch.launch_plans = wide_key
    try:
        seeded("group key wider than its L2P", SuperblockViolation,
               lambda: checked_scorer.score_codes(p_max.seq1_codes, p_max.seq2_codes,
                                                  p_max.weights))
    finally:
        dispatch.launch_plans = plans
    rng = np.random.default_rng(18)
    ring = AlignmentScorer("cuda", device=dev, check=True,
                           sharding=RingSharding.over_devices(2, devices=[dev] * 2))
    long1 = rng.integers(1, 27, size=86000).astype(np.int8)
    long2 = rng.integers(1, 27, size=85000).astype(np.int8)
    seeded("shared memory past the card's opt-in limit (a ring window at L2P 85120)",
           SmemBudgetError, lambda: ring.score_codes(long1, [long2], [1, 1, 1, 1]))
    bad = [np.array([1, 2, 27], dtype=np.int8), *p_max.seq2_codes[:3]]
    seeded("codes >= 27", OperandViolation,
           lambda: checked_scorer.score_codes(p_max.seq1_codes, bad, p_max.weights))

    # -- d. the shared-memory and register audit, the card's own numbers ----
    budget = smem.card_budget(dev)
    limit = cs._smem_limit(dev)
    if budget != limit:
        fail(f"check: torch's shared_memory_per_block_optin {budget} != the "
             f"kernel library's {limit}")
    n, worst = smem.audit_chooser_space(budget=budget)
    drift = [l2p for l2p in range(128, smem.MAX_L2P_RING + 1, 128)
             if cs._smem_need(l2p) != smem.fused_tile_shape(l2p).smem]
    if drift:
        fail(f"check: the smem model differs from csrc's tile_shape at L2P {drift[:8]}")
    rows = smem.audit_attributes(smem.kernel_attributes())
    log(f"check smem audit: {n} configs within {budget} B a block (the card's "
        f"opt-in limit); worst {worst.describe()}; fused fits L2P <= "
        f"{smem.max_fused_l2p(budget)}; model == fused_scorer_smem at every L2P "
        f"128..{smem.MAX_L2P_RING} [{card}]")
    for r in rows:
        log(f"check kernel attributes {r['kernel']}: {r['registers']} registers "
            f"(ptxas {r['expected_registers']}, cap {r['register_cap']}), static "
            f"{r['static_bytes']} B (model {r['model_static_bytes']}), max threads "
            f"{r['max_threads']}")
    log(f"check phase: {time.perf_counter() - t_phase:.1f} s")
    return check_counts


def analysis_phase(np, torch, cli, cs, fixtures, inputs, time_ms, card) -> dict[str, int]:
    """Phase 19: the cost model, the launch audit, the build counter, the
    comms audit and the staged feed under a retry, on the card (see the
    module docstring).  Returns the launch counts of its (a) runs."""
    import warnings

    from mpi_openmp_cuda_tpu_torch.analysis import collectives, traceaudit
    from mpi_openmp_cuda_tpu_torch.analysis.costmodel import schedule_cost_sheet
    from mpi_openmp_cuda_tpu_torch.analysis.recompile import assert_compiles
    from mpi_openmp_cuda_tpu_torch.bench import DEVICE_REPS, schedule_run
    from mpi_openmp_cuda_tpu_torch.io.parse import load_problem
    from mpi_openmp_cuda_tpu_torch.io.pipeline import ChunkPipeline
    from mpi_openmp_cuda_tpu_torch.ops import dispatch
    from mpi_openmp_cuda_tpu_torch.ops.dispatch import AlignmentScorer, bucket_launches
    from mpi_openmp_cuda_tpu_torch.ops.schedule import fused_schedule_config, launch_configs
    from mpi_openmp_cuda_tpu_torch.resilience.degrade import BackendDegrader
    from mpi_openmp_cuda_tpu_torch.resilience.policy import RetryPolicy
    from mpi_openmp_cuda_tpu_torch.serve.loop import ServeLoop, warm_kernels

    t_phase = time.perf_counter()
    dev = torch.device("cuda:0")
    big = ["max-size", "input3-class", "1024 short rows"]
    tags = [f.name for f in fixtures] + big
    gold = {t: inputs[t].with_suffix(".out").read_bytes() for t in tags}
    probs = {t: load_problem(str(inputs[t])) for t in tags}

    def counted(fn):
        torch.cuda.synchronize()
        cs.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, dict(cs.launch_counts)

    # -- a. launches on the card == the planner's declaration ---------------
    total = dict.fromkeys(cs.launch_counts, 0)
    for tag in tags:
        (rc, out, _), got = counted(lambda: run_cli(cli, ["--input", str(inputs[tag])]))
        want = fused_schedule_config(probs[tag]).declared_launches
        if rc != 0 or out != gold[tag]:
            fail(f"analysis: {tag}: rc {rc}, stdout differs from the golden")
        if got != want:
            fail(f"analysis: {tag}: the card launched {got}, the planner declares {want}")
        for name, n in got.items():
            total[name] += n
        if tag in big:
            # The traced dispatch raises ScheduleDriftError off the declaration.
            rep = traceaudit.audit_schedule(probs[tag], device=dev)
            if rep["findings"]:
                fail(f"analysis: {tag}: launch audit findings on the card {rep['findings']}")
            log(f"analysis launch audit {tag}: {rep['launches_by_kernel']}, "
                f"{rep['epilogues']} epilogue, {rep['host_fetches']} host fetch, operands "
                f"{[(r['name'], r['dtype'], r['bytes']) for r in rep['operands']][:8]}")
    log(f"analysis launches: {len(tags)} inputs, the card's launch_counts deltas == "
        f"declared_launches on every one (total {total}), stdout == the goldens")

    # -- b. the cost sheet against the card (diagnostic) ---------------------
    for tag in tags:
        prob = probs[tag]
        sheet = schedule_cost_sheet(prob)
        launches = bucket_launches(prob.seq1_codes, prob.seq2_codes, prob.weights, dev)
        if sheet["totals"] is None or sheet["totals"]["launches"] != len(launches):
            fail(f"analysis: {tag}: the sheet prices {sheet['totals']} launches, the card "
                 f"makes {len(launches)}")
        if not launches:
            continue
        rows = []
        for row, launch in zip(sheet["buckets"], launches):
            st = launch.state
            kern = ((lambda st=st: cs.fused_scorer(st)) if launch.l2s is None
                    else (lambda st=st, l2s=launch.l2s: cs.packed_scorer(st, l2s)))
            ms = time_ms(kern, reps=50)
            rows.append(f"{row['kernel']} L2P {row['l2p']} rows {row['rows']}: model "
                        f"{row['model_kernel_us']:.3f} us [{row['model']}], card "
                        f"{ms * 1e3:.3f} us ({row['model_kernel_us'] / (ms * 1e3):.3f})")
        wall_us = time_ms(schedule_run(launches), DEVICE_REPS) * 1e3
        pred = sheet["totals"]["predicted_wall_us"]
        log(f"analysis sheet {tag}: {'; '.join(rows)}; predicted_wall_us {pred:.3f} / "
            f"device_wall_us {wall_us:.3f} = {pred / wall_us:.3f} [{card}]")

    # -- c. no build in steady state -----------------------------------------
    for tag in tags:
        argv = ["--input", str(inputs[tag])]
        with assert_compiles(0):
            rc, out, _ = run_cli(cli, argv)
        if rc or out != gold[tag]:
            fail(f"analysis: warm {tag}: rc {rc}, stdout differs")
    pm, ps = probs["max-size"], probs["1024 short rows"]
    reqs = [{"id": "m0", "weights": list(pm.weights), "seq1": pm.seq1, "seq2": pm.seq2[:8]},
            {"id": "s0", "weights": list(ps.weights), "seq1": ps.seq1, "seq2": ps.seq2[:64]}]
    policy = RetryPolicy()
    deg = BackendDegrader(AlignmentScorer("cuda", device="cuda"),
                          lambda b: AlignmentScorer(b, device="cuda"))
    warm_kernels(deg)
    loop = ServeLoop(ChunkPipeline(policy, deg), policy)
    sink = _Sink()
    for raw in reqs:
        loop.ingest(json.dumps(raw), sink)
    with assert_compiles(0):
        while loop.tick():
            pass
    got = _lines_of(sink.records)
    want_lines = {"m0": gold["max-size"].decode().splitlines()[:8],
                  "s0": gold["1024 short rows"].decode().splitlines()[:64]}
    if got != want_lines:
        fail("analysis: the serve tick's lines differ from the batch CLI's")
    os.environ["SEQALIGN_HOST_DEVICES"] = "2"
    try:
        for mesh in ("2", "seq:2"):
            argv = ["--mesh", mesh, "--input", str(inputs["max-size"])]
            run_cli(cli, argv)  # warm
            with assert_compiles(0):
                rc, out, _ = run_cli(cli, argv)
            if rc or out != gold["max-size"]:
                fail(f"analysis: --mesh {mesh}: rc {rc}, stdout differs")
    finally:
        os.environ.pop("SEQALIGN_HOST_DEVICES", None)
    log(f"analysis builds: 0 in steady state over {len(tags)} warm CLI runs, a serve "
        "tick (8 max-size + 64 short rows), --mesh 2 and --mesh seq:2")

    # -- d. the comms audit's forms on [cuda:0] x 4 == the CPU golden ---------
    golden = json.loads((REPO / "tests" / "golden" / "torch_comms_audit.json").read_text())
    want_log = {e["spec"]: e["log"] for e in golden["entries"]}
    for spec in ("2x2", "seq:4"):
        cpu_sh, cpu_rows, _ = collectives.run_spec(spec, [torch.device("cpu")] * 4)
        sh, rows, calls = collectives.run_spec(spec, [dev] * 4, device="cuda")
        comm = sh.comm
        got_log = [[k, e] for k, e in comm.log]
        seqs = {s: comm.slot_log.get(s) for s in comm.local_slots()}
        placed = collectives.operand_placement(spec, calls, sh.mesh, comm.local_slots())
        if got_log != want_log[spec] or len({json.dumps(v) for v in seqs.values()}) != 1:
            fail(f"analysis: comms {spec} on the card: log {got_log} != golden "
                 f"{want_log[spec]} or slots differ")
        if placed or not np.array_equal(rows, cpu_rows):
            fail(f"analysis: comms {spec}: placement {placed}, rows differ from the CPU's")
        log(f"analysis comms {spec} on [cuda:0] x 4: comm.log == the CPU golden "
            f"({len(got_log)} calls, {dict(comm.counts)}), slots equal, operands placed")

    # -- e. the staged feed under a retry --------------------------------------
    uploads = []
    real_upload = dispatch._upload

    def counted_upload(val_flat, plans, device, ring):
        uploads.append(len(plans))
        return real_upload(val_flat, plans, device, ring)

    os.environ["TPU_SEQALIGN_FEED_OVERLAP"] = "1"
    dispatch._upload = counted_upload
    try:
        for tag, stream in (("max-size", None), ("1024 short rows", 16)):
            prob = probs[tag]
            report = inputs[tag].with_suffix(".retry.json")
            argv = (["--stream", str(stream)] if stream else []) + [
                "--retries", "1", "--faults", "chunk_scoring:fail=1",
                "--metrics-out", str(report), "--input", str(inputs[tag])]
            uploads.clear()
            rc, out, _ = run_cli(cli, argv)
            c = json.loads(report.read_text())["counters"]
            chunks = ([prob.seq2_codes] if not stream else
                      [prob.seq2_codes[i:i + stream]
                       for i in range(0, len(prob.seq2_codes), stream)])
            first = sum(len(launch_configs(prob.seq1_codes, ch, prob.weights))
                        for ch in chunks)
            staged, hits = c.get("feed_prestages", 0), c.get("feed_prestage_hits", 0)
            if rc or out != gold[tag]:
                fail(f"analysis: staged feed under a retry, {tag}: rc {rc}, stdout differs")
            if staged != len(chunks) or hits != first or len(uploads) != staged + 1:
                fail(f"analysis: staged feed under a retry, {tag}: {staged} feeds staged "
                     f"for {len(chunks)} chunks, {hits} hits (first attempts' launches "
                     f"{first}), {len(uploads)} uploads (want {staged + 1})")
            log(f"analysis staged feed under a retry, {tag}{f' --stream {stream}' if stream else ''}: "
                f"stdout == golden, {staged} feeds, {hits} hits == the first attempts' "
                f"launches, {len(uploads)} uploads (the retried chunk re-uploaded)")
    finally:
        dispatch._upload = real_upload
        os.environ.pop("TPU_SEQALIGN_FEED_OVERLAP", None)

    # -- the synchronising calls between a batch's first launch and its copy --
    for tag in big:
        prob = probs[tag]
        run = schedule_run(bucket_launches(prob.seq1_codes, prob.seq2_codes, prob.weights,
                                           dev))
        run()
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                run()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        # The mode's own notice ("... is a prototype feature ...") is no sync.
        syncs = [str(w.message).splitlines()[0][:100] for w in caught
                 if "synchroniz" in str(w.message) and "prototype" not in str(w.message)]
        log(f"analysis sync debug {tag}: {len(syncs)} synchronising call(s) between the "
            f"first launch and the epilogue copy {syncs[:4]}")
    log(f"analysis phase: {time.perf_counter() - t_phase:.1f} s")
    return total


def _files_under(root: Path) -> set[str]:
    """Every file and directory under ``root``."""
    out = set()
    for d, dirs, files in os.walk(root):
        out.update(os.path.join(d, n) for n in dirs + files)
    return out


def installed_phase(cli, cs, inputs, prefix_best, card) -> dict[str, int]:
    """Phase 20: the port as a user installs it, on the card (see the
    module docstring).  Returns the launch counts of its runs of the
    fixtures and max-size, summed from their run reports."""
    import shutil
    import sysconfig
    from concurrent.futures import ThreadPoolExecutor

    from mpi_openmp_cuda_tpu_torch.io.parse import load_problem
    from mpi_openmp_cuda_tpu_torch.obs.metrics import validate_report
    from mpi_openmp_cuda_tpu_torch.ops import _build

    names = ("fused_scorer", "packed_scorer")
    pip = ("--no-index", "--no-deps", "--no-build-isolation", "-q")
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)

    # -- a. a wheel from a copy of the checkout, installed into a venv --------
    t0 = time.perf_counter()
    src = root / "src"
    src.mkdir()
    for name in ("pyproject.toml", "README.md"):
        shutil.copy(REPO / name, src)
    for name in ("mpi_openmp_cuda_tpu", PKG):
        shutil.copytree(REPO / name, src / name, ignore=shutil.ignore_patterns("__pycache__"))
    subprocess.run([sys.executable, "-m", "pip", "wheel", *pip, "-w", str(root / "dist"),
                    str(src)], check=True, timeout=600)
    wheel = next((root / "dist").glob("*.whl"))
    t_wheel = time.perf_counter() - t0
    venv = root / "venv"
    subprocess.run([sys.executable, "-m", "venv", str(venv)], check=True, timeout=300)
    site = next((venv / "lib").glob("python*/site-packages"))
    # Chained to this interpreter's packages (torch, numpy): the card's
    # host has no network, so no dependency is resolved.
    live = {sysconfig.get_paths()[k] for k in ("purelib", "platlib")}
    (site / "chain.pth").write_text("".join(f"{p}\n" for p in sorted(live)))
    subprocess.run([str(venv / "bin" / "pip"), "install", *pip, str(wheel)], check=True,
                   timeout=600)
    installed = _files_under(site)
    log(f"installed: {wheel.name} built in {t_wheel:.3f} s, installed into a venv in "
        f"{time.perf_counter() - t0 - t_wheel:.3f} s")

    cache = root / "cache"  # a fresh cache home: the first build is cold
    foreign = root / "elsewhere"
    foreign.mkdir()
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "TPU_SEQALIGN_COMPILE_CACHE")}
    env["SEQALIGN_CACHE_DIR"] = str(cache)
    script = str(venv / "bin" / "tpu-seqalign-torch")

    def checkout_run(path):
        """The checkout's stdout and launch counts for ``path``, in this
        process."""
        cs.reset_launch_counts()
        rc, out, _ = run_cli(cli, ["--input", str(path)])
        if rc != 0:
            fail(f"installed: the checkout's CLI on {path.name}: rc {rc}")
        return out, dict(cs.launch_counts)

    def installed_run(tag, cmd, path, want, home=cache):
        """One installed CLI process from the foreign directory, its cache
        home ``home``, under ``--profile --metrics-out``: stdout ==
        ``want[0]``, the report's launches == ``want[1]``; returns (wall s,
        report counters, stderr)."""
        report = root / f"{tag}.json"
        t = time.perf_counter()
        with open(path, "rb") as fh:
            proc = subprocess.run([*cmd, "--profile", "--metrics-out", str(report)],
                                  stdin=fh, capture_output=True, cwd=foreign,
                                  env={**env, "SEQALIGN_CACHE_DIR": str(home)}, timeout=600)
        wall = time.perf_counter() - t
        err = proc.stderr.decode(errors="replace")
        if proc.returncode != 0 or proc.stdout != want[0]:
            fail(f"installed {tag}: rc {proc.returncode}, stdout == the checkout's "
                 f"{proc.stdout == want[0]}: {err[-3000:]}")
        rep = json.loads(report.read_text())
        validate_report(rep)
        c = rep["counters"]
        got = {name: c.get(f"{name}_launches", 0) for name in names}
        if got != want[1]:
            fail(f"installed {tag}: launches {got}, the checkout's {want[1]}")
        return wall, c, err

    # -- b. the first use: both kernels built into the fresh cache home --------
    prob = load_problem(str(inputs["max-size"]))
    short = load_problem(str(inputs["1024 short rows"]))
    both = root / "both.txt"
    seqs = prob.seq2[:8] + short.seq2[:64]
    both.write_text(" ".join(map(str, prob.weights)) + f"\n{prob.seq1}\n{len(seqs)}\n"
                    + "\n".join(seqs) + "\n")
    want_both = checkout_run(both)
    oracle = "".join(
        f"#{i}: score: {s}, n: {n}, k: {k}\n" for i, (s, n, k) in enumerate(
            prefix_best(prob.seq1_codes, q, prob.weights)
            for q in prob.seq2_codes[:8] + short.seq2_codes[:64]))
    if want_both[0].decode() != oracle or min(want_both[1].values()) < 1:
        fail(f"installed: the checkout's CLI on both.txt: == oracle "
             f"{want_both[0].decode() == oracle}, launches {want_both[1]}")
    cold, c_cold, err_cold = installed_run("cold", [script], both, want_both)
    built = {name: cache / "torch_kernels" / _build._target(name).name for name in names}
    if c_cold.get("recompiles") != 2 or not all(p.exists() for p in built.values()):
        fail(f"installed cold: recompiles {c_cold.get('recompiles')}, libraries "
             f"{ {n: p.exists() for n, p in built.items()} } under {cache / 'torch_kernels'}")
    line = f"kernels {', '.join(names)} in {cache / 'torch_kernels'}"
    if line not in err_cold:
        fail(f"installed cold: stderr does not name the build directory: {err_cold[-1500:]}")
    warm, c_warm, _ = installed_run("warm", [script], both, want_both)
    if c_warm.get("recompiles", 0):
        fail(f"installed warm: a second run built {c_warm['recompiles']} kernels")
    log(f"installed: first use on 8 max-size + 64 short rows ({want_both[1]}): cold run "
        f"{cold:.3f} s (2 nvcc builds, each at its kernel's first launch, into "
        f"{cache / 'torch_kernels'}), warm run {warm:.3f} s, first-use build "
        f"{cold - warm:.3f} s [{card}]")

    # Two cold processes at once on one more fresh cache home: one builds
    # each kernel under the build lock, the other waits and loads it.
    shared = root / "shared-cache"
    with ThreadPoolExecutor(2) as pool:
        pair = list(pool.map(lambda i: installed_run(f"shared-{i}", [script], both, want_both,
                                                     shared), range(2)))
    if sum(c.get("recompiles", 0) for _, c, _ in pair) != 2:
        fail(f"installed: two cold processes on one cache home built "
             f"{[c.get('recompiles', 0) for _, c, _ in pair]} kernels, not 2 in all")
    log(f"installed: two cold processes at once on one fresh cache home, both == the "
        f"checkout's; recompiles {[c.get('recompiles', 0) for _, c, _ in pair]}, walls "
        f"{[round(w, 3) for w, _, _ in pair]} s [{card}]")

    # -- c. the fixtures and max-size from the foreign directory ---------------
    runs = {path.stem: ([script], path) for path in sorted(inputs.values())
            if path.parent == REPO / "tests" / "fixtures"}
    runs["max-size"] = ([script], inputs["max-size"])
    runs["module mixedcase"] = ([str(venv / "bin" / "python"), "-m", PKG],
                                inputs["mixedcase.txt"])
    wants = {tag: checkout_run(path) for tag, (_, path) in runs.items()}
    for tag, (_, path) in runs.items():
        golden = path.with_suffix(".out").read_bytes()
        if wants[tag][0] != golden:
            fail(f"installed: the checkout's CLI on {tag} differs from its golden")
    # README "Library", the port's example, run as written.
    readme = ("import mpi_openmp_cuda_tpu_torch as pkg\n"
              "scorer = pkg.AlignmentScorer('auto', sharding=pkg.BatchSharding.over_devices())\n"
              "print(scorer.score('HELLOWORLD', ['OWRL'], [10, 2, 3, 4]).tolist())\n")
    with ThreadPoolExecutor(4) as pool:
        library = pool.submit(subprocess.run, [str(venv / "bin" / "python"), "-c", readme],
                              capture_output=True, text=True, cwd=foreign, env=env,
                              timeout=600)
        done = dict(zip(runs, pool.map(
            lambda tag: installed_run(tag.replace(" ", "-"), runs[tag][0], runs[tag][1],
                                      wants[tag]), runs)))
        lib = library.result()
    if lib.returncode != 0 or lib.stdout != "[[40, 4, 2]]\n":
        fail(f"installed: the README library example: rc {lib.returncode}, stdout "
             f"{lib.stdout!r}: {lib.stderr[-2000:]}")
    counts = dict.fromkeys(names, 0)
    for tag, (wall, c, _) in done.items():
        if c.get("recompiles", 0):
            fail(f"installed {tag}: built {c['recompiles']} kernels after the first use")
        if tag != "module mixedcase":
            for name in names:
                counts[name] += wants[tag][1][name]
    new = sorted(_files_under(site) - installed)
    if new:
        fail(f"installed: the runs wrote under site-packages: {new[:10]}")
    log(f"installed: {len(runs)} runs (tpu-seqalign-torch on the 7 fixtures and max-size, "
        f"python -m on mixedcase) == their goldens, launches == the checkout's, 0 builds, "
        f"the README library example [[40, 4, 2]] on cuda, "
        f"nothing written under site-packages; launches {counts}; walls "
        f"{ {tag: round(w, 3) for tag, (w, _, _) in done.items()} } s [{card}]")
    tmp.cleanup()
    return counts


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
    abl = load_script("torch_kernel_ablate")
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
    check_route_fields(rec, "cuda")
    counts = rec["kernel_launches"]
    for name in ("fused_scorer", "issue_probe"):
        if not counts.get(name, 0) > 0:
            fail(f"the bench path never launched {name}")
    log(f"bench: {rec['launches']} launches per scoring run; launches in the "
        f"whole bench run (warm-ups, timed repeats and probes included): {counts}")
    return counts


def check_route_fields(rec: dict, route: str) -> None:
    """A bench record at one route: ``formulation`` names it, and the
    kernel floor, bound and single-program fields are all set on
    ``cuda``, all null on ``gather``."""
    from mpi_openmp_cuda_tpu_torch.bench import BOUND_KEYS, FLOOR_KEYS, SINGLE_PROGRAM_KEYS

    keys = FLOOR_KEYS + BOUND_KEYS + SINGLE_PROGRAM_KEYS
    unset = [k for k in keys if rec.get(k) is None]
    want_unset = [] if route == "cuda" else list(keys)
    if rec.get("formulation") != route or unset != want_unset or any(
            rec.get(k) is None for k in ("device_wall_us", "value")):
        fail(f"bench record of {rec.get('metric')!r}: formulation "
             f"{rec.get('formulation')!r}, null fields {unset}; want {route!r} with "
             f"null fields {want_unset}")


def scripts_phase(card) -> None:
    """Phase 21: the conformance check, the bench table's input3-class and
    gather rows and the stream bench, each in a process of its own."""
    from mpi_openmp_cuda_tpu_torch.obs.metrics import validate_report

    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("BENCH_", "STREAM_BENCH_", "TORCH_CONFORMANCE_"))}

    def script(name, *args, extra=None, timeout=600):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(REPO / "scripts" / f"{name}.py"), *args],
                              cwd=REPO, env={**env, **(extra or {})}, capture_output=True,
                              text=True, timeout=timeout)
        wall = time.perf_counter() - t0
        for line in (proc.stdout + proc.stderr).splitlines():
            if line.strip():
                log(f"{name}: {line}")
        if proc.returncode != 0:
            fail(f"scripts/{name}.py exited {proc.returncode}")
        log(f"{name}: exit 0 in {wall:.1f} s [{card}]")
        return proc.stdout.splitlines()

    # -- a. the conformance check, in full ------------------------------------
    script("torch_conformance")

    # -- b. the bench table's input3-class and gather rows ---------------------
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "records.ndjson"
        script("torch_bench_table", "--procs", "2", "--rows", "input3-class,gather",
               "--records", str(path), extra={"BENCH_REPS": "2", "BENCH_ATTEMPTS": "2"})
        lines = path.read_text().splitlines()
    if len(lines) != 4:
        fail(f"the bench table recorded {len(lines)} bench records, want 4")
    for line in lines:
        rec = json.loads(line)
        validate_report(rec)
        check_route_fields(rec, "gather" if "+w=1000000,1,1,1" in rec["metric"] else "cuda")
    log("bench table: 2 input3-class records read cuda with every field set, 2 at "
        "1000000,1,1,1 read gather with null kernel floor, bound and single-program fields")

    # -- c. the stream bench, one round ----------------------------------------
    out = script("torch_stream_bench", extra={"STREAM_BENCH_ROUNDS": "1"})
    rec = json.loads(out[-1])
    modes = sorted(rec.get("e2e_s", {}))
    if modes != ["batch", "stream", "stream+journal"] or not all(
            v > 0 for v in rec["e2e_s"].values()) or rec.get("rounds") != 1:
        fail(f"the stream bench's record: {rec}")
    log(f"stream bench: stream/batch {rec['stream_vs_batch']:.4f}, journal/stream "
        f"{rec['journal_vs_stream']:.4f} over one round [{card}]")



def drills_phase(card) -> dict[str, int]:
    """Phase 22: the six serve and fleet drills at full size, each in a
    process of its own.  Returns the scorers' launches summed over the
    drills' records (each read from the drill's own run reports)."""
    t_phase = time.perf_counter()
    total = {"fused_scorer": 0, "packed_scorer": 0}
    records = {}
    with tempfile.TemporaryDirectory() as tmp:
        env = {**os.environ, "TMPDIR": tmp}
        for group in DRILL_GROUPS:
            t0 = time.perf_counter()
            procs, walls = {}, {}
            for name in group:
                out = open(Path(tmp) / f"{name}.out", "w+")
                procs[name] = (subprocess.Popen(
                    [sys.executable, str(REPO / "scripts" / f"torch_{name}.py")], cwd=REPO,
                    env=env, stdout=out, stderr=subprocess.STDOUT, text=True), out)
            while len(walls) < len(procs):
                if time.perf_counter() - t0 > DRILL_TIMEOUT_S:
                    for proc, _ in procs.values():
                        proc.kill()
                    fail(f"drills {sorted(set(procs) - set(walls))} still running after "
                         f"{DRILL_TIMEOUT_S} s")
                for name, (proc, _) in procs.items():
                    if name not in walls and proc.poll() is not None:
                        walls[name] = time.perf_counter() - t0
                time.sleep(0.1)
            for name, (proc, out) in procs.items():
                out.seek(0)
                lines = out.read().splitlines()
                out.close()
                for line in lines:
                    if line.strip():
                        log(f"{name}: {line}")
                if proc.returncode != 0:
                    fail(f"scripts/torch_{name}.py exited {proc.returncode}")
                rec = json.loads(next(x for x in reversed(lines) if x.startswith("{")))
                bad = {k: v for k, v in rec.get("scenarios", {}).items() if v != "ok"}
                if not rec.get("scenarios") or bad or rec.get("device") != "cuda":
                    fail(f"torch_{name}: record {rec}")
                for k in total:
                    total[k] += rec["launches"][k]
                records[name] = rec
                log(f"{name}: exit 0, {len(rec['scenarios'])} scenarios ok, launches "
                    f"{rec['launches']}, wall {walls[name]:.1f} s [{card}]")
    load = records["load_smoke"]
    log(f"load smoke: plateau {load['plateau_rps']:.3f} req/s (p99 latency "
        f"{load['plateau_p99_latency_s']} s); 2x {load['2x']['goodput_rps']:.3f} req/s of "
        f"{load['2x']['rate_rps']:.3f} offered (p99 {load['2x']['p99_latency_s']} s); 5x "
        f"{load['5x']['goodput_rps']:.3f} of {load['5x']['rate_rps']:.3f} (p99 "
        f"{load['5x']['p99_latency_s']} s); refit scale {load['refit']['scale']:.6g}, "
        f"budget {load['refit']['budget_s']:.6g} s; p99 queue wait b1 "
        f"{load['replay']['b1_p99_queue_wait_s']} s, b2 "
        f"{load['replay']['b2_p99_queue_wait_s']} s [{card}]")
    if not all(total.values()):
        fail(f"the drills launched {total}: both scorers must launch")
    log(f"drills phase: {time.perf_counter() - t_phase:.1f} s, launches {total} [{card}]")
    return total

if __name__ == "__main__":
    sys.exit(main())
