"""Batch CLI: ``python -m mpi_openmp_cuda_tpu_torch < input.txt``.

Parse stdin (or ``--input``), score every Seq2 with ``AlignmentScorer``
on the chosen device, and print ``#i: score: S, n: N, k: K`` per Seq2 on
stdout.  Diagnostics go to stderr; on any failure nothing reaches stdout.
The port of ``mpi_openmp_cuda_tpu/io/cli.py``'s batch path, its serve
plane (``--serve``, ``--port``, ``--telemetry-port``: ``serve/loop.py``)
its elastic serve fleet (``--fleet-board``, ``--fleet-worker``,
``--fleet-standby``: ``serve/fleet.py``) and its warm plane
(``--prewarm``: ``aot/``):
``--stream`` (chunked, pipelined), ``--journal``/``--resume``,
``--retries``, ``--faults``, ``--degrade``, ``--deadline``,
``--selfcheck``, the drain on SIGTERM/SIGINT (or ``SEQALIGN_DRAIN=1``),
the obs plane (``--metrics``, ``--metrics-out``, ``--heartbeat``,
``--profile``, ``--trace`` and ``--trace-out``), and several devices:
``--mesh`` (batch sharding, the Seq1 ring, both) and ``--distributed``
(one process a device, torchrun's environment; only rank 0 reads the
input and prints, the other ranks feed from its broadcasts and print
nothing; with ``SEQALIGN_BEACON_S`` set and no ``--journal``, the
lost-shard rescue tier instead: a dead rank's shard is rescored on rank
0).

Exit codes: 0 ok; 2 a usage error argparse rejects (an unknown flag, a
bad value; the usage text goes to stderr, as in the JAX CLI); 64 a
rejected flag combination or a malformed ``--faults`` spec; 65 fatal (bad
input, weights outside the int32 gate, no CUDA device without ``--device cpu``,
a kernel that fails to build or launch without ``--degrade``, a journal
of another problem, an exhausted retry budget, a mesh larger than the
devices there are); 75 resumable (a drain,
or a failure rooted in a watchdog deadline: rerun, with ``--resume``
under ``--journal``); 1 when the reader of stdout went away.  With
``--metrics-out`` / ``--trace-out`` the run report and the trace are
written on every exit path, the exit code inside; a fatal exit also
dumps the flight recorder.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import signal
import sys
import threading

import numpy as np

from ..analysis import SeqcheckError
from ..obs import arm_observability, disarm_observability
from ..obs import export as obs_export
from ..obs import flightrec as obs_flightrec
from ..obs import trace as obs_trace
from ..obs.events import log_line
from ..obs.metrics import gauge as obs_gauge
from ..obs.spans import activate_spans, deactivate_spans
from ..obs.spans import span as obs_span
from ..obs.spans import span_beside
from ..ops import _build
from ..ops.dispatch import AlignmentScorer
from ..resilience.degrade import BackendDegrader, run_degrading, verify_rows_against_oracle
from ..resilience.drain import DrainInterrupt, drain_guard, drain_requested
from ..resilience.faults import activate_faults, deactivate_faults, parse_spec
from ..resilience.policy import RetryPolicy
from ..resilience.watchdog import DeadlineExpiredError, activate_watchdog, deactivate_watchdog
from ..utils.env import env_flag, env_float, env_int, env_str
from ..utils.profiling import PhaseTimer, device_trace
from .parse import load_problem, open_input, parse_stream_header
from .pipeline import ChunkPipeline, FeedStager, PendingWindow, count_stream
from .printer import guarded_stdout, print_results, write_json_sidecar

EX_OK = 0
EX_ARGPARSE = 2  # argparse's own usage error
EX_USAGE = 64
EX_FATAL = 65
EX_TEMPFAIL = 75

PROG = "mpi_openmp_cuda_tpu_torch"


class _Usr2Dumper:
    """The helper thread that dumps the flight recorder for SIGUSR2.

    The handler runs on the main thread between two bytecodes, possibly
    inside ``FlightRecorder.record_event`` with the recorder's lock held
    (a plain lock: taking it again there would hang the process).  So
    the handler only counts a request and wakes this thread, which dumps
    once the main thread lets go of the lock.  :meth:`stop` dumps what
    is still pending, then ends the thread."""

    def __init__(self):
        self._wake = threading.Event()
        self._requests = 0
        self._done = 0
        self._stopping = False
        self._thread = threading.Thread(target=self._loop, name="seqalign-usr2-dump",
                                        daemon=True)
        self._thread.start()

    def request(self) -> None:
        """Signal-handler safe: a counter and one wake-up."""
        self._requests += 1
        self._wake.set()

    def _loop(self) -> None:
        while True:
            self._wake.wait()
            self._wake.clear()
            while self._done < self._requests:
                self._done += 1
                obs_flightrec.dump_active("sigusr2")
            if self._stopping:
                return

    def stop(self) -> None:
        self._stopping = True
        self._wake.set()
        self._thread.join()


_usr2: _Usr2Dumper | None = None  # the run's dumper while SIGUSR2 is ours


def _sigusr2_dump(signum, frame) -> threading.Thread | None:
    """SIGUSR2 dumps the flight recorder without stopping the run
    (registered only while the obs plane is armed), never on the thread
    the signal interrupted (:class:`_Usr2Dumper`).  Called with no run
    dumper (a direct call), it dumps on a thread of its own, returned."""
    dumper = _usr2
    if dumper is not None:
        dumper.request()
        return None
    helper = threading.Thread(target=obs_flightrec.dump_active, args=("sigusr2",),
                              name="seqalign-usr2-dump", daemon=True)
    helper.start()
    return helper


def _typed(cast, ok, want):
    def parse(text: str):
        value = cast(text)
        if not ok(value):
            raise argparse.ArgumentTypeError(f"must be {want}, got {value}")
        return value

    return parse


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=PROG,
        description="Batch sequence-alignment scorer on PyTorch + CUDA "
        "(stdin/stdout contract of the MPI+OpenMP+CUDA reference).",
    )
    p.add_argument("--input", default=None, help="input file (default: stdin)")
    p.add_argument(
        "--backend",
        choices=("auto", "cuda", "mm", "gather", "oracle"),
        default="auto",
        help="compute path (default auto = cuda: the Hopper kernels, or "
        "their plain PyTorch versions on --device cpu); mm = one-hot fp32 "
        "matmul, gather = int32 gather (PyTorch on the device); oracle = "
        "host numpy",
    )
    p.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="device to score on (default cuda; cpu only when asked for)",
    )
    p.add_argument(
        "--mesh", default=None,
        help="device mesh: 'N' or 'batch:N' shards the Seq2 batch over N "
        "devices (data parallel); 'seq:N' ring-shards Seq1 over N devices "
        "(sequence/context parallel, past the reference's length caps); "
        "'DxS' composes both on a 2-D mesh (default: one device).  On "
        "--device cpu the host counts as SEQALIGN_HOST_DEVICES devices",
    )
    p.add_argument(
        "--distributed", action="store_true",
        help="join a multi-process job first (torch.distributed, from "
        "torchrun's MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK): "
        "each process drives its local slots (its share of the cards, or "
        "SEQALIGN_HOST_DEVICES of them), rank 0 reads the input and prints; "
        "without --mesh the batch is sharded over every global slot",
    )
    p.add_argument("--json", default=None, metavar="PATH",
                   help="also write results as a JSON sidecar file")
    p.add_argument(
        "--journal", default=None, metavar="PATH",
        help="per-sequence result journal: a rerun on the same input "
        "resumes from the first unscored sequence (the JAX CLI's format)",
    )
    p.add_argument(
        "--resume", action="store_true",
        help="assert that the --journal file exists and resume from it",
    )
    p.add_argument(
        "--stream", type=_typed(int, lambda v: v >= 1, ">= 1"), default=None,
        metavar="CHUNK",
        help="pipelined mode: parse and score CHUNK sequences at a time with "
        "a window of chunks in flight (TPU_SEQALIGN_STREAM_DEPTH, default "
        "4); output identical, printed after the whole stream succeeds",
    )
    p.add_argument(
        "--retries", type=_typed(int, lambda v: v >= 0, ">= 0"), default=0,
        metavar="N", help="retry a transient device failure up to N times",
    )
    p.add_argument(
        "--faults", default=None, metavar="SPEC",
        help="deterministic fault injection: 'site:fail=N[,after=M]"
        "[,kind=transient|fatal]' entries joined by ';' (SEQALIGN_FAULTS "
        "when absent); sites in resilience/faults.py",
    )
    p.add_argument(
        "--degrade", action="store_true",
        help="when a backend exhausts its retries or cannot run its kernel, "
        "fall down the chain cuda -> mm -> gather with a warning, the first "
        "degraded chunk re-verified against the host oracle",
    )
    p.add_argument(
        "--deadline", type=_typed(float, lambda v: v > 0, "> 0"), default=None,
        metavar="S",
        help="watchdog deadline in seconds around device work: expiry is a "
        "transient fault for --retries/--degrade, and a run that fails on "
        "it exits 75 (SEQALIGN_DEADLINE_S when absent)",
    )
    p.add_argument(
        "--selfcheck", action="store_true",
        help="after scoring, rescore a deterministic sample on the host "
        "oracle and fail on any mismatch",
    )
    p.add_argument("--profile", action="store_true",
                   help="print per-phase wall-clock timings to stderr")
    p.add_argument(
        "--trace", default=None, metavar="DIR",
        help="capture a torch.profiler trace (CPU and CUDA activities) of the "
        "scoring phase into DIR as a Chrome trace (trace-<pid>.json)",
    )
    p.add_argument(
        "--trace-out", default=None, metavar="PATH",
        help="write a Chrome-trace/Perfetto JSON timeline to PATH when the "
        "run exits (every exit code): host spans, bus events and one row per "
        "launch group, measured beside the Hopper launch model, with a "
        "gap_attribution summary (SEQALIGN_TRACE; implies --metrics; "
        "distinct from --trace, the torch.profiler trace)",
    )
    p.add_argument(
        "--metrics", action="store_true",
        help="arm the observability plane: resilience counters, config gauges "
        "and per-phase spans collected for the run (SEQALIGN_METRICS; implied "
        "by --metrics-out, --heartbeat and --trace-out); off by default, and "
        "then every instrumentation site is a single attribute check",
    )
    p.add_argument(
        "--metrics-out", default=None, metavar="PATH",
        help="write the versioned JSON run report to PATH (plus a PATH.prom "
        "Prometheus text sidecar) when the run exits, failed (65) and "
        "preempted (75) exits included (SEQALIGN_METRICS_OUT; implies "
        "--metrics)",
    )
    p.add_argument(
        "--heartbeat", type=_typed(float, lambda v: v > 0, "> 0"), default=None,
        metavar="S",
        help="emit a one-line '[obs] chunk I/N retries=R degraded=D' status to "
        "stderr from the watchdog monitor thread after every S quiet seconds "
        "(SEQALIGN_HEARTBEAT_S; implies --metrics and composes with "
        "--deadline on the same monitor thread)",
    )
    p.add_argument(
        "--serve", action="store_true",
        help="persistent serving mode: hold the scorer (its kernels built and "
        "loaded) in a long-lived loop, read newline-delimited JSON alignment "
        "requests, coalesce concurrent requests' Seq2s into shared fixed-shape "
        "superblocks (bucketed continuous batching) and stream per-sequence "
        "result records back; requests arrive on a loopback socket (--port) "
        "or the --input pipe/stdin; SIGTERM drains: in-flight superblocks "
        "finish, queued requests are journaled (--journal) and the run exits "
        "75 for a --resume rerun",
    )
    p.add_argument(
        "--port", type=_typed(int, lambda v: v >= 0, ">= 0"), default=None,
        metavar="PORT",
        help="with --serve: listen for request connections on 127.0.0.1:PORT "
        "(0 = OS-assigned; the bound port is announced on stderr); "
        "SEQALIGN_SERVE_PORT supplies the value when this flag is absent; "
        "without a port the server reads requests from --input/stdin and "
        "exits when the pipe drains",
    )
    p.add_argument(
        "--telemetry-port", type=_typed(int, lambda v: v >= 0, ">= 0"),
        default=None, metavar="PORT",
        help="with --serve: also serve a read-only plain-HTTP telemetry "
        "endpoint on 127.0.0.1:PORT (0 = OS-assigned; announced on stderr): "
        "GET /metrics is a live Prometheus scrape of the armed registry, "
        "/healthz and /trace answer JSON; the same data rides the serve "
        'socket itself as {"cmd": "metrics"|"healthz"|"trace"} verbs '
        "(SEQALIGN_TELEMETRY_PORT)",
    )
    p.add_argument(
        "--fleet-board", default=None, metavar="DIR",
        help="directory for the fleet coordination board (atomic file-backed "
        "key-value posts; no torch.distributed needed). With --serve this loop "
        "becomes the fleet COORDINATOR: planned superblocks are offered on the "
        "board under expiring leases (SEQALIGN_LEASE_S), scored by "
        "--fleet-worker processes, and results are fenced by lease epoch so a "
        "dead or zombie worker can never lose or double-answer a request; with "
        "no live workers every block scores locally. With --fleet-worker it "
        "names the board to claim work from.",
    )
    p.add_argument(
        "--fleet-worker", action="store_true",
        help="run as an elastic-fleet scoring worker: build and load the "
        "kernels, register on the --fleet-board, heartbeat "
        "(SEQALIGN_WORKER_HEARTBEAT_S), claim offered superblocks under lease "
        "epochs, score them through the shared chunk pipeline (same "
        "retry/degrade ladder as --serve), and post epoch-stamped results; "
        "joins mid-serve and exits when the coordinator posts shutdown",
    )
    p.add_argument(
        "--fleet-standby", action="store_true",
        help="run as a STANDBY fleet coordinator: watch the active leader's "
        "beat on the --fleet-board, and when it goes silent for a full lease "
        "window (SEQALIGN_LEASE_S), claim the next leader generation, replay "
        "the dead leader's board checkpoint (unanswered requests + answered "
        "reply ids), fence its late posts by generation, and resume serving "
        "with zero duplicate and zero dropped replies; exits 0 when the fleet "
        "shuts down cleanly instead (--port/--telemetry-port open "
        "immediately, so clients can reconnect-and-redrive before the "
        "takeover lands)",
    )
    p.add_argument(
        "--check", action="store_true",
        help="validate every concrete dispatch decision against the launch "
        "contracts before it launches (the formulation, the int32 and fp32 "
        "windows, the packed class, the launch group and ring window, the "
        "operands, and the shared-memory model in "
        "mpi_openmp_cuda_tpu_torch/analysis); a violation is an error, never "
        "a move to another backend; the SEQALIGN_CHECK env var enables the "
        "same checks when this flag is absent",
    )
    p.add_argument(
        "--prewarm", action="store_true",
        help="pay the card's cold costs at process start (the kernels' build "
        "and load, each width's shared-memory opt-in, one launch a warm "
        "shape): replay the warm-set manifest of an earlier run and warm the "
        "problem's launch shapes, then rewrite the manifest, so a restarted "
        "process (a serve replica, a drain->--resume rerun, a fleet worker) "
        "answers its first request warm; under --serve the steady-state "
        "baseline is then pinned at the first tick (SEQALIGN_PREWARM; the "
        "manifest is <cache home>/aot/<card tag>.json, cache home "
        "SEQALIGN_CACHE_DIR)",
    )
    return p


def _is_resumable(e: BaseException | None) -> bool:
    """True when a failure chain is rooted in a watchdog deadline expiry
    (exit 75, not 65)."""
    seen: set[int] = set()
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        if isinstance(e, DeadlineExpiredError):
            return True
        e = e.__cause__ or e.__context__
    return False


def _check_resume(args) -> None:
    """``--resume`` asserts the journal file already exists."""
    if args.resume and not os.path.exists(args.journal):
        raise FileNotFoundError(
            f"--resume: journal {args.journal!r} does not exist (a first "
            "run takes --journal alone; --resume asserts there is prior "
            "progress to reuse)"
        )


def _build_policy(args) -> tuple[RetryPolicy, str | None]:
    """The run's policy and fault spec: ``--faults``, else
    ``SEQALIGN_FAULTS``; only the env spec gets the
    ``SEQALIGN_FAULT_RETRIES`` retry floor."""
    retries = args.retries
    fault_spec = args.faults
    if fault_spec is None:
        fault_spec = env_str("SEQALIGN_FAULTS") or None
        if fault_spec:
            retries = max(retries, env_int("SEQALIGN_FAULT_RETRIES", 0))
    return RetryPolicy(retries=retries), fault_spec


def _build_obs(args) -> tuple[bool, str | None, float | None, str | None]:
    """``(armed, metrics_out, heartbeat_s, trace_out)``: each flag falls
    back to its env var, and any of ``--metrics`` / ``--metrics-out`` /
    ``--heartbeat`` / ``--trace-out`` arms the plane."""
    metrics_out = args.metrics_out or env_str("SEQALIGN_METRICS_OUT")
    trace_out = args.trace_out or env_str("SEQALIGN_TRACE")
    heartbeat_s = (args.heartbeat if args.heartbeat is not None
                   else env_float("SEQALIGN_HEARTBEAT_S"))
    if heartbeat_s is not None and heartbeat_s <= 0:
        raise ValueError(f"SEQALIGN_HEARTBEAT_S must be > 0, got {heartbeat_s}")
    enabled = bool(args.metrics or env_flag("SEQALIGN_METRICS") or metrics_out
                   or heartbeat_s or trace_out)
    return enabled, metrics_out or None, heartbeat_s, trace_out or None


def _make_scorer(args, distributed: bool) -> AlignmentScorer:
    """The run's scorer: ``--mesh``'s sharding (``parallel/specs.py``), or,
    in a ``--distributed`` job without one, the batch sharded over every
    global slot, each process's local slots (the reference's MPI_Scatter,
    main.c:174; JAX shards over every global device)."""
    from ..ops.dispatch import resolve_device
    from ..parallel.specs import build_sharding

    if args.backend != "oracle":  # the oracle touches no device
        resolve_device(args.device)  # no card and no --device cpu: that error first
    sharding = build_sharding(args.mesh, device=args.device)
    if sharding is None and distributed:
        from ..parallel.sharding import BatchSharding

        sharding = BatchSharding.over_devices(None, device=args.device)
    return AlignmentScorer(args.backend, device=args.device, sharding=sharding,
                           check=_check_on(args))


def _check_on(args) -> bool:
    """``--check``, or ``SEQALIGN_CHECK`` when the flag is absent."""
    return bool(args.check) or env_flag("SEQALIGN_CHECK")


def _make_run_scorer(args, distributed: bool) -> BackendDegrader:
    """The run's scorer in its degrade chain, under the ``scorer`` span
    (``setup.scorer``)."""
    with obs_span("scorer", detail=True):
        return _make_degrader(args, _make_scorer(args, distributed))


def _make_degrader(args, scorer) -> BackendDegrader:
    """The run's degrade chain state (a pass-through unless --degrade);
    replacement scorers keep the device, the sharding and the check."""
    return BackendDegrader(
        scorer,
        lambda b: AlignmentScorer(b, device=args.device, sharding=scorer.sharding,
                                  check=scorer.check),
        enabled=bool(args.degrade),
    )


def _run_prewarm(args, timer, *, problem=None, backend=None) -> bool:
    """The warm plane at process start, behind ``--prewarm`` /
    ``SEQALIGN_PREWARM`` (``aot/prewarm.py``; not for the oracle, which
    touches no device).  Advisory: a failure is a warning on stderr,
    never the run's failure, and the run's own launches then meet any
    fault as they would without a prewarm.  True when the prewarm ran
    (the serve loop then pins its steady baseline at tick 0)."""
    if not args.prewarm or args.backend == "oracle":
        return False
    try:
        from ..aot.prewarm import prewarm
        from ..serve.batcher import DEFAULT_BLOCK_ROWS

        with timer.phase("prewarm"):
            # A problem-bearing prewarm also warms the serve superblock
            # shapes of its rows: the manifest it writes is what a later
            # `--serve --prewarm` restart replays.
            prewarm(problem=problem, backend=backend, device=args.device,
                    rows_per_block=env_int("SEQALIGN_SERVE_BLOCK_ROWS", DEFAULT_BLOCK_ROWS),
                    check=_check_on(args))
        return True
    except SeqcheckError:
        raise  # --check: a violation is an error, never a cold start
    except Exception as e:
        # advisory: warming is an optimization; scoring proceeds cold.
        print(f"{PROG}: warning: prewarm failed ({e})", file=sys.stderr)
        return False


def _run_batch(args, policy, out, timer, dist=None) -> None:
    """The batch path.  In a multi-process job (``dist``) only rank 0
    parses, and broadcasts the problem (an abort header when its parse
    fails, so no rank hangs) and, under ``--journal``, its journal's done
    set, so every rank runs the same schedule; only rank 0 prints."""
    from ..utils.journal import ResultJournal

    multi = dist is not None and dist.process_count() > 1
    coordinator = dist is None or dist.is_coordinator()
    with timer.phase("parse"):
        problem = None
        if coordinator:
            try:
                problem = load_problem(args.input)
            except Exception:
                if dist is not None:
                    dist.broadcast_problem(None, failed=True)
                raise
        if dist is not None:
            problem = dist.broadcast_problem(problem)
    journal = staged = done = None
    with timer.phase("setup"):
        deg = _make_run_scorer(args, dist is not None)
        if args.journal:
            journal = ResultJournal(args.journal)
            if not multi:
                _check_resume(args)
            elif coordinator:
                try:
                    _check_resume(args)
                    done = journal.load_done(problem)
                except Exception:
                    dist.broadcast_index_set(None, failed=True)
                    raise
                dist.broadcast_index_set(sorted(done))
            else:
                done = {int(i): None for i in dist.broadcast_index_set(None)}
        else:
            # The batch's copies in start before the score phase, as in
            # the JAX CLI; single-use, so a retry or a degraded scorer
            # copies again.  Not under --journal, whose resume scores a
            # reduced subset, nor on a mesh (its shards are placed at
            # dispatch).
            with obs_span("stage", detail=True):
                staged = FeedStager(deg).stage(
                    problem.seq1_codes, problem.seq2_codes, problem.weights)
    obs_gauge("backend", deg.scorer.backend)
    if dist is None and deg.scorer.sharding is None:
        # The warm set mirrors the single-device dispatch: a mesh's or a
        # job's launches are per shard, and are not warmed here.
        _run_prewarm(args, timer, problem=problem, backend=deg.scorer.backend)

    def score_once(sc):
        if journal is not None:
            return journal.score_with_resume(sc, problem, done=done, record=coordinator)
        return sc.score_codes(problem.seq1_codes, problem.seq2_codes, problem.weights,
                              staged=staged)

    def verify(rows):
        verify_rows_against_oracle(
            problem.seq1_codes, problem.seq2_codes, problem.weights, rows)

    beacon_s = env_float("SEQALIGN_BEACON_S")
    with timer.phase("score"), device_trace(args.trace):
        if dist is not None and beacon_s and not args.journal:
            # The lost-shard rescue tier: each rank scores its own shard
            # and posts it to the job's store, no collective; a rank that
            # misses the beacon deadline has its shard rescored here.
            # --journal takes precedence (its resume schedule is the
            # collective schedule); the other ranks get None and print
            # nothing.
            results = dist.scatter_gather_rescue(
                problem.seq1_codes, problem.seq2_codes, problem.weights,
                policy=policy, beacon_s=beacon_s, backend=args.backend,
                device=args.device,
            )
        else:
            results = run_degrading(
                policy, deg, lambda: score_once(deg.scorer), score_once, "scoring",
                verify=verify if deg.enabled else None,
            )
    if args.selfcheck and coordinator:
        from ..utils.selfcheck import verify_results

        with timer.phase("selfcheck"):
            checked = verify_results(problem, results)
            log_line(f"{PROG}: selfcheck OK ({checked} sequences re-verified on "
                     "the host oracle)")
    with timer.phase("print"):
        if coordinator:  # the other ranks print nothing (main.c:199-211)
            if args.json:
                write_json_sidecar(results, args.json,
                                   meta={"backend": deg.scorer.backend,
                                         "device": args.device})
            print_results(results, out=out)
    timer.report()


def _run_streaming_worker(args, policy, timer, dist) -> None:
    """A ``--stream`` run on a rank other than 0: receive the stream
    header, then score every broadcast chunk in the coordinator's own
    order, one chunk in flight (dispatch chunk i + 1, then gather chunk
    i), until the end sentinel.  It parses, journals and prints nothing."""
    with timer.phase("setup"):
        scorer = _make_scorer(args, True)
    weights, seq1, _ = dist.broadcast_stream_meta(None)

    def finish(promise, codes, budget):
        first = [promise]

        def attempt():
            if first:
                return first.pop().result()
            return scorer.score_codes(seq1, codes, weights)

        policy.run(attempt, "chunk scoring", budget)

    with timer.phase("stream"):
        held = None
        while True:
            codes = dist.broadcast_chunk(None)
            if codes is None:
                break
            item = None
            if codes:
                budget = policy.new_budget()
                promise = policy.run(
                    lambda: scorer.score_codes_async(seq1, codes, weights),
                    "chunk dispatch", budget)
                item = (promise, codes, budget)
            if held is not None:
                finish(*held)
            held = item
        if held is not None:
            finish(*held)
    timer.report()


def _run_streaming(args, policy, out, timer, dist=None) -> None:
    """The --stream pipeline: parse and score CHUNK sequences at a time
    with a window of chunks in flight (each one's device-to-host copy
    started at dispatch, the next chunk's host-to-device copies staged
    while the current one computes).  Output is buffered and written only
    after the whole stream succeeds.  With --journal, a
    ``StreamJournal`` resumes chunk by chunk: only the sequences without
    a hash-matching record are scored.

    In a multi-process job (``dist``) rank 0 broadcasts the stream header
    and then each (journal-reduced) chunk before dispatching it, with one
    chunk in flight, the schedule :func:`_run_streaming_worker` mirrors
    collective for collective; any failure on rank 0 broadcasts an abort
    at the collective the other ranks wait in, so none hangs.

    The ``stream`` phase's host work lies in five detail spans beside the
    dispatch's own (``obs.spans.span_beside``): ``stream.parse`` (a chunk
    read and encoded), ``stream.stage`` (its feed staged), ``stream.submit``
    (the held chunk dispatched), ``stream.window_wait`` (the block on the
    oldest chunk's result) and ``stream.finish`` (its lines printed into
    the buffer, and journalled); ``pipeline.stream_counts`` counts the
    chunks dispatched and the pushes that found the window full."""
    from ..utils.journal import JournalMismatchError, StreamJournal, seq_hash

    multi = dist is not None and dist.process_count() > 1
    if multi and not dist.is_coordinator():
        _run_streaming_worker(args, policy, timer, dist)
        return
    with timer.phase("setup"):
        deg = _make_run_scorer(args, dist is not None)
    obs_gauge("backend", deg.scorer.backend)
    if dist is None:
        # Replay only (no problem is in hand before the stream starts): a
        # drain -> --resume rerun rejoins warm from its predecessor's
        # manifest.
        _run_prewarm(args, timer)
    all_results = [] if args.json else None
    lines = io.StringIO()
    try:
        stream_cm = open_input(args.input)
    except Exception:
        if multi:
            dist.broadcast_stream_meta(None, failed=True)
        raise
    with stream_cm as stream:
        with timer.phase("parse_header"):
            try:
                header = parse_stream_header(stream)
            except Exception:
                if multi:
                    dist.broadcast_stream_meta(None, failed=True)
                raise
        if multi:
            dist.broadcast_stream_meta((header.weights, header.seq1_codes, header.num_seq2))
        end_sent = False
        try:
            # The denominator of the heartbeat's "chunk I/N".
            obs_gauge("chunks_total", -(-header.num_seq2 // args.stream))
            journal, done = None, {}
            if args.journal:
                _check_resume(args)
                journal = StreamJournal(args.journal, header.weights, header.seq1_codes,
                                        header.num_seq2)
                done = journal.load()
            pipe = ChunkPipeline(policy, deg)
            # No staging under --journal (a resumed chunk is reduced to its
            # unscored subset, so a whole-chunk prestage would move dead
            # bytes) nor in a multi-process job (the chunk order is the
            # collective schedule).
            stager = FeedStager(
                deg, enabled=False if (journal is not None or multi) else None)
            seq1, weights = header.seq1_codes, header.weights

            def submit(start, codes, staged=None):
                """Dispatch a chunk: (promise, start, codes, pend, rows,
                hashes, budget); with a journal only the unrecorded rows
                are scored (and broadcast, even when none are left)."""
                budget = policy.new_budget()
                if journal is None:
                    if multi:
                        dist.broadcast_chunk(codes)
                    promise = pipe.dispatch(seq1, codes, weights, budget, staged=staged)
                    count_stream("stream_chunks")
                    return (promise, start, codes, None, None, None, budget)
                hashes = [seq_hash(c) for c in codes]
                pend = []
                rows = np.zeros((len(codes), 3), dtype=np.int32)
                for j, h in enumerate(hashes):
                    rec = done.get(start + j)
                    if rec is not None and rec[0] == h:
                        rows[j] = rec[1]
                    elif rec is not None:
                        raise JournalMismatchError(
                            f"journal entry for sequence {start + j} does not match "
                            "the input (sequence changed); delete the journal or "
                            "pass a fresh --journal path"
                        )
                    else:
                        pend.append(j)
                if multi:
                    dist.broadcast_chunk([codes[j] for j in pend])
                promise = None
                if pend:
                    promise = pipe.dispatch(seq1, [codes[j] for j in pend], weights,
                                            budget, staged=staged)
                    count_stream("stream_chunks")
                return (promise, start, codes, pend, rows, hashes, budget)

            def push(item):
                """A dispatched chunk onto the window, counted when the
                window first finished its oldest entry."""
                if window.push(*item):
                    count_stream("stream_window_full")

            def finish(promise, start, codes, pend, rows, hashes, budget):
                res = None
                if promise is not None:
                    sub = codes if pend is None else [codes[j] for j in pend]
                    with span_beside("window_wait"):
                        res = pipe.materialise(promise, seq1, sub, weights, budget)
                with span_beside("finish"):
                    out_rows = res
                    if pend is not None:
                        out_rows = rows
                        if res is not None:
                            for j, row in zip(pend, res):
                                out_rows[j] = row
                            # An injected append fault fires before the
                            # first byte, so a retried append duplicates
                            # nothing; it gets its own budget, apart from
                            # the chunk's.
                            policy.run(
                                lambda: journal.append([start + j for j in pend],
                                                       [hashes[j] for j in pend], res),
                                "journal append",
                            )
                    print_results(out_rows, out=lines, start=start)
                    if all_results is not None:
                        all_results.extend(out_rows)

            with contextlib.ExitStack() as stack:
                stack.enter_context(timer.phase("stream"))
                stack.enter_context(device_trace(args.trace))
                if journal is not None:
                    stack.enter_context(journal)
                depth = 1 if multi else max(1, env_int("TPU_SEQALIGN_STREAM_DEPTH", 4))
                window = PendingWindow(depth, finish)
                drained_at = None
                # One chunk of input lookahead: each step reads a chunk,
                # dispatches the held one, then stages the chunk just read,
                # then lets the window finish its oldest entry.
                held = None
                chunks = header.iter_chunks(args.stream)
                while True:
                    with span_beside("parse"):
                        chunk = next(chunks, None)
                    if chunk is None:
                        break
                    start, codes = chunk
                    if drain_requested():
                        # Admit no more chunks; the window still finishes
                        # (and journals) what is in flight.  A held,
                        # undispatched chunk is not admitted: the drain
                        # point is its start.
                        drained_at = held[0] if held is not None else start
                        held = None
                        break
                    item = None
                    if held is not None:
                        with span_beside("submit"):
                            item = submit(*held)
                    with span_beside("stage"):
                        held = (start, codes, stager.stage(seq1, codes, weights))
                    if item is not None:
                        push(item)
                if held is not None:
                    with span_beside("submit"):
                        item = submit(*held)
                    push(item)
                if multi:
                    # The end sentinel before the last gather: the other
                    # ranks learn the stream ended, then gather their last
                    # chunk, in the same order as here.
                    dist.broadcast_chunk(None, end=True)
                    end_sent = True
                window.flush()
                if drained_at is not None:
                    if journal is not None:
                        journal.append_event("drain")
                        raise DrainInterrupt(
                            f"stream preempted before sequence {drained_at} of "
                            f"{header.num_seq2}; scored chunks are in the journal — "
                            "rerun with --resume to finish"
                        )
                    raise DrainInterrupt(
                        f"stream preempted before sequence {drained_at} of "
                        f"{header.num_seq2}; no --journal, so a rerun starts over"
                    )
        except BaseException:
            if multi and not end_sent:
                # Release the ranks blocked on the next chunk broadcast.
                dist.broadcast_chunk(None, failed=True)
            raise
    out.write(lines.getvalue())
    if args.json:
        write_json_sidecar(all_results, args.json,
                           meta={"backend": deg.scorer.backend, "device": args.device})
    timer.report()


def _run_fleet_worker(args, policy, timer) -> int:
    """The ``--fleet-worker`` path: one scorer whose kernels are built and
    loaded (and, with ``--prewarm``, the manifest's shapes warmed) before
    the worker registers (a first claim pays no build inside its lease; a
    kernel that cannot be built is the CLI's 65 without ``--degrade``),
    then ``serve.fleet.run_fleet_worker`` until the coordinator posts
    shutdown or a drain signal; the worker's exit code."""
    from ..serve import fleet as serve_fleet
    from ..serve import loop as serve_loop

    with timer.phase("setup"):
        deg = _make_run_scorer(args, False)
        serve_loop.warm_kernels(deg)
    obs_gauge("backend", deg.scorer.backend)
    _run_prewarm(args, timer, backend=deg.scorer.backend)
    return serve_fleet.run_fleet_worker(args, timer, policy, deg)


def _run_serve(args, policy, out, timer) -> None:
    """The ``--serve`` and ``--fleet-standby`` path: one scorer (``--mesh``
    shards it) whose kernels are built and loaded before the first
    request, with ``--prewarm`` the manifest's launch shapes replayed (the
    loop then pins its steady baseline at tick 0), then
    ``serve.loop.run_serve`` until the input drains or a drain signal."""
    from ..serve import loop as serve_loop

    if args.journal:
        _check_resume(args)
    with timer.phase("setup"):
        deg = _make_run_scorer(args, False)
        serve_loop.warm_kernels(deg)
    obs_gauge("backend", deg.scorer.backend)
    prewarmed = _run_prewarm(args, timer, backend=deg.scorer.backend)
    serve_loop.run_serve(args, timer, policy, deg, out_stream=out, prewarmed=prewarmed)


def _reject_fleet_combos(args) -> str | None:
    """The fleet flags' combination rules, in the JAX CLI's order and
    words: the message of the first rejected combination, else None."""
    rules = []
    if args.fleet_worker:
        rules += [(f"{flag} cannot be combined with --fleet-worker ({why})", bad)
                  for flag, bad, why in (
            ("--serve", args.serve, "a process is the fleet coordinator OR a "
             "scoring worker, never both"),
            ("--stream", args.stream is not None, "workers score fleet "
             "superblocks claimed off the board, not streamed chunks"),
            ("--distributed", args.distributed, "the fleet is its own "
             "multi-process layer on the coordination board"),
            ("--port", args.port is not None, "workers take work from the "
             "board, not a socket"),
        )]
        rules.append(("--fleet-worker requires --fleet-board DIR (the board is "
                      "where work is claimed)", not args.fleet_board))
    if args.fleet_standby:
        rules += [(f"{flag} cannot be combined with --fleet-standby ({why})", bad)
                  for flag, bad, why in (
            ("--serve", args.serve, "a standby IS a serve loop in waiting; it "
             "becomes the coordinator only by winning the takeover"),
            ("--fleet-worker", args.fleet_worker, "a process is a standby "
             "coordinator OR a scoring worker, never both"),
            ("--stream", args.stream is not None, "the standby serves fleet "
             "requests after takeover, not streamed chunks"),
            ("--distributed", args.distributed, "the fleet is its own "
             "multi-process layer on the coordination board"),
            ("--input", args.input is not None, "a standby's requests come "
             "from the dead leader's checkpoint and reconnecting clients, not "
             "a pipe"),
        )]
        rules.append(("--fleet-standby requires --fleet-board DIR (the board is "
                      "where the leader lease lives)", not args.fleet_board))
    rules.append(("--fleet-board requires --serve (coordinator), --fleet-worker "
                  "(scoring worker), or --fleet-standby (failover coordinator)",
                  bool(args.fleet_board) and not (
                      args.serve or args.fleet_worker or args.fleet_standby)))
    return next((msg for msg, bad in rules if bad), None)


def run(argv: list[str] | None = None) -> int:
    # The run's one span recorder exists before anything else, so the
    # argument parsing is timed too; it records only if something reads
    # it: --profile, the obs plane (which adopts it) or a close listener.
    timer = PhaseTimer()
    recorder = timer.recorder
    args_t0 = recorder.now()
    try:
        args = build_arg_parser().parse_args(argv)
    except SystemExit as e:
        # argparse's own verdict: usage text on stderr and 2 for a bad
        # command line, 0 after --help.
        if e.code == EX_OK:
            return EX_OK
        if e.code == EX_ARGPARSE:
            return EX_ARGPARSE
        return EX_USAGE
    if args.stream and args.selfcheck:
        print(f"{PROG}: error: --selfcheck cannot be combined with --stream "
              "(selfcheck re-verifies against the fully-materialised problem)",
              file=sys.stderr)
        return EX_USAGE
    if args.degrade and args.distributed:
        print(f"{PROG}: error: --distributed cannot be combined with --degrade "
              "(the backend choice is the SPMD program itself; a lone host "
              "degrading its backend desynchronises the collective schedules)",
              file=sys.stderr)
        return EX_USAGE
    if args.serve:
        for flag, bad, why in (
            ("--stream", args.stream is not None, "the serve loop IS the streaming "
             "pipeline; chunking is driven by the request queue, not a flag"),
            ("--selfcheck", args.selfcheck, "selfcheck re-verifies a "
             "fully-materialised batch; a server has no final batch"),
            ("--distributed", args.distributed, "the serving plane is "
             "single-process; shard the scorer with --mesh instead"),
        ):
            if bad:
                print(f"{PROG}: error: {flag} cannot be combined with --serve ({why})",
                      file=sys.stderr)
                return EX_USAGE
    rejected = _reject_fleet_combos(args)
    if rejected:
        print(f"{PROG}: error: {rejected}", file=sys.stderr)
        return EX_USAGE
    if args.port is not None and not (args.serve or args.fleet_standby):
        print(f"{PROG}: error: --port requires --serve (the port is where the "
              "serving loop listens)", file=sys.stderr)
        return EX_USAGE
    if args.telemetry_port is not None and not (args.serve or args.fleet_standby):
        print(f"{PROG}: error: --telemetry-port requires --serve (live telemetry "
              "scrapes a running serve loop; a batch run's report is --metrics-out)",
              file=sys.stderr)
        return EX_USAGE
    if args.resume and not args.journal:
        print(f"{PROG}: error: --resume requires --journal PATH (the journal "
              "is what a resume resumes from)", file=sys.stderr)
        return EX_USAGE
    # A malformed spec or env value is a usage error, caught before the
    # runtime try below would make it a 65.
    try:
        policy, fault_spec = _build_policy(args)
        args.prewarm = args.prewarm or env_flag("SEQALIGN_PREWARM")
        if fault_spec:
            parse_spec(fault_spec)
        deadline = args.deadline
        if deadline is None:
            deadline = env_float("SEQALIGN_DEADLINE_S")
        obs_on, metrics_out, heartbeat_s, trace_out = _build_obs(args)
        # --serve, a standby and a worker arm the plane and the flight
        # recorder unconditionally: the recorder must be taping before the
        # first request, and a worker's board snapshots (metrics, recent
        # trace events, the tape collected when it dies) need the planes.
        obs_on = obs_on or args.serve or args.fleet_standby or args.fleet_worker
        frec_depth = env_int("SEQALIGN_FLIGHTREC_DEPTH") if obs_on else 0
    except ValueError as e:
        print(f"{PROG}: error: {e}", file=sys.stderr)
        return EX_USAGE
    timer.enabled = args.profile
    spans_on = obs_on or timer.read
    if spans_on:
        # Armed, the module-level spans (dispatch's, the serve loop's)
        # nest under the phases.
        activate_spans(recorder=recorder)
        recorder.add("run.args", args_t0)
    drain = dist = stdout = None
    registry = prev_usr2 = None
    rc: int | None = None
    try:
        with obs_span("run.arm"):
            # The obs plane arms before anything that can publish into it
            # (faults, the watchdog, scoring); the finally below flushes
            # the report and the trace on every exit path, 65 and 75
            # included.
            if obs_on:
                registry, _ = arm_observability(
                    with_trace=bool(trace_out) or args.fleet_worker,
                    flightrec_depth=frec_depth, recorder=recorder)
                global _usr2
                _usr2 = _Usr2Dumper()
                try:
                    prev_usr2 = signal.signal(signal.SIGUSR2, _sigusr2_dump)
                except (ValueError, AttributeError, OSError):
                    # Not the main thread, or no SIGUSR2 on this platform.
                    prev_usr2 = None
            activate_faults(fault_spec)
            if deadline or heartbeat_s:
                # Heartbeat-only (no deadline) is legal: the monitor then
                # enforces nothing and only emits the status line.
                activate_watchdog(
                    deadline or None, heartbeat_s=heartbeat_s,
                    heartbeat=obs_export.heartbeat_callback() if heartbeat_s else None,
                )
            drain = drain_guard()
            drain.__enter__()
            # Native libraries (the CUDA runtime, nvcc's build, gloo's
            # peer banners) may write to fd 1; only the result lines reach
            # the real stdout.  The guard is up before a --distributed job
            # is joined.
            stdout = guarded_stdout()
            out = stdout.__enter__()
        try:
            if args.distributed:
                from ..parallel import distributed as dist

                with timer.phase("distributed_init"):
                    dist.initialize_distributed(args.device)
            if args.fleet_worker:
                worker_rc = _run_fleet_worker(args, policy, timer)
            elif args.serve or args.fleet_standby:
                _run_serve(args, policy, out, timer)
            elif args.stream:
                _run_streaming(args, policy, out, timer, dist)
            else:
                _run_batch(args, policy, out, timer, dist)
        finally:
            # The result lines leave for the real stdout here, and fd 1 is
            # restored (a reader gone away raises BrokenPipeError: 1).
            with obs_span("run.flush"):
                stdout.__exit__(None, None, None)
        rc = worker_rc if args.fleet_worker else EX_OK
        return rc
    except DrainInterrupt as e:
        # A requested preemption: nothing printed, the journal flushed.
        print(f"{PROG}: drained: {e}", file=sys.stderr)
        rc = EX_TEMPFAIL
        return rc
    except BrokenPipeError:
        rc = 1
        return rc
    except Exception as e:  # fail-stop: diagnose on stderr, nonzero exit
        print(f"{PROG}: error: {e}", file=sys.stderr)
        rc = EX_TEMPFAIL if _is_resumable(e) else EX_FATAL
        return rc
    finally:
        with obs_span("run.teardown"):
            kernels = _build.loaded()
            if kernels and (args.profile or obs_on):
                # Where this run's kernels were found or built (the
                # checkout's build/, the cache home, a temporary
                # directory): a report line like [profile]'s, so the run
                # report counts no log line.
                print(f"{PROG}: kernels {', '.join(kernels)} in {_build.BUILD_DIR}",
                      file=sys.stderr)
            if registry is not None:
                _flush_obs(registry, recorder, rc, metrics_out, trace_out, prev_usr2)
            # Faults, the watchdog, the drain handlers and the span
            # recorder are armed per run: library callers after a CLI run
            # see none of them.
            deactivate_faults()
            deactivate_watchdog()
            if drain is not None:
                drain.__exit__(None, None, None)
            if dist is not None:
                dist.shutdown_distributed()
            if spans_on:
                deactivate_spans()


def _flush_obs(registry, recorder, rc, metrics_out, trace_out, prev_usr2) -> None:
    """The obs plane's exit: a fatal exit dumps the flight recorder, the
    trace and the run report are written with the exit code (a failed
    write warns, never masks the run's verdict), SIGUSR2 is restored and
    the plane disarmed."""
    if rc == EX_FATAL:
        obs_flightrec.dump_active("fatal-exit")
    global _usr2
    tracer = obs_trace.active_trace()
    try:
        obs_export.flush_trace(tracer, trace_out, exit_code=rc)
    except Exception as e:
        # advisory: the run's verdict stands; a lost trace is a warning.
        log_line(f"{PROG}: warning: trace not written ({e})")
    extra = {"clock_anchor": recorder.anchor()}
    if tracer is not None:
        extra["gap_attribution"] = tracer.gap_attribution()
    try:
        obs_export.flush_run_report(registry, recorder, metrics_out, exit_code=rc,
                                    extra=extra)
    except Exception as e:
        # advisory: the run's verdict stands; a lost report is a warning.
        log_line(f"{PROG}: warning: run report not written ({e})")
    if prev_usr2 is not None:
        try:
            signal.signal(signal.SIGUSR2, prev_usr2)
        except (ValueError, OSError):
            pass
    # The handler is gone: the dumper ends after any pending dump.
    if _usr2 is not None:
        _usr2.stop()
        _usr2 = None
    disarm_observability()


def main() -> None:
    try:
        rc = run()
    except (KeyError, ValueError) as e:
        # Only the pre-arm plumbing can get here (an undeclared env read in
        # utils/env.py, a malformed env value): run()'s ladder maps
        # everything once its flush try is entered.  A usage verdict with
        # the message, not a traceback, as in the JAX CLI.
        print(f"{PROG}: usage: {e}", file=sys.stderr)
        rc = EX_USAGE
    sys.exit(rc)
