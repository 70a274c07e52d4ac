"""Batch CLI: ``python -m mpi_openmp_cuda_tpu_torch < input.txt``.

Parse stdin (or ``--input``), score every Seq2 with ``AlignmentScorer``
on the chosen device, and print ``#i: score: S, n: N, k: K`` per Seq2 on
stdout.  Diagnostics go to stderr; on any failure nothing reaches stdout.
The port of ``mpi_openmp_cuda_tpu/io/cli.py``'s single-process batch
path: ``--stream`` (chunked, pipelined), ``--journal``/``--resume``,
``--retries``, ``--faults``, ``--degrade``, ``--deadline``,
``--selfcheck``, and the drain on SIGTERM/SIGINT (or ``SEQALIGN_DRAIN=1``).

Exit codes (BSD sysexits): 0 ok; 64 usage (bad flags or flag
combinations, a malformed ``--faults`` spec); 65 fatal (bad input,
weights outside the int32 gate, no CUDA device without ``--device cpu``,
a kernel that fails to build or launch without ``--degrade``, a journal
of another problem, an exhausted retry budget); 75 resumable (a drain,
or a failure rooted in a watchdog deadline: rerun, with ``--resume``
under ``--journal``); 1 when the reader of stdout went away.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import sys

import numpy as np

from ..obs.events import log_line
from ..ops.dispatch import AlignmentScorer
from ..resilience.degrade import BackendDegrader, run_degrading, verify_rows_against_oracle
from ..resilience.drain import DrainInterrupt, drain_guard, drain_requested
from ..resilience.faults import activate_faults, deactivate_faults, parse_spec
from ..resilience.policy import RetryPolicy
from ..resilience.watchdog import DeadlineExpiredError, activate_watchdog, deactivate_watchdog
from ..utils.env import env_float, env_int, env_str
from .parse import load_problem, open_input, parse_stream_header
from .pipeline import ChunkPipeline, FeedStager, PendingWindow
from .printer import guarded_stdout, print_results, write_json_sidecar

EX_OK = 0
EX_USAGE = 64
EX_FATAL = 65
EX_TEMPFAIL = 75

PROG = "mpi_openmp_cuda_tpu_torch"


class UsageError(Exception):
    """A bad command line (exit code 64)."""


class _Parser(argparse.ArgumentParser):
    def error(self, message):
        raise UsageError(message)


def _typed(cast, ok, want):
    def parse(text: str):
        value = cast(text)
        if not ok(value):
            raise argparse.ArgumentTypeError(f"must be {want}, got {value}")
        return value

    return parse


def build_arg_parser() -> argparse.ArgumentParser:
    p = _Parser(
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


def _make_degrader(args) -> BackendDegrader:
    """The run's degrade chain state (a pass-through unless --degrade);
    replacement scorers keep the device."""
    return BackendDegrader(
        AlignmentScorer(args.backend, device=args.device),
        lambda b: AlignmentScorer(b, device=args.device),
        enabled=bool(args.degrade),
    )


def _run_batch(args, policy, out) -> None:
    from ..utils.journal import ResultJournal

    problem = load_problem(args.input)
    deg = _make_degrader(args)
    journal = None
    if args.journal:
        _check_resume(args)
        journal = ResultJournal(args.journal)
    # No feed staging here: no device work runs before the one dispatch,
    # so there is nothing for early copies to overlap (--stream stages).

    def score_once(sc):
        if journal is not None:
            return journal.score_with_resume(sc, problem)
        return sc.score_codes(problem.seq1_codes, problem.seq2_codes, problem.weights)

    def verify(rows):
        verify_rows_against_oracle(
            problem.seq1_codes, problem.seq2_codes, problem.weights, rows)

    results = run_degrading(
        policy, deg, lambda: score_once(deg.scorer), score_once, "scoring",
        verify=verify if deg.enabled else None,
    )
    if args.selfcheck:
        from ..utils.selfcheck import verify_results

        checked = verify_results(problem, results)
        log_line(f"{PROG}: selfcheck OK ({checked} sequences re-verified on the "
                 "host oracle)")
    if args.json:
        write_json_sidecar(results, args.json,
                           meta={"backend": deg.scorer.backend, "device": args.device})
    print_results(results, out=out)


def _run_streaming(args, policy, out) -> None:
    """The --stream pipeline: parse and score CHUNK sequences at a time
    with a window of chunks in flight (each one's device-to-host copy
    started at dispatch, the next chunk's host-to-device copies staged
    while the current one computes).  Output is buffered and written only
    after the whole stream succeeds.  With --journal, a
    ``StreamJournal`` resumes chunk by chunk: only the sequences without
    a hash-matching record are scored."""
    from ..utils.journal import JournalMismatchError, StreamJournal, seq_hash

    deg = _make_degrader(args)
    all_results = [] if args.json else None
    lines = io.StringIO()
    with open_input(args.input) as stream:
        header = parse_stream_header(stream)
        journal, done = None, {}
        if args.journal:
            _check_resume(args)
            journal = StreamJournal(args.journal, header.weights, header.seq1_codes,
                                    header.num_seq2)
            done = journal.load()
        pipe = ChunkPipeline(policy, deg)
        # No staging under --journal: a resumed chunk is reduced to its
        # unscored subset, so a whole-chunk prestage would move dead bytes.
        stager = FeedStager(deg, enabled=False if journal is not None else None)
        seq1, weights = header.seq1_codes, header.weights

        def submit(start, codes, staged=None):
            """Dispatch a chunk: (promise, start, codes, pend, rows, hashes,
            budget); with a journal only the unrecorded rows are scored."""
            budget = policy.new_budget()
            if journal is None:
                promise = pipe.dispatch(seq1, codes, weights, budget, staged=staged)
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
            promise = None
            if pend:
                promise = pipe.dispatch(seq1, [codes[j] for j in pend], weights, budget,
                                        staged=staged)
            return (promise, start, codes, pend, rows, hashes, budget)

        def finish(promise, start, codes, pend, rows, hashes, budget):
            res = None
            if promise is not None:
                sub = codes if pend is None else [codes[j] for j in pend]
                res = pipe.materialise(promise, seq1, sub, weights, budget)
            out_rows = res
            if pend is not None:
                out_rows = rows
                if res is not None:
                    for j, row in zip(pend, res):
                        out_rows[j] = row
                    # An injected append fault fires before the first byte,
                    # so a retried append duplicates nothing; it gets its
                    # own budget, apart from the chunk's scoring budget.
                    policy.run(
                        lambda: journal.append([start + j for j in pend],
                                               [hashes[j] for j in pend], res),
                        "journal append",
                    )
            print_results(out_rows, out=lines, start=start)
            if all_results is not None:
                all_results.extend(out_rows)

        with contextlib.ExitStack() as stack:
            if journal is not None:
                stack.enter_context(journal)
            window = PendingWindow(max(1, env_int("TPU_SEQALIGN_STREAM_DEPTH", 4)), finish)
            drained_at = None
            # One chunk of input lookahead: each step dispatches the held
            # chunk, then stages the chunk just read, then lets the window
            # finish its oldest entry.
            held = None
            for start, codes in header.iter_chunks(args.stream):
                if drain_requested():
                    # Admit no more chunks; the window still finishes (and
                    # journals) what is in flight.  A held, undispatched
                    # chunk is not admitted: the drain point is its start.
                    drained_at = held[0] if held is not None else start
                    held = None
                    break
                item = submit(*held) if held is not None else None
                held = (start, codes, stager.stage(seq1, codes, weights))
                if item is not None:
                    window.push(*item)
            if held is not None:
                window.push(*submit(*held))
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
    out.write(lines.getvalue())
    if args.json:
        write_json_sidecar(all_results, args.json,
                           meta={"backend": deg.scorer.backend, "device": args.device})


def run(argv: list[str] | None = None) -> int:
    try:
        args = build_arg_parser().parse_args(argv)
    except UsageError as e:
        print(f"{PROG}: usage: {e}", file=sys.stderr)
        return EX_USAGE
    if args.stream and args.selfcheck:
        print(f"{PROG}: error: --selfcheck cannot be combined with --stream "
              "(selfcheck re-verifies against the fully-materialised problem)",
              file=sys.stderr)
        return EX_USAGE
    if args.resume and not args.journal:
        print(f"{PROG}: error: --resume requires --journal PATH (the journal "
              "is what a resume resumes from)", file=sys.stderr)
        return EX_USAGE
    # A malformed spec is a usage error, caught before the runtime try
    # below would make it a 65.
    try:
        policy, fault_spec = _build_policy(args)
        if fault_spec:
            parse_spec(fault_spec)
        deadline = args.deadline
        if deadline is None:
            deadline = env_float("SEQALIGN_DEADLINE_S")
    except ValueError as e:
        print(f"{PROG}: error: {e}", file=sys.stderr)
        return EX_USAGE
    drain = None
    try:
        activate_faults(fault_spec)
        if deadline:
            activate_watchdog(deadline)
        drain = drain_guard()
        drain.__enter__()
        # Native libraries (the CUDA runtime, nvcc's build) may write to
        # fd 1; only the result lines reach the real stdout.
        with guarded_stdout() as out:
            if args.stream:
                _run_streaming(args, policy, out)
            else:
                _run_batch(args, policy, out)
        return EX_OK
    except DrainInterrupt as e:
        # A requested preemption: nothing printed, the journal flushed.
        print(f"{PROG}: drained: {e}", file=sys.stderr)
        return EX_TEMPFAIL
    except BrokenPipeError:
        return 1
    except Exception as e:  # fail-stop: diagnose on stderr, nonzero exit
        print(f"{PROG}: error: {e}", file=sys.stderr)
        return EX_TEMPFAIL if _is_resumable(e) else EX_FATAL
    finally:
        # Faults, the watchdog and the drain handlers are armed per run:
        # library callers after a CLI run see none of them.
        deactivate_faults()
        deactivate_watchdog()
        if drain is not None:
            drain.__exit__(None, None, None)


def main() -> None:
    sys.exit(run())
