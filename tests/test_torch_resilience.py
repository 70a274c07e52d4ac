"""The port's resilience runtime against the contracts that
``tests/test_resilience.py`` and ``tests/test_survival.py`` pin for the
JAX package: the fault grammar and registry, the retry policy (shared
budgets, fatal classes, deterministic backoff), the degrade chain
cuda -> mm -> gather with its oracle check, the watchdog (injected hangs
expire into a transient error, a polled device wait gives up at the
deadline), the drain (75, then --resume) and the exit-code contract, all
through the port's CLI on ``--device cpu`` with byte-exact goldens."""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from mpi_openmp_cuda_tpu.ops.oracle import score_batch_oracle
from mpi_openmp_cuda_tpu.resilience import faults as jfaults
from mpi_openmp_cuda_tpu.resilience import policy as jpolicy
from mpi_openmp_cuda_tpu_torch.io import cli as tcli
from mpi_openmp_cuda_tpu_torch.ops import _build
from mpi_openmp_cuda_tpu_torch.ops import cuda_scorer as cs
from mpi_openmp_cuda_tpu_torch.ops import dispatch as tdispatch
from mpi_openmp_cuda_tpu_torch.resilience import drain as drain_mod
from mpi_openmp_cuda_tpu_torch.resilience.degrade import (
    DEGRADE_CHAIN, DegradedBackendMismatchError, MaterialisedRows,
    verify_rows_against_oracle,
)
from mpi_openmp_cuda_tpu_torch.resilience.faults import (
    FaultRegistry, InjectedFatalFaultError, InjectedFaultError, SiteFaults,
    activate_faults, deactivate_faults, fire, parse_spec,
)
from mpi_openmp_cuda_tpu_torch.resilience.policy import (
    FATAL_ERROR_TYPES, DeviceFaultError, KernelUnavailableError, RetryExhaustedError,
    RetryPolicy,
)
from mpi_openmp_cuda_tpu_torch.resilience.watchdog import (
    THREAD_NAME, DeadlineExpiredError, HangWithoutDeadlineError, activate_watchdog,
    deactivate_watchdog, guard, hang_until_deadline,
)

REPO = Path(__file__).resolve().parent.parent
FIX = REPO / "tests" / "fixtures"


def fixture(name: str) -> str:
    return str(FIX / f"{name}.txt")


def golden(name: str) -> str:
    return (FIX / f"{name}.out").read_text()


@pytest.fixture(autouse=True)
def _quiet_env(monkeypatch):
    # No real backoff sleeps; no ambient survival settings.
    monkeypatch.setenv("SEQALIGN_BACKOFF_BASE", "0")
    for var in ("SEQALIGN_DEADLINE_S", "SEQALIGN_DRAIN", "SEQALIGN_FAULTS",
                "SEQALIGN_FAULT_RETRIES"):
        monkeypatch.delenv(var, raising=False)


def port(*args, capfd, rc_want=0):
    """The port's CLI in-process on the CPU: (stdout, stderr)."""
    rc = tcli.run(["--device", "cpu", *args])
    cap = capfd.readouterr()
    assert rc == rc_want, cap.err
    return cap.out, cap.err


def _watchdog_threads():
    return [t for t in threading.enumerate() if t.name == THREAD_NAME]


# -- the fault grammar and registry ---------------------------------------


def test_parse_spec_full_grammar_matches_jax():
    spec = "chunk_scoring:fail=2;journal_append:fail=1,after=3,kind=fatal;hang:gather:fail=1"
    got = parse_spec(spec)
    assert got == {
        "chunk_scoring": SiteFaults(fail=2),
        "journal_append": SiteFaults(fail=1, after=3, kind="fatal"),
        "hang:gather": SiteFaults(fail=1),
    }
    want = jfaults.parse_spec(spec)
    assert {k: (v.fail, v.after, v.kind) for k, v in got.items()} == {
        k: (v.fail, v.after, v.kind) for k, v in want.items()}


@pytest.mark.parametrize(
    "bad, match",
    [
        ("bogus_site:fail=1", "known sites"),
        ("kill:fleet-workr:fail=1", "known sites"),  # a misspelt fleet site
        ("chunk_scoring", "want site:fail=N"),
        ("chunk_scoring:after=1", "needs fail=N"),
        ("chunk_scoring:nope=1", "bad --faults key"),
        ("chunk_scoring:fail=x", "bad --faults value"),
        ("chunk_scoring:fail=-1", "must be >= 0"),
        ("chunk_scoring:fail=1,kind=sometimes", "bad --faults kind"),
        ("chunk_scoring:fail=1;chunk_scoring:fail=2", "duplicate"),
        ("hang:dispatch:fail=1,kind=fatal", "does not take kind"),
    ],
)
def test_parse_spec_rejects_malformed(bad, match):
    with pytest.raises(ValueError, match=match):
        parse_spec(bad)


def test_batch_sites_are_the_jax_sites():
    from mpi_openmp_cuda_tpu_torch.resilience.faults import KNOWN_SITES

    assert KNOWN_SITES == jfaults.KNOWN_SITES
    assert KNOWN_SITES == {
        "chunk_dispatch", "chunk_scoring", "device_transfer", "journal_append",
        "broadcast_problem", "broadcast_chunk", "broadcast_index_set",
        "broadcast_stream_meta", "hang:dispatch", "hang:gather", "hang:broadcast",
        "kill:journal-append", "kill:serve-tick", "slow-client",
        "dead-socket-midstream", "poison-session", "overload-burst", "burst:overload",
        "kill:fleet-worker", "kill:fleet-coordinator", "zombie:fleet-worker",
        "zombie:fleet-leader", "board:torn-post", "board:enospc", "lease:stall"}


def test_registry_counts_are_deterministic():
    reg = FaultRegistry("chunk_scoring:fail=2,after=1")
    reg.fire("chunk_scoring")
    for _ in range(2):
        with pytest.raises(InjectedFaultError):
            reg.fire("chunk_scoring")
    reg.fire("chunk_scoring")
    reg.fire("journal_append")
    assert reg.injected == 2 and reg.counts == {"chunk_scoring": 4, "journal_append": 1}


def test_fatal_kind_is_a_value_error():
    reg = FaultRegistry("device_transfer:fail=1,kind=fatal")
    with pytest.raises(InjectedFatalFaultError) as exc:
        reg.fire("device_transfer")
    assert isinstance(exc.value, ValueError) and RetryPolicy.is_fatal(exc.value)
    assert not RetryPolicy.is_fatal(InjectedFaultError("x"))


def test_fire_is_inert_until_activated():
    deactivate_faults()
    fire("chunk_scoring")
    try:
        reg = activate_faults("chunk_scoring:fail=1")
        with pytest.raises(InjectedFaultError):
            fire("chunk_scoring")
        assert reg.injected == 1
    finally:
        deactivate_faults()
    fire("chunk_scoring")


# -- the retry policy ------------------------------------------------------


def test_policy_shared_budget_spans_stages():
    policy = RetryPolicy(retries=2, backoff_base=0, log=lambda m: None)
    budget = policy.new_budget()
    state = {"a": 0, "b": 0}

    def stage(key):
        def fn():
            state[key] += 1
            if state[key] == 1:
                raise RuntimeError(f"transient {key}")
            return key
        return fn

    assert policy.run(stage("a"), "a", budget=budget) == "a"
    assert policy.run(stage("b"), "b", budget=budget) == "b"
    assert budget == [2]
    with pytest.raises(RetryExhaustedError):
        policy.run(lambda: (_ for _ in ()).throw(RuntimeError("c")), "c", budget=budget)


@pytest.mark.parametrize("exc", [
    ValueError("shape bug"), TypeError("bad call"),
    KernelUnavailableError("kernel build failed"),
    DeviceFaultError("fused_scorer failed: CUDA error 700"),
    torch.AcceleratorError("CUDA error: an illegal memory access was encountered"),
], ids=["value", "type", "build", "sticky", "accelerator"])
def test_policy_never_retries_fatal_errors(exc):
    calls = {"n": 0}

    def bad():
        calls["n"] += 1
        raise exc

    policy = RetryPolicy(retries=5, backoff_base=0, log=lambda m: None)
    with pytest.raises(type(exc)):
        policy.run(bad, "x")
    assert calls["n"] == 1 and isinstance(exc, FATAL_ERROR_TYPES)


@pytest.mark.parametrize("exc", [
    RuntimeError("device busy"), torch.OutOfMemoryError("CUDA out of memory"),
    InjectedFaultError("x"), DeadlineExpiredError("late"),
], ids=["runtime", "oom", "injected", "deadline"])
def test_policy_retries_transient_errors(exc):
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] == 1:
            raise exc
        return "ok"

    assert RetryPolicy(retries=1, backoff_base=0, log=lambda m: None).run(flaky, "x") == "ok"
    assert not isinstance(exc, FATAL_ERROR_TYPES)


def test_launch_errors_split_sticky_from_unavailable():
    assert isinstance(cs.launch_error("fused_scorer", 700), DeviceFaultError)
    assert isinstance(cs.launch_error("fused_scorer", 719), DeviceFaultError)
    for code in (1, 9, 209, 701):  # bad value, config, no image, resources
        assert isinstance(cs.launch_error("fused_scorer", code), KernelUnavailableError)


def test_policy_exhaustion_chains_the_cause():
    policy = RetryPolicy(retries=1, backoff_base=0, log=lambda m: None)

    def down():
        raise RuntimeError("persistent device loss")

    with pytest.raises(RetryExhaustedError, match="persistent device loss") as exc:
        policy.run(down, "scoring")
    assert isinstance(exc.value.__cause__, RuntimeError)


def test_backoff_is_exponential_capped_and_deterministic_like_jax():
    delays = []
    policy = RetryPolicy(retries=6, backoff_base=0.1, backoff_cap=0.5,
                         sleep=delays.append, log=lambda m: None)
    state = {"n": 0}

    def flaky():
        state["n"] += 1
        if state["n"] <= 6:
            raise RuntimeError("flap")
        return "ok"

    assert policy.run(flaky, "site") == "ok"
    raw = [min(0.5, 0.1 * 2 ** k) for k in range(6)]
    assert all(0.5 * r <= d < 1.5 * r for d, r in zip(delays, raw))
    twin = jpolicy.RetryPolicy(retries=6, backoff_base=0.1, backoff_cap=0.5)
    assert [twin.backoff_delay(k + 1, "site") for k in range(6)] == delays


# -- the degrade chain -----------------------------------------------------


def test_chain_and_materialised_rows():
    assert DEGRADE_CHAIN == {"cuda": "mm", "mm": "gather"}
    rows = [(1, 2, 3)]
    wrapped = MaterialisedRows(rows)
    wrapped.prefetch()
    assert wrapped.result() is rows


def test_verify_rows_against_oracle_catches_corruption():
    seq1 = np.array([1, 2, 3, 4], dtype=np.int8)
    seqs = [np.array([1, 2], dtype=np.int8), np.array([3], dtype=np.int8)]
    weights = [4, 3, 2, 1]
    good = score_batch_oracle(seq1, seqs, weights)
    verify_rows_against_oracle(seq1, seqs, weights, good)
    bad = [tuple(good[0]), (good[1][0] + 1, good[1][1], good[1][2])]
    with pytest.raises(DegradedBackendMismatchError):
        verify_rows_against_oracle(seq1, seqs, weights, bad)
    assert isinstance(DegradedBackendMismatchError("x"), ValueError)


# -- e2e: faults through the CLI -------------------------------------------


def test_batch_under_budget_faults_keep_goldens(capfd):
    out, err = port("--input", fixture("tiny"), "--retries", "2",
                    "--faults", "chunk_scoring:fail=2", capfd=capfd)
    assert out == golden("tiny") and err.count("retrying") == 2


def test_batch_over_budget_faults_fail_stop(capfd):
    out, err = port("--input", fixture("tiny"), "--retries", "1",
                    "--faults", "chunk_scoring:fail=5", capfd=capfd, rc_want=65)
    assert out == "" and "retry budget exhausted" in err


def test_stream_under_and_over_budget(capfd):
    out, err = port("--input", fixture("stress_small"), "--stream", "3", "--retries", "2",
                    "--faults", "chunk_scoring:fail=2", capfd=capfd)
    assert out == golden("stress_small") and "retrying" in err
    out, err = port("--input", fixture("stress_small"), "--stream", "3",
                    "--faults", "chunk_scoring:fail=99", capfd=capfd, rc_want=65)
    assert out == "" and "retry budget exhausted" in err


def test_stream_chunk_budget_is_shared_across_stages(capfd):
    spec = "chunk_dispatch:fail=1;chunk_scoring:fail=1"
    out, _ = port("--input", fixture("tiny"), "--stream", "64", "--retries", "2",
                  "--faults", spec, capfd=capfd)
    assert out == golden("tiny")
    out, err = port("--input", fixture("tiny"), "--stream", "64", "--retries", "1",
                    "--faults", spec, capfd=capfd, rc_want=65)
    assert out == "" and "retry budget exhausted" in err


def test_stream_prefetch_fault_is_absorbed(capfd):
    out, err = port("--input", fixture("stress_small"), "--stream", "3",
                    "--faults", "device_transfer:fail=99", capfd=capfd)
    assert out == golden("stress_small") and "retrying" not in err


def test_injected_fatal_fault_skips_retries(capfd):
    out, err = port("--input", fixture("tiny"), "--retries", "5",
                    "--faults", "chunk_scoring:fail=1,kind=fatal", capfd=capfd, rc_want=65)
    assert out == "" and "injected fatal fault" in err and "retrying" not in err


def test_malformed_faults_spec_is_a_usage_error(capfd):
    _, err = port("--input", fixture("tiny"), "--faults", "warp_core:fail=1",
                  capfd=capfd, rc_want=64)
    assert "error:" in err and "known sites" in err


def test_env_spec_with_retry_floor(monkeypatch, capfd):
    monkeypatch.setenv("SEQALIGN_FAULTS", "chunk_scoring:fail=2")
    monkeypatch.setenv("SEQALIGN_FAULT_RETRIES", "3")
    out, err = port("--input", fixture("tiny"), capfd=capfd)
    assert out == golden("tiny") and "retrying" in err


def test_explicit_faults_override_env_without_floor(monkeypatch, capfd):
    monkeypatch.setenv("SEQALIGN_FAULTS", "chunk_scoring:fail=99")
    monkeypatch.setenv("SEQALIGN_FAULT_RETRIES", "99")
    out, err = port("--input", fixture("tiny"), "--faults", "chunk_scoring:fail=1",
                    capfd=capfd, rc_want=65)
    assert out == "" and "retry budget exhausted" in err


def test_faults_are_disarmed_after_the_run(capfd):
    port("--input", fixture("tiny"), "--retries", "1", "--faults", "chunk_scoring:fail=1",
         capfd=capfd)
    fire("chunk_scoring")


# -- e2e: the degrade chain ------------------------------------------------


def test_degrade_cuda_to_mm_completes_run(capfd):
    out, err = port("--input", fixture("tiny"), "--retries", "1", "--degrade",
                    "--faults", "chunk_scoring:fail=2", capfd=capfd)
    assert out == golden("tiny")
    assert "backend 'cuda' exhausted its retry budget" in err
    assert "degrading to 'mm'" in err and "degrading to 'gather'" not in err


def test_degrade_reaches_gather(capfd):
    out, err = port("--input", fixture("stress_small"), "--retries", "1", "--degrade",
                    "--faults", "chunk_scoring:fail=4", capfd=capfd)
    assert out == golden("stress_small")
    assert "degrading to 'mm'" in err and "degrading to 'gather'" in err


def test_degrade_stream_mode_completes_run(capfd):
    out, err = port("--input", fixture("stress_small"), "--stream", "3", "--retries", "1",
                    "--degrade", "--faults", "chunk_scoring:fail=2", capfd=capfd)
    assert out == golden("stress_small") and "degrading to 'mm'" in err


def test_degrade_chain_exhaustion_fails_stop(capfd):
    out, err = port("--input", fixture("tiny"), "--degrade",
                    "--faults", "chunk_scoring:fail=99", capfd=capfd, rc_want=65)
    assert out == "" and "degrading to 'gather'" in err
    assert "retry budget exhausted" in err


@pytest.fixture
def broken_build(monkeypatch, tmp_path):
    """Kernel launches on CPU tensors go to the kernel, and its build
    fails: nvcc is ``false``, which exits 1."""
    monkeypatch.setattr(cs, "_device_of", lambda state: "cuda")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")
    monkeypatch.setattr(_build, "_libs", {})
    cs._entry.cache_clear()
    yield
    cs._entry.cache_clear()


def test_failed_kernel_build_is_fatal_without_degrade(broken_build, capfd):
    """auto is cuda; a kernel that cannot be built ends the run with 65,
    never retried and never moved to another backend."""
    out, err = port("--input", fixture("tiny"), "--retries", "3", capfd=capfd, rc_want=65)
    assert out == "" and "kernel build failed" in err
    assert "retrying" not in err and "degrading" not in err


def test_failed_kernel_build_degrades_to_mm_under_degrade(broken_build, capfd):
    out, err = port("--input", fixture("tiny"), "--degrade", capfd=capfd)
    assert out == golden("tiny")
    assert "backend 'cuda' cannot run its kernel here; degrading to 'mm'" in err


# -- the watchdog ----------------------------------------------------------


def test_guard_is_noop_without_watchdog():
    with guard("anything"):
        pass
    assert _watchdog_threads() == []


def test_activate_deactivate_joins_monitor_thread():
    wd = activate_watchdog(5.0)
    try:
        assert len(_watchdog_threads()) == 1
        with wd.guard("covered op"):
            pass
    finally:
        deactivate_watchdog()
    assert _watchdog_threads() == [] and wd.expiries == 0


def test_injected_hang_surfaces_transient_expiry():
    wd = activate_watchdog(0.05)
    try:
        with wd.guard("covered op"):
            with pytest.raises(DeadlineExpiredError, match="covered op"):
                wd.hang_until_expiry("hang:test")
    finally:
        deactivate_watchdog()
    assert wd.expiries == 1 and isinstance(DeadlineExpiredError("x"), RuntimeError)


def test_injected_hang_without_watchdog_is_fatal():
    with pytest.raises(HangWithoutDeadlineError, match="no watchdog"):
        hang_until_deadline("hang:test")
    assert isinstance(HangWithoutDeadlineError("x"), ValueError)


def test_polled_device_wait_gives_up_at_the_deadline():
    """A device result that never lands: the guarded wait polls its event
    and raises the transient expiry instead of blocking forever."""

    class NeverDone:
        def query(self):
            return False

        def synchronize(self):  # pragma: no cover - must not be called
            raise AssertionError("blocking wait under a deadline")

    pend = tdispatch.BucketedPending(torch.zeros((0, 3), dtype=torch.int32))
    pend._host, pend._event = torch.zeros((0, 3), dtype=torch.int32), NeverDone()
    wd = activate_watchdog(0.05)
    try:
        with pytest.raises(DeadlineExpiredError, match="device result wait"):
            pend.result()
    finally:
        deactivate_watchdog()
    assert wd.expiries == 1


@pytest.mark.parametrize("site", ["dispatch", "gather"])
def test_hang_retried_under_deadline(site, capfd):
    out, err = port("--input", fixture("tiny"), "--retries", "2", "--deadline", "0.05",
                    "--faults", f"hang:{site}:fail=1", capfd=capfd)
    assert out == golden("tiny") and "watchdog deadline" in err
    assert _watchdog_threads() == []


def test_deadline_rooted_exhaustion_exits_resumable(capfd):
    out, err = port("--input", fixture("tiny"), "--retries", "0", "--deadline", "0.05",
                    "--faults", "hang:dispatch:fail=3", capfd=capfd, rc_want=75)
    assert out == "" and "retry budget exhausted" in err


def test_hang_without_deadline_fails_fast(capfd):
    out, err = port("--input", fixture("tiny"), "--retries", "5",
                    "--faults", "hang:dispatch:fail=1", capfd=capfd, rc_want=65)
    assert out == "" and "no watchdog armed" in err and "retrying" not in err


# -- the drain and the exit codes ------------------------------------------


def test_prearmed_drain_batch_journal_then_resume(tmp_path, monkeypatch, capfd):
    path = str(tmp_path / "j.jsonl")
    monkeypatch.setenv("SEQALIGN_DRAIN", "1")
    out, err = port("--input", fixture("tiny"), "--journal", path, capfd=capfd, rc_want=75)
    assert out == "" and "drained" in err and "--resume" in err
    lines = [json.loads(line) for line in Path(path).read_text().splitlines()]
    assert lines[0]["format"] == "mpi_openmp_cuda_tpu.journal.v1"
    assert {"event": "drain"} in lines
    monkeypatch.delenv("SEQALIGN_DRAIN")
    out, _ = port("--input", fixture("tiny"), "--journal", path, "--resume", capfd=capfd)
    assert out == golden("tiny")


def test_prearmed_drain_without_journal_still_resumable_exit(monkeypatch, capfd):
    monkeypatch.setenv("SEQALIGN_DRAIN", "1")
    out, err = port("--input", fixture("tiny"), "--stream", "2", capfd=capfd, rc_want=75)
    assert out == "" and "starts over" in err


def test_sigterm_mid_stream_drains_then_resume(tmp_path, monkeypatch, capfd):
    path = str(tmp_path / "j.jsonl")
    calls = {"n": 0}
    orig = tdispatch.AlignmentScorer.score_codes_async

    def signalling(self, *a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            signal.raise_signal(signal.SIGTERM)
        return orig(self, *a, **kw)

    monkeypatch.setattr(tdispatch.AlignmentScorer, "score_codes_async", signalling)
    out, err = port("--input", fixture("stress_small"), "--stream", "3", "--journal", path,
                    capfd=capfd, rc_want=75)
    assert out == "" and "drain requested (SIGTERM)" in err
    assert "preempted before sequence" in err
    recs = [json.loads(line) for line in Path(path).read_text().splitlines()]
    assert {"event": "drain"} in recs
    assert sum(1 for r in recs if "index" in r) >= 3
    monkeypatch.setattr(tdispatch.AlignmentScorer, "score_codes_async", orig)
    out, _ = port("--input", fixture("stress_small"), "--stream", "3", "--journal", path,
                  "--resume", capfd=capfd)
    assert out == golden("stress_small")


def test_sigterm_inside_a_bus_publish_is_announced_at_the_next_check(capfd):
    """The drain handler publishes nothing: a SIGTERM that lands while the
    main thread holds the flight recorder's and the trace's locks (inside
    a bus publish) only sets the flag, and the next check announces it
    (a publish from the handler would wait on those locks forever)."""
    from mpi_openmp_cuda_tpu_torch.obs import (
        arm_observability, disarm_observability, flightrec, trace)

    registry, _ = arm_observability(with_trace=True, flightrec_depth=16)
    try:
        with drain_mod.drain_guard():
            with flightrec.active_flightrec()._lock, trace.active_trace()._lock:
                signal.raise_signal(signal.SIGTERM)
            assert "drain requested" not in capfd.readouterr().err
            assert drain_mod.drain_requested()
            assert "drain requested (SIGTERM)" in capfd.readouterr().err
            assert registry.snapshot()["counters"]["drain_requests"] == 1
            assert [e["name"] for e in flightrec.active_flightrec().snapshot_tape()
                    if e["name"] == "drain.request"] == ["drain.request"]
    finally:
        disarm_observability()
    assert not drain_mod.drain_requested()


def test_cli_run_leaves_no_signal_handlers(capfd):
    before = (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT))
    port("--input", fixture("tiny"), "--deadline", "5", capfd=capfd)
    assert (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)) == before
    assert _watchdog_threads() == [] and not drain_mod.drain_requested()


def test_exit_code_contract(tmp_path, monkeypatch, capfd):
    assert (tcli.EX_OK, tcli.EX_USAGE, tcli.EX_FATAL, tcli.EX_TEMPFAIL) == (0, 64, 65, 75)
    port("--input", fixture("tiny"), capfd=capfd)
    _, err = port("--input", fixture("tiny"), "--resume", capfd=capfd, rc_want=64)
    assert "--resume requires --journal" in err
    port("--input", fixture("tiny"), "--stream", "2", "--selfcheck", capfd=capfd, rc_want=64)
    for bad in (["--retries", "-1"], ["--stream", "0"], ["--deadline", "0"],
                ["--backend", "xla"]):
        # argparse's own usage error, as in the JAX CLI.
        port("--input", fixture("tiny"), *bad, capfd=capfd, rc_want=2)
    badfile = tmp_path / "bad.txt"
    badfile.write_text("1 2 3\n")
    port("--input", str(badfile), capfd=capfd, rc_want=65)
    _, err = port("--input", fixture("tiny"), "--journal", str(tmp_path / "nope.jsonl"),
                  "--resume", capfd=capfd, rc_want=65)
    assert "does not exist" in err
    monkeypatch.setenv("SEQALIGN_DRAIN", "1")
    port("--input", fixture("tiny"), "--journal", str(tmp_path / "j.jsonl"), capfd=capfd,
         rc_want=75)


@pytest.mark.parametrize("backend", ["cuda", "mm", "gather", "oracle"])
def test_selfcheck_passes_on_every_backend(backend, capfd):
    out, err = port("--input", fixture("stress_small"), "--backend", backend,
                    "--selfcheck", capfd=capfd)
    assert out == golden("stress_small") and "selfcheck OK" in err


# -- kill and resume (subprocesses; the slow tier, as in the JAX suite) ----


def _big_input(path: Path) -> None:
    rng = np.random.default_rng(5)
    letters = np.array(list("ABCDEFGHIJKLMNOPQRSTUVWXYZ"))
    seq1 = "".join(rng.choice(letters, size=300))
    seqs = ["".join(rng.choice(letters, size=int(n))) for n in rng.integers(1, 60, size=150)]
    path.write_text("\n".join(["3 1 2 4", seq1, str(len(seqs)), *seqs]) + "\n")


def _port_proc(*args, stdin_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("SEQALIGN_")}
    env["SEQALIGN_BACKOFF_BASE"] = "0"
    with open(stdin_path) as f:
        return subprocess.run(
            [sys.executable, "-m", "mpi_openmp_cuda_tpu_torch", "--device", "cpu", *args],
            stdin=f, capture_output=True, text=True, env=env, cwd=REPO, timeout=300,
        )


@pytest.mark.slow
@pytest.mark.chaos_kill
def test_kill_mid_batch_then_resume_byte_identical(tmp_path):
    inp = tmp_path / "big.txt"
    _big_input(inp)
    journal = str(tmp_path / "j.jsonl")
    clean = _port_proc(stdin_path=inp)
    assert clean.returncode == 0, clean.stderr
    killed = _port_proc("--journal", journal, "--faults", "kill:journal-append:fail=1,after=1",
                        stdin_path=inp)
    assert killed.returncode == -signal.SIGKILL and killed.stdout == ""
    recs = [json.loads(line) for line in Path(journal).read_text().splitlines() if line]
    assert sum(1 for r in recs if "index" in r) == 64
    resumed = _port_proc("--journal", journal, "--resume", stdin_path=inp)
    assert resumed.returncode == 0, resumed.stderr
    assert resumed.stdout == clean.stdout


@pytest.mark.slow
@pytest.mark.chaos_kill
def test_kill_mid_stream_then_resume_byte_identical(tmp_path):
    inp = tmp_path / "big.txt"
    _big_input(inp)
    journal = str(tmp_path / "js.jsonl")
    clean = _port_proc("--stream", "16", stdin_path=inp)
    assert clean.returncode == 0, clean.stderr
    killed = _port_proc("--stream", "16", "--journal", journal,
                        "--faults", "kill:journal-append:fail=1,after=2", stdin_path=inp)
    assert killed.returncode == -signal.SIGKILL and killed.stdout == ""
    recs = [json.loads(line) for line in Path(journal).read_text().splitlines() if line]
    assert sum(1 for r in recs if "index" in r) == 32
    resumed = _port_proc("--stream", "16", "--journal", journal, "--resume", stdin_path=inp)
    assert resumed.returncode == 0, resumed.stderr
    assert resumed.stdout == clean.stdout
