"""The environment knobs the port reads, and their typed accessors.

A copy of the registry pattern of ``mpi_openmp_cuda_tpu/utils/
platform.py``, holding only the variables the port reads so far (the
serve, telemetry and breaker knobs of ``--serve``, the fleet's and the
rescue tier's ``SEQALIGN_BEACON_S``, the warm plane's ``SEQALIGN_PREWARM``
and the native driver's ``TPU_SEQALIGN_DEVICE`` among them), under
the same names as the JAX package, so one shell drives both CLIs, plus
the rendezvous variables of a ``--distributed`` job under torchrun's
names (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``); nothing else in the port reads
them.  :func:`cache_home` and :func:`platform_tag` place the warm
plane's manifest (``aot/manifest.py``).  Every
read happens at call time (tests' ``monkeypatch.setenv`` works) and a
malformed value raises one ``ValueError`` naming the variable.
"""

from __future__ import annotations

import dataclasses
import os
import re


@dataclasses.dataclass(frozen=True)
class EnvVar:
    """One declared knob: name, type ('str' / 'int' / 'float' / 'flag'),
    default and a one-line doc."""

    name: str
    kind: str
    default: str | int | float | bool | None
    doc: str


ENV_VARS: tuple[EnvVar, ...] = (
    EnvVar("SEQALIGN_FAULTS", "str", None,
           "deterministic fault-injection spec (see --faults)"),
    EnvVar("SEQALIGN_FAULT_RETRIES", "int", 0,
           "extra retry-budget floor when the fault spec comes from "
           "SEQALIGN_FAULTS"),
    EnvVar("SEQALIGN_BACKOFF_BASE", "float", None,
           "the retry policy's backoff base delay in seconds (0: no sleep)"),
    EnvVar("SEQALIGN_DEADLINE_S", "float", None,
           "watchdog deadline in seconds around device work (same as "
           "--deadline; expiry is a transient fault)"),
    EnvVar("SEQALIGN_DRAIN", "flag", False,
           "pre-arm the drain: the run flushes its journal and exits 75 "
           "at its first chunk boundary"),
    EnvVar("TPU_SEQALIGN_STREAM_DEPTH", "int", 4,
           "chunks in flight in the --stream pipeline"),
    EnvVar("TPU_SEQALIGN_FEED_OVERLAP", "flag", True,
           "stage the next chunk's host->device copies on a side CUDA "
           "stream while the current chunk computes (0 disables)"),
    EnvVar("SEQALIGN_METRICS", "flag", False,
           "arm the observability plane (same as --metrics)"),
    EnvVar("SEQALIGN_METRICS_OUT", "str", None,
           "write the JSON run report (and a .prom sidecar) here on exit "
           "(same as --metrics-out)"),
    EnvVar("SEQALIGN_HEARTBEAT_S", "float", None,
           "seconds between [obs] status lines on stderr (same as "
           "--heartbeat)"),
    EnvVar("SEQALIGN_TRACE", "str", None,
           "write the Chrome-trace JSON timeline here on exit (same as "
           "--trace-out)"),
    EnvVar("SEQALIGN_FLIGHTREC_DEPTH", "int", 256,
           "flight-recorder ring depth while the obs plane is armed "
           "(0 disables)"),
    EnvVar("SEQALIGN_CACHE_DIR", "str", None,
           "the port's cache home (flight-recorder dumps under "
           "<dir>/flightrec)"),
    EnvVar("TPU_SEQALIGN_COMPILE_CACHE", "str", None,
           "off/0 disables the cache home; a directory is the legacy "
           "home when SEQALIGN_CACHE_DIR is unset"),
    EnvVar("SEQALIGN_PREWARM", "flag", False,
           "warm the kernels' launch shapes at process start (same as "
           "--prewarm; the manifest lives under <cache home>/aot)"),
    EnvVar("TPU_SEQALIGN_DEVICE", "str", None,
           "the native driver final_torch's device: cuda (default) or cpu "
           "(read by native/torch_backend.cpp, handed to native_bridge)"),
    EnvVar("SEQALIGN_HOST_DEVICES", "int", 1,
           "mesh devices the host counts as under --device cpu, each naming "
           "the one CPU device (the port's counterpart of XLA's "
           "--xla_force_host_platform_device_count); on cuda, a count above "
           "the card count gives that many mesh slots naming the cards in "
           "turn; under --distributed, the slots of each process (on cuda "
           "naming the process's cards in turn), every process setting the "
           "same count"),
    # The serve plane (--serve): its socket, queue, batching, SLO armor
    # and live telemetry.
    EnvVar("SEQALIGN_SERVE_PORT", "int", None,
           "loopback port for the --serve request socket (same as --port; "
           "0 = OS-assigned, announced on stderr)"),
    EnvVar("SEQALIGN_SERVE_MAX_QUEUE", "int", 256,
           "serve admission cap: requests queued past this depth are "
           "rejected with a 'queue full' error record"),
    EnvVar("SEQALIGN_SERVE_WINDOW_S", "float", 0.05,
           "serve gather window (seconds): after the first queued request "
           "the loop lingers this long so a concurrent burst coalesces "
           "into shared superblocks"),
    EnvVar("SEQALIGN_SERVE_BLOCK_ROWS", "int", 64,
           "rows per serve superblock; every dispatch has exactly this row "
           "count (padded), so the launch shapes stay few"),
    EnvVar("SEQALIGN_SERVE_MAX_POP", "int", 0,
           "max requests popped per serve tick (0 = unlimited); bounds one "
           "tick's latency under backlog"),
    EnvVar("SEQALIGN_SERVE_DEADLINE_S", "float", None,
           "default per-request deadline (seconds) for serve requests that "
           "carry no 'deadline_s' field; past-deadline requests are "
           "answered with a typed 'deadline' error instead of occupying "
           "superblock rows"),
    EnvVar("SEQALIGN_SERVE_COST_BUDGET_S", "float", 4.0,
           "admission token bucket: max modelled superblock-wall seconds "
           "(the Hopper launch model of ops/schedule.py) of "
           "admitted-but-unfinished serve work; over-budget requests get a "
           "typed 'overloaded' rejection with retry_after_s"),
    EnvVar("SEQALIGN_SERVE_COST_SCALE", "float", 1.0,
           "admission cost-model refit multiplier: request prices are the "
           "modelled wall x this scale, so a measured-load refit "
           "(load/refit.py) can calibrate the bucket to observed walls "
           "while the launch model stays the prior; 1.0 = trust the prior"),
    EnvVar("SEQALIGN_SERVE_SHED_WAIT_S", "float", 30.0,
           "load-shedding threshold: when the p90 of recent queue waits "
           "reaches this many seconds the serve loop escalates "
           "accept -> shed-new -> drain-only (de-escalates below half)"),
    EnvVar("SEQALIGN_SERVE_WRITE_TIMEOUT_S", "float", 5.0,
           "per-connection socket send timeout (seconds): a client whose "
           "socket buffer stays full this long is classified dead and its "
           "sessions abandoned (0 disables)"),
    EnvVar("SEQALIGN_TELEMETRY_PORT", "int", None,
           "loopback port for the --serve plain-HTTP telemetry endpoint "
           "(same as --telemetry-port; 0 = OS-assigned, announced on "
           "stderr): GET /metrics | /healthz | /trace"),
    EnvVar("SEQALIGN_BREAKER_THRESHOLD", "int", 3,
           "circuit breaker: transient primary-dispatch failures within "
           "the window that open the breaker (pinning the degraded "
           "backend; requires --degrade)"),
    EnvVar("SEQALIGN_BREAKER_WINDOW", "int", 16,
           "circuit breaker failure-memory window, in serve-loop ticks"),
    EnvVar("SEQALIGN_BREAKER_COOLDOWN", "int", 8,
           "serve-loop ticks an open breaker waits before probing the "
           "primary backend half-open"),
    EnvVar("SEQALIGN_BEACON_S", "float", None,
           "liveness-beacon / shard-gather deadline (seconds) enabling the "
           "lost-shard rescue tier under --distributed batch runs"),
    EnvVar("SEQALIGN_FLEET_WORKERS", "int", 0,
           "expected scoring-worker count of the serve fleet "
           "(--fleet-board): a hint only, the coordinator logs when the "
           "fleet first reaches this size"),
    EnvVar("SEQALIGN_LEASE_S", "float", 2.0,
           "fleet superblock lease: nominal seconds an offer may sit "
           "without a result before the coordinator fences its epoch and "
           "re-dispatches (counted in board-poll ticks)"),
    EnvVar("SEQALIGN_WORKER_HEARTBEAT_S", "float", 0.02,
           "fleet worker heartbeat and board-poll cadence in seconds"),
    EnvVar("SEQALIGN_FLEET_MAX_REDISPATCH", "int", 5,
           "re-dispatches one fleet superblock may take before the "
           "coordinator dead-letters it to the local quarantine ladder"),
    EnvVar("SEQALIGN_FLEET_GC_TICKS", "int", 0,
           "board-poll ticks before the fleet's board GC sweeps a key "
           "classified as debris; 0 means two lease windows"),
    EnvVar("SEQALIGN_FLEET_OBSSNAP_S", "float", 0.25,
           "fleet worker observability-snapshot cadence in seconds (its "
           "metrics, recent trace events and flight-recorder tape, posted "
           "to the board in place)"),
    # The rendezvous of a --distributed job, under torchrun's names.
    EnvVar("MASTER_ADDR", "str", None,
           "--distributed: the coordinator's (rank 0's) host"),
    EnvVar("MASTER_PORT", "int", None,
           "--distributed: the coordinator's TCP port"),
    EnvVar("WORLD_SIZE", "int", None, "--distributed: processes in the job"),
    EnvVar("SEQALIGN_CHECK", "flag", False,
           "validate every concrete dispatch decision against the launch "
           "contracts before it launches (same as --check)"),
    EnvVar("BENCH_INPUT", "str", None,
           "the bench's workload: an input file (default: the input3-class "
           "synthetic problem)"),
    EnvVar("BENCH_WEIGHTS", "str", None,
           "the bench's weights, 'w1,w2,w3,w4', over the workload's own"),
    EnvVar("BENCH_BACKEND", "str", "cuda",
           "the bench's backend: cuda or oracle"),
    EnvVar("BENCH_ATTEMPTS", "int", 3,
           "the bench's timing attempts before the probe gate gives up"),
    EnvVar("BENCH_REPS", "int", 3,
           "the bench's warm end-to-end runs after the first"),
    EnvVar("CUDA_HOME", "str", None,
           "the CUDA toolkit whose bin/nvcc builds the kernels (before "
           "CUDA_PATH and PATH)"),
    EnvVar("CUDA_PATH", "str", None,
           "the CUDA toolkit, when CUDA_HOME is unset"),
    EnvVar("RANK", "int", None, "--distributed: this process's rank"),
    EnvVar("LOCAL_RANK", "int", None,
           "--distributed: this process's rank on its host (default RANK)"),
    EnvVar("LOCAL_WORLD_SIZE", "int", None,
           "--distributed: processes on this host (default WORLD_SIZE)"),
)

_REGISTRY = {v.name: v for v in ENV_VARS}
_FLAG_TRUE = ("1", "true", "yes", "on")
_FLAG_FALSE = ("0", "false", "no", "off", "")


def _declared(name: str, kind: str) -> EnvVar:
    var = _REGISTRY.get(name)
    if var is None or var.kind != kind:
        raise KeyError(f"{name} is not a declared {kind} env var (utils/env.py)")
    return var


def env_str(name: str, default: str | None = None) -> str | None:
    var = _declared(name, "str")
    raw = os.environ.get(name)
    if raw is None:
        return default if default is not None else var.default
    return raw


def _number(name: str, kind: str, cast, default):
    var = _declared(name, kind)
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default if default is not None else var.default
    try:
        return cast(raw)
    except ValueError:
        raise ValueError(f"{name} must be a number, got {raw!r} ({var.doc})") from None


def env_int(name: str, default: int | None = None) -> int | None:
    return _number(name, "int", int, default)


def env_float(name: str, default: float | None = None) -> float | None:
    return _number(name, "float", float, default)


def env_flag(name: str, default: bool | None = None) -> bool:
    """1/true/yes/on vs 0/false/no/off (empty = off); anything else is an
    error, not a silent False."""
    var = _declared(name, "flag")
    raw = os.environ.get(name)
    if raw is None:
        return bool(default if default is not None else var.default)
    low = raw.strip().lower()
    if low in _FLAG_TRUE:
        return True
    if low in _FLAG_FALSE:
        return False
    raise ValueError(
        f"{name} must be a boolean flag (1/0/true/false/yes/no/on/off), "
        f"got {raw!r} ({var.doc})"
    )


def cache_home() -> str | None:
    """The port's cache root, or None when caching is disabled
    (``TPU_SEQALIGN_COMPILE_CACHE=off``/``0``); the JAX package's
    ``utils/platform.py::cache_home`` with the port's own default.

    Precedence: ``SEQALIGN_CACHE_DIR``, else a ``TPU_SEQALIGN_COMPILE_CACHE``
    directory, else ``~/.cache/mpi_openmp_cuda_tpu_torch``."""
    legacy = env_str("TPU_SEQALIGN_COMPILE_CACHE")
    if legacy is not None and legacy.strip().lower() in ("off", "0", ""):
        return None
    explicit = env_str("SEQALIGN_CACHE_DIR")
    if explicit:
        return explicit
    if legacy:
        return legacy
    return os.path.join(os.path.expanduser("~"), ".cache", "mpi_openmp_cuda_tpu_torch")


def platform_tag(device=None) -> str:
    """The warm plane's partition tag for ``device`` (``cuda`` when None):
    ``cuda-sm<major><minor>-<device-name slug>`` on a card (e.g.
    ``cuda-sm90-nvidia-h100-80gb-hbm3``), the device type (``cpu``)
    otherwise; the port's counterpart of ``mpi_openmp_cuda_tpu/utils/
    platform.py::platform_tag``, so a CPU manifest never drives a card's
    replay, nor one card's another's."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev.type
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    major, minor = torch.cuda.get_device_capability(index)
    slug = re.sub(r"[^a-z0-9]+", "-", torch.cuda.get_device_name(index).lower()).strip("-")
    return f"cuda-sm{major}{minor}-{slug}"
