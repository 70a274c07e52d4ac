"""The environment knobs the port reads, and their typed accessors.

A copy of the registry pattern of ``mpi_openmp_cuda_tpu/utils/
platform.py``, holding only the variables the port reads so far, under
the same names as the JAX package, so one shell drives both CLIs.  Every
read happens at call time (tests' ``monkeypatch.setenv`` works) and a
malformed value raises one ``ValueError`` naming the variable.
"""

from __future__ import annotations

import dataclasses
import os


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
