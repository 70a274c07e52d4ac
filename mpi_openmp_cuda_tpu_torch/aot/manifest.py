"""The warm-set manifest: what was warmed, under which fingerprint, at
what cost; atomic on disk, versioned through the obs run-report envelope
(the port of ``mpi_openmp_cuda_tpu/aot/manifest.py``).

A prewarming process records every entry it warmed (``cache_key``, the
fingerprint digest, ``compile_wall_s``, ``bytes``); the next process on
the same card loads it and replays those entries through
``compile.compile_entry`` before it serves, without needing the original
problem in hand.

Staleness: an entry whose recorded digest differs from the current
``warmset.backend_fingerprint`` (another torch, CUDA, card, nvcc flags or
kernel source) is stale.  :func:`split_entries` splits it out; ``prewarm``
lists it in the next manifest's ``stale`` section and re-warms it under
the current fingerprint, never replays it.  A JAX manifest (another
cache home by default, another digest always) is never fresh here.

Loading is forgiving (a missing, unreadable or schema-invalid manifest
loads as ``None`` with a logged line): prewarm is an optimization and
never the reason a process fails to start.  Writing is strict and atomic
(tmp + ``os.replace``): a reader never sees a torn manifest.
"""

from __future__ import annotations

import json
import os

from ..obs.events import log_line
from ..obs.metrics import validate_report, wrap_report

#: Envelope kind (``obs/metrics.py::validate_report`` knows this branch).
MANIFEST_KIND = "aot-manifest"

PROG = "mpi_openmp_cuda_tpu_torch"


def default_manifest_path(device=None) -> str | None:
    """``<cache home>/aot/<platform tag>.json`` (``utils/env.py``): one
    manifest a card model and toolchain tag, so a CPU manifest never
    drives a card's replay.  ``None`` when the cache home is disabled."""
    from ..utils.env import cache_home, platform_tag

    home = cache_home()
    if home is None:
        return None
    return os.path.join(home, "aot", f"{platform_tag(device)}.json")


def build_manifest(results, fingerprint: dict, *, stale=()) -> dict:
    """The versioned envelope of ``[(WarmEntry, wall_s, bytes), ...]``;
    ``stale`` lists the superseded entry dicts re-warmed this run."""
    entries = []
    total_wall = 0.0
    total_bytes = 0
    for entry, wall_s, nbytes in results:
        d = entry.to_dict()
        d["fingerprint"] = fingerprint["digest"]
        d["compile_wall_s"] = round(float(wall_s), 6)
        d["bytes"] = nbytes
        entries.append(d)
        total_wall += float(wall_s)
        total_bytes += int(nbytes or 0)
    body = {
        "fingerprint": dict(fingerprint),
        "entries": entries,
        "stale": [dict(s) for s in stale],
        "totals": {
            "entries": len(entries),
            "compile_wall_s": round(total_wall, 6),
            "bytes": total_bytes,
        },
    }
    return wrap_report(MANIFEST_KIND, body)


def write_manifest(report: dict, path: str) -> None:
    """Validate, then persist atomically: a failed prewarm leaves the
    previous manifest whole."""
    validate_report(report)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(json.dumps(report, indent=2, sort_keys=True) + "\n")
    os.replace(tmp, path)


def load_manifest(path: str) -> dict | None:
    """A valid manifest, or ``None`` (absent, unparseable, schema-invalid
    or of another kind: each logged, none fatal).  Never raises."""
    try:
        with open(path) as f:
            report = json.load(f)
    except FileNotFoundError:
        return None
    except (OSError, ValueError) as e:
        log_line(f"{PROG}: aot manifest unreadable ({e})")
        return None
    try:
        validate_report(report)
    except ValueError as e:
        log_line(f"{PROG}: aot manifest invalid ({e})")
        return None
    if report.get("kind") != MANIFEST_KIND:
        log_line(f"{PROG}: aot manifest has kind {report.get('kind')!r}, "
                 f"want {MANIFEST_KIND!r}")
        return None
    return report


def split_entries(report: dict, digest: str):
    """(fresh WarmEntries, stale entry dicts) under the current
    fingerprint ``digest``.  A record under the current digest that is
    not a port entry is dropped with a logged line."""
    from .warmset import WarmEntry

    fresh, stale = [], []
    for d in report.get("entries", []):
        if d.get("fingerprint") != digest:
            stale.append(d)
            continue
        try:
            fresh.append(WarmEntry.from_dict(d))
        except (ValueError, TypeError) as e:
            log_line(f"{PROG}: aot manifest entry dropped ({e})")
    return fresh, stale
