"""Process-start prewarming: replay the manifest, warm the problem's
launch shapes, rewrite the manifest, all before the first real dispatch
(the port of ``mpi_openmp_cuda_tpu/aot/prewarm.py``).

Called by the CLI behind ``--prewarm`` / ``SEQALIGN_PREWARM``:

* before a serve loop's first tick (``--serve``, ``--fleet-standby``),
  so ``ServeLoop.baseline_steady`` pins the steady-state baseline at tick
  0 and the first block is held to zero builds, loads and setups too;
* before a fleet worker registers, a ``--stream`` run (replay only) and a
  single-device batch run (with its problem), so a restarted process
  (an autoscaled replica, a drain -> ``--resume`` rerun) rejoins warm.

Failure policy: prewarming is an optimization.  Each entry is warmed
under its own guard (a failure is counted on ``aot.failed`` and logged,
the rest go on) and the CLI guards the whole call.  Nothing here routes a
later launch anywhere: a kernel that failed to warm is launched by the
dispatch as always, which raises if it cannot run.

Emits the ``aot.entries`` / ``aot.compiled`` / ``aot.stale`` /
``aot.failed`` counters and the ``prewarm_wall_s`` gauge into the obs
registry, and one stderr line.
"""

from __future__ import annotations

import time

from ..analysis import SeqcheckError
from ..obs.events import log_line
from ..obs.metrics import gauge, inc
from ..ops import _build
from ..ops.dispatch import resolve_device
from .compile import compile_entry, validate_entry
from .manifest import (
    PROG,
    build_manifest,
    default_manifest_path,
    load_manifest,
    split_entries,
    write_manifest,
)
from .warmset import WarmEntry, backend_fingerprint, select_warmset


def _replay_entries(manifest_path: str | None, digest: str):
    """(fresh, stale) of the on-disk manifest; ([], []) without one."""
    if manifest_path is None:
        return [], []
    report = load_manifest(manifest_path)
    if report is None:
        return [], []
    return split_entries(report, digest)


def prewarm(
    problem=None,
    backend: str | None = None,
    *,
    rows_per_block: int | None = None,
    manifest_path: str | None = None,
    device=None,
    check: bool = False,
) -> dict:
    """Warm the process on ``device`` (``cuda`` when None): manifest
    replay, plus the problem's warm set when a problem is in hand; returns
    a summary dict.

    Merge order: the manifest's fresh entries (known hot from a real
    earlier run), then the problem's warm set, then the stale entries
    re-warmed under the current fingerprint (source ``stale-rewarm``,
    listed in the new manifest), deduplicated on ``executable_key``.
    With ``check`` (``--check``) each entry's launch is validated first
    (``compile.validate_entry``) and a violation raises."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    fp = backend_fingerprint(dev)
    cache_dir = str(_build.BUILD_DIR) if dev.type == "cuda" else None
    if manifest_path is None:
        manifest_path = default_manifest_path(dev)

    fresh, stale = _replay_entries(manifest_path, fp["digest"])
    merged: dict[tuple, WarmEntry] = {}
    for e in fresh:
        merged.setdefault(e.executable_key, e)
    if problem is not None and backend not in (None, "oracle"):
        for e in select_warmset(problem, backend, rows_per_block=rows_per_block):
            merged.setdefault(e.executable_key, e)
    for d in stale:
        try:
            e = WarmEntry.from_dict({**d, "source": "stale-rewarm"})
        except (ValueError, TypeError) as err:
            log_line(f"{PROG}: aot stale entry dropped ({err})")
            continue
        merged.setdefault(e.executable_key, e)

    results = []
    failed = 0
    for entry in merged.values():
        try:
            if check:
                validate_entry(entry, dev)
            wall_s, nbytes = compile_entry(entry, dev)
        except SeqcheckError:
            raise  # --check: a violation is an error, not a cold entry
        except Exception as err:
            # advisory: one entry that failed to warm stays cold; its first
            # dispatch launches the kernel (or raises) as without a prewarm.
            failed += 1
            inc("aot.failed")
            log_line(f"{PROG}: aot warm failed for {entry.executable_key} ({err})")
            continue
        results.append((entry, wall_s, nbytes))

    if manifest_path is not None and results:
        try:
            write_manifest(build_manifest(results, fp, stale=stale), manifest_path)
        except OSError as err:
            log_line(f"{PROG}: aot manifest write failed ({err})")
            manifest_path = None

    wall = time.perf_counter() - t0
    inc("aot.entries", len(merged))
    inc("aot.compiled", len(results))
    inc("aot.stale", len(stale))
    gauge("prewarm_wall_s", round(wall, 6))
    log_line(
        f"{PROG}: prewarmed {len(results)}/{len(merged)} launch shapes in {wall:.3f}s "
        f"(replayed {len(fresh)}, stale {len(stale)}, failed {failed}; "
        f"cache={'on' if cache_dir else 'off'})"
    )
    return {
        "entries": len(merged),
        "compiled": len(results),
        "replayed": len(fresh),
        "stale": len(stale),
        "failed": failed,
        "prewarm_wall_s": wall,
        "cache_dir": cache_dir,
        "manifest_path": manifest_path,
    }
