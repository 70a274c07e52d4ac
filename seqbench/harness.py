"""The harness's data plane: everything is found by name.

``BENCHMARK.json`` names each cell's configuration and traffic and the
metrics; the files are

* ``seqbench/configs/<config>.json``: a deployment, whose ``kind`` names
  the driver ``seqbench/drivers/<kind>.py``, with the port's CLI
  arguments (``cli_args``) and environment (``env``);
* ``seqbench/traffic/<traffic>.json``: a traffic mix's numbers, read by
  :mod:`.generate`;
* ``seqbench/metrics/<metric>.py``: a reader, ``read(run) -> float |
  None``, for each metric, end-to-end or per-layer.

A new cell, configuration, traffic mix or metric is new files and new
entries, never an edit.  :func:`measure` runs one cell once and returns
its result without printing it (the entry the tests use); ``run.py``
prints it.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# Top-level module names the run's process must never hold: JAX and the
# JAX package this port was made from (whole names: the port's own name
# begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "mpi_openmp_cuda_tpu")


def process_start() -> float:
    """The ``time.monotonic`` reading at which this process started
    (from ``/proc/self/stat``, to the kernel's clock tick)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.monotonic() - age
    except (OSError, ValueError, IndexError):
        return time.monotonic()


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is in :data:`FORBIDDEN`."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def held_modules(run: "Run") -> list[str]:
    """The forbidden modules held, once the window has closed, by this
    process or by the one that ran the program for it (the server)."""
    return sorted(set(forbidden_modules()) | set(run.held))


@dataclass
class Context:
    """One run of one cell."""

    root: Path
    bench: dict
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    started: float = field(default_factory=time.monotonic)

    def path(self, *parts: str) -> Path:
        return self.root.joinpath("seqbench", *parts)


@dataclass
class Run:
    """What a driver measured; the metric readers read it."""

    kind: str
    setup_s: float
    window_s: float
    attempted: int
    failed: int
    checks: dict
    device: dict
    jobs: list = field(default_factory=list)  # batch: {"wall_s", "cells", "bytes"}
    spans: list = field(default_factory=list)  # batch, traced: {phase: seconds} a job
    launches: dict = field(default_factory=dict)  # kernel launches in the window
    outcomes: list = field(default_factory=list)  # serve: loadgen.Outcome
    telemetry: dict = field(default_factory=dict)  # serve: "start"/"end" snapshots
    trace: dict | None = None  # devtrace summary, plus the traced work
    held: list = field(default_factory=list)  # serve: forbidden modules the server held
    notes: list = field(default_factory=list)  # lines printed before the result


def _by_name(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} {name!r}")


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def context(workload: str, seed: int, seconds: float, trace: bool, *, root: Path = ROOT,
            device: str = "cuda", started: float | None = None) -> Context:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = _by_name(bench["workloads"], workload, "workload")
    conf = _by_name(bench["configs"], cell["config"], "config")
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "seqbench" / "traffic" / f"{cell['traffic']}.json").read_text())
    return Context(root, bench, cell, config, traffic, int(seed), float(seconds), bool(trace),
                   device, time.monotonic() if started is None else started)


def metrics_of(ctx: Context) -> list[dict]:
    """The metric entries this cell reports: with ``--trace 0`` its
    end-to-end metrics, with ``--trace 1`` its per-layer ones."""
    cell = ctx.cell["name"]
    e2e = [m for m in ctx.bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not ctx.trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in ctx.bench["per_layer"]
            if cell in m.get("workloads", []) or ("workloads" not in m and m["moves"] in names)]


def read_metrics(ctx: Context, run: Run) -> dict:
    """Each metric's reader over ``run``; a reader that finds nothing
    leaves its metric out."""
    out = {}
    for m in metrics_of(ctx):
        reader = _load(ctx.path("metrics", f"{m['name']}.py"), f"seqbench_metric_{len(out)}")
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def drive(ctx: Context) -> Run:
    """Run the cell's driver, named by its configuration's ``kind``."""
    driver = _load(ctx.path("drivers", f"{ctx.config['kind']}.py"), "seqbench_driver")
    return driver.run(ctx)


def measure(ctx: Context) -> tuple[dict, Run]:
    """One run of one cell: the contract's result object (``checks``
    last) and the record from ``drivers/<kind>.py``."""
    run = drive(ctx)
    result = {
        "correct": all(c["value"] <= c["limit"] for c in run.checks.values()),
        "attempted": run.attempted,
        "failed": run.failed,
        "metrics": read_metrics(ctx, run),
        "device": run.device,
    }
    if ctx.trace and run.trace is not None:
        result["device"] = {**run.device, "busy_s": run.trace["busy_s"],
                            "window_s": run.trace["window_s"]}
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["checks"] = run.checks
    return result, run
