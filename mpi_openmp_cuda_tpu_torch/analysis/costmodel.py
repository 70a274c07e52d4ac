"""The Hopper cost sheet: every launch the port can plan, priced on the host
(the port's counterpart of ``mpi_openmp_cuda_tpu/analysis/costmodel.py``).

Every fact the sheet prices is host arithmetic over the derivations the
production dispatch runs, so it needs no card and is golden-pinnable:

* the **work** of a launch — needed cells, int32 ops, table lookups and
  operand bytes — from ``ops/costs.py`` (3 int ops and 1 lookup a needed
  cell; the data-sheet peaks 16.7 Tops/s, 8.36 Tword/s and 3.35 TB/s give
  its **bound**);
* the **modelled kernel time** of a launch — for the fused kernel the
  fitted launch model ``ops/schedule.launch_us`` (5.87 % rms over 153
  launches on an H100, which already holds the fixed cost ``LAUNCH_US``
  of a launch); for the packed kernel, which has no fitted model, its
  bound plus ``LAUNCH_US``, tagged ``"model": "launch+bound"``;
* the **comms** of a mesh — the collectives ``parallel/`` calls by hand,
  priced over NVLink 4 at NVIDIA's data-sheet rate, never measured here.

Three products, as in the JAX package:

* :func:`config_cost` / :func:`sweep_config_costs` /
  :func:`audit_config_space` — one row per launch shape the dispatch can
  plan, the shapes ``analysis/smem.py`` sweeps (every fused width of one
  device and of the Seq1 ring's windows, the packed classes, the serve
  block), priced per canonical unit of work (:func:`config_cost`);
* :func:`schedule_cost_sheet` — a problem's launches as
  ``ops/schedule.kernel_configs`` plans them, priced one by one, their
  totals, the hot-config ranking the warm plane warms first, the
  declared launches by kernel, and the ``comms`` rows;
* :func:`predicted_wall_us` — the one number the bench prints beside its
  measured ``device_wall_us``.

Model scope: ``predicted_wall_us`` is the sum of the launches' modelled
times (they run back to back on one stream); the batch's copy back is
not modelled, so the bench's measured wall exceeds it by that.  ``launch_overhead_us`` is the ``LAUNCH_US`` part of
``model_kernel_us`` (launches x ``LAUNCH_US``), split out, never added a
second time.  The kernels issue no matrix operation, so the sheet has no
feed roofline: ``predicted_mfu_vs_feed_roofline`` is null and
``predicted_bound_share`` (the bound over the predicted wall) takes its
place.
"""

from __future__ import annotations

import dataclasses
import math

from . import CostModelError

#: NVLink 4 on the H100 SXM: 450 GB/s each direction a GPU (NVIDIA's data
#: sheet, not a measurement of this port).
NVLINK_GBYTES_S = 450.0
#: The fixed cost of one hand-called collective over NVLink: a named model
#: constant, not measured (the sheet says so) until a four-chip cell exists.
NVLINK_HOP_LATENCY_S = 2.0e-6

#: Mesh sizes the scaling rows price.
SCALING_MESH_SIZES = (2, 4, 8)

#: A canonical fused unit's Seq1 on one device: the reference's cap.
_CANONICAL_LEN1 = 3000


def nvlink_collective_wall_s(op: str, payload_bytes: int, axis_size: int) -> float:
    """Modelled wall of one ``parallel/comm.py`` collective among
    ``axis_size`` members, ``payload_bytes`` the bytes one member sends:

    - ``shift`` (the ring's neighbour exchange): one hop, ``b/bw + hop``;
    - ``all_gather``: the ring algorithm's ``N - 1`` steps, each moving
      the payload, ``(N - 1) * (b/bw + hop)``;
    - ``gather`` (to the host, after the compute): ``N - 1`` payloads into
      one link, ``(N - 1) * b/bw + hop``;
    - ``broadcast``: a tree, ``ceil(log2 N) * (b/bw + hop)``.
    """
    if axis_size <= 1:
        return 0.0
    bw = NVLINK_GBYTES_S * 1e9
    n = axis_size
    b = float(payload_bytes)
    if op == "shift":
        return b / bw + NVLINK_HOP_LATENCY_S
    if op == "all_gather":
        return (n - 1) * (b / bw + NVLINK_HOP_LATENCY_S)
    if op == "gather":
        return (n - 1) * b / bw + NVLINK_HOP_LATENCY_S
    if op == "broadcast":
        return math.ceil(math.log2(n)) * (b / bw + NVLINK_HOP_LATENCY_S)
    raise CostModelError(f"no NVLink cost rule for collective {op!r}")


def _price(formulation: str, len1: int, lens, l1p: int, l2p: int,
           split: int | None = None):
    """``(counts, bound_s, bound_by, model_s, model)`` of one launch (a
    fused one at ``split``, None for its width's default)."""
    from ..ops.costs import bound_seconds, shape_counts
    from ..ops.schedule import LAUNCH_US, launch_us

    counts = shape_counts(len1, lens, l1p, l2p)
    bound_s, term = bound_seconds(counts)
    if formulation == "cuda-fused":
        return (counts, bound_s, term, launch_us(len1, lens, l2p, split) * 1e-6,
                "launch-model")
    if formulation == "cuda-packed":
        return counts, bound_s, term, LAUNCH_US * 1e-6 + bound_s, "launch+bound"
    raise CostModelError(
        f"no kernel time model for formulation {formulation!r}: the sheet "
        "prices the Hopper kernels only (cuda-fused, cuda-packed)"
    )


@dataclasses.dataclass(frozen=True)
class ConfigCost:
    """The cost of one canonical unit of work at one launch shape: ``rows``
    fully-live rows of ``l2p`` chars (``l2s`` on the packed kernel) against
    a Seq1 of ``len1`` chars."""

    kind: str  # fused | ring | packed | serve (smem.iter_chooser_space)
    formulation: str  # cuda-fused | cuda-packed
    l2p: int
    l2s: int | None
    rows: int
    len1: int
    l1p: int
    cells: int
    int_ops: int
    lookups: int
    bytes: int
    bound_us: float
    bound_by: str
    model_kernel_us: float
    model: str  # launch-model | launch+bound

    @property
    def bound_share(self) -> float:
        """The bound over the modelled time: the share of the card's peak
        the model says the launch reaches."""
        return self.bound_us / self.model_kernel_us

    def describe(self) -> str:
        return (
            f"{self.kind:<6s} {self.formulation:<11s} L2P={self.l2p:>5d} "
            f"l2s={self.l2s or '-':>2} rows={self.rows:>3d} len1={self.len1:>5d} "
            f"cells={self.cells:>10d} bound={self.bound_us:9.3f}us ({self.bound_by}) "
            f"model={self.model_kernel_us:9.3f}us [{self.model}] "
            f"share<={self.bound_share:5.3f}"
        )


def config_cost(kind: str, l2p: int, l2s: int | None = None) -> ConfigCost:
    """Price one launch shape of ``analysis/smem.py``'s sweep, per canonical
    unit: a ``fused`` shape one full row of ``l2p`` chars against the
    3000-char Seq1 cap; a ``ring`` window one full row against ``l2p +
    128`` chars (one offset tile past the row); a ``packed`` shape ``128 /
    l2s`` rows of ``l2s`` chars (one 128-wide tile's worth); a ``serve``
    shape one 64-row block of full rows (``smem.SERVE_BLOCK_ROWS``)."""
    from ..ops.dispatch import round_up
    from .smem import SERVE_BLOCK_ROWS

    packed = l2s is not None
    if kind not in ("fused", "ring", "packed", "serve"):
        raise CostModelError(f"unknown launch-shape kind {kind!r}")
    width = l2s if packed else l2p
    if kind == "serve":
        rows = SERVE_BLOCK_ROWS
    else:
        rows = 128 // l2s if packed else 1
    len1 = l2p + 128 if kind == "ring" else _CANONICAL_LEN1
    l1p = round_up(len1, 128)
    formulation = "cuda-packed" if packed else "cuda-fused"
    counts, bound_s, term, model_s, model = _price(
        formulation, len1, [width] * rows, l1p, l2p)
    if not (math.isfinite(model_s) and model_s > 0.0 and counts.cells > 0):
        raise CostModelError(
            f"{kind} L2P={l2p} l2s={l2s}: modelled time {model_s!r} s over "
            f"{counts.cells} cells: the launch model (ops/schedule.py) no longer "
            "covers this shape"
        )
    return ConfigCost(
        kind=kind, formulation=formulation, l2p=int(l2p), l2s=l2s, rows=rows,
        len1=len1, l1p=l1p, cells=counts.cells, int_ops=counts.int_ops,
        lookups=counts.lookups, bytes=counts.bytes, bound_us=bound_s * 1e6,
        bound_by="bytes" if term == "bytes" else "operations",
        model_kernel_us=model_s * 1e6, model=model,
    )


def sweep_config_costs():
    """Yield a :class:`ConfigCost` for every launch shape the dispatch can
    plan: the shapes of ``smem.iter_chooser_space`` (one a kind, width
    and class), so a new width or class there is priced here too."""
    from .smem import iter_chooser_space

    seen = set()
    for est in iter_chooser_space():
        key = (est.kind, est.l2p, est.l2s)
        if key not in seen:
            seen.add(key)
            yield config_cost(*key)


def audit_config_space():
    """Sweep every plannable launch shape: ``(n, best)``, ``best`` the shape
    whose model comes nearest its bound; raises :class:`CostModelError`
    on a shape the model cannot price or a share past 1 (a model faster
    than the card's peak)."""
    n = 0
    best: ConfigCost | None = None
    for cc in sweep_config_costs():
        n += 1
        if not 0.0 < cc.bound_share <= 1.0:
            raise CostModelError(f"bound share outside (0, 1]: {cc.describe()}")
        if best is None or cc.bound_share > best.bound_share:
            best = cc
    if best is None:
        raise CostModelError("the launch-shape sweep yielded no shapes")
    return n, best


def _scaling_rows(cfgs: list, priced: list, total_model_s: float) -> list[dict]:
    """``predicted_scaling_efficiency`` rows for 2/4/8-device meshes on both
    axes.  Each launch's modelled time splits into ``LAUNCH_US`` and its
    work; on N devices every device makes every launch and does 1/N of
    the work.  The batch axis (``parallel/sharding.py``) then gathers the
    ``[B, 3]`` rows to the host, one ``gather`` a launch; the Seq1 ring
    (``parallel/ring.py``) pays ``ring_plan``'s R ``shift``s of a
    ``Bs``-char block and one ``all_gather`` of the ``[B, 4]`` candidates
    a launch.  Efficiency is ``T1 / (N * T_N)``."""
    from ..ops.schedule import LAUNCH_US
    from ..parallel.ring import ring_plan

    launch_s = LAUNCH_US * 1e-6
    rows = []
    for n in SCALING_MESH_SIZES:
        compute_s = sum(launch_s + (m - launch_s) / n for m in priced)
        gather_s = sum(nvlink_collective_wall_s("gather", c.rows * 3 * 4, n) for c in cfgs)
        ring_s, steps = 0.0, []
        for c in cfgs:
            bs, r = ring_plan(c.l1p, c.l2p, n, kernel=True)
            steps.append(r)
            ring_s += (r * nvlink_collective_wall_s("shift", bs, n)  # uint8 codes
                       + nvlink_collective_wall_s("all_gather", c.rows * 4 * 4, n))
        for axis, comms_s, extra in (("batch", gather_s, {}),
                                     ("seq", ring_s + gather_s, {"ring_steps": steps})):
            tn = compute_s + comms_s
            rows.append({
                "mesh": n,
                "axis": axis,
                "comms_wall_us": comms_s * 1e6,
                "predicted_wall_us": tn * 1e6,
                "predicted_scaling_efficiency": total_model_s / (n * tn),
                **extra,
            })
    return rows


def _off_kernel_sheet(backend: str) -> dict:
    """A schedule some launch of which runs no Hopper kernel (``mm``,
    ``gather``, ``oracle``, or a ``cuda`` launch routed to ``gather`` past
    the int32 window): nothing is priced for work that does not run."""
    return {
        "backend": backend,
        "formulation": None,
        "buckets": [],
        "totals": None,
        "predicted_mfu_vs_feed_roofline": None,
        "predicted_bound_share": None,
        "hot_configs": [],
        "fused": None,
        "comms": None,
    }


def schedule_cost_sheet(problem, backend: str = "cuda") -> dict:
    """Price ``problem``'s production launches on ``backend``: a JSON-ready
    dict with one ``buckets`` row a launch, the ``totals``, the
    ``hot_configs`` ranking (by modelled time, aggregated by the warm
    manifest's launch-shape key), the ``fused`` launch groups and the
    launches each kernel must see, and the ``comms`` rows."""
    from ..ops.schedule import LAUNCH_US, fused_schedule_config, kernel_configs

    if backend == "auto":
        backend = "cuda"
    if backend != "cuda":
        return _off_kernel_sheet(backend)
    cfgs = kernel_configs(problem, backend)
    if any(c.kernel is None for c in cfgs):
        return _off_kernel_sheet(backend)
    buckets, priced = [], []
    tot = dict.fromkeys(("cells", "int_ops", "lookups", "bytes_moved_min"), 0)
    bound_total_s = 0.0
    by_key: dict[tuple, dict] = {}
    by_kernel: dict[str, int] = {}
    for c in cfgs:
        counts, bound_s, term, model_s, model = _price(
            c.formulation, c.len1, list(c.lens), c.l1p, c.l2p, c.split)
        priced.append(model_s)
        buckets.append({
            "formulation": c.formulation,
            "kernel": c.kernel,
            "l1p": c.l1p,
            "l2p": c.l2p,
            "len1": c.len1,
            "rows": c.rows,
            "live_pairs": c.live_pairs,
            "l2s": c.l2s,
            "cluster": list(c.cluster) if c.cluster else None,
            "bucket_keys": list(c.bucket_keys),
            "launches": 1,
            "cells": counts.cells,
            "int_ops": counts.int_ops,
            "lookups": counts.lookups,
            "bytes_moved_min": counts.bytes,
            "bound_us": bound_s * 1e6,
            "bound_by": "bytes" if term == "bytes" else "operations",
            "model_kernel_us": model_s * 1e6,
            "model": model,
        })
        for k, v in (("cells", counts.cells), ("int_ops", counts.int_ops),
                     ("lookups", counts.lookups), ("bytes_moved_min", counts.bytes)):
            tot[k] += v
        bound_total_s += bound_s
        by_kernel[c.kernel] = by_kernel.get(c.kernel, 0) + 1
        agg = by_key.setdefault(c.cache_key, {
            "formulation": c.formulation, "l1p": c.l1p, "l2p": c.l2p, "l2s": c.l2s,
            "rows": c.rows, "launches": 0, "model_s": 0.0})
        agg["launches"] += 1
        agg["model_s"] += model_s
    total_model_s = sum(priced)
    hot = sorted(by_key.values(), key=lambda r: (-r["model_s"], r["l2p"], r["l2s"] or 0))
    hot_rows = [{
        "rank": rank,
        **{k: r[k] for k in ("formulation", "l1p", "l2p", "l2s", "rows", "launches")},
        "model_kernel_us": r["model_s"] * 1e6,
        "wall_share": r["model_s"] / total_model_s,
    } for rank, r in enumerate(hot, start=1)]
    declared = fused_schedule_config(problem, backend)
    return {
        "backend": backend,
        "formulation": "cuda",
        "buckets": buckets,
        "totals": {
            "launches": len(cfgs),
            "launches_by_kernel": dict(sorted(by_kernel.items())),
            "executables": len(by_key),
            **tot,
            "bound_us": bound_total_s * 1e6,
            "model_kernel_us": total_model_s * 1e6,
            # The LAUNCH_US inside each model_kernel_us, split out (not added).
            "launch_overhead_us": len(cfgs) * LAUNCH_US,
            "predicted_wall_us": total_model_s * 1e6,
        },
        "predicted_mfu_vs_feed_roofline": None,
        "predicted_bound_share": (bound_total_s / total_model_s) if cfgs else None,
        "hot_configs": hot_rows,
        "fused": {
            "groups": [list(g) for g in declared.groups],
            "declared_launches": dict(declared.declared_launches),
        },
        "comms": {
            "link": "NVLink 4, H100 SXM",
            "link_gbytes_s": NVLINK_GBYTES_S,
            "hop_latency_us": NVLINK_HOP_LATENCY_S * 1e6,
            "measured": False,
            "source": "NVIDIA data sheet rate and a named latency constant; "
                      "waits for a four-chip cell",
            "scaling": _scaling_rows(cfgs, priced, total_model_s) if cfgs else [],
        },
    }


def predicted_wall_us(problem, backend: str = "cuda") -> float | None:
    """The sheet's ``predicted_wall_us`` (None off the kernels), the number
    the bench prints beside its measured ``device_wall_us``."""
    totals = schedule_cost_sheet(problem, backend)["totals"]
    return None if totals is None else totals["predicted_wall_us"]
