"""The launch audit: what the dispatch hands the card, held against what the
planner declares (the port's counterpart of
``mpi_openmp_cuda_tpu/analysis/traceaudit.py``).

The JAX audit lowers its entry points and walks the jaxprs.  Eager PyTorch
has no program to lower, so this audit walks the dispatch itself, on the
host, with the launches stubbed: :func:`trace_dispatch` runs one
``AlignmentScorer`` dispatch with ``dispatch.run_launch`` replaced by a
stub that records the launch and writes nothing (no FLOP runs, as none
runs in a lowering), and counts the PyTorch epilogues the dispatch runs
beside its launches (calls of ``cuda_scorer.finish_rows``) and its host
fetches (``BucketedPending._start_copy``, where the card's one
device-to-host copy of a batch is made).  The functions are restored
when the dispatch ends; the audit is a tool of the scripts and tests,
not of a serving process.

* **The launch budget** (:func:`audit_schedule`): the launches the
  dispatch makes, by kernel, must equal ``schedule.fused_schedule_config
  (...).declared_launches``, with no PyTorch epilogue (the finish kernels
  write every finished row; an ``mm`` or ``gather`` launch returns them)
  and one host fetch a batch; a mismatch raises
  :class:`ScheduleDriftError`.  On the card
  ``chip_smoke.py`` holds the kernels' own ``launch_counts`` deltas to the
  same declaration.
* **The operand inventory**: every tensor operand of every launch (the
  tensor fields of ``cuda_scorer.ScorerState``, as ``dispatch._to_device``
  fills them: views of the dispatch's one arena, ``ops/feed.py``), with
  its dtype, shape, bytes and address.  Findings: a dtype wider than the
  kernels read (their C entries take uint8 codes, int32 lengths and
  table), an operand of at least :data:`LARGE_BUFFER_BYTES` uploaded twice
  in one dispatch (two addresses, the same bytes), a second value table
  in one batch.
* **The entry points** (:func:`audit_entry_points`): every
  ``contracts.ENTRY_CONTRACTS`` entry run at the audit buckets under a
  ``TorchFunctionMode`` that counts its dtype widenings and its device
  transfers.
* **Donation**: eager PyTorch has no ``donate_argnums``.  A launch's
  operands are freed when the launch is dropped, so the ``donation``
  section says ``donation_supported: false`` and lists every large
  operand in ``pinned_live`` with that reason.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib

from . import ScheduleDriftError, TraceAuditError

#: An operand at or above this size is "large" (the JAX audit's bound).
LARGE_BUFFER_BYTES = 16 << 10

#: Why eager PyTorch pins every large operand (the donation section).
NO_DONATION = "freed when its launch is dropped; no donation in eager torch"

#: The bytes a word of each operand the kernels read: their C entries take
#: uint8 codes and int32 lengths and table (``cuda_scorer._ARGTYPES``), and
#: the wrappers refuse others.
KERNEL_ITEMSIZE = {"seq1ext": 1, "rows": 1, "lens": 4, "val": 4}

#: Conversions the entry-point walk inspects (``Tensor`` methods).
_CONVERSIONS = frozenset({"to", "long", "int", "float", "double", "half", "short",
                          "char", "byte", "bfloat16", "type", "cpu", "cuda"})


def operand_fields() -> tuple[str, ...]:
    """The tensor fields of ``cuda_scorer.ScorerState``, in order: what a
    launch uploads (read from the dataclass, not listed by hand)."""
    from ..ops.cuda_scorer import ScorerState

    return tuple(f.name for f in dataclasses.fields(ScorerState)
                 if "Tensor" in str(f.type))


@dataclasses.dataclass
class DispatchTrace:
    """What one traced dispatch did: its launches (with the route each
    took), epilogues and host fetches."""

    launches: list = dataclasses.field(default_factory=list)
    epilogues: int = 0
    host_fetches: int = 0


@contextlib.contextmanager
def trace_dispatch():
    """``with trace_dispatch() as trace:`` around dispatches of this thread:
    ``run_launch`` stubbed and recorded, ``cuda_scorer.finish_rows`` and
    the host fetch counted."""
    import torch

    from ..ops import cuda_scorer, dispatch

    trace = DispatchTrace()
    run_launch, finish_rows = dispatch.run_launch, cuda_scorer.finish_rows
    start_copy = dispatch.BucketedPending._start_copy

    def stub_launch(launch, backend, done=None):
        st = launch.state
        route = dispatch.effective_backend(
            backend, launch.maxv, st.rows.shape[1], launch.max_scored)
        trace.launches.append((launch, route))
        if done is None:
            done = torch.zeros((st.rows.shape[0], 3), dtype=torch.int32,
                               device=st.rows.device)
        return done

    def counted_finish(*args, **kwargs):
        trace.epilogues += 1
        return finish_rows(*args, **kwargs)

    def counted_copy(self):
        trace.host_fetches += 1
        return start_copy(self)

    dispatch.run_launch, cuda_scorer.finish_rows = stub_launch, counted_finish
    dispatch.BucketedPending._start_copy = counted_copy
    try:
        yield trace
    finally:
        dispatch.run_launch, cuda_scorer.finish_rows = run_launch, finish_rows
        dispatch.BucketedPending._start_copy = start_copy


def _kernel_of(launch, route: str) -> str:
    """The ``launch_counts`` name a launch counts under (``mm`` and
    ``gather`` under their own names: they launch no kernel)."""
    if route != "cuda":
        return route
    return "fused_scorer" if launch.l2s is None else "packed_scorer"


def operand_inventory(launches) -> tuple[list[dict], list[dict]]:
    """``(rows, findings)``: one row per tensor operand of each launch, and
    the operand findings (see the module docstring)."""
    rows, findings = [], []
    # Operands are views of one arena: an operand is shared when its
    # address is an earlier one's (Seq1 and the table, once a dispatch).
    seen: dict[int, dict] = {}  # address -> first row
    by_bytes: dict[tuple, list[dict]] = {}
    tables = set()
    for i, launch in enumerate(launches):
        for name in operand_fields():
            t = getattr(launch.state, name)
            addr = t.data_ptr()
            row = {"launch": i, "name": name, "dtype": str(t.dtype).replace("torch.", ""),
                   "shape": list(t.shape), "bytes": t.numel() * t.element_size(),
                   "shared": addr in seen}
            rows.append(row)
            if name == "val":
                tables.add(addr)
            if t.element_size() > KERNEL_ITEMSIZE[name]:
                findings.append({
                    "kind": "widening", "entry": f"launch {i}",
                    "detail": f"{name} uploads as {row['dtype']} ({t.element_size()} B a "
                              f"word) where the kernels read {KERNEL_ITEMSIZE[name]} B: "
                              f"{row['bytes']} B moved for fewer used; narrow it before "
                              "the upload",
                })
            if addr in seen:
                continue
            seen[addr] = row
            if row["bytes"] >= LARGE_BUFFER_BYTES:
                digest = hashlib.blake2b(t.detach().cpu().contiguous().numpy().tobytes(),
                                         digest_size=16).digest()
                by_bytes.setdefault((name, digest), []).append(row)
    for (name, _), same in sorted(by_bytes.items(), key=lambda kv: kv[0][0]):
        if len(same) > 1:
            findings.append({
                "kind": "duplicate-upload", "entry": f"launch {same[1]['launch']}",
                "detail": f"{name} ({same[0]['bytes']} B) uploaded {len(same)} times in one "
                          f"dispatch (launches {[r['launch'] for r in same]}): upload it "
                          "once and share the tensor",
            })
    if len(tables) > 1:
        findings.append({
            "kind": "second-value-table", "entry": "batch",
            "detail": f"{len(tables)} value tables uploaded for one batch; "
                      "dispatch._upload makes one for all its launches",
        })
    return rows, findings


def donation_section(rows: list[dict]) -> dict:
    """The ``donation`` section: every large operand pinned live, with the
    reason eager PyTorch gives."""
    large = [r for r in rows if r["bytes"] >= LARGE_BUFFER_BYTES and not r["shared"]]
    return {
        "donation_supported": False,
        "large_buffers": len(large),
        "donated_large_buffers": 0,
        "undonated_large_buffers": 0,
        "pinned_live": [
            f"launch {r['launch']} {r['name']}: {r['dtype']}{r['shape']} "
            f"{r['bytes'] / 1024:.1f} KiB — {NO_DONATION}" for r in large
        ],
        "covered": True,
    }


def audit_schedule(problem, backend: str = "cuda", device="cpu") -> dict:
    """Trace one dispatch of ``problem`` on ``backend`` and ``device``
    (:func:`trace_dispatch`) and hold it to the planner's declaration:
    raises :class:`ScheduleDriftError` when the launches by kernel differ
    from ``fused_schedule_config(...).declared_launches``, or a batch with
    launches runs a PyTorch epilogue or makes other than one host fetch.
    Returns the JSON-ready report (operand findings listed, not raised)."""
    import torch

    from ..ops.dispatch import AlignmentScorer
    from ..ops.schedule import fused_schedule_config, kernel_configs

    if backend == "auto":
        backend = "cuda"
    declared = fused_schedule_config(problem, backend)
    scorer = AlignmentScorer(backend, device=torch.device(device))
    with trace_dispatch() as trace:
        scorer.score_codes_async(problem.seq1_codes, problem.seq2_codes,
                                 problem.weights).result()
    launches = [launch for launch, _ in trace.launches]
    by_kernel: dict[str, int] = dict.fromkeys(declared.declared_launches, 0)
    buckets = []
    for i, (launch, route) in enumerate(trace.launches):
        kernel = _kernel_of(launch, route)
        by_kernel[kernel] = by_kernel.get(kernel, 0) + 1
        st = launch.state
        buckets.append({"launch": i, "kernel": kernel, "l1p": int(st.l1p),
                        "l2p": int(st.rows.shape[1]), "rows": int(st.rows.shape[0]),
                        "l2s": launch.l2s, "bucket_keys": list(launch.keys)})
    rows, findings = operand_inventory(launches)
    want_kernels = {k: v for k, v in by_kernel.items() if k in declared.declared_launches}
    want_epilogues = 0  # the finish kernels, or mm and gather, finish every row
    want_fetches = 1 if launches else 0
    if (want_kernels != declared.declared_launches or len(launches) != declared.launches
            or trace.epilogues != want_epilogues or trace.host_fetches != want_fetches):
        raise ScheduleDriftError(
            f"the dispatch made {len(launches)} launch(es) {by_kernel}, "
            f"{trace.epilogues} epilogue(s) and {trace.host_fetches} host fetch(es); "
            f"the planner declares {declared.launches} launch(es) "
            f"{declared.declared_launches}, {want_epilogues} epilogues and "
            f"{want_fetches} host fetch: dispatch.bucket_launches and "
            "schedule.kernel_configs have drifted apart (ops/dispatch.py, ops/schedule.py)"
        )
    return {
        "backend": backend,
        "device": str(device),
        "buckets": buckets,
        "launches": len(launches),
        "launches_by_kernel": dict(sorted(by_kernel.items())),
        "declared_launches": dict(declared.declared_launches),
        "executables": len({c.cache_key for c in kernel_configs(problem, backend)}),
        "epilogues": trace.epilogues,
        "host_fetches": trace.host_fetches,
        "operands": rows,
        "findings": findings,
        "donation": donation_section(rows),
    }


class _ConversionCounter:
    """A ``TorchFunctionMode`` body: counts dtype widenings and device
    transfers among the tensor conversions an entry point makes."""

    def __init__(self):
        import torch

        class Mode(torch.overrides.TorchFunctionMode):
            def __torch_function__(mode, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                if (getattr(func, "__name__", "") in _CONVERSIONS and args
                        and isinstance(args[0], torch.Tensor)
                        and isinstance(out, torch.Tensor)):
                    if out.element_size() > args[0].element_size():
                        self.widenings += 1
                    if out.device != args[0].device:
                        self.transfers += 1
                return out

        self.mode = Mode()
        self.widenings = 0
        self.transfers = 0


def audit_entry_points(buckets=None) -> list[dict]:
    """Run every ``contracts.ENTRY_CONTRACTS`` entry at the audit buckets
    (``contracts._AUDIT_BUCKETS``) on the CPU: one row per (entry, bucket)
    with its widenings, device transfers and output.  Raises
    :class:`TraceAuditError` when an entry fails to run or moves a tensor
    between devices (a CPU run has none to move between)."""
    from .contracts import _AUDIT_BUCKETS, ENTRY_CONTRACTS

    rows = []
    for contract in ENTRY_CONTRACTS:
        for b, l1p, l2p in buckets or _AUDIT_BUCKETS:
            counter = _ConversionCounter()
            try:
                with counter.mode:
                    out = contract.run(b, l1p, l2p)
            except Exception as exc:  # noqa: BLE001 - re-raised with context
                raise TraceAuditError(
                    f"{contract.name} failed at bucket (b={b}, l1p={l1p}, l2p={l2p}): "
                    f"{exc!r}") from exc
            if counter.transfers:
                raise TraceAuditError(
                    f"{contract.name} at bucket (b={b}, l1p={l1p}, l2p={l2p}) moved "
                    f"{counter.transfers} tensor(s) between devices: an entry point's "
                    "operands arrive on its device (ops/feed.py::put_feed)")
            rows.append({"entry": contract.name, "bucket": [b, l1p, l2p],
                         "widenings": counter.widenings, "transfers": counter.transfers,
                         "out_shape": list(out.shape),
                         "out_dtype": str(out.dtype).replace("torch.", "")})
    return rows


def run_or_raise(problem, backend: str = "cuda") -> dict:
    """Driver entry: :func:`audit_schedule`, raising :class:`TraceAuditError`
    naming every operand finding."""
    report = audit_schedule(problem, backend)
    if report["findings"]:
        rows = "\n  ".join(f"[{f['kind']}] {f['entry']}: {f['detail']}"
                           for f in report["findings"])
        raise TraceAuditError(
            f"launch audit: {len(report['findings'])} finding(s):\n  {rows}")
    return report
