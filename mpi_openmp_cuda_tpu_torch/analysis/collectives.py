"""The comms audit: the collectives of the sharded paths, inventoried and
held to their plan (the port's counterpart of
``mpi_openmp_cuda_tpu/analysis/collectives.py``).

The JAX package's collectives are derived by XLA from ``shard_map``
layouts, so its audit walks the compiled program.  The port calls its
collectives by hand, through ``parallel/comm.py``, which logs every call
in each local slot's sequence (``Collectives.slot_log``: kind, elements,
bytes).  This audit reads those logs, and the ``parallel/`` source, and
proves four things for every mesh form of :data:`AUDIT_SPECS`, run on
``[cpu] x N`` through ``LocalCollectives`` at the JAX audit's
representative batch (:func:`representative_problem`), and a fifth for a
job's logs:

1. **The inventory**, per slot and in program order: the batch mesh makes
   no collective in the compute and one ``gather`` a dispatch;
   the Seq1 ring ``R`` ``shift``s, one ``all_gather`` of the candidates
   and one ``gather`` a dispatch (PERF.md §3).
2. **Ordering consistency**: every slot's sequence is the same
   (``divergent-sequence`` otherwise), and, statically, no collective
   call in ``parallel/*.py`` sits under a branch whose predicate reads the
   rank or the slot (:func:`divergent_branches`: the port's form of the
   JAX audit's collective under a varying ``cond``).
3. **Hygiene**: outside ``comm.py`` no ``parallel/`` code moves a tensor
   between devices (:func:`device_crossings`, ``device-crossing``), and
   every shard's operands sit on its slot's device
   (:func:`operand_placement`, ``unsharded-operand``).
4. **The ring cross-check**: each ring slot's shifts equal
   ``ring_plan``'s R, and the cost sheet's seq rows
   (``analysis/costmodel.py``) price the same R (``ring-plan-drift``).
5. **The hybrid form** (:func:`hybrid_findings`, fed by a job of several
   processes of several slots each): every slot's sequence, from its
   process's ``ProcessCollectives.slot_log``, equals the same slot's in
   the one-process run of the same mesh (``hybrid-divergence``).

``scripts/torch_comms_audit.py`` wraps the body in the ``comms-audit``
report and diffs it against ``tests/golden/torch_comms_audit.json``.  CPU
only, the kernels' plain versions at a tiny size, a second or so.
"""

from __future__ import annotations

import ast
import contextlib
import hashlib
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from . import CollectiveAuditError

#: Every mesh-spec form (``parallel/specs.py``) and the devices it takes.
AUDIT_SPECS: dict[str, int] = {"2": 2, "batch:2": 2, "seq:4": 4, "2x2": 4}

#: The JAX audit's representative batch: Seq1 of 150 chars (L1P 256, so
#: the ring takes R >= 2 shifts) and six Seq2 rows up to 100 (L2P 128).
_REP_SEED = 14
_REP_LEN1 = 150
_REP_LEN2S = (100, 60, 40, 100, 25, 7)
_REP_WEIGHTS = (2, 2, 1, 10)

#: The collective methods of ``parallel/comm.py``'s interface.
_COMM_METHODS = frozenset({"shift", "all_gather", "gather", "broadcast"})
#: Identifiers whose value differs between ranks or slots.
_RANK_NAMES = frozenset({"rank", "slot", "process_index", "is_coordinator",
                         "local_rank", "LOCAL_RANK", "RANK"})
#: Tensor methods that move data between devices.
_CROSSING_METHODS = frozenset({"to", "cuda", "cpu", "copy_"})
#: ``parallel/`` functions outside ``comm.py`` allowed a device crossing,
#: with the reason: the gather's host fetch, started early.
_HOST_FETCH_SITES = {
    ("parallel/sharding.py", "ShardedPending.prefetch"):
        "the gather's device-to-host fetch into pinned memory, started at "
        "dispatch (a one-process job's half of comm.gather)",
}


def representative_problem():
    """``(seq1_codes, seq2_codes, weights)``: the JAX audit's batch, from
    ``default_rng(14)`` in its order."""
    rng = np.random.default_rng(_REP_SEED)
    seq1 = rng.integers(1, 27, size=_REP_LEN1).astype(np.int32)
    seq2s = [rng.integers(1, 27, size=n).astype(np.int32) for n in _REP_LEN2S]
    return seq1, seq2s, list(_REP_WEIGHTS)


def signature(seq) -> str:
    """Stable digest of one slot's collective sequence."""
    blob = json.dumps([list(op) for op in seq])
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


@contextlib.contextmanager
def _placement_spy():
    """Record the operand devices of every shard launch the sharded paths
    make (``sharding.run_launch``, ``ring.fused_scorer`` and
    ``ring.ring_window_rows``), in call order: a list of device sets."""
    from ..parallel import ring, sharding

    calls: list[set] = []
    saved = (sharding.run_launch, ring.fused_scorer, ring.ring_window_rows)

    def devices_of(*tensors):
        import torch

        return {t.device for t in tensors if isinstance(t, torch.Tensor)}

    def run_launch(launch, backend, done=None):
        st = launch.state
        calls.append(devices_of(st.seq1ext, st.rows, st.lens, st.val, done))
        return saved[0](launch, backend, done)

    def fused_scorer(st):
        calls.append(devices_of(st.seq1ext, st.rows, st.lens, st.val))
        return saved[1](st)

    def ring_window_rows(win, d, bs, len1, rows, lens, val):
        calls.append(devices_of(win, rows, lens, val))
        return saved[2](win, d, bs, len1, rows, lens, val)

    sharding.run_launch, ring.fused_scorer, ring.ring_window_rows = (
        run_launch, fused_scorer, ring_window_rows)
    try:
        yield calls
    finally:
        sharding.run_launch, ring.fused_scorer, ring.ring_window_rows = saved


def operand_placement(entry: str, calls, mesh, slots) -> list[dict]:
    """``unsharded-operand`` findings: the k-th shard launch runs slot
    ``slots[k % len(slots)]`` (the sharded paths launch their local slots
    in order), and every operand of it must sit on that slot's device."""
    findings = []
    for k, devs in enumerate(calls):
        slot = slots[k % len(slots)]
        want = mesh.device(slot)
        off = sorted(str(d) for d in devs if d != want)
        if off:
            findings.append({
                "kind": "unsharded-operand", "entry": entry,
                "detail": f"launch {k} of slot {slot} reads operands on {off}, not on "
                          f"the slot's device {want}: send them in the "
                          "arena of mesh.device(slot) (feed.put_feed)",
            })
    return findings


def run_spec(spec: str, devices=None, device="cpu"):
    """Score the representative batch through ``AlignmentScorer`` on the
    mesh ``spec`` over ``devices`` (``None``: the process's global devices,
    as the CLI's ``--mesh`` takes them) with the ``cuda`` backend (the
    kernels' plain versions on the CPU).  Returns ``(sharding, rows,
    placement calls)``; the sharding's ``comm`` holds the logs."""
    from ..ops.dispatch import AlignmentScorer
    from ..parallel.specs import build_sharding

    sharding = build_sharding(spec, device=device, devices=devices)
    seq1, seq2s, weights = representative_problem()
    scorer = AlignmentScorer("cuda", device=sharding.mesh.device(0), sharding=sharding)
    sharding.comm.reset_counts()
    with _placement_spy() as calls:
        rows = scorer.score_codes(seq1, seq2s, weights)
    return sharding, rows, calls


def _expected(sharding, batch) -> list[tuple[str, int]]:
    """The kinds and counts of one slot's sequence that the plan says, in
    order: a ring slot's ``R`` shifts, its ``all_gather`` and the gather;
    a batch slot's one gather a dispatch, whatever its buckets."""
    from ..parallel.ring import RingSharding, ring_plan

    if isinstance(sharding, RingSharding):
        _, r = ring_plan(batch.l1p, batch.l2p, sharding.sp, kernel=True)
        return [("shift", r), ("all_gather", 1), ("gather", 1)]
    return [("gather", 1)]


def _runs(seq) -> list[tuple[str, int]]:
    """Run-length kinds of a sequence: ``[(kind, count), ...]``."""
    out: list[list] = []
    for kind, *_ in seq:
        if out and out[-1][0] == kind:
            out[-1][1] += 1
        else:
            out.append([kind, 1])
    return [tuple(r) for r in out]


def audit_spec_entries(devices_for=None) -> tuple[list[dict], list[dict]]:
    """Run every :data:`AUDIT_SPECS` form (``devices_for(n)`` gives its
    devices; ``[cpu] x n`` by default) and audit its logs: one entry row
    a form, and the inventory, ordering and placement findings."""
    import torch

    from ..ops.dispatch import pad_problem

    if devices_for is None:
        def devices_for(n):
            return [torch.device("cpu")] * n
    seq1, seq2s, _ = representative_problem()
    batch = pad_problem(seq1, seq2s)
    entries: list[dict] = []
    findings: list[dict] = []
    for spec, need in AUDIT_SPECS.items():
        sharding, _, calls = run_spec(spec, devices_for(need))
        comm = sharding.comm
        entry = f"{type(sharding).__name__}[{spec}]"
        slots = comm.local_slots()
        seqs = {s: comm.slot_log.get(s, []) for s in slots}
        sigs = {s: signature(seqs[s]) for s in slots}
        consistent = len(set(sigs.values())) == 1
        if not consistent:
            findings.append({
                "kind": "divergent-sequence", "entry": entry,
                "detail": f"slots issue different collective sequences {sigs}: in a job "
                          "of several processes the ranks would wait on different "
                          "collectives and hang",
            })
        want = _expected(sharding, batch)
        for s in slots:
            got = _runs(seqs[s])
            if got != want:
                findings.append({
                    "kind": "inventory-drift", "entry": entry,
                    "detail": f"slot {s} issued {got}, the plan says {want}",
                })
        findings += operand_placement(entry, calls, sharding.mesh, slots)
        first = seqs[slots[0]]
        entries.append({
            "spec": spec,
            "entry": entry,
            "mesh_axes": dict(sharding.mesh.shape),
            "positions": len(slots),
            "collectives": [{"kind": k, "elements": e, "bytes": b} for k, e, b in first],
            "payload_bytes": sum(b for s in slots for _, _, b in seqs[s]),
            "signature": sigs[slots[0]],
            "per_position": [{"position": s, "signature": sigs[s]} for s in slots],
            "consistent": consistent,
            "counts": dict(sorted(comm.counts.items())),
            "log": [[k, e] for k, e in comm.log],
        })
    return entries, findings


def hybrid_findings(spec: str, slot_logs: dict) -> list[dict]:
    """``hybrid-divergence`` findings: ``slot_logs`` (``{slot: [(kind,
    elements, bytes)]}``, the ``slot_log`` of every process of a job that
    ran :func:`run_spec` on ``spec``, merged) against each slot's sequence
    in the one-process ``LocalCollectives`` run of ``spec`` over ``[cpu] x
    N``, ``N`` the job's global slots."""
    import torch

    sharding, _, _ = run_spec(spec, [torch.device("cpu")] * len(slot_logs))
    want = sharding.comm.slot_log
    findings = []
    for slot in range(sharding.mesh.size):
        got = [tuple(op) for op in slot_logs.get(slot, ())]
        if got != want.get(slot, []):
            findings.append({
                "kind": "hybrid-divergence", "entry": f"{type(sharding).__name__}[{spec}]",
                "detail": f"slot {slot} issued {got} in the job of several processes, "
                          f"{want.get(slot, [])} in one process: the processes' slots "
                          "no longer follow the one-process plan",
            })
    return findings


def ring_crosscheck(entries: list[dict]) -> tuple[list[dict], list[dict]]:
    """Each ring form's shifts a slot against ``ring_plan``'s R and against
    the R the cost sheet's seq row prices for the same batch."""
    from ..ops.dispatch import pad_problem
    from ..parallel.ring import ring_plan
    from .costmodel import schedule_cost_sheet

    seq1, seq2s, weights = representative_problem()
    batch = pad_problem(seq1, seq2s)
    problem = SimpleNamespace(seq1_codes=seq1, seq2_codes=seq2s, weights=weights)
    scaling = schedule_cost_sheet(problem)["comms"]["scaling"]
    rows, findings = [], []
    for e in entries:
        sp = e["mesh_axes"].get("seq", 1)
        if sp <= 1:
            continue
        _, r = ring_plan(batch.l1p, batch.l2p, sp, kernel=True)
        sheet_r = next((row["ring_steps"] for row in scaling
                        if row["axis"] == "seq" and row["mesh"] == sp), None)
        shifts = sum(1 for op in e["collectives"] if op["kind"] == "shift")
        gathers = sum(1 for op in e["collectives"] if op["kind"] == "all_gather")
        ok = shifts == r and gathers == 1 and sheet_r == [r]
        rows.append({"entry": e["entry"], "planned_r": r, "shifts": shifts,
                     "all_gathers": gathers, "sheet_r": sheet_r, "match": ok})
        if not ok:
            findings.append({
                "kind": "ring-plan-drift", "entry": e["entry"],
                "detail": f"ring_plan says R={r} shifts + 1 all_gather a slot, the "
                          f"run made {shifts} + {gathers} and the cost sheet prices "
                          f"{sheet_r}: parallel/ring.py and analysis/costmodel.py have "
                          "drifted apart",
            })
    return rows, findings


# -- the static passes over parallel/ -------------------------------------------


def _parallel_trees(package_root: Path | None):
    root = Path(package_root) if package_root else Path(__file__).resolve().parent.parent
    for path in sorted((root / "parallel").glob("*.py")):
        yield f"parallel/{path.name}", ast.parse(path.read_text(), filename=str(path))


def _dotted(node) -> str:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    elif isinstance(node, ast.Call):
        parts.append(_dotted(node.func) + "()")
    return ".".join(reversed(parts))


def _is_comm_call(call: ast.Call, comm_funcs: set[str]) -> bool:
    """A call of the collectives interface (on a ``comm`` receiver or a
    ``*Collectives(...)`` object), or of a module function that makes one."""
    func = call.func
    if isinstance(func, ast.Attribute) and func.attr in _COMM_METHODS:
        recv = _dotted(func.value)
        return recv.endswith("comm") or recv.endswith("Collectives()")
    return isinstance(func, ast.Name) and func.id in comm_funcs


def _reads_rank(expr) -> bool:
    for node in ast.walk(expr):
        name = (node.id if isinstance(node, ast.Name)
                else node.attr if isinstance(node, ast.Attribute) else None)
        if name in _RANK_NAMES:
            return True
    return False


def _functions(tree):
    """``(qualname, node)`` of every function and method of a module."""
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node.name, node
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    yield f"{node.name}.{sub.name}", sub


def divergent_branches(package_root: str | Path | None = None) -> list[dict]:
    """``divergent-sequence`` findings: a collective call in
    ``parallel/*.py`` (the interface's methods, or a module function that
    calls one) under an ``if``, ``while``, conditional expression or ``for``
    whose test or iterable reads the rank or the slot."""
    findings = []
    for rel, tree in _parallel_trees(package_root):
        if rel == "parallel/comm.py":
            continue  # the implementations, not callers
        funcs = dict(_functions(tree))
        comm_funcs: set[str] = set()
        while True:  # module functions that reach a collective, to a fixpoint
            grown = {name for name, node in funcs.items() if "." not in name and any(
                isinstance(c, ast.Call) and _is_comm_call(c, comm_funcs)
                for c in ast.walk(node))}
            if grown <= comm_funcs:
                break
            comm_funcs |= grown
        for qual, node in funcs.items():
            for branch in ast.walk(node):
                if isinstance(branch, (ast.If, ast.While, ast.IfExp)):
                    test, body = branch.test, [branch.body, getattr(branch, "orelse", [])]
                elif isinstance(branch, ast.For):
                    test, body = branch.iter, [branch.body, branch.orelse]
                else:
                    continue
                if not _reads_rank(test):
                    continue
                for part in body:
                    for stmt in (part if isinstance(part, list) else [part]):
                        for c in ast.walk(stmt):
                            if isinstance(c, ast.Call) and _is_comm_call(c, comm_funcs):
                                findings.append({
                                    "kind": "divergent-sequence",
                                    "entry": f"{rel}:{qual}",
                                    "detail": f"line {c.lineno}: collective "
                                              f"{_dotted(c.func)}() under a branch on the "
                                              f"rank or slot (line {branch.lineno}): ranks "
                                              "would issue different sequences and hang",
                                })
    return findings


def device_crossings(package_root: str | Path | None = None) -> list[dict]:
    """``device-crossing`` findings: a ``.to``, ``.cuda``, ``.cpu`` or
    ``.copy_`` call in ``parallel/*.py`` outside ``comm.py`` and the
    allowed host-fetch sites (operands go up from host numpy only through
    the feed's arena, ``feed.put_feed``, and between devices only through
    ``comm.py``)."""
    findings = []
    for rel, tree in _parallel_trees(package_root):
        if rel == "parallel/comm.py":
            continue
        for qual, node in _functions(tree):
            if (rel, qual) in _HOST_FETCH_SITES:
                continue
            for c in ast.walk(node):
                if (isinstance(c, ast.Call) and isinstance(c.func, ast.Attribute)
                        and c.func.attr in _CROSSING_METHODS
                        and not _dotted(c.func.value).startswith(("np", "numpy"))):
                    findings.append({
                        "kind": "device-crossing", "entry": f"{rel}:{qual}",
                        "detail": f"line {c.lineno}: {_dotted(c.func)}() moves a tensor "
                                  "between devices outside parallel/comm.py: route it "
                                  "through the collectives, which log it",
                    })
    return findings


def audit_collectives(package_root: str | Path | None = None, devices_for=None) -> dict:
    """The comms-audit body: per-form entries, the ring cross-check, every
    finding (dynamic and static) and the cost sheet's comms rows for the
    input3-class schedule."""
    from ..models.workload import input3_class_problem
    from .costmodel import schedule_cost_sheet

    entries, findings = audit_spec_entries(devices_for)
    ring_rows, ring_findings = ring_crosscheck(entries)
    findings = (findings + ring_findings + divergent_branches(package_root)
                + device_crossings(package_root))
    return {
        "entries": entries,
        "ring_crosscheck": ring_rows,
        "findings": findings,
        "comms": schedule_cost_sheet(input3_class_problem())["comms"],
        "counts": {
            "entries": len(entries),
            "collectives": sum(len(e["log"]) for e in entries),
            "payload_bytes": sum(e["payload_bytes"] for e in entries),
            "findings": len(findings),
        },
    }


def inventory_totals() -> dict:
    """The bench's summary of the audit: entries, collectives, payload
    bytes and findings over the ``[cpu] x N`` forms (host work only)."""
    entries, findings = audit_spec_entries()
    return {
        "entries": len(entries),
        "collectives": sum(len(e["log"]) for e in entries),
        "payload_bytes": sum(e["payload_bytes"] for e in entries),
        "findings": len(findings),
    }


def run_or_raise(package_root: str | Path | None = None) -> dict:
    """Driver entry: the audit body, or :class:`CollectiveAuditError` naming
    every finding (and on an empty inventory: the ring must contribute)."""
    body = audit_collectives(package_root)
    if body["findings"]:
        rows = "\n  ".join(f"[{f['kind']}] {f['entry']}: {f['detail']}"
                           for f in body["findings"])
        raise CollectiveAuditError(
            f"collective audit: {len(body['findings'])} finding(s):\n  {rows}")
    if not any(e["collectives"] for e in body["entries"]):
        raise CollectiveAuditError(
            "collective audit inventoried ZERO collectives across every mesh form: "
            "the ring contributes R shifts + 1 all_gather a slot; the logs of "
            "parallel/comm.py or the audit's runs have drifted")
    return body
