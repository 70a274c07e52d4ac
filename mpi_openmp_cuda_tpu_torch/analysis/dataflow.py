"""The staging dataflow pass: the staged feed is read once, stream-safe, and
re-staged on retry (the port's counterpart of
``mpi_openmp_cuda_tpu/analysis/dataflow.py``).

The JAX pass proves that a donated buffer is dead when XLA deletes it.
Eager PyTorch donates nothing; the port's hazard of the same kind is the
**staged feed**.  ``AlignmentScorer.prestage_codes`` (``ops/dispatch.py``)
starts a dispatch's host-to-device copies early, on a side CUDA stream;
``StagedFeed.take`` hands them to ONE dispatch, after making the current
stream wait on the copies' event and recording the stream on every
operand (so the caching allocator does not reuse a block the side stream
still writes).  A feed read twice, an operand the stream is not recorded
on, or a retry that re-reads a taken feed would score stale or reused
memory, on the card only.  The pass walks the package AST (lockgraph's
module index and call resolution) and proves three rules:

(a) **single use** — a ``StagedFeed`` is made only in ``prestage_codes``;
    its launches (``feed._launches``) are read only inside ``StagedFeed``;
    every
    function that calls ``.take(...)`` takes a feed once and reads it no
    more after the take.
(b) **stream safety** — ``take`` waits on the feed's event and calls
    ``record_stream`` on every device tensor of a launch's state, the
    tensor list DERIVED from ``dispatch._to_device`` (the ``ScorerState``
    keywords it fills from ``put(...)`` or a tensor parameter): a fifth
    operand added there without a ``record_stream`` is a finding.
(c) **re-staging on retry** — from every re-dispatch root (the batch
    CLI's and the pipeline's retry ladders with their closures inlined,
    the fleet worker's score path, the rescue), every call path reaches
    the uploads (``put``) through the dispatch layer and nothing above it
    uploads; a root hands its attempts the feed object itself or nothing
    (``staged=`` a name, ``None``, or popped from a single-use holder:
    never something rebuilt from a feed); and every function that takes a
    feed falls back to ``_upload`` from host numpy when ``take`` returns
    None (a digest mismatch or a spent feed).

The result is a :class:`StagingPlan` in the JAX ``DonationPlan``'s view
shape (the ``donation-audit`` report): one entry a launch entry point,
an empty ``donate`` list, every tensor operand pinned with the reason
eager PyTorch gives, the re-staging paths and the findings, each hazard
with its blocking call path.  Pure AST, no device, milliseconds.
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path

from . import DataflowError
from .lockgraph import _index_module, _package_files, _resolve_call
from .traceaudit import LARGE_BUFFER_BYTES, NO_DONATION

_FEED_CLASS = "StagedFeed"
_FEED_MAKER = ("ops/dispatch.py", "AlignmentScorer.prestage_codes")
_FEED_TAKE = ("ops/dispatch.py", "StagedFeed.take")
_STATE_BUILDER = ("ops/dispatch.py", "_to_device")

#: Receivers the AST cannot type: the retry ladders score through
#: ``degrader.scorer`` and a lambda parameter, the rescue through a local
#: scorer.  Like lockgraph's hints they encode the package's wiring; a
#: root that then reaches no upload fails the pass (a vacuous proof).
_VAR_TYPE_HINTS: dict[tuple[str, str], str] = {
    ("io/cli.py", "sc"): "AlignmentScorer",
    ("io/pipeline.py", "deg.scorer"): "AlignmentScorer",
    ("io/pipeline.py", "sc"): "AlignmentScorer",
    ("resilience/rescue.py", "scorer"): "AlignmentScorer",
}
_ATTR_TYPE_HINTS: dict[tuple[str, str, str], str] = {
    ("serve/fleet.py", "FleetWorker", "pipeline"): "ChunkPipeline",
}

#: Every function that can score the same chunk more than once.
_REDISPATCH_ROOTS: tuple[tuple[str, str], ...] = (
    ("io/cli.py", "_run_batch"),
    ("io/pipeline.py", "ChunkPipeline.dispatch"),
    ("io/pipeline.py", "ChunkPipeline.materialise"),
    ("serve/fleet.py", "FleetWorker._score_claim"),
    ("serve/fleet.py", "FleetWorker._score_offer"),
    ("resilience/rescue.py", "rescue_orphans"),
)

#: The modules whose functions may upload: the dispatch and the sharded
#: paths, below every retry boundary.
_UPLOAD_LAYER = frozenset({"ops/dispatch.py", "parallel/sharding.py", "parallel/ring.py"})

#: The launch entry points whose operands the plan pins
#: (``dispatch.run_launch``'s routes).
_LAUNCH_ENTRIES: tuple[tuple[str, str], ...] = (
    ("ops/cuda_scorer.py", "fused_scorer"),
    ("ops/cuda_scorer.py", "packed_scorer"),
    ("ops/matmul_scorer.py", "mm_rows"),
    ("ops/gather_scorer.py", "gather_rows"),
)


# -- plan dataclasses ----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PinnedArg:
    """One operand left to the allocator, with its reason."""

    argnum: int
    name: str
    kind: str
    reason: str
    path: tuple[str, ...] = ()

    def to_json(self) -> dict:
        return {"argnum": self.argnum, "name": self.name, "kind": self.kind,
                "reason": self.reason, "path": list(self.path)}


@dataclasses.dataclass(frozen=True)
class EntryPlan:
    """The plan of one launch entry point: nothing donated, every tensor
    operand pinned."""

    module: str
    wrapper: str
    params: tuple[str, ...]
    pinned: tuple[PinnedArg, ...]
    call_sites: tuple[str, ...]
    donate: tuple[int, ...] = ()

    def to_json(self) -> dict:
        return {"module": self.module, "wrapper": self.wrapper, "body": self.wrapper,
                "params": list(self.params), "donate": list(self.donate),
                "wired": None, "pinned": [p.to_json() for p in self.pinned],
                "call_sites": list(self.call_sites)}


@dataclasses.dataclass(frozen=True)
class StagingPlan:
    """The package's staging verdict, in the ``DonationPlan`` view shape."""

    entries: tuple[EntryPlan, ...]
    state_fields: tuple[str, ...]  # the tensor operands rule (b) derived
    restage_paths: tuple[dict, ...]
    findings: tuple[dict, ...]

    def to_body(self) -> dict:
        """The ``kind="donation-audit"`` report body (the caller adds
        ``trace_audit``)."""
        return {
            "plan": {
                "large_buffer_bytes": LARGE_BUFFER_BYTES,
                "donation_supported": False,
                "state_fields": list(self.state_fields),
                "entries": [e.to_json() for e in self.entries],
            },
            "restage_paths": [dict(r) for r in self.restage_paths],
            "findings": [dict(f) for f in self.findings],
            "counts": {
                "entries": len(self.entries),
                "donated_argnums": 0,
                "pinned": sum(len(e.pinned) for e in self.entries),
                "restage_paths": len(self.restage_paths),
                "findings": len(self.findings),
            },
        }


# -- AST collection --------------------------------------------------------------


class _FuncNode:
    """One function or method, lambdas and nested defs inlined (their
    bodies run under the enclosing retry machinery).  Its calls, uploads
    (``put(...)`` lines) and takes (``.take(...)`` lines) are collected at
    first use: most of the package is never on a re-dispatch path."""

    def __init__(self, module: str, qualname: str, node: ast.AST):
        self.module, self.qualname, self.node = module, qualname, node
        self._facts = None

    def _collect(self):
        calls, uploads, takes = [], [], []
        for sub in ast.walk(self.node):
            if not isinstance(sub, ast.Call):
                continue
            func = sub.func
            if isinstance(func, ast.Name) and func.id == "put":
                uploads.append(sub.lineno)
            if isinstance(func, ast.Attribute) and func.attr == "take":
                takes.append(sub.lineno)
            desc = None
            if isinstance(func, ast.Name):
                desc = ("name", func.id)
            elif isinstance(func, ast.Attribute):
                base = func.value
                if isinstance(base, ast.Name) and base.id == "self":
                    desc = ("self", func.attr)
                elif (isinstance(base, ast.Attribute) and isinstance(base.value, ast.Name)
                      and base.value.id == "self"):
                    desc = ("selfattr", base.attr, func.attr)
                elif isinstance(base, ast.Name):
                    desc = ("mod", base.id, func.attr)
                else:
                    recv = _dotted(base)
                    if recv is not None:
                        desc = ("varattr", recv, func.attr)
            if desc is not None:
                calls.append((desc, sub.lineno))
        self._facts = (calls, uploads, takes)

    @property
    def calls(self) -> list:  # (desc, line)
        if self._facts is None:
            self._collect()
        return self._facts[0]

    @property
    def uploads(self) -> list:
        if self._facts is None:
            self._collect()
        return self._facts[1]

    @property
    def takes(self) -> list:
        if self._facts is None:
            self._collect()
        return self._facts[2]


def _dotted(node: ast.AST) -> str | None:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


class _Package:
    """The parsed package: the func table (closures inlined), the module
    indexes and the class table, with the type hints applied."""

    def __init__(self, package_root: str | Path | None = None):
        if package_root is None:
            package_root = Path(__file__).resolve().parent.parent
        self.root = Path(package_root)
        self.trees: dict[str, ast.Module] = {}
        self.indexes: dict = {}
        self.funcs: dict[tuple[str, str], _FuncNode] = {}
        self.classes: dict = {}
        self.texts: dict[str, str] = {}
        for path, rel in _package_files(self.root):
            text = path.read_text()
            try:
                tree = ast.parse(text, filename=str(path))
            except SyntaxError:
                continue  # seqlint owns syntax errors
            self.trees[rel] = tree
            self.texts[rel] = text
            index = _index_module(rel, tree)
            self.indexes[rel] = index
            for (mod, cls, attr), tname in _ATTR_TYPE_HINTS.items():
                if mod == rel and cls in index.classes:
                    index.classes[cls].attr_types.setdefault(attr, tname)
            for cname, cinfo in index.classes.items():
                self.classes.setdefault(cname, (rel, cinfo))
            for node in tree.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self.funcs[(rel, node.name)] = _FuncNode(rel, node.name, node)
                elif isinstance(node, ast.ClassDef):
                    for stmt in node.body:
                        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                            q = f"{node.name}.{stmt.name}"
                            self.funcs[(rel, q)] = _FuncNode(rel, q, stmt)

    def mentioning(self, *tokens: str):
        """The functions of the modules whose text holds any of ``tokens``."""
        mods = {rel for rel, text in self.texts.items() if any(t in text for t in tokens)}
        return [(k, f) for k, f in self.funcs.items() if k[0] in mods]

    def resolve(self, desc, module: str, qualname: str):
        """lockgraph's resolution plus the type-hinted receivers."""
        kind = desc[0]
        if kind in ("varattr", "mod"):
            tname = _VAR_TYPE_HINTS.get((module, desc[1]))
            if tname is not None and tname in self.classes:
                home, _ = self.classes[tname]
                key = (home, f"{tname}.{desc[2]}")
                if key in self.funcs:
                    return key
            if kind == "varattr":
                return None
        return _resolve_call(desc, module, qualname, self.indexes, self.classes,
                             self.funcs)

    def reachable(self, start) -> dict:
        """Func keys reachable from ``start`` -> their shortest call path."""
        paths = {start: (start,)}
        frontier = [start]
        while frontier:
            cur = frontier.pop(0)
            info = self.funcs.get(cur)
            if info is None:
                continue
            for desc, _ in info.calls:
                callee = self.resolve(desc, info.module, info.qualname)
                if callee is not None and callee not in paths:
                    paths[callee] = paths[cur] + (callee,)
                    frontier.append(callee)
        return paths


def _name(key) -> str:
    return f"{key[0]}:{key[1]}"


def _finding(kind: str, entry: str, detail: str) -> dict:
    return {"kind": kind, "entry": entry, "detail": detail}


# -- rule (a): single use ----------------------------------------------------------


def _parent_map(root: ast.AST) -> dict:
    parents = {}
    for node in ast.walk(root):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


def _reads_after(fn_node: ast.AST, call: ast.AST, holder: str, parents: dict) -> list[int]:
    """Lines where ``holder`` is read in a statement that runs after the
    one holding ``call`` (the statements following it in each enclosing
    block; a loop around it re-runs the whole loop body)."""
    lines = []
    node = call
    while node is not fn_node:
        parent = parents.get(node)
        if parent is None:
            break
        if isinstance(parent, (ast.For, ast.While, ast.AsyncFor)):
            for sub in ast.walk(parent):
                if (isinstance(sub, ast.Name) and sub.id == holder
                        and isinstance(sub.ctx, ast.Load) and sub.lineno != call.lineno):
                    lines.append(sub.lineno)
        for field in ("body", "orelse", "finalbody"):
            block = getattr(parent, field, None)
            if isinstance(block, list) and node in block:
                for stmt in block[block.index(node) + 1:]:
                    for sub in ast.walk(stmt):
                        if (isinstance(sub, ast.Name) and sub.id == holder
                                and isinstance(sub.ctx, ast.Load)):
                            lines.append(sub.lineno)
        node = parent
    return sorted(set(lines))


def _single_use(pkg: _Package) -> list[dict]:
    findings = []
    for key, fn in pkg.mentioning(_FEED_CLASS, "_launches", ".take("):
        in_feed = key[1].startswith(f"{_FEED_CLASS}.")
        parents = None
        takes_by_holder: dict[str, list] = {}
        for sub in ast.walk(fn.node):
            if (isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name)
                    and sub.func.id == _FEED_CLASS and key != _FEED_MAKER):
                findings.append(_finding(
                    "feed-origin", _name(key),
                    f"line {sub.lineno} makes a {_FEED_CLASS} outside "
                    f"{_name(_FEED_MAKER)}: a feed's copies and event come from there"))
            if (isinstance(sub, ast.Attribute) and sub.attr == "_launches"
                    and isinstance(sub.ctx, ast.Load) and not in_feed
                    and not (isinstance(sub.value, ast.Name) and sub.value.id == "self")):
                findings.append(_finding(
                    "feed-read", _name(key),
                    f"line {sub.lineno} reads a staged feed's launches outside "
                    f"{_FEED_CLASS}.take: they may still be in flight on the side "
                    "stream, or already handed to another dispatch"))
            if (isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute)
                    and sub.func.attr == "take" and isinstance(sub.func.value, ast.Name)):
                takes_by_holder.setdefault(sub.func.value.id, []).append(sub)
        for holder, calls in takes_by_holder.items():
            if len(calls) > 1:
                findings.append(_finding(
                    "feed-taken-twice", _name(key),
                    f"{holder}.take(...) at lines {[c.lineno for c in calls]}: a feed "
                    "feeds one dispatch"))
                continue
            if parents is None:
                parents = _parent_map(fn.node)
            after = _reads_after(fn.node, calls[0], holder, parents)
            if after:
                findings.append(_finding(
                    "feed-read-after-take", _name(key),
                    f"{holder} read at lines {after} after its take at line "
                    f"{calls[0].lineno}: a taken feed is spent"))
    take = pkg.funcs.get(_FEED_TAKE)
    if take is not None and not _empties_feed(take.node):
        findings.append(_finding(
            "take-not-destructive", _name(_FEED_TAKE),
            "take hands out the staged launches without setting self._launches to "
            "None: a feed passed to a retried attempt would feed it the same tensors"))
    return findings


def _empties_feed(node: ast.AST) -> bool:
    """Whether ``node`` assigns None to ``self._launches`` (alone or in a
    tuple assignment)."""
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Assign):
            continue
        for tgt in sub.targets:
            pairs = (zip(tgt.elts, sub.value.elts)
                     if isinstance(tgt, ast.Tuple) and isinstance(sub.value, ast.Tuple)
                     else [(tgt, sub.value)])
            for t, v in pairs:
                if (isinstance(t, ast.Attribute) and t.attr == "_launches"
                        and isinstance(v, ast.Constant) and v.value is None):
                    return True
    return False


# -- rule (b): stream safety ---------------------------------------------------------


def state_tensor_fields(pkg: _Package) -> tuple[str, ...]:
    """The ``ScorerState`` keywords ``dispatch._to_device`` fills with a
    device tensor: ``put(...)`` or a parameter annotated ``torch.Tensor``."""
    fn = pkg.funcs.get(_STATE_BUILDER)
    if fn is None:
        return ()
    tensor_params = {a.arg for a in fn.node.args.args
                     if a.annotation is not None and "Tensor" in ast.unparse(a.annotation)}
    fields = []
    for sub in ast.walk(fn.node):
        if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name) \
                and sub.func.id == "ScorerState":
            for kw in sub.keywords:
                v = kw.value
                if (isinstance(v, ast.Call) and isinstance(v.func, ast.Name)
                        and v.func.id == "put") or (
                        isinstance(v, ast.Name) and v.id in tensor_params):
                    fields.append(kw.arg)
    return tuple(fields)


def _stream_safety(pkg: _Package, fields: tuple[str, ...]) -> list[dict]:
    name = _name(_FEED_TAKE)
    fn = pkg.funcs.get(_FEED_TAKE)
    if fn is None:
        return [_finding("take-missing", name, f"{_FEED_CLASS}.take no longer exists: "
                         "update analysis/dataflow.py with the feed's new reader")]
    if not fields:
        return [_finding("state-fields-unproven", _name(_STATE_BUILDER),
                         "no device tensor field of ScorerState found in "
                         "dispatch._to_device: the derivation rotted (a vacuous proof)")]
    findings = []
    waits = [c for c in ast.walk(fn.node) if isinstance(c, ast.Call)
             and isinstance(c.func, ast.Attribute) and c.func.attr == "wait_event"]
    if not waits:
        findings.append(_finding(
            "missing-wait-event", name,
            "take hands out staged launches without making the current stream wait "
            "on the copies' event: a launch could read a tensor before it lands"))
    recorded: set[str] = set()
    for loop in ast.walk(fn.node):
        if not isinstance(loop, ast.For):
            continue
        if not any(isinstance(c, ast.Call) and isinstance(c.func, ast.Attribute)
                   and c.func.attr == "record_stream" for c in ast.walk(loop)):
            continue
        for elt in ast.walk(loop.iter):
            if isinstance(elt, ast.Attribute):
                recorded.add(elt.attr)
    for field in fields:
        if field not in recorded:
            findings.append(_finding(
                "missing-record-stream", name,
                f"operand {field!r} of a launch's state (dispatch._to_device) is handed "
                "to another stream without record_stream: the caching allocator may "
                "reuse its block while the launch still reads it"))
    return findings


# -- rule (c): re-staging on retry -----------------------------------------------------


def _staged_keywords(node: ast.AST) -> list[tuple[int, str | None]]:
    """``(line, problem)`` of every ``staged=`` keyword under ``node``;
    ``problem`` is None when the value is ``None``, a name (the feed
    object: its destructive ``take`` spends it on the first attempt) or
    popped from a single-use holder (``feed.pop() if feed else None``)."""
    out = []
    for call in ast.walk(node):
        if not isinstance(call, ast.Call):
            continue
        for kw in call.keywords:
            if kw.arg != "staged":
                continue
            v = kw.value
            pops = [c for c in ast.walk(v) if isinstance(c, ast.Call)
                    and isinstance(c.func, ast.Attribute) and c.func.attr == "pop"]
            if (isinstance(v, ast.Constant) and v.value is None) or pops \
                    or isinstance(v, ast.Name):
                out.append((call.lineno, None))
            else:
                out.append((call.lineno, f"staged={ast.unparse(v)}"))
    return out


def _restage(pkg: _Package, roots) -> tuple[list[dict], list[dict], dict]:
    """Rule (c): ``(restage rows, findings, {root: its reachable paths})``."""
    rows, findings, root_paths = [], [], {}
    uploaders = {k for k, f in pkg.mentioning("put(") if f.uploads}
    unsafe_takers = set()
    for key, fn in pkg.mentioning(".take("):
        if not fn.takes:
            continue
        src = ast.unparse(fn.node)
        if "is not None" not in src or "_upload(" not in src:
            unsafe_takers.add(key)
            findings.append(_finding(
                "take-without-restage", _name(key),
                f"takes a staged feed (line {fn.takes[0]}) but has no fall-back to "
                "_upload from host numpy when take returns None"))
    for root in roots:
        rname = _name(root)
        if root not in pkg.funcs:
            findings.append(_finding(
                "restage-root-missing", rname,
                "re-dispatch root no longer exists: update _REDISPATCH_ROOTS in "
                "analysis/dataflow.py"))
            continue
        for line, problem in _staged_keywords(pkg.funcs[root].node):
            if problem is not None:
                findings.append(_finding(
                    "retry-rereads-feed", rname,
                    f"line {line} passes {problem} to a dispatch the retry ladder can "
                    "repeat: an attempt must get the feed object itself (its take spends "
                    "it) or nothing, never launches rebuilt from a feed"))
        paths = root_paths[root] = pkg.reachable(root)
        reached = sorted(uploaders & set(paths))
        if not reached:
            findings.append(_finding(
                "restage-unproven", rname,
                "the root reaches no upload through the resolved call graph: the "
                "retry ladder stopped scoring, or a _VAR_TYPE_HINTS row rotted (a "
                "vacuous proof fails closed)"))
            continue
        for leaf in reached:
            path = paths[leaf]
            witness = " -> ".join(_name(p) for p in path)
            # Above the dispatch layer nothing uploads: a retried attempt
            # must reach the uploads again from host arrays.
            stagers = [k for k in path[:-1] if pkg.funcs[k].uploads
                       and k[0] not in _UPLOAD_LAYER]
            readers = [k for k in path[:-1] if k in unsafe_takers]
            rows.append({"root": rname, "leaf": _name(leaf),
                         "path": [_name(k) for k in path],
                         "ok": not stagers and not readers})
            for k in stagers:
                findings.append(_finding(
                    "stage-above-retry", rname,
                    f"{_name(k)} uploads (line {pkg.funcs[k].uploads[0]}) above the "
                    f"dispatch on the re-dispatch path {witness}: a retry would reuse "
                    "its device tensors; keep operands host-side until the dispatch"))
            for k in readers:
                findings.append(_finding(
                    "retry-rereads-feed", rname,
                    f"{_name(k)} takes a staged feed with no host fall-back on the "
                    f"re-dispatch path {witness}"))
    return rows, findings, root_paths


def _with_blocking_path(finding: dict, root_paths: dict) -> dict:
    """``finding`` with the call path from the first re-dispatch root that
    reaches its function, when one does (the counterexample's stack)."""
    for paths in root_paths.values():
        for key, path in paths.items():
            if _name(key) == finding["entry"]:
                return {**finding, "path": [_name(k) for k in path]}
    return finding


# -- the plan ----------------------------------------------------------------------------


def _call_sites(pkg: _Package, entries) -> dict:
    """``{entry: sorted "module:qualname" callers}`` for every entry."""
    sites: dict = {e: set() for e in entries}
    names = {e[1] for e in entries}
    for key, fn in pkg.mentioning(*names):
        for desc, _ in fn.calls:
            if desc[0] == "name" and desc[1] in names:
                callee = pkg.resolve(desc, fn.module, fn.qualname)
                if callee in sites:
                    sites[callee].add(_name(key))
    return {e: sorted(s) for e, s in sites.items()}


def build_plan(package_root: str | Path | None = None, *,
               redispatch_roots=_REDISPATCH_ROOTS) -> StagingPlan:
    """Run the whole pass and return the :class:`StagingPlan`
    (``redispatch_roots`` exists for seeded packages in the tests)."""
    pkg = _Package(package_root)
    fields = state_tensor_fields(pkg)
    findings = _single_use(pkg) + _stream_safety(pkg, fields)
    restage, rfindings, root_paths = _restage(pkg, redispatch_roots)
    findings = [_with_blocking_path(f, root_paths) for f in findings + rfindings]
    entries = []
    all_sites = _call_sites(pkg, _LAUNCH_ENTRIES)
    for entry in _LAUNCH_ENTRIES:
        if entry not in pkg.funcs:
            continue
        sites = all_sites[entry]
        if not sites:
            findings.append(_finding(
                "no-call-sites", _name(entry),
                "no package call site of this launch entry resolved: a plan proven "
                "against zero sites proves nothing"))
        pinned = tuple(PinnedArg(i, f, "no-donation", NO_DONATION, tuple(sites))
                       for i, f in enumerate(fields))
        entries.append(EntryPlan(entry[0], entry[1], fields, pinned, tuple(sites)))
    return StagingPlan(
        entries=tuple(entries),
        state_fields=fields,
        restage_paths=tuple(restage),
        findings=tuple(sorted(findings, key=lambda f: (f["kind"], f["entry"]))),
    )


def audit_dataflow(package_root: str | Path | None = None) -> dict:
    """The report body (never raises on findings)."""
    return build_plan(package_root).to_body()


def run_or_raise(package_root: str | Path | None = None) -> dict:
    """Driver entry: the body, or :class:`DataflowError` naming every
    finding."""
    body = audit_dataflow(package_root)
    if body["findings"]:
        rows = "\n  ".join(f"[{f['kind']}] {f['entry']}: {f['detail']}"
                           for f in body["findings"])
        raise DataflowError(f"dataflow: {len(body['findings'])} finding(s):\n  {rows}")
    return body
