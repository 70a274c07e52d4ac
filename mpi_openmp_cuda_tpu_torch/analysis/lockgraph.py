"""Whole-program lock-graph audit (``lockgraph``).

seqlint's SEQ008/SEQ010 are *lexical*: they see one function at a time.
This pass is the interprocedural complement (the port of
``mpi_openmp_cuda_tpu/analysis/lockgraph.py``, unchanged in its rules).  It walks every module's AST, builds
the intra-package call graph, extracts every lock acquisition site
(``with self.<guard>:`` on a ``threading.Condition``/``Lock``/``RLock``
attribute, ``with <local guard>:``, and explicit ``.acquire()`` /
``.release()`` calls), and audits three properties:

(a) **lock-order cycles** — the acquired-while-held relation over all
    locks must be acyclic; a cycle is a potential deadlock between the
    serve loop, reader threads, and the watchdog monitor.
(b) **no blocking operation while a serve-plane/obs lock is held** —
    socket accept/recv/connect, board I/O (``post``/``claim``/
    ``get``/``keys``/``delete`` on a board, ``board_read_json``), file
    I/O (``open``, ``os.replace``/``fsync``/``link``/...), subprocess
    spawns, ``time.sleep``, and ``ServeClock.block_until`` are all
    unbounded (or bounded only by an external timeout) — reachable
    through ANY call chain from inside a held-lock region of a module
    classified serve-plane (or living under ``obs/``) they stall every
    thread contending that lock.  The one legal waiter is
    ``block_until(cond, ...)`` where ``cond`` IS the held lock: that is
    the ``Condition.wait_for`` contract (the lock is *released* while
    waiting), the exact seam SEQ007 routes every serve wait through.
    Bounded stream writes (``.write``/``.flush`` under ``SO_SNDTIMEO``,
    serialising one responder's output) are deliberately NOT in the op
    set: serialising those writes is what the responder lock is *for*.
(c) **no cross-class acquire/release splits** — a lock explicitly
    ``.acquire()``-d in one class and ``.release()``-d in another is a
    protocol smell the ``with`` statement exists to prevent.

The call graph is resolved conservatively: ``self.m()`` to the
enclosing class, ``self.attr.m()`` through ``self.attr = Class(...)``
assignments, bare and module-qualified names through the import table.
The event bus is the one piece of dynamic dispatch the walker must know
about: ``obs.events.publish``/``log_line`` fan out *synchronously* to
every subscriber, so a ``publish()`` under a lock nests every
subscriber's recorder lock beneath it — the walker adds a static edge
from ``publish`` to every ``record_event`` method in the package.

Findings are emitted as a ``kind="concurrency-audit"`` run-report body
(``scripts/torch_concurrency_audit.py`` diffs the stable view against
the committed golden ``tests/golden/torch_concurrency_audit.json``).
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path

from . import LockGraphError
from .seqlint import ROLE_SERVE, _GUARD_TYPES, module_roles

#: Attribute calls that block on a socket regardless of receiver name.
_SOCKET_ATTRS = {"accept", "recv", "recvfrom", "connect", "sendall", "listen"}
#: ``.send`` blocks too, but the name is generic (Responder.send is a
#: host-side method); only flag it on receivers that are plainly sockets.
_SOCKETISH_NAMES = ("sock", "conn")
#: Board verbs: on a FileBoard every one is file I/O (fsync + rename).
_BOARD_ATTRS = {"post", "claim", "delete", "get", "keys"}
_OS_FILE_ATTRS = {
    "replace", "fsync", "link", "unlink", "makedirs", "rename",
    "remove", "rmdir", "listdir", "walk",
}

#: Constructor-parameter wiring the AST cannot see: attributes assigned
#: from an ``__init__`` parameter, typed here by the package's one real
#: composition (serve/loop.py run_serve wires the AdmissionController
#: into the RequestQueue).  Like the bus fan-out below, this encodes the
#: repo's wiring CONTRACT — the queue->controller lock nesting it
#: creates is deliberate and pinned in the committed golden.
_ATTR_TYPE_HINTS: dict[tuple[str, str, str], str] = {
    ("serve/queue.py", "RequestQueue", "_controller"): "AdmissionController",
}


#: Modules whose locks are in scope for rule (b): serve-plane classified
#: modules plus everything under obs/ (the recorders the bus fans into).
def _lock_in_blocking_scope(rel: str) -> bool:
    roles = module_roles("pkg/" + rel) or ()
    return ROLE_SERVE in roles or rel.startswith("obs/")


@dataclasses.dataclass(frozen=True)
class BlockingOp:
    """One lexical blocking operation inside some function."""

    kind: str  # socket / board / file / subprocess / sleep / block_until
    detail: str
    module: str
    func: str  # qualname
    line: int
    waits_on: str | None = None  # lock id block_until waits on, if known
    held: tuple = ()  # lock ids lexically held around the op

    def site(self) -> str:
        return f"{self.module}:{self.line}"


@dataclasses.dataclass
class _FuncInfo:
    """Everything the audit needs about one function/method."""

    module: str
    qualname: str
    # (callee descriptor, held-lock tuple, line)
    calls: list = dataclasses.field(default_factory=list)
    # Lock ids acquired anywhere in this function (with-statements).
    acquires: list = dataclasses.field(default_factory=list)
    # Direct nesting: (outer lock id, inner lock id, line).
    nested: list = dataclasses.field(default_factory=list)
    blocking: list = dataclasses.field(default_factory=list)
    # Explicit .acquire()/.release() calls: (lock id, verb, line).
    explicit: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _ClassInfo:
    module: str
    name: str
    guards: set = dataclasses.field(default_factory=set)
    # attr name -> class name string it was constructed from.
    attr_types: dict = dataclasses.field(default_factory=dict)
    methods: set = dataclasses.field(default_factory=set)


class _ModuleIndex:
    """Per-module symbol tables: imports, classes, functions."""

    def __init__(self, rel: str):
        self.rel = rel
        # imported symbol name -> (module rel path or None, symbol)
        self.from_imports: dict[str, tuple[str | None, str]] = {}
        # module alias -> module rel path (intra-package only)
        self.mod_imports: dict[str, str] = {}
        self.classes: dict[str, _ClassInfo] = {}
        self.functions: set[str] = set()  # module-level function names


def _resolve_relative(rel: str, level: int, module: str | None) -> str | None:
    """Map a ``from ..obs.events import x`` to an inner module path like
    ``obs/events.py`` (None when it escapes the package)."""
    base = Path(rel).parent.parts
    hops = level - 1
    if hops > len(base):
        return None
    kept = base[: len(base) - hops] if hops else base
    tail = tuple(module.split(".")) if module else ()
    return "/".join(kept + tail) + ".py" if (kept or tail) else None


def _index_module(rel: str, tree: ast.Module) -> _ModuleIndex:
    idx = _ModuleIndex(rel)
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level > 0:
            target = _resolve_relative(rel, node.level, node.module)
            if target is None:
                continue
            for alias in node.names:
                name = alias.asname or alias.name
                idx.from_imports[name] = (target, alias.name)
                # The imported name may itself be a MODULE of the named
                # package (`from . import clock`): keep the would-be
                # module path so `clock.f()` calls resolve.  Bogus
                # entries for plain symbols are harmless — nothing
                # attribute-calls through a function name.
                idx.mod_imports.setdefault(
                    name, target[:-3] + "/" + alias.name + ".py"
                )
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            info = _ClassInfo(rel, node.name)
            for sub in ast.walk(node):
                if isinstance(sub, ast.Assign) and isinstance(
                    sub.value, ast.Call
                ):
                    func = sub.value.func
                    ctor = None
                    if isinstance(func, ast.Name):
                        ctor = func.id
                    elif isinstance(func, ast.Attribute):
                        ctor = func.attr
                    is_guard = ctor in _GUARD_TYPES and (
                        isinstance(func, ast.Name)
                        or (
                            isinstance(func, ast.Attribute)
                            and isinstance(func.value, ast.Name)
                            and func.value.id == "threading"
                        )
                    )
                    for tgt in sub.targets:
                        if (
                            isinstance(tgt, ast.Attribute)
                            and isinstance(tgt.value, ast.Name)
                            and tgt.value.id == "self"
                        ):
                            if is_guard:
                                info.guards.add(tgt.attr)
                            elif ctor is not None and ctor[:1].isupper():
                                info.attr_types[tgt.attr] = ctor
            for stmt in node.body:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    info.methods.add(stmt.name)
            idx.classes[node.name] = info
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            idx.functions.add(node.name)
    return idx


def _root_name(node: ast.AST) -> str | None:
    """The leftmost Name of an attribute/subscript chain."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


class _FuncWalker:
    """Walk one function body lexically, tracking the held-lock stack;
    nested defs are collected and walked as their own functions (their
    bodies run later, under whatever locks their caller holds)."""

    def __init__(self, index: _ModuleIndex, cls: _ClassInfo | None,
                 qualname: str, outer_guards: dict[str, str]):
        self.index = index
        self.cls = cls
        self.info = _FuncInfo(index.rel, qualname)
        # local variable name -> lock id (threading guard constructions,
        # including those inherited from the enclosing function).
        self.local_guards = dict(outer_guards)
        self.nested_defs: list = []

    # -- lock identity -----------------------------------------------------

    def _lock_id_of(self, expr: ast.AST) -> str | None:
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
            and self.cls is not None
            and expr.attr in self.cls.guards
        ):
            return f"{self.index.rel}:{self.cls.name}.{expr.attr}"
        if isinstance(expr, ast.Name) and expr.id in self.local_guards:
            return self.local_guards[expr.id]
        # `self.<attr>.<guard>` — another object's lock, reached through
        # a constructor-typed attribute (rule c's cross-class shape).
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Attribute)
            and isinstance(expr.value.value, ast.Name)
            and expr.value.value.id == "self"
            and self.cls is not None
        ):
            owner = self.cls.attr_types.get(expr.value.attr)
            target = self.index.classes.get(owner) if owner else None
            if target is not None and expr.attr in target.guards:
                return f"{self.index.rel}:{target.name}.{expr.attr}"
        return None

    # -- the walk ----------------------------------------------------------

    def walk(self, body: list, held: tuple = ()) -> None:
        for stmt in body:
            self._stmt(stmt, held)

    def _stmt(self, node: ast.AST, held: tuple) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self.nested_defs.append(node)
            return
        if isinstance(node, ast.Lambda):
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            inner = held
            for item in node.items:
                self._expr(item.context_expr, held)
                lock = self._lock_id_of(item.context_expr)
                if lock is not None:
                    if lock not in self.info.acquires:
                        self.info.acquires.append(lock)
                    for outer in inner:
                        if outer != lock:
                            self.info.nested.append(
                                (outer, lock, node.lineno)
                            )
                    if lock not in inner:
                        inner = inner + (lock,)
            self.walk(node.body, inner)
            return
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            func = node.value.func
            ctor = None
            if isinstance(func, ast.Name):
                ctor = func.id
            elif isinstance(func, ast.Attribute) and isinstance(
                func.value, ast.Name
            ) and func.value.id == "threading":
                ctor = func.attr
            if ctor in _GUARD_TYPES:
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        self.local_guards[tgt.id] = (
                            f"{self.index.rel}:"
                            f"{self.info.qualname}.{tgt.id}"
                        )
        for child in ast.iter_child_nodes(node):
            self._stmt(child, held) if isinstance(
                child, ast.stmt
            ) else self._expr(child, held)

    def _expr(self, node: ast.AST, held: tuple) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self.nested_defs.append(node)
            return
        if isinstance(node, ast.Lambda):
            return
        if isinstance(node, ast.Call):
            self._call(node, held)
        for child in ast.iter_child_nodes(node):
            self._expr(child, held)

    # -- calls: resolution descriptors + blocking classification -----------

    def _call(self, node: ast.Call, held: tuple) -> None:
        func = node.func
        line = node.lineno
        desc = None
        if isinstance(func, ast.Name):
            desc = ("name", func.id)
            if func.id == "open":
                self._block("file", "open()", line, held)
            elif func.id == "board_read_json":
                self._block("board", "board_read_json()", line, held)
            elif func.id == "Popen":
                self._block("subprocess", "Popen()", line, held)
            elif func.id == "sleep":
                self._block("sleep", "sleep()", line, held)
        elif isinstance(func, ast.Attribute):
            base = func.value
            attr = func.attr
            root = _root_name(base)
            if isinstance(base, ast.Name) and base.id == "self":
                desc = ("self", attr)
            elif (
                isinstance(base, ast.Attribute)
                and isinstance(base.value, ast.Name)
                and base.value.id == "self"
            ):
                desc = ("selfattr", base.attr, attr)
            elif isinstance(base, ast.Name):
                desc = ("mod", base.id, attr)
            # blocking classification is receiver-based, resolution-free:
            if attr == "block_until":
                waits = (
                    self._lock_id_of(node.args[0]) if node.args else None
                )
                self.info.blocking.append(BlockingOp(
                    "block_until", "block_until(...)",
                    self.index.rel, self.info.qualname, line, waits, held,
                ))
            elif attr in _SOCKET_ATTRS:
                self._block("socket", f".{attr}()", line, held)
            elif attr == "send" and root is not None and any(
                s in root.lower() for s in _SOCKETISH_NAMES
            ):
                self._block("socket", f"{root}.send()", line, held)
            elif attr in _BOARD_ATTRS and root is not None and (
                "board" in root.lower()
                or (
                    isinstance(base, ast.Attribute)
                    and "board" in base.attr.lower()
                )
            ):
                self._block("board", f"{root}...{attr}()", line, held)
            elif root == "os" and attr in _OS_FILE_ATTRS:
                self._block("file", f"os.{attr}()", line, held)
            elif root in ("subprocess", "shutil"):
                self._block(
                    "subprocess" if root == "subprocess" else "file",
                    f"{root}.{attr}()", line, held,
                )
            elif root == "time" and attr == "sleep":
                self._block("sleep", "time.sleep()", line, held)
            # explicit acquire/release bookkeeping (rule c):
            if attr in ("acquire", "release"):
                lock = self._lock_id_of(base)
                if lock is not None:
                    self.info.explicit.append((lock, attr, line))
        if desc is not None:
            self.info.calls.append((desc, held, line))
        for arg in node.args:
            self._expr(arg, held)
        for kw in node.keywords:
            self._expr(kw.value, held)

    def _block(self, kind: str, detail: str, line: int, held: tuple) -> None:
        self.info.blocking.append(BlockingOp(
            kind, detail, self.index.rel, self.info.qualname, line,
            None, held,
        ))


def _walk_function(index: _ModuleIndex, cls, qualname: str, node,
                   outer_guards: dict, out: dict) -> None:
    walker = _FuncWalker(index, cls, qualname, outer_guards)
    walker.walk(node.body)
    out[(index.rel, qualname)] = walker.info
    for nested in walker.nested_defs:
        _walk_function(
            index, cls, f"{qualname}.{nested.name}", nested,
            walker.local_guards, out,
        )


# -- package walk ----------------------------------------------------------


def _package_files(package_root: Path):
    for path in sorted(package_root.rglob("*.py")):
        if "__pycache__" in path.parts:
            continue
        yield path, str(path.relative_to(package_root))


def build_graph(package_root: str | Path | None = None):
    """Parse the package: (func table, module indexes, class table)."""
    if package_root is None:
        package_root = Path(__file__).resolve().parent.parent
    package_root = Path(package_root)
    funcs: dict[tuple[str, str], _FuncInfo] = {}
    indexes: dict[str, _ModuleIndex] = {}
    classes: dict[str, tuple[str, _ClassInfo]] = {}
    for path, rel in _package_files(package_root):
        try:
            tree = ast.parse(path.read_text(), filename=str(path))
        except SyntaxError:
            continue  # seqlint owns syntax errors
        index = _index_module(rel, tree)
        indexes[rel] = index
        for (mod, cls, attr), tname in _ATTR_TYPE_HINTS.items():
            if mod == rel and cls in index.classes:
                index.classes[cls].attr_types.setdefault(attr, tname)
        for cname, cinfo in index.classes.items():
            # Last definition wins on (unexpected) cross-module clashes;
            # resolution prefers the same module first anyway.
            classes[cname] = (rel, cinfo)
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                _walk_function(index, None, node.name, node, {}, funcs)
            elif isinstance(node, ast.ClassDef):
                cinfo = index.classes[node.name]
                for stmt in node.body:
                    if isinstance(
                        stmt, (ast.FunctionDef, ast.AsyncFunctionDef)
                    ):
                        _walk_function(
                            index, cinfo,
                            f"{node.name}.{stmt.name}", stmt, {}, funcs,
                        )
    return funcs, indexes, classes


def _resolve_call(desc, module: str, qualname: str, indexes, classes, funcs):
    """Resolve one call descriptor to a func-table key, or None."""
    index = indexes[module]
    kind = desc[0]
    if kind == "self":
        cls = qualname.split(".", 1)[0]
        key = (module, f"{cls}.{desc[1]}")
        return key if key in funcs else None
    if kind == "selfattr":
        cls = qualname.split(".", 1)[0]
        cinfo = index.classes.get(cls)
        if cinfo is None:
            return None
        tname = cinfo.attr_types.get(desc[1])
        if tname is None:
            return None
        target = index.classes.get(tname)
        home = module if target is not None else None
        if target is None and tname in classes:
            home, target = classes[tname]
        if target is None:
            return None
        key = (home, f"{tname}.{desc[2]}")
        return key if key in funcs else None
    if kind == "name":
        name = desc[1]
        if (module, name) in funcs:
            return (module, name)
        imp = index.from_imports.get(name)
        if imp is not None and imp[0] is not None:
            src, sym = imp
            if (src, sym) in funcs:
                return (src, sym)
            if (src, f"{sym}.__init__") in funcs:
                return (src, f"{sym}.__init__")
        if name in index.classes and (
            (module, f"{name}.__init__") in funcs
        ):
            return (module, f"{name}.__init__")
        return None
    if kind == "mod":
        mod = index.mod_imports.get(desc[1])
        if mod is not None and (mod, desc[2]) in funcs:
            return (mod, desc[2])
        return None
    return None


class LockGraph:
    """The resolved audit state: adjacency, lock set, findings."""

    def __init__(self, package_root: str | Path | None = None):
        self.funcs, self.indexes, self.classes = build_graph(package_root)
        # Resolved adjacency: func key -> [(callee key, held, line)].
        self.calls: dict = {}
        for key, info in self.funcs.items():
            resolved = []
            for desc, held, line in info.calls:
                callee = _resolve_call(
                    desc, info.module, info.qualname,
                    self.indexes, self.classes, self.funcs,
                )
                if callee is not None:
                    resolved.append((callee, held, line))
            self.calls[key] = resolved
        # The event bus fan-out: publish/log_line synchronously invoke
        # every subscriber's record_event (obs/events.py) — static edges.
        subscribers = sorted(
            k for k in self.funcs if k[1].endswith(".record_event")
        )
        for bus in (("obs/events.py", "publish"), ("obs/events.py", "log_line")):
            if bus in self.funcs:
                self.calls.setdefault(bus, [])
                for sub in subscribers:
                    self.calls[bus].append((sub, (), 0))
        self._reach_cache: dict = {}

    # -- reachability ------------------------------------------------------

    def _reachable(self, start) -> dict:
        """Func keys reachable from ``start`` (inclusive) -> call path."""
        cached = self._reach_cache.get(start)
        if cached is not None:
            return cached
        paths = {start: (start,)}
        frontier = [start]
        while frontier:
            cur = frontier.pop()
            for callee, _held, _line in self.calls.get(cur, ()):
                if callee not in paths:
                    paths[callee] = paths[cur] + (callee,)
                    frontier.append(callee)
        self._reach_cache[start] = paths
        return paths

    # -- the audit ---------------------------------------------------------

    def audit(self) -> dict:
        locks: set[str] = set()
        for info in self.funcs.values():
            locks.update(info.acquires)
        edges: dict[tuple[str, str], str] = {}
        findings: list[dict] = []

        for key, info in self.funcs.items():
            for outer, inner, line in info.nested:
                edges.setdefault(
                    (outer, inner),
                    f"{info.module}:{info.qualname}:{line}",
                )
            # Transitive: every call made while a lock is held pulls in
            # the callee's whole reachable set.
            for callee, held, line in self.calls.get(key, ()):
                if not held:
                    continue
                paths = self._reachable(callee)
                for target, path in paths.items():
                    tinfo = self.funcs[target]
                    via = " -> ".join(
                        [f"{info.qualname}:{line}"]
                        + [self.funcs[p].qualname for p in path]
                    )
                    for lock in tinfo.acquires:
                        for outer in held:
                            if outer != lock:
                                edges.setdefault((outer, lock), via)
                    for op in tinfo.blocking:
                        for outer in held:
                            self._check_blocking(
                                outer, op, via, findings
                            )
            # Lexical blocking ops under a lock held in this very body.
            for op in info.blocking:
                for outer in op.held:
                    self._check_blocking(
                        outer, op,
                        f"{info.qualname}:{op.line}", findings,
                    )
        findings.extend(self._cycles(edges))
        findings.extend(self._split_acquire_release())

        dedup: dict[tuple, dict] = {}
        for f in findings:
            dedup.setdefault((f["kind"], f["lock"], f["site"]), f)
        ordered = sorted(
            dedup.values(),
            key=lambda f: (f["kind"], f["lock"], f["site"]),
        )
        return {
            "files": len(self.indexes),
            "functions": len(self.funcs),
            "locks": sorted(locks),
            "edges": [
                {"src": a, "dst": b, "via": via}
                for (a, b), via in sorted(edges.items())
            ],
            "findings": ordered,
            "counts": {
                "locks": len(locks),
                "edges": len(edges),
                "findings": len(ordered),
            },
        }

    def _check_blocking(self, outer: str, op: BlockingOp, via: str,
                        findings: list) -> None:
        if not _lock_in_blocking_scope(outer.split(":", 1)[0]):
            return
        if op.kind == "block_until" and op.waits_on == outer:
            return  # the legal Condition.wait_for idiom
        findings.append({
            "kind": "blocking-while-locked",
            "lock": outer,
            "site": f"{op.module}:{op.line}",
            "detail": (
                f"{op.kind} op {op.detail} in {op.func} reachable while "
                f"{outer} is held (via {via})"
            ),
        })

    def _cycles(self, edges: dict) -> list:
        adj: dict[str, list[str]] = {}
        for (a, b) in edges:
            adj.setdefault(a, []).append(b)
        findings = []
        state: dict[str, int] = {}  # 1 = on stack, 2 = done

        def visit(node: str, stack: list[str]):
            state[node] = 1
            stack.append(node)
            for nxt in sorted(adj.get(node, ())):
                if state.get(nxt) == 1:
                    cycle = stack[stack.index(nxt):] + [nxt]
                    findings.append({
                        "kind": "lock-order-cycle",
                        "lock": nxt,
                        "site": " -> ".join(cycle),
                        "detail": (
                            "lock-ordering cycle (potential deadlock): "
                            + " -> ".join(cycle)
                        ),
                    })
                elif state.get(nxt) is None:
                    visit(nxt, stack)
            stack.pop()
            state[node] = 2

        for node in sorted(adj):
            if state.get(node) is None:
                visit(node, [])
        return findings

    def _split_acquire_release(self) -> list:
        acquirers: dict[str, set] = {}
        releasers: dict[str, set] = {}
        sites: dict[str, str] = {}
        for key, info in self.funcs.items():
            owner = info.qualname.split(".", 1)[0]
            for lock, verb, line in info.explicit:
                table = acquirers if verb == "acquire" else releasers
                table.setdefault(lock, set()).add(owner)
                sites.setdefault(lock, f"{info.module}:{line}")
        findings = []
        for lock in sorted(set(acquirers) | set(releasers)):
            a = acquirers.get(lock, set())
            r = releasers.get(lock, set())
            if a and r and a != r:
                findings.append({
                    "kind": "split-acquire-release",
                    "lock": lock,
                    "site": sites[lock],
                    "detail": (
                        f"acquired by {sorted(a)} but released by "
                        f"{sorted(r)}: lock ownership must not cross "
                        "class boundaries — use `with`"
                    ),
                })
        return findings


def audit_lock_graph(package_root: str | Path | None = None) -> dict:
    """The full audit report body (never raises on findings)."""
    return LockGraph(package_root).audit()


def run_or_raise(package_root: str | Path | None = None) -> dict:
    """Driver entry: audit, raise :class:`LockGraphError` on findings,
    return the report body when clean."""
    report = audit_lock_graph(package_root)
    if report["findings"]:
        rows = "\n  ".join(
            f"[{f['kind']}] {f['lock']} at {f['site']}: {f['detail']}"
            for f in report["findings"]
        )
        raise LockGraphError(
            f"lockgraph: {len(report['findings'])} finding(s):\n  {rows}\n"
            "Fix the ordering/blocking site (hoist the call out of the "
            "locked region, or route the wait through the held "
            "condition's block_until)."
        )
    return report
