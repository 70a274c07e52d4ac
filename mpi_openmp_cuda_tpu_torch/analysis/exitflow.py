"""Failure-path certifier: whole-program exception-flow analysis (the
port of ``mpi_openmp_cuda_tpu/analysis/exitflow.py`` with the port's
sinks: its ``RetryPolicy``, reached through any ``*policy.run`` receiver;
the typed serve wire-error replies; the sysexits map of ``io/cli.py``;
reasoned ``# advisory:`` swallows; and the finally-first flush, which the
port's ``run()`` makes through ``_flush_obs``).

The robustness story is spread over four PRs — the retry taxonomy
(``resilience/policy.py``: ``FATAL_ERROR_TYPES`` propagate, everything
else retries), the sysexits contract (``io/cli.py``: 64 usage / 65
fatal / 75 resumable), the finally-first flush (every exit path leaves
the run report behind), and the typed serve wire errors
(``{"id","error"}`` replies) — but until this pass it was enforced
only by *sampled* chaos runs.  This module makes it a static theorem
over the package AST, the eighth analysis tier:

1. **Propagation graph.**  Every ``raise`` site, every
   ``try/except/finally``, and the intra-package call graph (reusing
   :mod:`.lockgraph`'s module index and call resolution; lambdas and
   nested defs are walked as their own nodes with closure-aware
   higher-order edges, the :mod:`.dataflow` trick, because the retry
   plane invokes them under *its* handlers, not their definer's).
2. **Sink proof.**  Each production-reachable raise site's exception
   is walked up the graph — through matching handlers, re-raises and
   ``raise X from e`` chains — until it terminates in a legal sink:
   the RetryPolicy ladder (``retry-policy``), a serve wire-error reply
   or quarantine route (``wire-reply``), the CLI sysexits map
   (``exit-map``), a reasoned ``# advisory:`` swallow marker
   (``advisory``), or a typed narrow handler (``handled``).  A path
   that escapes the root without a classifier is an
   ``unclassified-raise`` finding; a broad handler that swallows
   without a marker is ``swallow-unmarked``; a handler arm shadowed by
   an earlier broader arm is ``double-classified``.
3. **Flush contract.**  In ``io/cli.py`` and ``serve/loop.py``, every
   exit statement of the driver function must sit inside the try whose
   ``finally`` performs the terminal metrics/trace flush (pre-arm
   usage returns excepted), or it is a ``flush-bypass`` finding; and
   exit 75 (``EX_TEMPFAIL``) must be reachable only from a
   ``DrainInterrupt`` handler or an ``_is_resumable``-style
   cause-chain predicate rooted in deadline/drain types
   (``tempfail-unrooted`` otherwise).
4. **Fault registry cross-check.**  Every site name in
   ``resilience/faults.py`` (including the ``hang:``/``kill:``
   survival aliases) must still name a fire point the production graph
   reaches — a renamed site can never silently make the chaos runs
   vacuous (``fault-site-unreachable``).

``run_or_raise`` raises :class:`.ExitFlowError` on any finding;
``scripts/torch_exitpath_audit.py`` diffs the report against the
committed golden ``tests/golden/torch_exitpath_audit.json``.
"""

from __future__ import annotations

import ast
import builtins
import dataclasses
import re
from pathlib import Path

from . import ExitFlowError
from .lockgraph import _index_module, _package_files, _resolve_call

# -- taxonomy --------------------------------------------------------------

#: Legal sink kinds, most specific classifier first: a site whose paths
#: reach several sinks reports the highest-priority one as primary.
SINK_PRIORITY = (
    "retry-policy",
    "wire-reply",
    "exit-map",
    "advisory",
    "handled",
    "swallow",
    "import-time",
    "out-of-plane",
)

#: The reasoned-swallow marker: ``# advisory: <why this may be dropped>``.
#: A bare marker (no reason text) does not count (seqlint SEQ014 flags it).
_ADVISORY_RE = re.compile(r"#\s*advisory:\s*(.*\S)?")

#: Names whose presence in a cli handler body marks the sysexits map.
_EXIT_NAMES = {"EX_OK", "EX_ARGPARSE", "EX_USAGE", "EX_FATAL", "EX_TEMPFAIL"}
_EXIT_CODES = {0, 1, 2, 64, 65, 75}

#: Calls whose presence in a serve-plane handler body marks the typed
#: wire-error reply / quarantine route.
_WIRE_CALLS = {"_block_failed", "_bisect", "_score_block_sync", "fail", "send"}

#: Calls that constitute the finally-first flush (cli and serve teardown;
#: the port's ``run()`` flushes the report and the trace in ``_flush_obs``).
_FLUSH_CALLS = {"flush_run_report", "flush_trace", "record_steady_gauge", "_flush_obs"}

#: Exception types that legally root an exit-75 (resumable) mapping.
_RESUMABLE_ROOTS = {"DeadlineExpiredError", "DrainInterrupt"}

#: Exit-code constant names legal on a pre-arm (pre-flush-try) return
#: (the port's CLI returns argparse's own 2 as ``EX_ARGPARSE``).
_PREARM_OK = {"EX_USAGE", "EX_OK", "EX_ARGPARSE"}
_PREARM_CODES = {0, 2, 64}

#: Fault-registry fire/probe call names (module function + bound aliases).
_FAULT_CALLS = {"fire", "scheduled", "_fault_fire", "_fault_scheduled", "_fault"}

#: Attribute names too generic for the last-segment call fallback (they
#: resolve to builtin container/file verbs far more often than package
#: functions; resolving them would drown the graph in bogus edges).
_GENERIC_ATTRS = {
    "append", "add", "get", "pop", "items", "keys", "values", "update",
    "join", "read", "write", "strip", "split", "encode", "decode",
    "sort", "copy", "extend", "format", "count", "index", "close",
}

#: Cap on last-segment fallback candidates: an attr name matching more
#: package functions than this is treated as unresolvable.
_FALLBACK_CAP = 6

# -- data model ------------------------------------------------------------


@dataclasses.dataclass
class Handler:
    """One ``except`` arm with its statically-derived classification."""

    types: tuple  # declared type names after alias expansion; () = bare
    broad: bool  # bare / Exception / BaseException
    line: int
    end: int
    kind: str  # sink kind, "reraise", or "raise-new"
    new_type: str | None = None  # for raise-new
    logs: bool = False
    marker: str | None = None  # advisory reason text (None = no marker)
    binds: str | None = None  # `except X as name` binding


@dataclasses.dataclass
class _TryCtx:
    """One enclosing try whose handlers guard the current position."""

    handlers: list


@dataclasses.dataclass
class RaiseSite:
    exc: str  # type name or "<dynamic>"
    line: int
    ctx: tuple  # innermost-first _TryCtx stack at the raise


@dataclasses.dataclass
class _Func:
    module: str
    qualname: str
    params: frozenset
    parent: tuple | None = None  # definer key for nested defs / lambdas
    def_ctx: tuple = ()  # definer's try stack at the definition site
    raises: list = dataclasses.field(default_factory=list)
    calls: list = dataclasses.field(default_factory=list)  # (desc, line, ctx)
    #: function references passed/registered: (target, receiver, line, ctx)
    #: where target is a func key or a call descriptor and receiver is the
    #: descriptor of the call the reference rides in (None = bare ref).
    refs: list = dataclasses.field(default_factory=list)
    #: calls to closure parameters: (line, ctx) — the higher-order
    #: invocation points (``fn()`` inside RetryPolicy.run).
    param_calls: list = dataclasses.field(default_factory=list)
    tries: list = dataclasses.field(default_factory=list)  # list[list[Handler]]
    returns: list = dataclasses.field(default_factory=list)  # (line, kind)
    hard_exits: list = dataclasses.field(default_factory=list)  # (line, name)
    node: object = None

    def key(self):
        return (self.module, self.qualname)


# -- per-function AST walk -------------------------------------------------


def _type_names(node, aliases):
    """Declared handler type(s) as a flat name tuple (alias-expanded)."""
    if node is None:
        return ()
    items = node.elts if isinstance(node, ast.Tuple) else [node]
    names = []
    for item in items:
        if isinstance(item, ast.Attribute):
            names.append(item.attr)
        elif isinstance(item, ast.Name):
            names.extend(aliases.get(item.id, (item.id,)))
    return tuple(names)


def _walk_no_defs(node):
    """ast.walk that does not descend into nested defs/lambdas."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        sub = stack.pop()
        yield sub
        if not isinstance(
            sub, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ):
            stack.extend(ast.iter_child_nodes(sub))


def _body_walk(body_nodes):
    """Every node in a handler body, including the statements themselves,
    without descending into nested defs/lambdas."""
    for stmt in body_nodes:
        yield stmt
        yield from _walk_no_defs(stmt)


def _call_names(body_nodes):
    """All called names (Name id or Attribute attr) in handler bodies."""
    out = set()
    for stmt in body_nodes:
        for sub in _body_walk([stmt]):
            if isinstance(sub, ast.Call):
                if isinstance(sub.func, ast.Name):
                    out.add(sub.func.id)
                elif isinstance(sub.func, ast.Attribute):
                    out.add(sub.func.attr)
    return out


def _raise_type(node: ast.Raise, binds: dict, classmap) -> str:
    """The (static) exception type a raise statement throws."""
    exc = node.exc
    if isinstance(exc, ast.Call):
        if isinstance(exc.func, ast.Name):
            name = exc.func.id
        elif isinstance(exc.func, ast.Attribute):
            name = exc.func.attr
        else:
            return "<dynamic>"
        if name == "ArgumentTypeError":
            # argparse catches this inside parse_args and performs the
            # usage exit itself: a legal exit-map sink by construction.
            return name
        if name in classmap or isinstance(getattr(builtins, name, None), type):
            return name
        return "<dynamic>"
    if isinstance(exc, ast.Name):
        bound = binds.get(exc.id)
        if bound:
            return bound
        if exc.id in classmap or isinstance(
            getattr(builtins, exc.id, None), type
        ):
            return exc.id
        return "<dynamic>"
    if isinstance(exc, ast.Attribute):
        return exc.attr if exc.attr[:1].isupper() else "<dynamic>"
    return "<dynamic>"


def _in_serve_plane(module: str) -> bool:
    return module.startswith("serve/") or "/serve/" in module


def _classify_handler(h, types, module, qualname, lines, classmap):
    """Map one except arm to its propagation behaviour / sink kind."""
    broad = (not types) or bool(set(types) & {"Exception", "BaseException"})
    end = h.body[-1].end_lineno if h.body else h.lineno
    marker = None
    for ln in lines[h.lineno - 1: end]:
        m = _ADVISORY_RE.search(ln)
        if m:
            marker = (m.group(1) or "").strip() or None
            break
    logs = "log_line" in _call_names(h.body)
    bare_raise = False
    new_type = None
    for sub in _body_walk(h.body):
        if isinstance(sub, ast.Raise):
            if sub.exc is None:
                bare_raise = True
            elif new_type is None:
                new_type = _raise_type(sub, {}, classmap)
    # Classifier recognizers come first: the RetryPolicy ladder's fatal
    # arm re-raises, but *reaching the ladder* is the classification.
    if module.endswith("resilience/policy.py") and qualname.startswith(
        "RetryPolicy."
    ):
        kind = "retry-policy"
    elif _in_serve_plane(module) and (_call_names(h.body) & _WIRE_CALLS):
        kind = "wire-reply"
    elif module.endswith("io/cli.py") and _is_exit_map(h):
        kind = "exit-map"
    elif bare_raise:
        kind = "reraise"
    elif new_type is not None:
        kind = "raise-new"
    elif marker is not None:
        kind = "advisory"
    elif not broad:
        kind = "handled"
    else:
        kind = "swallow"
    return Handler(
        types=types,
        broad=broad,
        line=h.lineno,
        end=end,
        kind=kind,
        new_type=new_type,
        logs=logs,
        marker=marker,
        binds=h.name,
    )


def _is_exit_map(h: ast.ExceptHandler) -> bool:
    for sub in _body_walk(h.body):
        if isinstance(sub, ast.Name) and sub.id in _EXIT_NAMES:
            return True
        if (
            isinstance(sub, ast.Return)
            and isinstance(sub.value, ast.Constant)
            and not isinstance(sub.value.value, bool)
            and sub.value.value in _EXIT_CODES
        ):
            return True
    return False


def _arg_names(args: ast.arguments) -> set:
    params = {a.arg for a in args.posonlyargs + args.args + args.kwonlyargs}
    if args.vararg:
        params.add(args.vararg.arg)
    if args.kwarg:
        params.add(args.kwarg.arg)
    return params


class _FnWalker:
    """Walk one function body tracking the enclosing-try stack; nested
    defs and lambdas become their own _Func nodes (they run under
    whatever handlers their *caller* installs — never the definer's)."""

    def __init__(self, module, qualname, params, outer_params, lines,
                 aliases, classmap, out):
        self.fn = _Func(module, qualname, frozenset(params) | outer_params)
        self.lines = lines
        self.aliases = aliases
        self.classmap = classmap
        self.out = out
        self.local_defs = {}  # nested def name -> func key
        self.binds = {}  # except-binding name -> type name
        out[self.fn.key()] = self.fn

    # -- statements --------------------------------------------------------

    def walk(self, body, ctx=()):
        for stmt in body:
            self._stmt(stmt, ctx)

    def _stmt(self, node, ctx):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            key = self._child(node.name, node.args, node.body, ctx)
            self.local_defs[node.name] = key
            return
        if isinstance(node, ast.ClassDef):
            return  # nested classes are out of the failure plane
        if isinstance(node, ast.Try):
            handlers = []
            for h in node.handlers:
                types = _type_names(h.type, self.aliases)
                handlers.append(
                    _classify_handler(
                        h, types, self.fn.module, self.fn.qualname,
                        self.lines, self.classmap,
                    )
                )
            self.fn.tries.append(handlers)
            tc = _TryCtx(handlers)
            self.walk(node.body, (tc,) + ctx)
            for h, hd in zip(node.handlers, handlers):
                if h.name and hd.types:
                    self.binds[h.name] = hd.types[0]
                # Handler bodies are guarded by OUTER tries only
                # (sibling arms never catch each other).
                self.walk(h.body, ctx)
                if h.name:
                    self.binds.pop(h.name, None)
            self.walk(node.orelse, ctx)  # else runs after the body succeeded
            self.walk(node.finalbody, ctx)
            return
        if isinstance(node, ast.Raise):
            if node.exc is not None:
                exc = _raise_type(node, self.binds, self.classmap)
                self.fn.raises.append(RaiseSite(exc, node.lineno, ctx))
            for sub in (node.exc, node.cause):
                if sub is not None:
                    self._expr(sub, ctx)
            return
        if isinstance(node, ast.Return):
            self.fn.returns.append((node.lineno, _return_kind(node.value)))
            if node.value is not None:
                self._expr(node.value, ctx)
            return
        for sub in ast.iter_child_nodes(node):
            if isinstance(sub, ast.expr):
                self._expr(sub, ctx)
            elif isinstance(sub, ast.stmt):
                self._stmt(sub, ctx)
            elif isinstance(sub, (ast.excepthandler, ast.withitem)):
                self._stmt_like(sub, ctx)

    def _stmt_like(self, node, ctx):
        for sub in ast.iter_child_nodes(node):
            if isinstance(sub, ast.expr):
                self._expr(sub, ctx)
            elif isinstance(sub, ast.stmt):
                self._stmt(sub, ctx)

    # -- expressions -------------------------------------------------------

    def _expr(self, node, ctx):
        if isinstance(node, ast.Lambda):
            self._child(f"<lambda>L{node.lineno}", node.args, node.body, ctx)
            return
        if isinstance(node, ast.Call):
            self._call(node, ctx)
            return
        for sub in ast.iter_child_nodes(node):
            if isinstance(sub, ast.expr):
                self._expr(sub, ctx)

    def _call(self, node: ast.Call, ctx):
        desc = _call_desc(node.func)
        if desc is not None:
            if desc[0] == "name" and desc[1] in self.fn.params:
                self.fn.param_calls.append((node.lineno, ctx))
            elif desc in (("mod", "sys", "exit"), ("mod", "os", "_exit")):
                self.fn.hard_exits.append((node.lineno, desc[2]))
            else:
                self.fn.calls.append((desc, node.lineno, ctx))
        if isinstance(node.func, ast.Attribute):
            self._expr(node.func.value, ctx)
        elif not isinstance(node.func, ast.Name):
            self._expr(node.func, ctx)
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            target = self._ref_target(arg, ctx)
            if target is not None:
                self.fn.refs.append((target, desc, node.lineno, ctx))
            else:
                self._expr(arg, ctx)

    def _ref_target(self, arg, ctx):
        """A function-valued argument (the higher-order edge source)."""
        if isinstance(arg, ast.Lambda):
            return self._child(
                f"<lambda>L{arg.lineno}", arg.args, arg.body, ctx
            )
        if isinstance(arg, ast.Name):
            if arg.id in self.local_defs:
                return self.local_defs[arg.id]
            if arg.id not in self.fn.params:
                # Maybe a module-level function passed by name; the
                # resolver decides (plain data names resolve to nothing).
                return ("name", arg.id)
            return None
        if (
            isinstance(arg, ast.Attribute)
            and isinstance(arg.value, ast.Name)
            and arg.value.id == "self"
        ):
            return ("self", arg.attr)
        return None

    def _child(self, name, args, body, ctx):
        w = _FnWalker(
            self.fn.module, f"{self.fn.qualname}.{name}", _arg_names(args),
            self.fn.params, self.lines, self.aliases, self.classmap,
            self.out,
        )
        w.fn.parent = self.fn.key()
        w.fn.def_ctx = ctx
        w.local_defs = dict(self.local_defs)
        if isinstance(body, list):
            w.walk(body)
        else:
            w._expr(body, ())
        return w.fn.key()


def _return_kind(value):
    if value is None:
        return ("none", None)
    if isinstance(value, ast.Name):
        return ("name", value.id)
    if isinstance(value, ast.Constant) and isinstance(value.value, int):
        return ("const", value.value)
    return ("expr", None)


def _call_desc(func):
    """Call descriptor compatible with lockgraph._resolve_call."""
    if isinstance(func, ast.Name):
        return ("name", func.id)
    if isinstance(func, ast.Attribute):
        base = func.value
        if isinstance(base, ast.Name) and base.id == "self":
            return ("self", func.attr)
        if (
            isinstance(base, ast.Attribute)
            and isinstance(base.value, ast.Name)
            and base.value.id == "self"
        ):
            return ("selfattr", base.attr, func.attr)
        if isinstance(base, ast.Name):
            return ("mod", base.id, func.attr)
        return ("varattr", "<expr>", func.attr)
    return None


def _tuple_aliases(tree: ast.Module) -> dict:
    """Module-level ``FATAL_ERROR_TYPES = (ValueError, TypeError)``-style
    exception-tuple constants, expanded at handler-type resolution."""
    out = {}
    for node in tree.body:
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and isinstance(node.value, ast.Tuple)
        ):
            names = [
                e.id for e in node.value.elts if isinstance(e, ast.Name)
            ]
            if names and all(n[:1].isupper() for n in names):
                out[node.targets[0].id] = tuple(names)
    return out


# -- package graph ---------------------------------------------------------


class _Graph:
    """Parsed package: func table, indexes, class hierarchy, edges."""

    def __init__(self, package_root: str | Path | None = None):
        if package_root is None:
            package_root = Path(__file__).resolve().parent.parent
        self.root = Path(package_root)
        self.funcs: dict = {}
        self.indexes: dict = {}
        self.classes: dict = {}  # class name -> (module, _ClassInfo)
        self.classmap: dict = {}  # class name -> tuple of base names
        self.module_raises: dict = {}  # rel -> import-time raise count
        self.sources: dict = {}  # rel -> source lines
        self.trees: dict = {}  # rel -> parsed module
        self.files = 0
        self._parse()
        self._index_edges()

    def _parse(self):
        for path, rel in _package_files(self.root):
            try:
                text = path.read_text()
                tree = ast.parse(text, filename=str(path))
            except (SyntaxError, OSError):
                continue  # seqlint owns syntax errors
            self.files += 1
            lines = text.splitlines()
            self.sources[rel] = lines
            self.trees[rel] = tree
            self.indexes[rel] = _index_module(rel, tree)
            aliases = _tuple_aliases(tree)
            for node in ast.walk(tree):
                if isinstance(node, ast.ClassDef):
                    self.classmap[node.name] = tuple(
                        b.attr if isinstance(b, ast.Attribute) else b.id
                        for b in node.bases
                        if isinstance(b, (ast.Name, ast.Attribute))
                    )
            for cname, cinfo in self.indexes[rel].classes.items():
                self.classes[cname] = (rel, cinfo)
            for node in tree.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self._walk_fn(rel, node.name, node, lines, aliases)
                elif isinstance(node, ast.ClassDef):
                    for stmt in node.body:
                        if isinstance(
                            stmt, (ast.FunctionDef, ast.AsyncFunctionDef)
                        ):
                            self._walk_fn(
                                rel, f"{node.name}.{stmt.name}", stmt,
                                lines, aliases,
                            )
                else:
                    # Import-time raises (module-body guards) are a
                    # legal fail-fast sink of their own.
                    n = sum(
                        1
                        for sub in _walk_no_defs(node)
                        if isinstance(sub, ast.Raise) and sub.exc is not None
                    )
                    if isinstance(node, ast.Raise) and node.exc is not None:
                        n += 1
                    if n:
                        self.module_raises[rel] = (
                            self.module_raises.get(rel, 0) + n
                        )

    def _walk_fn(self, rel, qualname, node, lines, aliases):
        w = _FnWalker(
            rel, qualname, _arg_names(node.args), frozenset(), lines,
            aliases, self.classmap, self.funcs,
        )
        w.fn.node = node
        w.walk(node.body)

    # -- resolution --------------------------------------------------------

    def resolve(self, desc, module, qualname):
        """Resolve a call/ref descriptor to candidate func keys."""
        if (
            isinstance(desc, tuple)
            and len(desc) == 2
            and desc in self.funcs
        ):
            return [desc]  # already a key (lambda / nested def)
        if desc[0] == "name":
            # Nested-def scoping: resolve through the enclosing chain.
            parts = qualname.split(".")
            for i in range(len(parts), 0, -1):
                key = (module, ".".join(parts[:i] + [desc[1]]))
                if key in self.funcs:
                    return [key]
        got = _resolve_call(
            desc, module, qualname, self.indexes, self.classes, self.funcs
        )
        if got is not None:
            return [got]
        # The retry ladder: ``policy.run`` / ``self.policy.run`` receivers
        # are the run's RetryPolicy (a name too common for the
        # last-segment fallback below).
        if desc[-1] == "run" and len(desc) >= 3 and str(desc[-2]).endswith("policy"):
            return list(self.retry_run)
        # Last-segment fallback for dynamic receivers (``dist.broadcast``,
        # ``loop.tick``): honest over-approximation, capped, with the
        # builtin container verbs excluded.
        attr = None
        if desc[0] in ("varattr", "mod"):
            attr = desc[2]
        elif desc[0] in ("self", "selfattr"):
            attr = desc[-1]
        if attr and attr not in _GENERIC_ATTRS and not attr.startswith("__"):
            cands = self._lastseg.get(attr, [])
            if 0 < len(cands) <= _FALLBACK_CAP:
                return list(cands)
        return []

    def _index_edges(self):
        self._lastseg = {}
        for key in self.funcs:
            seg = key[1].rsplit(".", 1)[-1]
            self._lastseg.setdefault(seg, []).append(key)
        #: callers[key] -> list of (caller key, line, ctx) frames.
        self.callers = {}
        #: forward adjacency for reachability.
        self.forward = {}
        self.retry_run = sorted(
            k
            for k in self.funcs
            if k[0].endswith("resilience/policy.py")
            and k[1].startswith("RetryPolicy.run")
        )
        for fn in self.funcs.values():
            fkey = fn.key()
            if fn.parent is not None:
                # Definition edge: production reach flows definer ->
                # closure, but adds no caller frame (invocation frames
                # come from the pass sites / receivers below).
                self.forward.setdefault(fn.parent, set()).add(fkey)
            for desc, line, ctx in fn.calls:
                for tkey in self.resolve(desc, fn.module, fn.qualname):
                    self.forward.setdefault(fkey, set()).add(tkey)
                    self.callers.setdefault(tkey, []).append(
                        (fkey, line, ctx)
                    )
            for target, receiver, line, ctx in fn.refs:
                for tkey in self.resolve(target, fn.module, fn.qualname):
                    self.forward.setdefault(fkey, set()).add(tkey)
                    self.callers.setdefault(tkey, []).extend(
                        self._invocation_frames(receiver, fn, line, ctx)
                    )

    def _invocation_frames(self, receiver, fn, line, ctx):
        """Where a passed function reference is actually invoked: the
        receiver's parameter-call sites when known (``fn()`` inside
        RetryPolicy.run), the retry ladder when the receiver forwards
        into it (run_degrading), else the pass site itself (the
        registration-point approximation for signal handlers and thread
        targets)."""
        if receiver is not None:
            cands = self.resolve(receiver, fn.module, fn.qualname)
            frames = []
            for ckey in cands:
                cfn = self.funcs[ckey]
                frames.extend(
                    (ckey, ln, cctx) for ln, cctx in cfn.param_calls
                )
            if frames:
                return frames
            names = {c[1].rsplit(".", 1)[-1] for c in cands}
            if "run_degrading" in names or receiver[-1] == "run_degrading":
                frames = [
                    (rkey, ln, cctx)
                    for rkey in self.retry_run
                    for ln, cctx in self.funcs[rkey].param_calls
                ]
                if frames:
                    return frames
        return [(fn.key(), line, ctx)]

    # -- reachability ------------------------------------------------------

    def roots(self):
        keys = []
        for mod, names in (
            ("io/cli.py", ("main", "run")),
            ("serve/loop.py", ("run_serve",)),
            ("serve/fleet.py", ("run_fleet_worker",)),
        ):
            for key in self.funcs:
                if key[0].endswith(mod) and key[1] in names:
                    keys.append(key)
        if not keys:
            keys = sorted(k for k in self.funcs if k[1] == "main")
        return keys

    def production_set(self):
        seen = set(self.roots())
        stack = list(seen)
        while stack:
            key = stack.pop()
            for nxt in self.forward.get(key, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append(nxt)
        return seen


# -- exception hierarchy ---------------------------------------------------


def _ancestors(name: str, classmap: dict) -> list:
    seen: list = []
    queue = [name]
    while queue:
        n = queue.pop(0)
        if n in seen:
            continue
        seen.append(n)
        queue.extend(classmap.get(n, ()))
    return seen


def _is_subtype(exc: str, target: str, classmap: dict) -> bool:
    for a in _ancestors(exc, classmap):
        if a == target:
            return True
        A = getattr(builtins, a, None)
        T = getattr(builtins, target, None)
        if isinstance(A, type) and isinstance(T, type):
            try:
                if issubclass(A, T):
                    return True
            except TypeError:  # advisory: non-class builtin shadowing a name
                pass
    return False


def _base_only(exc: str, classmap: dict) -> bool:
    """True when ``exc`` derives from BaseException but not Exception
    (DrainInterrupt / KeyboardInterrupt: must sail past ``except
    Exception`` nets)."""
    for a in _ancestors(exc, classmap):
        A = getattr(builtins, a, None)
        if isinstance(A, type) and issubclass(A, BaseException):
            return not issubclass(A, Exception)
    return False  # unplaceable types default to Exception-derived


def _matches(exc: str, handler: Handler, classmap: dict) -> bool:
    if not handler.types or "BaseException" in handler.types:
        return True
    if "Exception" in handler.types:
        return exc == "<dynamic>" or not _base_only(exc, classmap)
    if exc == "<dynamic>":
        return False
    return any(_is_subtype(exc, t, classmap) for t in handler.types)


# -- sink-proof walk -------------------------------------------------------

_WALK_CAP = 40000  # frames per site; a backstop, never hit in practice


def _classify_site(graph: _Graph, key, site: RaiseSite, production: set):
    """All sinks (and root escapes) one raise site's exception reaches."""
    sinks: set = set()
    escapes: list = []
    seen = set()
    stack = [(key, site.exc, site.ctx)]
    budget = _WALK_CAP
    while stack and budget:
        budget -= 1
        fkey, exc, ctx = stack.pop()
        mark = (fkey, exc, tuple(id(c) for c in ctx))
        if mark in seen:
            continue
        seen.add(mark)
        caught = False
        for i, tc in enumerate(ctx):
            hit = None
            for handler in tc.handlers:
                if _matches(exc, handler, graph.classmap):
                    hit = handler
                    break
            if hit is None:
                continue
            if hit.kind == "reraise":
                stack.append((fkey, exc, ctx[i + 1:]))
            elif hit.kind == "raise-new":
                stack.append(
                    (fkey, hit.new_type or "<dynamic>", ctx[i + 1:])
                )
            else:
                sinks.add(hit.kind)
            caught = True
            break
        if caught:
            continue
        # Escaped the function: continue up through production callers;
        # a frameless closure escapes through its definition site.
        frames = [
            f for f in graph.callers.get(fkey, []) if f[0] in production
        ]
        if not frames:
            parent = graph.funcs[fkey].parent
            if parent is not None and parent in production:
                stack.append((parent, exc, graph.funcs[fkey].def_ctx))
            else:
                escapes.append(f"{fkey[0]}:{fkey[1]}")
            continue
        for ckey, _line, cctx in frames:
            stack.append((ckey, exc, cctx))
    return sinks, escapes


# -- flush / exit-75 contract ---------------------------------------------


def _flush_try(fn: _Func):
    """The try statement whose finally performs the terminal flush."""
    if fn.node is None:
        return None
    for sub in _walk_no_defs(fn.node):
        if isinstance(sub, ast.Try) and sub.finalbody:
            called = set()
            for stmt in sub.finalbody:
                for c in ast.walk(stmt):
                    if isinstance(c, ast.Call):
                        if isinstance(c.func, ast.Attribute):
                            called.add(c.func.attr)
                        elif isinstance(c.func, ast.Name):
                            called.add(c.func.id)
            if called & _FLUSH_CALLS:
                return sub.lineno, sub.finalbody[-1].end_lineno, sorted(
                    called & _FLUSH_CALLS
                )
    return None


def _check_flush(graph: _Graph, findings: list) -> dict:
    """Every exit statement in the cli/serve drivers must pass through
    the finally-first flush (pre-arm usage returns excepted)."""
    out = {}
    for mod, fname in (("io/cli.py", "run"), ("serve/loop.py", "run_serve")):
        fn = next(
            (
                f
                for k, f in graph.funcs.items()
                if k[0].endswith(mod) and k[1] == fname
            ),
            None,
        )
        if fn is None:
            continue
        rel = fn.module
        span = _flush_try(fn)
        if span is None:
            findings.append(
                {
                    "kind": "flush-bypass",
                    "module": rel,
                    "line": fn.node.lineno if fn.node else 0,
                    "detail": f"{fname}() has no finally-first flush block",
                }
            )
            continue
        lo, hi, calls = span
        protected = 0
        for line, rk in fn.returns:
            if lo <= line <= hi:
                protected += 1
                continue
            if line < lo and (
                (rk[0] == "name" and rk[1] in _PREARM_OK)
                or (rk[0] == "const" and rk[1] in _PREARM_CODES)
            ):
                continue  # pre-arm usage exit: nothing armed to flush yet
            findings.append(
                {
                    "kind": "flush-bypass",
                    "module": rel,
                    "line": line,
                    "detail": (
                        f"{fname}() returns outside the flush try "
                        f"(lines {lo}-{hi})"
                    ),
                }
            )
        for line, name in fn.hard_exits:
            if not lo <= line <= hi:
                findings.append(
                    {
                        "kind": "flush-bypass",
                        "module": rel,
                        "line": line,
                        "detail": (
                            f"{fname}() calls {name}() outside the "
                            "flush try"
                        ),
                    }
                )
        out[rel] = {
            "function": fname,
            "flush_try": [lo, hi],
            "flush_calls": calls,
            "protected_returns": protected,
        }
    return out


def _resumable_predicates(graph: _Graph) -> set:
    """cli-module functions whose body walks the ``__cause__`` /
    ``__context__`` chain AND names a deadline/drain root type — the
    only predicates allowed to gate an exit-75."""
    out = set()
    for key, fn in graph.funcs.items():
        if not key[0].endswith("io/cli.py") or fn.node is None:
            continue
        attrs = set()
        names = set()
        for sub in ast.walk(fn.node):
            if isinstance(sub, ast.Attribute):
                attrs.add(sub.attr)
            elif isinstance(sub, ast.Name):
                names.add(sub.id)
        if {"__cause__", "__context__"} <= attrs and (
            names & _RESUMABLE_ROOTS
        ):
            out.add(key[1].rsplit(".", 1)[-1])
    return out


def _check_exit75(graph: _Graph, findings: list) -> None:
    """EX_TEMPFAIL (75) may be produced only under a DrainInterrupt
    handler or behind a resumable-cause predicate."""
    preds = _resumable_predicates(graph)
    for key, fn in graph.funcs.items():
        if not key[0].endswith("io/cli.py") or fn.node is None:
            continue
        for sub in _walk_no_defs(fn.node):
            is75 = (
                isinstance(sub, ast.Name)
                and sub.id == "EX_TEMPFAIL"
                and isinstance(sub.ctx, ast.Load)
            )
            if not is75:
                continue
            if _legal_75(fn.node, sub, preds, graph.classmap):
                continue
            findings.append(
                {
                    "kind": "tempfail-unrooted",
                    "module": key[0],
                    "line": sub.lineno,
                    "detail": (
                        f"{key[1]} maps exit 75 outside a DrainInterrupt "
                        "handler / resumable-cause predicate"
                    ),
                }
            )


def _legal_75(fn_node, node, preds, classmap) -> bool:
    """Is this EX_TEMPFAIL load inside a legal resumable context?"""
    path = _path_to(fn_node, node)
    if path is None:
        return False
    for anc in path:
        if isinstance(anc, ast.ExceptHandler):
            for t in _type_names(anc.type, {}):
                if t in _RESUMABLE_ROOTS or any(
                    a in _RESUMABLE_ROOTS for a in _ancestors(t, classmap)
                ):
                    return True
        if isinstance(anc, (ast.If, ast.IfExp)) and _calls_pred(
            anc.test, preds
        ):
            return True
    return False


def _calls_pred(test, preds) -> bool:
    for sub in ast.walk(test):
        if isinstance(sub, ast.Call):
            name = None
            if isinstance(sub.func, ast.Name):
                name = sub.func.id
            elif isinstance(sub.func, ast.Attribute):
                name = sub.func.attr
            if name in preds:
                return True
    return False


def _path_to(root, target):
    """Ancestor chain (outermost-first) from root down to target."""
    path: list = []

    def visit(node):
        if node is target:
            return True
        for sub in ast.iter_child_nodes(node):
            path.append(node)
            if visit(sub):
                return True
            path.pop()
        return False

    return path if visit(root) else None


# -- fault-registry cross-check -------------------------------------------


def _fault_registry(graph: _Graph):
    """Statically read KNOWN_SITES and the hang/kill alias maps out of
    the analysed package's resilience/faults.py."""
    rel = next(
        (r for r in graph.trees if r.endswith("resilience/faults.py")),
        None,
    )
    if rel is None:
        return None
    sites: set = set()
    aliases: dict = {}  # base fire-point name -> alias site
    for node in graph.trees[rel].body:
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        tgt = node.targets[0]
        if not isinstance(tgt, ast.Name):
            continue
        if tgt.id in ("KNOWN_SITES", "SERVE_SITES", "FLEET_SITES"):
            for sub in ast.walk(node.value):
                if isinstance(sub, ast.Constant) and isinstance(
                    sub.value, str
                ):
                    sites.add(sub.value)
        elif tgt.id in ("_HANG_SITES", "_KILL_SITES") and isinstance(
            node.value, ast.Dict
        ):
            for k, v in zip(node.value.keys, node.value.values):
                if isinstance(k, ast.Constant) and isinstance(
                    v, ast.Constant
                ):
                    aliases[str(k.value)] = str(v.value)
    return rel, sites, aliases


def _collect_fault_points(graph: _Graph) -> dict:
    """Every literal ``fire('<site>')``-family call in the package,
    attributed to its enclosing top-level function (module-level fire
    points attribute to None = import-time, always live)."""
    spans: dict = {}
    for key, fn in graph.funcs.items():
        if fn.node is not None:
            spans.setdefault(key[0], []).append(
                (fn.node.lineno, fn.node.end_lineno or fn.node.lineno, key)
            )
    points: dict = {}
    for rel, tree in graph.trees.items():
        owners = spans.get(rel, [])
        for sub in ast.walk(tree):
            if not isinstance(sub, ast.Call) or not sub.args:
                continue
            name = None
            if isinstance(sub.func, ast.Name):
                name = sub.func.id
            elif isinstance(sub.func, ast.Attribute):
                name = sub.func.attr
            if name not in _FAULT_CALLS:
                continue
            arg = sub.args[0]
            if not (
                isinstance(arg, ast.Constant) and isinstance(arg.value, str)
            ):
                continue
            owner = None
            for lo, hi, key in owners:
                if lo <= sub.lineno <= hi:
                    owner = key
                    break
            points.setdefault(arg.value, []).append((rel, sub.lineno, owner))
    return points


def _fault_reachable(owner, production: set) -> bool:
    if owner is None:
        return True  # module-level fire point: import-time
    if owner in production:
        return True
    # Fire points inside closures count through a production definer.
    return any(
        k[0] == owner[0] and k[1].startswith(owner[1] + ".")
        for k in production
    )


def _check_faults(graph: _Graph, production: set, findings: list) -> dict:
    reg = _fault_registry(graph)
    if reg is None:
        return {}
    rel, sites, aliases = reg
    points = _collect_fault_points(graph)
    reachable_points = sum(
        1
        for plist in points.values()
        for (_m, _l, owner) in plist
        if _fault_reachable(owner, production)
    )
    for site in sorted(sites):
        hits = list(points.get(site, []))
        hits.extend(
            p
            for base, alias in aliases.items()
            if alias == site
            for p in points.get(base, [])
        )
        if not hits:
            findings.append(
                {
                    "kind": "fault-site-unreachable",
                    "module": rel,
                    "line": 0,
                    "detail": (
                        f"registry site {site!r} has no fire()/scheduled() "
                        "point anywhere in the package (renamed site? "
                        "the chaos runs would be vacuous for it)"
                    ),
                }
            )
            continue
        if not any(
            _fault_reachable(owner, production) for (_m, _l, owner) in hits
        ):
            findings.append(
                {
                    "kind": "fault-site-unreachable",
                    "module": rel,
                    "line": hits[0][1],
                    "detail": (
                        f"registry site {site!r} fires only outside the "
                        "production call graph"
                    ),
                }
            )
    return {
        "registered": len(sites),
        "fire_points": sum(len(v) for v in points.values()),
        "reachable_fire_points": reachable_points,
    }


# -- handler hygiene (swallows, shadowed arms) ----------------------------


def _check_handlers(graph: _Graph, findings: list):
    broad = wire = 0
    advisory = []
    for key, fn in sorted(graph.funcs.items()):
        for handlers in fn.tries:
            for j, h in enumerate(handlers):
                if h.broad:
                    broad += 1
                if h.kind == "wire-reply":
                    wire += 1
                if h.marker:
                    advisory.append(f"{key[0]}: {h.marker}")
                if h.kind == "swallow":
                    findings.append(
                        {
                            "kind": "swallow-unmarked",
                            "module": key[0],
                            "line": h.line,
                            "detail": (
                                f"{key[1]} swallows "
                                f"{'/'.join(h.types) or 'everything'} "
                                "without a reasoned '# advisory:' marker"
                                + (" (logs only)" if h.logs else "")
                            ),
                        }
                    )
                # Shadowed arm: an earlier broader arm already claims
                # this arm's type — the exception is double-classified
                # and the later classifier is dead code.
                for earlier in handlers[:j]:
                    if _shadows(earlier, h, graph.classmap):
                        findings.append(
                            {
                                "kind": "double-classified",
                                "module": key[0],
                                "line": h.line,
                                "detail": (
                                    f"{key[1]}: handler for "
                                    f"{'/'.join(h.types) or 'everything'} "
                                    "is shadowed by the broader arm at "
                                    f"line {earlier.line}"
                                ),
                            }
                        )
                        break
    return broad, wire, sorted(advisory)


def _shadows(earlier: Handler, later: Handler, classmap) -> bool:
    if not earlier.types or "BaseException" in earlier.types:
        return True
    if "Exception" in earlier.types:
        if not later.types:
            return False  # bare still catches BaseException kinds
        return all(
            not _base_only(t, classmap)
            and _resolves_as_exception(t, classmap)
            for t in later.types
        )
    if not later.types:
        return False
    return all(
        any(_is_subtype(t, e, classmap) for e in earlier.types)
        for t in later.types
    )


def _resolves_as_exception(name: str, classmap) -> bool:
    """Only shadow-flag types we can actually place in the hierarchy."""
    return any(
        isinstance(getattr(builtins, a, None), type)
        for a in _ancestors(name, classmap)
    )


# -- audit entry points ----------------------------------------------------


def audit_exitflow(package_root: str | Path | None = None) -> dict:
    graph = _Graph(package_root)
    production = graph.production_set()
    findings: list = []

    broad, wire, advisory = _check_handlers(graph, findings)

    sink_counts: dict = {}
    raise_modules: dict = dict(graph.module_raises)
    total = prod_sites = 0
    for key, fn in sorted(graph.funcs.items()):
        for site in fn.raises:
            total += 1
            raise_modules[key[0]] = raise_modules.get(key[0], 0) + 1
            if key not in production:
                sink_counts["out-of-plane"] = (
                    sink_counts.get("out-of-plane", 0) + 1
                )
                continue
            prod_sites += 1
            if site.exc == "ArgumentTypeError":
                # argparse's type= callbacks: parse_args catches the
                # raise and performs the usage exit itself.
                sink_counts["exit-map"] = sink_counts.get("exit-map", 0) + 1
                continue
            sinks, escapes = _classify_site(graph, key, site, production)
            for esc in escapes:
                findings.append(
                    {
                        "kind": "unclassified-raise",
                        "module": key[0],
                        "line": site.line,
                        "detail": (
                            f"{site.exc} raised in {key[1]} escapes the "
                            f"production graph uncaught (via {esc})"
                        ),
                    }
                )
            primary = next((k for k in SINK_PRIORITY if k in sinks), None)
            if primary is None and not escapes:
                # No terminal frame reached (walk budget / pure-cycle
                # corner): count it visibly rather than dropping it.
                primary = "handled"
            if primary is not None:
                sink_counts[primary] = sink_counts.get(primary, 0) + 1
    import_raises = sum(graph.module_raises.values())
    if import_raises:
        sink_counts["import-time"] = import_raises

    flush = _check_flush(graph, findings)
    _check_exit75(graph, findings)
    faults = _check_faults(graph, production, findings)

    findings.sort(key=lambda f: (f["kind"], f["module"], f["line"]))
    return {
        "files": graph.files,
        "functions": len(graph.funcs),
        "sinks": {k: sink_counts[k] for k in sorted(sink_counts)},
        "raise_modules": {
            k: raise_modules[k] for k in sorted(raise_modules)
        },
        "advisory": advisory,
        "flush": flush,
        "fault_sites": faults,
        "findings": findings,
        "counts": {
            "raise_sites": total,
            "production_raises": prod_sites,
            "production_functions": len(production),
            "broad_handlers": broad,
            "wire_reply_handlers": wire,
            "advisory_markers": len(advisory),
            "findings": len(findings),
        },
    }


def run_or_raise(package_root: str | Path | None = None) -> dict:
    """Audit and raise :class:`ExitFlowError` on any finding."""
    report = audit_exitflow(package_root)
    if report["findings"]:
        rows = "\n".join(
            f"  [{f['kind']}] {f['module']}:{f['line']}: {f['detail']}"
            for f in report["findings"]
        )
        raise ExitFlowError(
            f"exception-flow audit failed "
            f"({len(report['findings'])} finding(s)):\n{rows}"
        )
    return report
