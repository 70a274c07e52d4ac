"""Repo-specific AST lint (``seqlint``), with the port's scopes.

The port of ``mpi_openmp_cuda_tpu/analysis/seqlint.py``.  Generic linters
cannot know that ``.item()`` in a kernel wrapper forces a device sync, that
env reads outside the registry fragment configuration, or that a
wall-clock read inside the resilience decision paths breaks replay
determinism.  These rules encode THIS package's conventions:

=======  ==================================================================
SEQ001   no host sync on the hot path — ``.item()``, ``.cpu()``,
         ``.tolist()``, ``.numpy()``, ``torch.cuda.synchronize()``, or
         ``int()``/``float()``/``bool()`` of a device tensor — inside the
         CUDA wrappers (``ops/cuda_scorer.py``), ``dispatch.run_launch``,
         the launch planning it feeds, and the ``--check`` hook
         (``analysis/contracts.py``, ``analysis/smem.py``): each one stalls
         the launch queue per call.  The hot functions are the
         :data:`_HOT_NAME_RE` names in :data:`ROLE_HOT` modules.
SEQ002   no ``os.environ`` / ``os.getenv`` outside ``utils/env.py`` — all
         knobs go through the typed env registry so ``--help`` and the
         docs can enumerate them.
SEQ003   no Python ``if``/``while`` on a device tensor on the hot path:
         the branch forces a sync to read the value (``torch.where`` keeps
         it on the card).  A device tensor is a ``torch.*`` call's result,
         a wrapper's or formulation's result, a name assigned from one, or
         a ``ScorerState`` tensor field (``.seq1ext``/``.rows``/``.lens``/
         ``.val``); its metadata (``.shape``, ``.dtype``, ``.device``) is
         host data.
SEQ004   no bare ``assert`` in runtime paths — asserts vanish under
         ``python -O``; raise with an actionable message instead.
SEQ005   no wall-clock reads (``time.time``/``monotonic``/
         ``perf_counter`` / ``datetime.now``) in the deterministic
         resilience / journal / load decision paths (``time.sleep`` is
         fine: it delays, it does not decide).
SEQ006   no direct ``print(..., file=sys.stderr)`` in the instrumented
         modules — route diagnostics through ``obs.events.log_line`` so an
         armed observability plane sees every line the operator sees.
SEQ007   no bare blocking waits (``time.sleep`` / ``Condition.wait`` /
         ``wait_for``) in ``serve/`` outside ``serve/clock.py`` — every
         serve-loop wait rides the injectable ``ServeClock.block_until``.
SEQ008   serve-plane shared state is mutated only under its owning lock:
         in a serve-plane module, a class that declares a
         ``threading.Condition``/``Lock``/``RLock`` attribute is
         *guarded*, and every ``self.*`` mutation outside ``__init__``
         must sit inside ``with self.<guard>:``.
SEQ009   every package module is explicitly classified in the
         ``_MODULE_CLASSES`` registry below; an unclassified module would
         silently escape every scoped rule.
SEQ010   no blocking operation lexically inside a ``with <lock>:`` body
         in serve-plane modules: socket ``accept``/``recv``/``connect``
         (and ``send`` on socket-named receivers), board file I/O,
         ``os`` file ops / ``open()``, ``subprocess``, and
         ``ServeClock.block_until`` on anything but the held lock itself —
         the lexical twin of ``analysis/lockgraph.py`` rule (b).
SEQ013   every numeric-bound literal in hot-path gate/kernel-wrapper code
         (the int32 and fp32 windows: ``2**31 - 1``, ``2**31``,
         ``2**24`` and their ``1 << N`` spellings) carries a ``# cert:
         <row>`` marker naming the ``analysis/ranges.py`` row that
         re-derives it (``scripts/torch_ranges_audit.py``).  A bare
         ``# cert:`` documents nothing and stays a finding.
SEQ014   every broad handler (``except:`` / ``except Exception``) in a
         classified module proves it is not a silent swallow: the body
         re-raises, routes the event through ``log_line``, forwards the
         bound exception into a classifier call, or carries a reasoned
         ``# advisory: <why>`` marker — the lexical twin of the
         exception-flow certifier's ``swallow-unmarked`` finding
         (``analysis/exitflow.py``).
SEQ015   every WORK-UNIT board post in the serving plane carries trace
         context: a ``json.dumps({...})`` dict literal with both ``"bid"``
         and ``"rows"`` keys must also carry a ``"traces"`` key.
=======  ==================================================================

Absent: the JAX package's SEQ011 (every module-level ``jax.jit`` declares
its ``donate_argnums``) and SEQ012 (raw ``jax.lax`` collectives only in
``parallel/``, with an explicit ``axis_name=``) police JAX constructs the
port does not have: it jits nothing, and its collectives are
``parallel/comm.py``'s counted wrappers over ``torch.distributed``.

Suppression: append ``# seqlint: disable=SEQ00N`` to the offending line
(multiple codes comma-separated).  A file-level
``# seqlint: disable-file=SEQ00N`` in the first ten lines suppresses a
rule for the whole file.  ``analysis/`` itself stays suppression-free.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path

from . import LintError

#: Functions on the launch hot path for SEQ001/SEQ003 (in ROLE_HOT
#: modules only): the kernel wrappers and their launch helpers, the
#: dispatch's launch and planning, and the --check hook's gates.
_HOT_NAME_RE = re.compile(
    r"^(fused_scorer|packed_scorer|_launch|call_entry|check_smem|_device_of|"
    r"_check_pack|run_launch|bucket_launches|_validate\w*|validate_\w+|"
    r"check_\w+|card_budget|_card_budget)$"
)

#: Module roles.  Each role keys one rule's scope; a module may hold
#: several (resilience/ is both clock-free in its decisions AND routed
#: through the event bus for its diagnostics).
ROLE_HOT = "hot-path"  # SEQ001/SEQ003 police its hot functions
ROLE_DETERMINISTIC = "deterministic"  # SEQ005: decisions are clock-free
ROLE_INSTRUMENTED = "instrumented"  # SEQ006: stderr rides the event bus
ROLE_SERVE = "serve-plane"  # SEQ007 waits + SEQ008 shared-state lock
ROLE_WAIT_HOME = "serve-clock-home"  # the one legal blocking-wait seam
ROLE_ENV_HOME = "env-home"  # the one legal os.environ reader
ROLE_HOST = "host"  # plain host-side module; only SEQ002/SEQ004 apply

#: EXHAUSTIVE classification of the package tree.  Exact file entries
#: override their directory's default; ``dir/`` entries classify every
#: module beneath them.  A module matching NEITHER is a SEQ009 finding
#: — new modules must be placed here deliberately, so no rule scope can
#: silently rot again (PR 6 shipped io/pipeline.py and serve/* without
#: touching these lists; this registry turns that into a failure).
_MODULE_CLASSES: dict[str, tuple[str, ...]] = {
    # -- exact files (override the directory default) ----------------------
    # The env registry is also INSTRUMENTED: any warning it grows rides
    # the event bus (SEQ006), not bare stderr.
    "utils/env.py": (ROLE_ENV_HOME, ROLE_INSTRUMENTED),
    "utils/journal.py": (ROLE_DETERMINISTIC, ROLE_INSTRUMENTED),
    "ops/dispatch.py": (ROLE_HOT, ROLE_INSTRUMENTED),
    "parallel/distributed.py": (ROLE_HOT, ROLE_INSTRUMENTED),
    "io/pipeline.py": (ROLE_INSTRUMENTED,),
    "serve/clock.py": (ROLE_WAIT_HOME,),
    "serve/queue.py": (ROLE_SERVE, ROLE_DETERMINISTIC),
    "serve/loop.py": (ROLE_SERVE, ROLE_INSTRUMENTED),
    "serve/session.py": (ROLE_SERVE, ROLE_INSTRUMENTED),
    # Fleet coordinator/worker: serve-plane waits (through the clock
    # seam) + bus instrumentation; its membership/lease bookkeeping is the
    # DETERMINISTIC resilience/membership.py (tick-counted decisions).
    "serve/fleet.py": (ROLE_SERVE, ROLE_INSTRUMENTED),
    # The admission controller's pricing and shed machine are clock-free
    # (waits are handed IN by the loop); the breaker's windows are
    # tick-counted — both stay under SEQ005.
    "serve/slo.py": (ROLE_SERVE, ROLE_DETERMINISTIC),
    # The trace recorder and flight recorder are written to from reader
    # threads, the main loop and the watchdog monitor, so they carry the
    # serve-plane lock discipline (SEQ008) though they live under obs/.
    "obs/trace.py": (ROLE_SERVE,),
    "obs/flightrec.py": (ROLE_SERVE,),
    # The --check hook runs on the launch path: its gates read host
    # arrays only (SEQ001/SEQ003 hold them to it).
    "analysis/contracts.py": (ROLE_HOT,),
    "analysis/smem.py": (ROLE_HOT,),
    # The load plane's one wall-clock module: pacing and socket reads
    # are measurements against a prebuilt schedule, not decisions.
    "load/driver.py": (ROLE_HOST,),
    # The bench: host-side timing of the scorer (walls and CUDA events
    # are its measurements, not decisions); its env knobs are declared in
    # utils/env.py like every other.
    "bench.py": (ROLE_HOST,),
    # -- directory defaults ------------------------------------------------
    # The warm plane is host-side orchestration whose diagnostics ride the
    # event bus; its timers are measurements, not decisions.
    "aot/": (ROLE_INSTRUMENTED,),
    "ops/": (ROLE_HOT,),
    "parallel/": (ROLE_HOT,),
    "resilience/": (ROLE_DETERMINISTIC, ROLE_INSTRUMENTED),
    "serve/": (ROLE_SERVE,),
    "analysis/": (ROLE_HOST,),
    "io/": (ROLE_HOST,),
    # Open-loop load generation: seeded schedules, never wall-clock in
    # decision paths (driver.py excepted above).
    "load/": (ROLE_DETERMINISTIC,),
    "models/": (ROLE_HOST,),
    "obs/": (ROLE_HOST,),
    "utils/": (ROLE_HOST,),
    # -- top-level modules -------------------------------------------------
    "__init__.py": (ROLE_HOST,),
    "__main__.py": (ROLE_HOST,),
    "native_bridge.py": (ROLE_HOST,),
}


def module_roles(rel: str | Path) -> tuple[str, ...] | None:
    """Roles for a lint-relative module path (``<pkg>/<inner...>.py``).

    The leading path component is the package directory name (whatever
    it is — the tests lint under ``pkg/``); classification keys on the
    inner path.  Returns ``None`` for an unclassified module (a SEQ009
    finding, not a crash: the linter must keep linting the rest)."""
    parts = Path(rel).parts
    inner = "/".join(parts[1:]) if len(parts) > 1 else parts[0]
    exact = _MODULE_CLASSES.get(inner)
    if exact is not None:
        return exact
    if "/" in inner:
        return _MODULE_CLASSES.get(inner.split("/", 1)[0] + "/")
    return None


#: The serving plane's single legal home for blocking waits (SEQ007)
#: and the single legal home for environment reads (SEQ002) — kept as
#: names because the rule MESSAGES cite them.
_SERVE_CLOCK_HOME = "serve/clock.py"
_ENV_HOME = "utils/env.py"

#: Guard types whose ``self.X = threading.<T>()`` assignment marks a
#: serve-plane class as lock-guarded (SEQ008).
_GUARD_TYPES = ("Condition", "Lock", "RLock")

#: In-place mutator methods: a call ``self.attr.<m>(...)`` mutates the
#: shared container exactly like an assignment does (SEQ008).
_MUTATOR_METHODS = {
    "append", "extend", "insert", "pop", "popleft", "appendleft",
    "remove", "clear", "add", "discard", "update", "setdefault",
    "popitem", "sort", "reverse",
}

_WALLCLOCK_ATTRS = {
    ("time", "time"),
    ("time", "monotonic"),
    ("time", "perf_counter"),
    ("time", "process_time"),
    ("time", "time_ns"),
    ("time", "monotonic_ns"),
    ("datetime", "now"),
    ("datetime", "utcnow"),
    ("date", "today"),
}

#: SEQ010's blocking-operation tables — the lexical mirror of the
#: reachability sets in ``analysis/lockgraph.py`` (keep in sync).
#: ``.write``/``.flush`` on a locked stream are deliberately absent:
#: they are bounded by SO_SNDTIMEO and serialising them is the lock's
#: purpose (Responder.send).
_SEQ010_SOCKET_ATTRS = ("accept", "recv", "recvfrom", "connect", "listen")
_SEQ010_SOCKETISH_SEND = ("send", "sendall")
_SEQ010_BOARD_ATTRS = ("post", "claim", "delete")
_SEQ010_OS_ATTRS = (
    "replace", "fsync", "link", "unlink", "makedirs", "rename",
    "remove", "rmdir", "listdir", "walk",
)

_SUPPRESS_RE = re.compile(r"#\s*seqlint:\s*disable=([A-Z0-9, ]+)")
_SUPPRESS_FILE_RE = re.compile(r"#\s*seqlint:\s*disable-file=([A-Z0-9, ]+)")

#: SEQ013's proof marker: must name a RangeCert ``derived_constants``
#: row (a bare ``# cert:`` proves nothing and stays a finding).
_CERT_RE = re.compile(r"#\s*cert:\s*(\S+)?")

#: SEQ014's swallow marker: must carry a non-empty reason (a bare
#: ``# advisory:`` documents nothing and stays a finding).  Keep in
#: sync with ``analysis.exitflow._ADVISORY_RE`` — the propagation-graph
#: certifier reads the SAME markers when classifying handler sinks.
_ADVISORY_RE = re.compile(r"#\s*advisory:\s*(\S.*)?$")

#: SEQ013's certified numeric-bound set — the int32 and fp32 windows
#: ``analysis/ranges.py`` re-derives (``int32-max``, ``f32-exact-window``;
#: keep in sync).  ``2**N`` / ``1 << N`` spellings of these values match.
_CERT_LITERALS = {
    16777216,  # f32-exact-window (2^24)
    2147483647,  # int32-max (2^31 - 1)
    2147483648,  # 2^31 itself (the 2**31 - 1 spelling's inner literal)
}


@dataclasses.dataclass(frozen=True)
class LintFinding:
    code: str
    path: str
    line: int
    message: str

    def describe(self) -> str:
        return f"{self.path}:{self.line}: {self.code} {self.message}"


def _suppressions(source: str):
    """Per-line and file-level rule suppressions from comments."""
    per_line: dict[int, set[str]] = {}
    file_level: set[str] = set()
    for i, text in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(text)
        if m:
            per_line[i] = {c.strip() for c in m.group(1).split(",")}
        if i <= 10:
            m = _SUPPRESS_FILE_RE.search(text)
            if m:
                file_level |= {c.strip() for c in m.group(1).split(",")}
    return per_line, file_level


class _Scope:
    """One function scope: whether it is on the hot path, and which local
    names hold device tensors (assigned from a device expression)."""

    def __init__(self, name: str, hot: bool):
        self.name = name
        self.hot = hot
        self.device_names: set[str] = set()


#: Calls whose results are device tensors (the wrappers, the plain
#: formulations, the staging copy).
_DEVICE_CALLS = {
    "fused_scorer", "packed_scorer", "call_entry", "_launch", "gather_rows",
    "mm_rows", "fused_scorer_plain", "packed_scorer_plain", "finish_rows",
    "score_rows", "put_feed", "ring_window_rows",
}
#: ScorerState's tensor fields.
_TENSOR_FIELDS = {"seq1ext", "rows", "lens", "val"}
#: Tensor metadata: host data, never a sync.
_HOST_META = {
    "shape", "dtype", "device", "is_contiguous", "data_ptr", "dim", "ndim",
    "numel", "element_size", "is_cuda", "size", "stride",
}
#: ``torch.*`` calls that return host data.
_TORCH_HOST_CALLS = {
    "device", "is_available", "current_stream", "current_device",
    "device_count", "get_device_name", "get_device_properties",
    "get_device_capability", "Stream", "Event",
}


def _call_name(func: ast.AST) -> str | None:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _root_name(node: ast.AST) -> str | None:
    while isinstance(node, (ast.Attribute, ast.Call, ast.Subscript)):
        node = node.func if isinstance(node, ast.Call) else node.value
    return node.id if isinstance(node, ast.Name) else None


def _is_device_expr(node: ast.AST, scope: _Scope) -> bool:
    """Does this expression hold a device tensor's value (not its
    metadata)?  A call's result is a device tensor when it is a ``torch.*``
    call (bar the host queries), a wrapper or formulation call, or a method
    of a device tensor (``raw.max()``); any other function's result is
    host data (``_ptr(state.rows)`` is an address, ``len(x)`` an int).  A
    comprehension holds what its element expression holds."""
    if isinstance(node, ast.Attribute) and node.attr in _HOST_META:
        return False
    if isinstance(node, ast.Call):
        name = _call_name(node.func)
        if isinstance(node.func, ast.Attribute):
            if name in _HOST_META:
                return False
            if _root_name(node.func) == "torch":
                return name not in _TORCH_HOST_CALLS
            return name in _DEVICE_CALLS or _is_device_expr(node.func.value, scope)
        return name in _DEVICE_CALLS
    if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
        return _is_device_expr(node.elt, scope)
    if isinstance(node, ast.DictComp):
        return _is_device_expr(node.key, scope) or _is_device_expr(node.value, scope)
    if isinstance(node, ast.Name):
        return node.id in scope.device_names
    if isinstance(node, ast.Attribute) and node.attr in _TENSOR_FIELDS:
        return True
    return any(_is_device_expr(c, scope) for c in ast.iter_child_nodes(node))


class _Linter(ast.NodeVisitor):
    def __init__(self, path: str, rel: str, source: str):
        self.path = path
        self.rel = rel
        self.findings: list[LintFinding] = []
        self.per_line, self.file_level = _suppressions(source)
        # SEQ013/SEQ014 read markers from the source text (AST nodes
        # drop comments).
        self._lines = source.splitlines()
        self.scopes: list[_Scope] = []
        # Every rule's scope derives from the one classification
        # registry — path predicates may not be re-derived ad hoc here
        # (that is exactly the drift SEQ009 exists to prevent).
        roles = module_roles(rel)
        self.unclassified = roles is None
        roles = roles or ()
        self.in_hot_module = ROLE_HOT in roles
        self.is_env_home = ROLE_ENV_HOME in roles
        self.in_deterministic = ROLE_DETERMINISTIC in roles
        self.in_instrumented = ROLE_INSTRUMENTED in roles
        self.in_serve = ROLE_SERVE in roles
        # SEQ010 lexical state: the guard attrs of each enclosing class,
        # the local guard names of each enclosing function, and the
        # stack of guards currently held by enclosing `with` bodies.
        self._class_guard_stack: list[set[str]] = []
        self._local_guard_stack: list[set[str]] = []
        self._held_guards: list[tuple[str, str]] = []

    # -- bookkeeping -------------------------------------------------------

    def _emit(self, code: str, node: ast.AST, message: str):
        line = getattr(node, "lineno", 0)
        if code in self.file_level or code in self.per_line.get(line, ()):
            return
        self.findings.append(LintFinding(code, self.rel, line, message))

    def _enter_function(self, node):
        hot = self.in_hot_module and bool(_HOT_NAME_RE.match(node.name))
        self.scopes.append(_Scope(node.name, hot))
        # SEQ010: a nested def inside a `with lock:` body runs LATER,
        # not under the lock — lexical held state does not cross a
        # function boundary.
        held, self._held_guards = self._held_guards, []
        self._local_guard_stack.append(self._local_guards(node))
        self.generic_visit(node)
        self._local_guard_stack.pop()
        self._held_guards = held
        self.scopes.pop()

    @staticmethod
    def _is_guard_ctor(value: ast.AST) -> bool:
        if not isinstance(value, ast.Call):
            return False
        func = value.func
        return (
            isinstance(func, ast.Attribute)
            and func.attr in _GUARD_TYPES
            and isinstance(func.value, ast.Name)
            and func.value.id == "threading"
        ) or (isinstance(func, ast.Name) and func.id in _GUARD_TYPES)

    @classmethod
    def _local_guards(cls, node) -> set[str]:
        """Plain local names assigned ``threading.Lock()/Condition()/
        RLock()`` anywhere in this function (SEQ010)."""
        out: set[str] = set()
        for sub in ast.walk(node):
            if isinstance(sub, ast.Assign) and cls._is_guard_ctor(sub.value):
                for tgt in sub.targets:
                    if isinstance(tgt, ast.Name):
                        out.add(tgt.id)
        return out

    visit_FunctionDef = _enter_function
    visit_AsyncFunctionDef = _enter_function

    @property
    def scope(self) -> _Scope | None:
        for s in reversed(self.scopes):
            if s.hot:
                return s
        return None

    # -- SEQ009: unclassified module ---------------------------------------

    def visit_Module(self, node: ast.Module):
        if self.unclassified:
            self._emit(
                "SEQ009",
                node,
                "module is not classified in the seqlint _MODULE_CLASSES "
                "registry; add it (hot-path / deterministic / instrumented "
                "/ serve-plane / host) so the rule scopes cover it",
            )
        if self.in_hot_module:
            self._scan_cert_literals(node, None)
        self.generic_visit(node)

    # -- SEQ013: numeric-bound literals name their cert row ----------------

    @staticmethod
    def _cert_literal_value(node: ast.AST) -> int | None:
        """The certified-bound value this expression spells, else None:
        a plain int literal, ``B ** N`` or ``B << N`` of literals."""
        if isinstance(node, ast.Constant):
            v = node.value
            if isinstance(v, int) and not isinstance(v, bool):
                return v if v in _CERT_LITERALS else None
            return None
        if (
            isinstance(node, ast.BinOp)
            and isinstance(node.op, (ast.Pow, ast.LShift))
            and isinstance(node.left, ast.Constant)
            and isinstance(node.right, ast.Constant)
            and isinstance(node.left.value, int)
            and isinstance(node.right.value, int)
            and 0 <= node.right.value <= 64
        ):
            v = (
                node.left.value**node.right.value
                if isinstance(node.op, ast.Pow)
                else node.left.value << node.right.value
            )
            return v if v in _CERT_LITERALS else None
        return None

    def _scan_cert_literals(self, node: ast.AST, stmt: ast.stmt | None):
        """Walk the tree tracking the smallest enclosing statement; any
        certified-bound literal must find a named ``# cert:`` marker on
        one of that statement's source lines (SEQ013)."""
        if isinstance(node, ast.stmt):
            stmt = node
        val = None if stmt is None else self._cert_literal_value(node)
        if val is not None:
            self._check_cert_marker(stmt, node, val)
            return  # the spelled value is claimed; 2/31 inside 2**31
            # are not independent bounds, and the statement's marker
            # check already ran once for this literal
        for child in ast.iter_child_nodes(node):
            self._scan_cert_literals(child, stmt)

    def _check_cert_marker(self, stmt: ast.stmt, node: ast.AST, val: int):
        end = getattr(stmt, "end_lineno", stmt.lineno)
        for text in self._lines[stmt.lineno - 1 : end]:
            m = _CERT_RE.search(text)
            if m is None:
                continue
            if m.group(1):
                return  # named marker: the bound cites its proof row
            self._emit(
                "SEQ013",
                node,
                f"bare `# cert:` marker on numeric bound {val} names no "
                "RangeCert row — cite the derived_constants row that "
                "re-derives it (scripts/torch_ranges_audit.py; see ops/bounds.py)",
            )
            return
        self._emit(
            "SEQ013",
            node,
            f"numeric overflow bound {val} in hot-path gate/kernel code "
            "carries no `# cert: <row>` marker; wire it through "
            "ops/bounds.py or name the RangeCert derived_constants row "
            "that re-derives it (analysis/ranges.py, scripts/torch_ranges_audit.py)",
        )

    # -- SEQ014: broad handlers prove they are not silent swallows ---------

    @staticmethod
    def _seq014_broad(node: ast.ExceptHandler) -> bool:
        """``except:`` / ``except Exception`` — the handler shapes wide
        enough to swallow ANYTHING the body raises."""
        t = node.type
        if t is None:
            return True
        if isinstance(t, ast.Attribute):
            t = ast.Name(id=t.attr)
        return isinstance(t, ast.Name) and t.id in (
            "Exception",
            "BaseException",
        )

    @staticmethod
    def _seq014_own_stmts(node: ast.ExceptHandler):
        """The handler's OWN statements — nested def/lambda bodies run
        later, not in the except arm, so a raise or log_line inside one
        proves nothing about this handler."""
        todo = list(node.body)
        while todo:
            stmt = todo.pop()
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            yield stmt
            todo.extend(
                child
                for child in ast.iter_child_nodes(stmt)
                if isinstance(child, ast.stmt)
            )

    def visit_ExceptHandler(self, node: ast.ExceptHandler):
        if self.unclassified or not self._seq014_broad(node):
            self.generic_visit(node)
            return
        routed = False
        for stmt in self._seq014_own_stmts(node):
            if isinstance(stmt, ast.Raise):
                self.generic_visit(node)
                return  # re-raise (or typed replacement): not a swallow
            for sub in ast.walk(stmt):
                if not isinstance(sub, ast.Call):
                    continue
                f = sub.func
                name = (
                    f.id
                    if isinstance(f, ast.Name)
                    else f.attr
                    if isinstance(f, ast.Attribute)
                    else None
                )
                if name == "log_line":
                    routed = True
                # Forwarding the BOUND exception into a call hands the
                # event to a classifier (the retry/quarantine ladders:
                # `_block_failed(block, e)`, `_is_resumable(e)`) — a
                # direct Name argument, not an f-string mention, which
                # merely formats the message.
                if node.name is not None and any(
                    isinstance(a, ast.Name) and a.id == node.name
                    for a in [*sub.args, *(k.value for k in sub.keywords)]
                ):
                    routed = True
        if routed:
            self.generic_visit(node)
            return
        end = node.body[-1].end_lineno or node.lineno
        for text in self._lines[node.lineno - 1 : end]:
            m = _ADVISORY_RE.search(text)
            if m is None:
                continue
            if m.group(1):
                self.generic_visit(node)
                return  # reasoned marker: swallowing IS the contract
            self._emit(
                "SEQ014",
                node,
                "bare `# advisory:` marker on a broad except arm gives "
                "no reason — say WHY swallowing is the contract here "
                "(latency optimisation, best-effort diagnostic, ...) so "
                "the exception-flow certifier can audit the swallow "
                "(analysis/exitflow.py, scripts/torch_exitpath_audit.py)",
            )
            self.generic_visit(node)
            return
        self._emit(
            "SEQ014",
            node,
            "broad `except Exception` handler neither re-raises, routes "
            "through log_line, nor carries a reasoned `# advisory: "
            "<why>` marker — a silent swallow is exactly the failure "
            "path the exception-flow certifier exists to retire "
            "(analysis/exitflow.py, scripts/torch_exitpath_audit.py)",
        )
        self.generic_visit(node)

    # -- SEQ008: serve-plane shared state under its lock -------------------

    def visit_ClassDef(self, node: ast.ClassDef):
        guards = self._class_guards(node) if self.in_serve else set()
        if guards:
            for stmt in node.body:
                if (
                    isinstance(
                        stmt, (ast.FunctionDef, ast.AsyncFunctionDef)
                    )
                    and stmt.name != "__init__"
                ):
                    for child in stmt.body:
                        self._scan_guarded(
                            child, node.name, guards, held=False
                        )
        self._class_guard_stack.append(guards)
        self.generic_visit(node)
        self._class_guard_stack.pop()

    @classmethod
    def _class_guards(cls, node: ast.ClassDef) -> set[str]:
        """Attribute names assigned ``threading.Condition()/Lock()/
        RLock()`` (or a bare imported ``Lock()`` etc.) anywhere in the
        class: the class's owning guards."""
        guards: set[str] = set()
        for sub in ast.walk(node):
            if not (
                isinstance(sub, ast.Assign) and cls._is_guard_ctor(sub.value)
            ):
                continue
            for tgt in sub.targets:
                if (
                    isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"
                ):
                    guards.add(tgt.attr)
        return guards

    @staticmethod
    def _self_attr_root(node: ast.AST) -> str | None:
        """The ``X`` of a ``self.X`` / ``self.X[...]`` chain, else None."""
        while isinstance(node, ast.Subscript):
            node = node.value
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
        ):
            return node.attr
        return None

    def _is_guard_enter(self, expr: ast.AST, guards: set[str]) -> bool:
        """``with self.<guard>:`` — the context expression IS a guard
        attribute (Condition/Lock are their own context managers)."""
        return self._self_attr_root(expr) in guards

    def _scan_guarded(self, node, cls: str, guards: set[str], held: bool):
        """Walk one guarded class's method body tracking whether a
        ``with self.<guard>:`` is lexically held, flagging every
        ``self.*`` mutation reached without it (SEQ008)."""
        if isinstance(node, (ast.With, ast.AsyncWith)):
            inner = held or any(
                self._is_guard_enter(item.context_expr, guards)
                for item in node.items
            )
            for child in node.body:
                self._scan_guarded(child, cls, guards, inner)
            return
        if not held:
            mutated = None
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    elts = tgt.elts if isinstance(tgt, (ast.Tuple, ast.List)) else [tgt]
                    for e in elts:
                        e = e.value if isinstance(e, ast.Starred) else e
                        mutated = mutated or self._self_attr_root(e)
            elif isinstance(node, ast.AugAssign):
                mutated = self._self_attr_root(node.target)
            elif isinstance(node, ast.Call):
                func = node.func
                if (
                    isinstance(func, ast.Attribute)
                    and func.attr in _MUTATOR_METHODS
                ):
                    mutated = self._self_attr_root(func.value)
            if mutated is not None:
                self._emit(
                    "SEQ008",
                    node,
                    f"`self.{mutated}` of guarded serve-plane class "
                    f"`{cls}` is mutated outside `with self.<guard>:`; "
                    "reader threads may only json.loads and enqueue — "
                    "every shared-state mutation crosses the owning "
                    "Condition/Lock",
                )
        for child in ast.iter_child_nodes(node):
            self._scan_guarded(child, cls, guards, held)

    # -- SEQ010: blocking ops lexically under a serve lock -----------------

    def _guard_token(self, expr: ast.AST) -> tuple[str, str] | None:
        """``self.X`` where X is an enclosing class's guard, or a local
        name assigned a guard constructor — the lock a ``with`` on this
        expression holds."""
        attr = self._self_attr_root(expr)
        if (
            attr is not None
            and self._class_guard_stack
            and attr in self._class_guard_stack[-1]
        ):
            return ("self", attr)
        if (
            isinstance(expr, ast.Name)
            and self._local_guard_stack
            and expr.id in self._local_guard_stack[-1]
        ):
            return ("local", expr.id)
        return None

    def _enter_with(self, node):
        pushed = 0
        if self.in_serve:
            for item in node.items:
                token = self._guard_token(item.context_expr)
                if token is not None:
                    self._held_guards.append(token)
                    pushed += 1
        self.generic_visit(node)
        del self._held_guards[len(self._held_guards) - pushed:]

    visit_With = _enter_with
    visit_AsyncWith = _enter_with

    @staticmethod
    def _receiver_name(func: ast.Attribute) -> str:
        """The receiver's last name segment, lowercased: ``x`` for
        ``x.post``, ``_board`` for ``self._board.post``."""
        base = func.value
        if isinstance(base, ast.Attribute):
            return base.attr.lower()
        if isinstance(base, ast.Name):
            return base.id.lower()
        return ""

    def _seq010_blocking(self, node: ast.Call) -> str | None:
        """Classify one call as a blocking op for SEQ010 (None = not
        blocking).  ``block_until`` is handled separately — it is legal
        on the held lock itself."""
        func = node.func
        if isinstance(func, ast.Name):
            if func.id == "open":
                return "file I/O (open)"
            if func.id == "board_read_json":
                return "board file I/O (board_read_json)"
            if func.id == "Popen":
                return "subprocess (Popen)"
            return None
        if not isinstance(func, ast.Attribute):
            return None
        attr = func.attr
        recv = self._receiver_name(func)
        if attr in _SEQ010_SOCKET_ATTRS:
            return f"socket .{attr}()"
        if attr in _SEQ010_SOCKETISH_SEND and (
            "sock" in recv or "conn" in recv
        ):
            return f"socket .{attr}()"
        if attr in _SEQ010_BOARD_ATTRS and "board" in recv:
            return f"board file I/O (.{attr}())"
        if recv == "os" and attr in _SEQ010_OS_ATTRS:
            return f"file I/O (os.{attr})"
        if recv == "subprocess" or attr == "Popen":
            return f"subprocess ({attr})"
        if recv == "shutil":
            return f"file I/O (shutil.{attr})"
        return None

    def _check_seq010(self, node: ast.Call) -> None:
        if not (self.in_serve and self._held_guards):
            return
        func = node.func
        if isinstance(func, ast.Attribute) and func.attr == "block_until":
            # Waiting ON the held lock releases it while waiting
            # (Condition.wait_for) — that is the pop_ready/_pause
            # pattern.  Waiting on anything else keeps the held lock
            # pinned through the whole wait.
            if node.args and self._guard_token(node.args[0]) == (
                self._held_guards[-1]
            ):
                return
            self._emit(
                "SEQ010",
                node,
                "block_until on a condition other than the held lock "
                "keeps that lock pinned through the wait; wait on the "
                "owning Condition itself, or move the wait outside the "
                "`with` body",
            )
            return
        detail = self._seq010_blocking(node)
        if detail is not None:
            held = ".".join(self._held_guards[-1])
            self._emit(
                "SEQ010",
                node,
                f"{detail} lexically inside `with {held}:` stalls every "
                "thread contending that lock behind the operation; "
                "compute the verdict under the lock, do the blocking "
                "work after releasing it (see RequestQueue.submit and "
                "analysis/lockgraph.py rule b)",
            )

    # -- SEQ004: bare assert ----------------------------------------------

    def visit_Assert(self, node: ast.Assert):
        self._emit(
            "SEQ004",
            node,
            "bare assert in a runtime path vanishes under python -O; "
            "raise RuntimeError with an actionable message",
        )
        self.generic_visit(node)

    # -- SEQ003 state: track device tensors -------------------------------

    def visit_Assign(self, node: ast.Assign):
        scope = self.scope
        if scope is not None and _is_device_expr(node.value, scope):
            for tgt in node.targets:
                for sub in ast.walk(tgt):
                    if isinstance(sub, ast.Name):
                        scope.device_names.add(sub.id)
        self.generic_visit(node)

    # -- SEQ003: Python branch on a device tensor ---------------------------

    def _check_branch(self, node):
        scope = self.scope
        if scope is not None and _is_device_expr(node.test, scope):
            self._emit(
                "SEQ003",
                node,
                f"Python branch on a device tensor in `{scope.name}`: reading "
                "its value syncs the launch queue — keep the decision on the "
                "host (lengths and table magnitudes are known there) or use "
                "torch.where",
            )
        self.generic_visit(node)

    visit_If = _check_branch
    visit_While = _check_branch

    # -- SEQ001 / SEQ002 / SEQ005: calls -----------------------------------

    def visit_Call(self, node: ast.Call):
        func = node.func
        scope = self.scope

        # SEQ001: host syncs on the hot path.
        if scope is not None:
            if isinstance(func, ast.Attribute) and func.attr in (
                "item", "cpu", "tolist", "numpy",
            ):
                self._emit(
                    "SEQ001",
                    node,
                    f".{func.attr}() on the hot path `{scope.name}` copies the "
                    "value to the host and waits for the launch queue; keep it "
                    "on the device, or decide from host data",
                )
            if (
                isinstance(func, ast.Attribute)
                and func.attr == "synchronize"
                and _root_name(func) == "torch"
            ):
                self._emit(
                    "SEQ001",
                    node,
                    f"torch.cuda.synchronize() on the hot path `{scope.name}` "
                    "drains the launch queue per call; wait on the result's "
                    "event where it is fetched (dispatch.wait_event)",
                )
            if (
                isinstance(func, ast.Name)
                and func.id in ("float", "int", "bool")
                and node.args
                and not isinstance(node.args[0], ast.Constant)
                and _is_device_expr(node.args[0], scope)
            ):
                self._emit(
                    "SEQ001",
                    node,
                    f"{func.id}() of a device tensor in `{scope.name}` forces "
                    "a host sync; decide from host data",
                )

        # SEQ002: env reads outside the registry.
        if not self.is_env_home:
            is_environ = (
                isinstance(func, ast.Attribute)
                and isinstance(func.value, ast.Attribute)
                and isinstance(func.value.value, ast.Name)
                and func.value.value.id == "os"
                and func.value.attr == "environ"
            )  # os.environ.get(...)
            is_getenv = (
                isinstance(func, ast.Attribute)
                and isinstance(func.value, ast.Name)
                and func.value.id == "os"
                and func.attr == "getenv"
            ) or (isinstance(func, ast.Name) and func.id == "getenv")
            if is_environ or is_getenv:
                self._emit(
                    "SEQ002",
                    node,
                    "environment read outside utils/env.py; add the "
                    "variable to the env registry (utils.env.ENV_VARS) and "
                    "use its typed accessor",
                )

        # SEQ005: wall-clock in deterministic paths.
        if self.in_deterministic and isinstance(func, ast.Attribute):
            base = func.value
            if (
                isinstance(base, ast.Name)
                and (base.id, func.attr) in _WALLCLOCK_ATTRS
            ) or (
                isinstance(base, ast.Attribute)
                and (base.attr, func.attr) in _WALLCLOCK_ATTRS
            ):
                self._emit(
                    "SEQ005",
                    node,
                    "wall-clock read in a deterministic resilience/"
                    "journal path; decisions must replay identically — "
                    "derive from the seeded policy state instead",
                )

        # SEQ006: direct stderr prints in instrumented modules.
        if (
            self.in_instrumented
            and isinstance(func, ast.Name)
            and func.id == "print"
        ):
            for kw in node.keywords:
                v = kw.value
                if (
                    kw.arg == "file"
                    and isinstance(v, ast.Attribute)
                    and v.attr == "stderr"
                ):
                    self._emit(
                        "SEQ006",
                        node,
                        "direct stderr print in an instrumented module "
                        "bypasses the observability plane; emit through "
                        "obs.events.log_line (same bytes on stderr, plus "
                        "a `log` event when the bus is armed)",
                    )

        # SEQ007: bare blocking waits in the serving plane.
        if self.in_serve:
            is_sleep = (
                isinstance(func, ast.Attribute)
                and func.attr == "sleep"
                and isinstance(func.value, ast.Name)
                and func.value.id == "time"
            ) or (isinstance(func, ast.Name) and func.id == "sleep")
            is_wait = isinstance(func, ast.Attribute) and func.attr in (
                "wait",
                "wait_for",
            )
            if is_sleep or is_wait:
                self._emit(
                    "SEQ007",
                    node,
                    "bare blocking wait in the serving plane; route the "
                    "wait through the injectable ServeClock.block_until "
                    "(serve/clock.py) so tests drive a fake clock and "
                    "drain signals stay bounded",
                )

        # SEQ015: work-unit board posts must carry trace context.  The
        # payload shape IS the signature: a serialized dict literal with
        # both "bid" and "rows" is a superblock crossing the board (the
        # fleet offer/result protocol) and must propagate "traces" too.
        if self.in_serve:
            is_dumps = (
                isinstance(func, ast.Attribute)
                and func.attr == "dumps"
                and isinstance(func.value, ast.Name)
                and func.value.id == "json"
            ) or (isinstance(func, ast.Name) and func.id == "dumps")
            if is_dumps and node.args and isinstance(node.args[0], ast.Dict):
                keys = {
                    k.value
                    for k in node.args[0].keys
                    if isinstance(k, ast.Constant)
                    and isinstance(k.value, str)
                }
                if {"bid", "rows"} <= keys and "traces" not in keys:
                    self._emit(
                        "SEQ015",
                        node,
                        "work-unit board payload (bid + rows) without a "
                        "`traces` key; propagate the admission-minted "
                        "trace ids over the board so the fleet timeline "
                        "links remote launches back to their requests",
                    )

        # SEQ010: blocking ops lexically under a held serve lock.
        self._check_seq010(node)
        self.generic_visit(node)

    # -- SEQ002: os.environ subscripts / membership ------------------------

    def visit_Subscript(self, node: ast.Subscript):
        if not self.is_env_home:
            v = node.value
            if (
                isinstance(v, ast.Attribute)
                and isinstance(v.value, ast.Name)
                and v.value.id == "os"
                and v.attr == "environ"
            ):
                self._emit(
                    "SEQ002",
                    node,
                    "environment read outside utils/env.py; add the "
                    "variable to the env registry (utils.env.ENV_VARS) and "
                    "use its typed accessor",
                )
        self.generic_visit(node)

    def visit_Compare(self, node: ast.Compare):
        # `"X" in os.environ` membership probes count as reads too.
        if not self.is_env_home:
            for cmp_node, op in zip(node.comparators, node.ops):
                if (
                    isinstance(op, (ast.In, ast.NotIn))
                    and isinstance(cmp_node, ast.Attribute)
                    and isinstance(cmp_node.value, ast.Name)
                    and cmp_node.value.id == "os"
                    and cmp_node.attr == "environ"
                ):
                    self._emit(
                        "SEQ002",
                        node,
                        "os.environ membership probe outside "
                        "utils/env.py; use the env registry's typed "
                        "accessor (utils.env)",
                    )
        self.generic_visit(node)


def lint_file(path: str | Path, package_root: str | Path) -> list[LintFinding]:
    path = Path(path)
    rel = str(path.relative_to(Path(package_root).parent))
    source = path.read_text()
    try:
        tree = ast.parse(source, filename=str(path))
    except SyntaxError as exc:
        return [
            LintFinding("SEQ000", rel, exc.lineno or 0, f"syntax error: {exc}")
        ]
    linter = _Linter(str(path), rel, source)
    linter.visit(tree)
    return sorted(linter.findings, key=lambda f: (f.path, f.line, f.code))


def lint_package(package_root: str | Path | None = None) -> list[LintFinding]:
    """Lint every module of the installed package tree.  scripts/ and
    tests/ are host-side tooling, outside the runtime rules' scope."""
    if package_root is None:
        package_root = Path(__file__).resolve().parent.parent
    package_root = Path(package_root)
    findings: list[LintFinding] = []
    for path in sorted(package_root.rglob("*.py")):
        if "__pycache__" in path.parts:
            continue
        findings.extend(lint_file(path, package_root))
    return findings


def run_or_raise(package_root: str | Path | None = None) -> int:
    """Driver entry: lint the package, raise :class:`LintError` listing
    every finding, return the number of files checked when clean."""
    if package_root is None:
        package_root = Path(__file__).resolve().parent.parent
    findings = lint_package(package_root)
    if findings:
        rows = "\n  ".join(f.describe() for f in findings)
        raise LintError(
            f"seqlint: {len(findings)} violation(s):\n  {rows}\n"
            "Fix the violation or suppress a justified case with "
            "`# seqlint: disable=<code>` and a reason on the line."
        )
    return sum(
        1
        for p in Path(package_root).rglob("*.py")
        if "__pycache__" not in p.parts
    )
