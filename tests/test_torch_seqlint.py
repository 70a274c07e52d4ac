"""The port's seqlint (``mpi_openmp_cuda_tpu_torch/analysis/seqlint.py``),
case by case against ``tests/test_seqlint.py`` with the port's scopes: the
real package must be clean, and each rule must catch its seeded violation
(and honour suppressions).  SEQ001/SEQ003 police the launch hot path (the
CUDA wrappers, ``dispatch.run_launch``, the ``--check`` hook); the env
registry is ``utils/env.py``; SEQ011/SEQ012 are absent (no ``jax.jit``,
no ``jax.lax`` collectives in the port)."""

from __future__ import annotations

import textwrap

import pytest

from mpi_openmp_cuda_tpu_torch.analysis import LintError
from mpi_openmp_cuda_tpu_torch.analysis import seqlint


def _lint_snippet(tmp_path, rel, source):
    """Write ``source`` at pkg/<rel> under tmp_path and lint it with the
    same path-keyed rule scoping as the real package tree."""
    root = tmp_path / "pkg"
    path = root / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source))
    return seqlint.lint_file(path, root)


class TestPackageIsClean:
    def test_zero_findings(self):
        findings = seqlint.lint_package()
        assert findings == [], "\n".join(f.describe() for f in findings)

    def test_run_or_raise_counts_files(self):
        assert seqlint.run_or_raise() > 30

    def test_analysis_tree_is_suppression_free(self):
        # ISSUE 3 acceptance: analysis/ earns no new suppressions.  The
        # suppression syntax may appear in docstrings/regexes (seqlint
        # documents its own grammar) — only ACTIVE suppressions count,
        # and those are exactly what _suppressions() parses.
        from pathlib import Path

        import mpi_openmp_cuda_tpu_torch.analysis as pkg

        for path in Path(pkg.__file__).parent.glob("*.py"):
            per_line, file_level = seqlint._suppressions(path.read_text())
            active = set(file_level)
            for codes in per_line.values():
                active |= codes
            active.discard("SEQ00N")  # the docstring's placeholder code
            assert not active, (path, active)


class TestSeq001HostSync:
    def test_item_in_a_kernel_wrapper(self, tmp_path):
        findings = _lint_snippet(
            tmp_path,
            "ops/foo.py",
            """
            def fused_scorer(state):
                return state.rows.sum().item()
            """,
        )
        assert [f.code for f in findings] == ["SEQ001"]
        assert ".item()" in findings[0].message

    @pytest.mark.parametrize("call", ["cpu", "tolist", "numpy"])
    def test_host_copies_in_run_launch(self, tmp_path, call):
        findings = _lint_snippet(
            tmp_path,
            "ops/foo.py",
            f"""
            def run_launch(launch, backend):
                return launch.state.rows.{call}()
            """,
        )
        assert [f.code for f in findings] == ["SEQ001"]
        assert f".{call}()" in findings[0].message

    def test_synchronize_in_the_check_hook(self, tmp_path):
        findings = _lint_snippet(
            tmp_path,
            "analysis/contracts.py",
            """
            import torch

            def validate_plans(val_flat, plans, backend, device=None):
                torch.cuda.synchronize()
            """,
        )
        assert [f.code for f in findings] == ["SEQ001"]
        assert "synchronize" in findings[0].message

    def test_int_of_a_device_tensor(self, tmp_path):
        findings = _lint_snippet(
            tmp_path,
            "parallel/foo.py",
            """
            import torch

            def run_launch(launch, backend):
                raw = torch.zeros(4)
                return int(raw.max())
            """,
        )
        assert [f.code for f in findings] == ["SEQ001"]

    def test_host_helpers_are_out_of_scope(self, tmp_path):
        # Same calls OUTSIDE a hot function name / hot module: clean.
        assert not _lint_snippet(
            tmp_path,
            "ops/foo.py",
            """
            def materialise_results(x):
                return x.sum().item()
            """,
        )
        assert not _lint_snippet(
            tmp_path,
            "io/foo.py",
            """
            def fused_scorer(x):
                return x.sum().item()
            """,
        )

    def test_int_of_host_metadata_is_fine(self, tmp_path):
        assert not _lint_snippet(
            tmp_path,
            "ops/foo.py",
            """
            def call_entry(fn, state):
                b, l2p = state.rows.shape
                return int(state.rows.shape[0]) + int(l2p)
            """,
        )


class TestSeq002EnvReads:
    @pytest.mark.parametrize(
        "line",
        [
            "os.environ.get('X')",
            "os.environ['X']",
            "os.getenv('X')",
            "'X' in os.environ",
        ],
    )
    def test_env_read_forms(self, tmp_path, line):
        findings = _lint_snippet(
            tmp_path, "io/foo.py", f"import os\n\nv = {line}\n"
        )
        assert [f.code for f in findings] == ["SEQ002"]
        assert "utils/env.py" in findings[0].message

    def test_env_module_is_the_legal_home(self, tmp_path):
        assert not _lint_snippet(
            tmp_path,
            "utils/env.py",
            "import os\n\nv = os.environ.get('X')\n",
        )


class TestSeq003DeviceBranch:
    def test_if_on_a_device_tensor(self, tmp_path):
        findings = _lint_snippet(
            tmp_path,
            "ops/foo.py",
            """
            import torch

            def run_launch(launch, backend):
                m = torch.max(launch.state.lens)
                if m > 0:
                    return m
                return None
            """,
        )
        assert [f.code for f in findings] == ["SEQ003"]
        assert "torch.where" in findings[0].message

    def test_branch_on_a_state_field_value(self, tmp_path):
        findings = _lint_snippet(
            tmp_path,
            "ops/foo.py",
            """
            def packed_scorer(state, l2s):
                while state.lens.max() > l2s:
                    l2s *= 2
                return l2s
            """,
        )
        assert [f.code for f in findings] == ["SEQ003"]

    def test_static_branch_is_fine(self, tmp_path):
        assert not _lint_snippet(
            tmp_path,
            "ops/foo.py",
            """
            def fused_scorer(state, wide):
                if wide > 1:
                    return state
                if state.rows.shape[1] % 4 or state.rows.dtype is None:
                    return None
                return state
            """,
        )

    def test_comprehension_of_metadata_is_host_data(self, tmp_path):
        assert not _lint_snippet(
            tmp_path,
            "ops/foo.py",
            """
            def _device_of(state):
                devs = {t.device for t in (state.rows, state.lens)}
                if len(devs) != 1:
                    raise ValueError("several devices")
                return devs.pop().type
            """,
        )


class TestSeq004BareAssert:
    def test_assert_anywhere_in_package(self, tmp_path):
        findings = _lint_snippet(
            tmp_path, "models/foo.py", "def f(x):\n    assert x > 0\n"
        )
        assert [f.code for f in findings] == ["SEQ004"]
        assert "python -O" in findings[0].message


class TestSeq005WallClock:
    def test_time_time_in_resilience(self, tmp_path):
        findings = _lint_snippet(
            tmp_path,
            "resilience/foo.py",
            "import time\n\ndef delay():\n    return time.time()\n",
        )
        assert [f.code for f in findings] == ["SEQ005"]
        assert "replay" in findings[0].message

    def test_sleep_is_allowed(self, tmp_path):
        # sleep delays, it does not decide: determinism is unaffected.
        assert not _lint_snippet(
            tmp_path,
            "resilience/foo.py",
            "import time\n\ndef delay():\n    time.sleep(0.1)\n",
        )

    def test_wall_clock_fine_outside_deterministic_paths(self, tmp_path):
        assert not _lint_snippet(
            tmp_path,
            "utils/timing.py",
            "import time\n\ndef now():\n    return time.perf_counter()\n",
        )


class TestSeq006StderrBypass:
    def test_direct_stderr_print_in_instrumented_module(self, tmp_path):
        findings = _lint_snippet(
            tmp_path,
            "resilience/foo.py",
            """
            import sys

            def warn(msg):
                print(msg, file=sys.stderr)
            """,
        )
        assert [f.code for f in findings] == ["SEQ006"]
        assert "log_line" in findings[0].message

    def test_plain_print_is_out_of_scope(self, tmp_path):
        # Only the stderr diagnostic channel must ride the bus; stdout is
        # the result stream and has its own byte-exact contract.
        assert not _lint_snippet(
            tmp_path,
            "resilience/foo.py",
            "import sys\n\ndef out(msg):\n    print(msg)\n",
        )

    def test_uninstrumented_modules_are_out_of_scope(self, tmp_path):
        assert not _lint_snippet(
            tmp_path,
            "io/foo.py",
            "import sys\n\ndef warn(m):\n    print(m, file=sys.stderr)\n",
        )

    @pytest.mark.parametrize(
        "rel",
        ["utils/journal.py", "ops/dispatch.py", "parallel/distributed.py"],
    )
    def test_every_instrumented_path_is_covered(self, tmp_path, rel):
        findings = _lint_snippet(
            tmp_path,
            rel,
            "import sys\n\ndef warn(m):\n    print(m, file=sys.stderr)\n",
        )
        assert [f.code for f in findings] == ["SEQ006"]


class TestSeq007BlockingWaits:
    def test_time_sleep_in_serve(self, tmp_path):
        findings = _lint_snippet(
            tmp_path,
            "serve/foo.py",
            "import time\n\ndef poll():\n    time.sleep(0.1)\n",
        )
        assert [f.code for f in findings] == ["SEQ007"]
        assert "ServeClock.block_until" in findings[0].message

    def test_condition_wait_forms_in_serve(self, tmp_path):
        findings = _lint_snippet(
            tmp_path,
            "serve/foo.py",
            """
            def poll(cond):
                cond.wait(0.1)
                cond.wait_for(lambda: True, timeout=0.1)
            """,
        )
        assert [f.code for f in findings] == ["SEQ007", "SEQ007"]

    def test_clock_module_is_the_legal_home(self, tmp_path):
        assert not _lint_snippet(
            tmp_path,
            "serve/clock.py",
            """
            def block_until(cond, predicate, timeout_s):
                return cond.wait_for(predicate, timeout=timeout_s)
            """,
        )

    def test_sleep_outside_serve_is_out_of_scope(self, tmp_path):
        # resilience/ backoff sleeps stay legal (SEQ005 explicitly
        # allows them: they delay, they do not decide).
        assert not _lint_snippet(
            tmp_path,
            "resilience/foo.py",
            "import time\n\ndef delay():\n    time.sleep(0.1)\n",
        )

    def test_serve_queue_is_on_the_seq005_list(self, tmp_path):
        # Admission decisions must be clock-free: SEQ005 now covers
        # serve/queue.py too.
        findings = _lint_snippet(
            tmp_path,
            "serve/queue.py",
            "import time\n\ndef admit():\n    return time.monotonic()\n",
        )
        assert "SEQ005" in [f.code for f in findings]


class TestSeq008SharedState:
    def test_unguarded_mutation_in_guarded_class(self, tmp_path):
        findings = _lint_snippet(
            tmp_path,
            "serve/foo.py",
            """
            import threading

            class Q:
                def __init__(self):
                    self._cond = threading.Condition()
                    self._items = []

                def submit(self, x):
                    self._items.append(x)
            """,
        )
        assert [f.code for f in findings] == ["SEQ008"]
        assert "json.loads" in findings[0].message  # the reader contract

    def test_guarded_mutation_is_clean(self, tmp_path):
        assert not _lint_snippet(
            tmp_path,
            "serve/foo.py",
            """
            import threading

            class Q:
                def __init__(self):
                    self._cond = threading.Condition()
                    self._items = []

                def submit(self, x):
                    with self._cond:
                        self._items.append(x)
                        self._seq = 1
            """,
        )

    def test_tuple_and_slice_targets_are_mutations(self, tmp_path):
        # The pop idiom: `popped, self._items[:n] = self._items[:n], []`
        # rebinding through a tuple/slice target is still shared-state
        # mutation and must hold the lock.
        findings = _lint_snippet(
            tmp_path,
            "serve/foo.py",
            """
            import threading

            class Q:
                def __init__(self):
                    self._lock = threading.Lock()
                    self._items = []

                def pop(self, n):
                    popped, self._items[:n] = self._items[:n], []
                    return popped
            """,
        )
        assert [f.code for f in findings] == ["SEQ008"]

    def test_init_is_exempt(self, tmp_path):
        # Construction happens before the object is shared; __init__
        # assigns freely (that is where the guard itself is born).
        assert not _lint_snippet(
            tmp_path,
            "serve/foo.py",
            """
            import threading

            class Q:
                def __init__(self, depth):
                    self._cond = threading.Condition()
                    self.max_depth = int(depth)
                    self._items = []
            """,
        )

    def test_unguarded_class_is_out_of_scope(self, tmp_path):
        # Session-style classes confined to the main loop thread own no
        # lock — SEQ008 only polices classes that DECLARE a guard.
        assert not _lint_snippet(
            tmp_path,
            "serve/foo.py",
            """
            class Session:
                def fill(self, j, row):
                    self._have[j] = True
                    self._emitted += 1
            """,
        )

    def test_outside_serve_is_out_of_scope(self, tmp_path):
        assert not _lint_snippet(
            tmp_path,
            "resilience/foo.py",
            """
            import threading

            class Q:
                def __init__(self):
                    self._lock = threading.Lock()
                    self._items = []

                def submit(self, x):
                    self._items.append(x)
            """,
        )

    def test_mutator_method_call_flagged(self, tmp_path):
        findings = _lint_snippet(
            tmp_path,
            "serve/foo.py",
            """
            import threading

            class Q:
                def __init__(self):
                    self._lock = threading.Lock()
                    self._seen = set()

                def mark(self, x):
                    self._seen.add(x)
            """,
        )
        assert [f.code for f in findings] == ["SEQ008"]


class TestModuleClassification:
    def test_every_package_module_is_classified(self):
        # SEQ009's real-tree contract: a module the registry does not
        # know about escapes every scoped rule — adding a module MUST
        # come with a deliberate classification.
        from pathlib import Path

        root = Path(seqlint.__file__).resolve().parent.parent
        for path in sorted(root.rglob("*.py")):
            if "__pycache__" in path.parts:
                continue
            rel = str(path.relative_to(root.parent))
            assert seqlint.module_roles(rel) is not None, rel

    def test_unclassified_module_is_a_finding(self, tmp_path):
        findings = _lint_snippet(tmp_path, "rogue.py", "x = 1\n")
        assert [f.code for f in findings] == ["SEQ009"]
        assert "_MODULE_CLASSES" in findings[0].message

    def test_pr6_modules_are_now_classified(self):
        # The drift this registry exists to fix: PR 6 shipped these
        # without touching any rule list.
        assert seqlint.module_roles("pkg/io/pipeline.py") == (
            seqlint.ROLE_INSTRUMENTED,
        )
        assert seqlint.ROLE_SERVE in seqlint.module_roles(
            "pkg/serve/loop.py"
        )
        assert seqlint.ROLE_INSTRUMENTED in seqlint.module_roles(
            "pkg/serve/session.py"
        )
        assert seqlint.ROLE_DETERMINISTIC in seqlint.module_roles(
            "pkg/serve/queue.py"
        )
        assert seqlint.module_roles("pkg/serve/clock.py") == (
            seqlint.ROLE_WAIT_HOME,
        )

    def test_exact_entry_overrides_directory(self):
        assert seqlint.ROLE_INSTRUMENTED in seqlint.module_roles(
            "pkg/ops/dispatch.py"
        )
        assert seqlint.module_roles("pkg/ops/other.py") == (
            seqlint.ROLE_HOT,
        )


class TestSuppressions:
    def test_per_line_disable(self, tmp_path):
        assert not _lint_snippet(
            tmp_path,
            "io/foo.py",
            "import os\n\nv = os.getenv('X')  # seqlint: disable=SEQ002\n",
        )

    def test_file_level_disable(self, tmp_path):
        assert not _lint_snippet(
            tmp_path,
            "models/foo.py",
            "# seqlint: disable-file=SEQ004\n\ndef f(x):\n    assert x\n",
        )

    def test_disable_is_rule_specific(self, tmp_path):
        findings = _lint_snippet(
            tmp_path,
            "io/foo.py",
            "import os\n\nv = os.getenv('X')  # seqlint: disable=SEQ004\n",
        )
        assert [f.code for f in findings] == ["SEQ002"]


class TestDriver:
    def test_run_or_raise_lists_findings(self, tmp_path):
        root = tmp_path / "pkg"
        (root / "io").mkdir(parents=True)
        (root / "io" / "bad.py").write_text("import os\nv = os.getenv('X')\n")
        with pytest.raises(LintError) as ei:
            seqlint.run_or_raise(root)
        msg = str(ei.value)
        assert "SEQ002" in msg and "bad.py:2" in msg
        assert "seqlint: disable" in msg  # tells the reader how to suppress

    def test_syntax_error_reported_not_raised(self, tmp_path):
        findings = _lint_snippet(tmp_path, "io/broken.py", "def f(:\n")
        assert [f.code for f in findings] == ["SEQ000"]


class TestSeq010BlockingUnderLock:
    def test_board_post_under_lock(self, tmp_path):
        findings = _lint_snippet(
            tmp_path,
            "serve/foo.py",
            """
            import threading

            class W:
                def __init__(self, board):
                    self._lock = threading.Lock()
                    self._board = board

                def publish(self, key, val):
                    with self._lock:
                        self._board.post(key, val)
            """,
        )
        assert [f.code for f in findings] == ["SEQ010"]
        assert "board file I/O" in findings[0].message

    def test_socket_accept_under_lock(self, tmp_path):
        findings = _lint_snippet(
            tmp_path,
            "serve/foo.py",
            """
            import threading

            class L:
                def __init__(self, sock):
                    self._lock = threading.Lock()
                    self._sock = sock

                def take(self):
                    with self._lock:
                        return self._sock.accept()
            """,
        )
        assert [f.code for f in findings] == ["SEQ010"]
        assert ".accept()" in findings[0].message

    def test_open_under_local_lock(self, tmp_path):
        # Function-local locks count too (the loop.py release_lock
        # shape) — file I/O inside the with body is still a stall.
        findings = _lint_snippet(
            tmp_path,
            "serve/foo.py",
            """
            import threading

            def journal(path, line):
                lock = threading.Lock()
                with lock:
                    with open(path, "a") as fh:
                        fh.write(line)
            """,
        )
        assert [f.code for f in findings] == ["SEQ010"]
        assert "open" in findings[0].message

    def test_subprocess_and_os_ops_under_lock(self, tmp_path):
        findings = _lint_snippet(
            tmp_path,
            "serve/foo.py",
            """
            import os
            import subprocess
            import threading

            class D:
                def __init__(self):
                    self._cond = threading.Condition()

                def rotate(self, a, b):
                    with self._cond:
                        os.replace(a, b)
                        subprocess.run(["sync"])
            """,
        )
        assert sorted(f.code for f in findings) == ["SEQ010", "SEQ010"]

    def test_block_until_on_foreign_lock(self, tmp_path):
        findings = _lint_snippet(
            tmp_path,
            "serve/foo.py",
            """
            import threading

            class Q:
                def __init__(self, clock):
                    self._lock = threading.Lock()
                    self._cond = threading.Condition()
                    self._clock = clock
                    self._n = 0

                def wait_other(self):
                    with self._lock:
                        self._clock.block_until(
                            self._cond, lambda: True, 1.0
                        )
            """,
        )
        assert [f.code for f in findings] == ["SEQ010"]
        assert "block_until" in findings[0].message

    def test_block_until_on_held_lock_is_legal(self, tmp_path):
        # The pop_ready/_pause pattern: Condition.wait_for RELEASES the
        # lock it waits on — waiting on the held guard is the designed
        # serve-plane wait, not a stall.
        assert not _lint_snippet(
            tmp_path,
            "serve/foo.py",
            """
            import threading

            class Q:
                def __init__(self, clock):
                    self._cond = threading.Condition()
                    self._clock = clock
                    self._items = []

                def pop(self):
                    with self._cond:
                        self._clock.block_until(
                            self._cond, lambda: bool(self._items), 1.0
                        )
                        popped, self._items[:] = list(self._items), []
                        return popped
            """,
        )

    def test_stream_write_under_lock_is_legal(self, tmp_path):
        # Responder.send: serialising .write/.flush on the locked stream
        # is the lock's PURPOSE (bounded by SO_SNDTIMEO), not a finding.
        assert not _lint_snippet(
            tmp_path,
            "serve/foo.py",
            """
            import threading

            class R:
                def __init__(self, out):
                    self._lock = threading.Lock()
                    self._out = out

                def send(self, line):
                    with self._lock:
                        self._out.write(line)
                        self._out.flush()
            """,
        )

    def test_blocking_after_release_is_legal(self, tmp_path):
        # The hoist pattern SEQ010 pushes toward: verdict under the
        # lock, blocking work after it.
        assert not _lint_snippet(
            tmp_path,
            "serve/foo.py",
            """
            import threading

            class W:
                def __init__(self, board):
                    self._lock = threading.Lock()
                    self._board = board
                    self._n = 0

                def publish(self, key, val):
                    with self._lock:
                        self._n += 1
                    self._board.post(key, val)
            """,
        )

    def test_nested_def_under_lock_is_not_held(self, tmp_path):
        # A closure defined inside a with body runs later, not under
        # the lock — lexical held state stops at the function boundary.
        assert not _lint_snippet(
            tmp_path,
            "serve/foo.py",
            """
            import threading

            class W:
                def __init__(self, board):
                    self._lock = threading.Lock()
                    self._board = board
                    self._flush = None

                def arm(self, key, val):
                    with self._lock:
                        def flush():
                            self._board.post(key, val)
                        self._flush = flush
            """,
        )

    def test_outside_serve_plane_is_out_of_scope(self, tmp_path):
        # SEQ010 is the serve-plane lock discipline; host modules may
        # hold a lock across file I/O (e.g. an atomic cache write).
        assert not _lint_snippet(
            tmp_path,
            "io/foo.py",
            """
            import threading

            class C:
                def __init__(self):
                    self._lock = threading.Lock()

                def save(self, path, data):
                    with self._lock:
                        with open(path, "w") as fh:
                            fh.write(data)
            """,
        )


class TestAbsentJaxRules:
    """SEQ011 and SEQ012 police JAX constructs the port does not have; the
    port's seqlint lists them as absent and reports neither."""

    @pytest.mark.parametrize(
        "rel,source",
        [
            ("ops/foo.py", "import jax\n\nENTRY = jax.jit(lambda x: x)\n"),
            ("ops/foo.py", "from jax import jit\n\nENTRY = jit(abs)\n"),
            ("ops/foo.py", "from jax import lax\n\ndef f(x):\n    return lax.psum(x, 'b')\n"),
            ("io/foo.py", "import jax\n\ndef f(x):\n    return jax.lax.all_gather(x, 'b')\n"),
            ("parallel/foo.py", "from jax import lax\n\ndef f(x):\n    return lax.ppermute(x, 'seq', [])\n"),
        ],
    )
    def test_jit_and_lax_collective_forms_report_nothing(self, tmp_path, rel, source):
        findings = _lint_snippet(tmp_path, rel, source)
        assert not [f for f in findings if f.code in ("SEQ011", "SEQ012")]

    def test_docstring_lists_them_as_absent(self):
        doc = seqlint.__doc__
        assert "Absent" in doc and "SEQ011" in doc and "SEQ012" in doc

    def test_no_collective_role_or_jit_rule(self):
        assert not hasattr(seqlint, "ROLE_COLLECTIVE_HOME")
        assert not hasattr(seqlint, "_COLLECTIVE_NAMES")
        assert not hasattr(seqlint._Linter, "_check_jit_donation")


class TestSeq013CertMarkers:
    def test_unmarked_bound_in_hot_code(self, tmp_path):
        findings = _lint_snippet(
            tmp_path,
            "ops/foo.py",
            """
            CEILING = 2147483647
            """,
        )
        assert [f.code for f in findings] == ["SEQ013"]
        assert "2147483647" in findings[0].message
        assert "ops/bounds.py" in findings[0].message

    def test_pow_and_shift_spellings_match(self, tmp_path):
        findings = _lint_snippet(
            tmp_path,
            "ops/foo.py",
            """
            WRAP = 2**31
            WINDOW = 1 << 24
            """,
        )
        assert [f.code for f in findings] == ["SEQ013", "SEQ013"]
        assert "2147483648" in findings[0].message
        assert "16777216" in findings[1].message

    def test_inner_literal_of_int32_ceiling_matches(self, tmp_path):
        # 2**31 - 1 spells the int32 ceiling via its inner 2**31.
        findings = _lint_snippet(
            tmp_path,
            "ops/foo.py",
            """
            CEILING = 2**31 - 1
            """,
        )
        assert [f.code for f in findings] == ["SEQ013"]

    def test_named_marker_is_clean(self, tmp_path):
        assert not _lint_snippet(
            tmp_path,
            "ops/foo.py",
            """
            CEILING = 2147483647  # cert: int32-max
            WINDOW = 1 << 24  # cert: f32-exact-window
            """,
        )

    def test_marker_anywhere_on_multiline_statement(self, tmp_path):
        assert not _lint_snippet(
            tmp_path,
            "ops/foo.py",
            """
            def gate(v):
                return min(
                    v,
                    2**31 - 1,  # cert: int32-max
                )
            """,
        )

    def test_bare_marker_is_a_finding(self, tmp_path):
        findings = _lint_snippet(
            tmp_path,
            "ops/foo.py",
            """
            CEILING = 2147483647  # cert:
            """,
        )
        assert [f.code for f in findings] == ["SEQ013"]
        assert "bare" in findings[0].message

    def test_host_modules_are_out_of_scope(self, tmp_path):
        assert not _lint_snippet(
            tmp_path,
            "models/foo.py",
            """
            REPORT_CEILING = 2147483647
            """,
        )

    def test_unrelated_literals_are_fine(self, tmp_path):
        assert not _lint_snippet(
            tmp_path,
            "ops/foo.py",
            """
            BLOCK = 128
            LANES = 8 * 128
            OPT_IN = 232448
            """,
        )

    def test_suppression_honoured(self, tmp_path):
        assert not _lint_snippet(
            tmp_path,
            "ops/foo.py",
            """
            CEILING = 2147483647  # seqlint: disable=SEQ013
            """,
        )

    def test_ranges_pass_is_classified_host(self):
        roles = seqlint.module_roles("pkg/analysis/ranges.py")
        assert roles == (seqlint.ROLE_HOST,)

    def test_literal_set_covers_the_wired_bounds(self):
        from mpi_openmp_cuda_tpu_torch.ops import bounds

        for v in (bounds.F32_EXACT_WINDOW, bounds.INT32_MAX, bounds.INT32_MAX + 1):
            assert v in seqlint._CERT_LITERALS, v

    def test_the_trees_markers_name_real_cert_rows(self):
        # Every `# cert: <row>` in the port names a row analysis/ranges.py
        # derives: the three literals of ops/bounds.py and cuda_scorer.py.
        import re
        from pathlib import Path

        from mpi_openmp_cuda_tpu_torch.analysis import ranges

        rows = ranges.cert_rows()
        root = Path(seqlint.__file__).resolve().parent.parent
        named = []
        for path in sorted(root.rglob("*.py")):
            for line in path.read_text().splitlines():
                m = re.search(r"#\s*cert:\s*(\S+)", line)
                if m and "analysis" not in path.parts:
                    named.append(m.group(1))
        assert len(named) == 3 and set(named) <= rows, named


class TestSeq014BroadSwallows:
    """Broad except arms must prove they are not silent swallows:
    re-raise, log_line, forwarding the bound exception into a
    classifier, or a reasoned `# advisory:` marker (SEQ014)."""

    def test_unmarked_broad_swallow(self, tmp_path):
        findings = _lint_snippet(
            tmp_path,
            "ops/foo.py",
            """
            def probe():
                try:
                    risky()
                except Exception:
                    return None
            """,
        )
        assert [f.code for f in findings] == ["SEQ014"]

    def test_bare_except_swallow(self, tmp_path):
        findings = _lint_snippet(
            tmp_path,
            "serve/foo.py",
            """
            def probe():
                try:
                    risky()
                except:  # noqa: E722
                    pass
            """,
        )
        assert [f.code for f in findings] == ["SEQ014"]

    def test_bare_advisory_marker_is_a_finding(self, tmp_path):
        # A marker with no reason text documents nothing — exactly the
        # bare-`# cert:` / bare-`# nodonate:` precedent.
        findings = _lint_snippet(
            tmp_path,
            "obs/foo.py",
            """
            def probe():
                try:
                    risky()
                except Exception:
                    # advisory:
                    return None
            """,
        )
        assert [f.code for f in findings] == ["SEQ014"]
        assert "no reason" in findings[0].message

    def test_base_exception_swallow(self, tmp_path):
        findings = _lint_snippet(
            tmp_path,
            "resilience/foo.py",
            """
            def probe():
                try:
                    risky()
                except BaseException:
                    return None
            """,
        )
        assert [f.code for f in findings] == ["SEQ014"]

    def test_nested_def_raise_does_not_satisfy(self, tmp_path):
        # A raise inside a nested def runs LATER, not in the except
        # arm — it proves nothing about this handler's swallow.
        findings = _lint_snippet(
            tmp_path,
            "ops/foo.py",
            """
            def probe():
                try:
                    risky()
                except Exception:
                    def fail():
                        raise RuntimeError("later")
                    return fail
            """,
        )
        assert [f.code for f in findings] == ["SEQ014"]

    def test_reasoned_marker_is_clean(self, tmp_path):
        assert not _lint_snippet(
            tmp_path,
            "ops/foo.py",
            """
            def probe():
                try:
                    risky()
                except Exception:
                    # advisory: best-effort probe only — None falls back
                    return None
            """,
        )

    def test_reraise_log_line_and_forwarding_are_clean(self, tmp_path):
        assert not _lint_snippet(
            tmp_path,
            "serve/foo.py",
            """
            def a():
                try:
                    risky()
                except Exception:
                    raise

            def b():
                try:
                    risky()
                except Exception as e:
                    log_line(f"failed ({e})")

            def c(block):
                try:
                    risky()
                except Exception as e:
                    _block_failed(block, e)
            """,
        )

    def test_narrow_handlers_are_out_of_scope(self, tmp_path):
        assert not _lint_snippet(
            tmp_path,
            "ops/foo.py",
            """
            def probe():
                try:
                    risky()
                except (OSError, ValueError):
                    return None
            """,
        )

    def test_suppression_honoured(self, tmp_path):
        assert not _lint_snippet(
            tmp_path,
            "ops/foo.py",
            """
            def probe():
                try:
                    risky()
                except Exception:  # seqlint: disable=SEQ014
                    return None
            """,
        )

    def test_exitflow_pass_is_classified_host(self):
        # The certifier CLASSIFIES handlers (it never swallows in one),
        # so it lives under the host role on purpose.
        roles = seqlint.module_roles("pkg/analysis/exitflow.py")
        assert roles == (seqlint.ROLE_HOST,)


class TestSeq015WorkUnitTraceContext:
    """Serve-plane board posts that carry a superblock (bid + rows)
    must propagate trace context — a `traces` key (SEQ015)."""

    def test_offer_shaped_payload_without_traces(self, tmp_path):
        findings = _lint_snippet(
            tmp_path,
            "serve/foo.py",
            """
            import json

            def post_offer(board, key, bid, block):
                board.post(key, json.dumps({
                    "bid": bid,
                    "epoch": 0,
                    "rows": [list(c) for c in block.codes],
                }))
            """,
        )
        assert [f.code for f in findings] == ["SEQ015"]

    def test_result_shaped_payload_without_traces(self, tmp_path):
        # The bare-name import spelling is the same post.
        findings = _lint_snippet(
            tmp_path,
            "serve/foo.py",
            """
            from json import dumps

            def post_result(board, key, bid, wid, rows):
                board.post(key, dumps({
                    "bid": bid,
                    "wid": wid,
                    "rows": rows.tolist(),
                }))
            """,
        )
        assert [f.code for f in findings] == ["SEQ015"]

    def test_payload_with_traces_is_clean(self, tmp_path):
        assert not _lint_snippet(
            tmp_path,
            "serve/foo.py",
            """
            import json

            def post_offer(board, key, bid, block, traces):
                board.post(key, json.dumps({
                    "bid": bid,
                    "rows": [list(c) for c in block.codes],
                    "traces": traces,
                }))
            """,
        )

    def test_control_posts_are_out_of_scope(self, tmp_path):
        # Claims/heartbeats/checkpoints carry no rows: not work units.
        assert not _lint_snippet(
            tmp_path,
            "serve/foo.py",
            """
            import json

            def post_claim(board, key, wid, epoch):
                board.post(key, json.dumps({"wid": wid, "epoch": epoch}))
            """,
        )

    def test_host_modules_are_out_of_scope(self, tmp_path):
        # The rule polices the serving plane; a host-side tool writing
        # a bid+rows blob to its own report is not a board post.
        assert not _lint_snippet(
            tmp_path,
            "analysis/foo.py",
            """
            import json

            def write(path, bid, rows):
                open(path, "w").write(json.dumps({"bid": bid, "rows": rows}))
            """,
        )

    def test_suppression_honoured(self, tmp_path):
        assert not _lint_snippet(
            tmp_path,
            "serve/foo.py",
            """
            import json

            def post_offer(board, key, bid, rows):
                board.post(key, json.dumps({  # seqlint: disable=SEQ015
                    "bid": bid,
                    "rows": rows,
                }))
            """,
        )
