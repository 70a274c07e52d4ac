"""The port's exception-flow certifier (``mpi_openmp_cuda_tpu_torch/
analysis/exitflow.py``), case by case against ``tests/test_exitflow.py``:
each seeded failure-path hazard caught by its owning typed finding, a
marked swallow accepted as a legal sink, and the port's tree pinned at
zero findings with its sink inventory (a non-zero retry-policy count
among it) matching ``tests/golden/torch_exitpath_audit.json``
(``scripts/torch_exitpath_audit.py``).  The port's sinks: its
``RetryPolicy`` reached through a ``*policy.run`` receiver, and the
finally-first flush made through ``_flush_obs``."""

from __future__ import annotations

import json
import textwrap
from pathlib import Path

import pytest

from mpi_openmp_cuda_tpu_torch.analysis import ExitFlowError
from mpi_openmp_cuda_tpu_torch.analysis.exitflow import audit_exitflow, run_or_raise

GOLDEN = Path(__file__).parent / "golden" / "torch_exitpath_audit.json"


def _audit(tmp_path, files: dict[str, str]) -> dict:
    """Audit a seeded snippet tree laid out as a package."""
    root = tmp_path / "pkg"
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return audit_exitflow(root)


def _kinds(report: dict) -> list[str]:
    return [f["kind"] for f in report["findings"]]


class TestSeededHazards:
    """Each failure-path hazard class, seeded synthetically, must be
    caught by its owning finding kind — the certifier fails closed."""

    def test_unclassified_raise(self, tmp_path):
        # A raise that propagates out of the production graph without
        # reaching any sink: the uncaught-escape hazard.
        report = _audit(
            tmp_path,
            {
                "app.py": """
                def helper():
                    raise RuntimeError("boom")

                def main():
                    helper()
                """,
            },
        )
        assert _kinds(report) == ["unclassified-raise"]
        f = report["findings"][0]
        assert "RuntimeError" in f["detail"]

    def test_double_classified(self, tmp_path):
        # A broad arm lexically BEFORE a narrow arm shadows it: the
        # ValueError is claimed by two sinks and the narrow one is dead.
        report = _audit(
            tmp_path,
            {
                "app.py": """
                def work():
                    raise ValueError("x")

                def main():
                    try:
                        work()
                    except Exception:
                        pass  # advisory: seeded broad arm
                    except ValueError:
                        return 1
                """,
            },
        )
        assert _kinds(report) == ["double-classified"]

    def test_flush_bypass(self, tmp_path):
        # run() exits with a non-pre-arm code OUTSIDE the flush try:
        # that exit path drops the run report on the floor.
        report = _audit(
            tmp_path,
            {
                "io/cli.py": """
                def flush_run_report():
                    return None

                def run():
                    try:
                        x = 1
                    finally:
                        flush_run_report()
                    return 65

                def main():
                    run()
                """,
            },
        )
        assert _kinds(report) == ["flush-bypass"]

    def test_tempfail_unrooted(self, tmp_path):
        # Exit 75 means "resume me" — gating it on a plain OSError
        # (no deadline/drain cause-chain predicate) would loop a
        # scheduler forever on a permanent failure.
        report = _audit(
            tmp_path,
            {
                "io/cli.py": """
                EX_TEMPFAIL = 75

                def flush_run_report():
                    return None

                def run():
                    try:
                        return 0
                    except OSError:
                        return EX_TEMPFAIL
                    finally:
                        flush_run_report()

                def main():
                    run()
                """,
            },
        )
        assert _kinds(report) == ["tempfail-unrooted"]

    def test_fault_site_unreachable(self, tmp_path):
        # A registry site with no fire point anywhere: the rename drift
        # that silently turns the chaos runs vacuous for that site.
        report = _audit(
            tmp_path,
            {
                "resilience/faults.py": """
                KNOWN_SITES = frozenset({"chunk_scoring"})

                def fire(site):
                    return False
                """,
                "app.py": """
                def main():
                    return 0
                """,
            },
        )
        assert _kinds(report) == ["fault-site-unreachable"]
        assert "chunk_scoring" in report["findings"][0]["detail"]

    def test_swallow_unmarked(self, tmp_path):
        # A broad except arm that eats everything with neither a
        # re-raise, a log, nor a reasoned `# advisory:` marker.
        report = _audit(
            tmp_path,
            {
                "app.py": """
                def work():
                    raise ValueError("x")

                def main():
                    try:
                        work()
                    except Exception:
                        pass
                """,
            },
        )
        assert "swallow-unmarked" in _kinds(report)

    def test_marked_swallow_is_a_legal_sink(self, tmp_path):
        # The same swallow WITH a reasoned marker classifies clean —
        # the marker is the legal sink for deliberate best-effort arms.
        report = _audit(
            tmp_path,
            {
                "app.py": """
                def work():
                    raise ValueError("x")

                def main():
                    try:
                        work()
                    except Exception:
                        # advisory: seeded best-effort arm for the test
                        pass
                """,
            },
        )
        assert report["findings"] == []
        assert report["sinks"].get("advisory", 0) == 1
        assert report["advisory"] == [
            "app.py: seeded best-effort arm for the test"
        ]

    def test_run_or_raise_lists_findings(self, tmp_path):
        root = tmp_path / "pkg"
        root.mkdir()
        (root / "app.py").write_text(
            textwrap.dedent(
                """
                def helper():
                    raise RuntimeError("boom")

                def main():
                    helper()
                """
            )
        )
        with pytest.raises(ExitFlowError) as exc:
            run_or_raise(root)
        assert "unclassified-raise" in str(exc.value)
        assert "RuntimeError" in str(exc.value)


class TestRealTree:
    """The committed package itself must certify clean — zero escapes,
    zero unmarked swallows, every exit flushed, every fault site live."""

    @pytest.fixture(scope="class")
    def report(self):
        return audit_exitflow()

    def test_zero_findings(self, report):
        assert report["findings"] == []
        assert report["counts"]["findings"] == 0

    def test_every_production_raise_reaches_a_sink(self, report):
        counts = report["counts"]
        assert counts["production_raises"] == sum(
            n for k, n in report["sinks"].items()
            if k not in ("out-of-plane", "import-time")
        )
        # The taxonomy is populated, not vacuous: the retry ladder, the
        # wire replies, and the sysexits map each classify real sites.
        assert report["sinks"]["retry-policy"] >= 10
        assert report["sinks"]["wire-reply"] >= 10
        assert report["sinks"]["exit-map"] >= 30

    def test_flush_contract_held(self, report):
        flush = report["flush"]
        assert set(flush) == {"io/cli.py", "serve/loop.py"}
        assert flush["io/cli.py"]["flush_calls"] == ["_flush_obs"]
        assert flush["io/cli.py"]["protected_returns"] >= 1

    def test_fault_registry_live(self, report):
        fs = report["fault_sites"]
        assert fs["registered"] >= 20
        assert fs["reachable_fire_points"] == fs["fire_points"]

    def test_every_swallow_is_marked_with_a_reason(self, report):
        # Satellite 1's pin: zero unmarked swallows in the committed
        # tree, and every marker carries non-empty reason text.
        assert report["counts"]["advisory_markers"] == len(
            report["advisory"]
        )
        for row in report["advisory"]:
            module, _, reason = row.partition(": ")
            assert module.endswith(".py")
            assert reason.strip()

    def test_matches_committed_golden(self, report):
        # The same drift gate scripts/torch_exitpath_audit.py enforces, pinned in
        # the suite so a stale golden cannot slip past a green CI lane.
        want = json.loads(GOLDEN.read_text())
        assert report["sinks"] == want["sinks"]
        assert report["raise_modules"] == want["raise_modules"]
        assert report["advisory"] == want["advisory"]
        assert report["fault_sites"] == want["fault_sites"]
        assert dict(report["counts"]) == want["counts"]


class TestPortSinks:
    """The port's own sinks: the retry ladder through a ``*policy.run``
    receiver, ``_flush_obs`` as the flush, argparse's pre-arm exit."""

    def test_policy_run_receiver_reaches_the_retry_ladder(self, tmp_path):
        report = _audit(
            tmp_path,
            {
                "resilience/policy.py": """
                class RetryPolicy:
                    def run(self, fn, describe):
                        try:
                            return fn()
                        except Exception as e:
                            raise RuntimeError(describe) from e
                """,
                "io/cli.py": """
                def score():
                    raise RuntimeError("transient")

                def run(policy):
                    return policy.run(lambda: score(), "scoring")

                def main():
                    run(None)
                """,
                "bench.py": "".join(
                    f"def run{i}():\n    return {i}\n" for i in range(8)
                ),
            },
        )
        assert report["sinks"].get("retry-policy", 0) >= 1, report

    def test_flush_obs_is_the_flush(self, tmp_path):
        report = _audit(
            tmp_path,
            {
                "io/cli.py": """
                EX_ARGPARSE = 2

                def _flush_obs():
                    return None

                def run(argv):
                    if argv:
                        return EX_ARGPARSE
                    try:
                        rc = 0
                        return rc
                    finally:
                        _flush_obs()

                def main():
                    run([])
                """,
            },
        )
        assert report["findings"] == [], report["findings"]
        assert report["flush"]["io/cli.py"]["flush_calls"] == ["_flush_obs"]

    def test_retry_policy_sinks_pinned_non_zero(self):
        want = json.loads(GOLDEN.read_text())
        assert want["sinks"]["retry-policy"] > 0
        assert want["findings"] == 0

    def test_undeclared_env_read_is_a_usage_exit(self, monkeypatch, capsys):
        # The KeyError of utils/env.py's registry, before run()'s flush
        # try: main() maps it to 64 with a message, as the JAX CLI does.
        from mpi_openmp_cuda_tpu_torch.io import cli

        def bad(argv=None):
            from mpi_openmp_cuda_tpu_torch.utils.env import env_int

            return env_int("SEQALIGN_NOT_A_KNOB")

        monkeypatch.setattr(cli, "run", bad)
        with pytest.raises(SystemExit) as exc:
            cli.main()
        assert exc.value.code == 64
        assert "usage:" in capsys.readouterr().err
