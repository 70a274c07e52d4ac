"""``scripts/torch_serve_chaos.py`` (the port's counterpart of
``scripts/serve_chaos.py``) on the CPU at the JAX drill's shapes: every
scenario passes, and the port's answers are the JAX package's on the same
request files: the drained journal byte for byte, the usage error and its
known-site list, and the answered ids and typed error kinds of the
overload, poison and client-loss scenarios."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
SCRIPT = REPO / "scripts" / "torch_serve_chaos.py"
SCENARIOS = ("breaker", "poison", "overload", "client-loss", "drain", "usage")
# The faults each scenario runs under (scripts/serve_chaos.py's).
FAULTS = {"overload": "overload-burst:fail=2", "poison": "poison-session:fail=1",
          "client-loss": "dead-socket-midstream:fail=1"}


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    """One ``--device cpu --small`` run: ``(exit code, stdout lines, its
    artifact directory)``."""
    tmp = tmp_path_factory.mktemp("serve_chaos")
    proc = subprocess.run([sys.executable, str(SCRIPT), "--device", "cpu", "--small"],
                          cwd=REPO, env={**os.environ, "TMPDIR": str(tmp)},
                          capture_output=True, text=True, timeout=300)
    (out,) = tmp.glob("torch_serve_chaos_*")
    return proc.returncode, proc.stdout.splitlines() + proc.stderr.splitlines(), out


@pytest.fixture(scope="module")
def jax_runs(drill, tmp_path_factory):
    """The JAX CLI on the drill's request files, all at once: the drain
    (``SEQALIGN_DRAIN=1 --serve --journal``), the usage error, and each
    scenario of :data:`FAULTS` under its fault.  ``{name: (exit code,
    stdout, stderr)}``; the drain's journal under ``"journal"``."""
    _, _, out = drill
    journal = tmp_path_factory.mktemp("jax_drain") / "jax.jsonl"
    argvs = {
        "drain": (["--serve", "--input", out / "drain-a.ndjson", "--journal", journal],
                  {"SEQALIGN_DRAIN": "1"}),
        "usage": (["--serve", "--input", os.devnull, "--faults", "warp-core:fail=1"], {}),
        **{name: (["--serve", "--input", out / f"{name}.ndjson", "--faults", fault], {})
           for name, fault in FAULTS.items()},
    }
    procs = {name: subprocess.Popen(
                 [sys.executable, "-m", "mpi_openmp_cuda_tpu", *map(str, argv)], cwd=REPO,
                 env={**os.environ, "JAX_PLATFORMS": "cpu", "SEQALIGN_BACKOFF_BASE": "0.01",
                      **env}, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for name, (argv, env) in argvs.items()}
    runs: dict = {"journal": journal}
    for name, p in procs.items():
        stdout, stderr = p.communicate(timeout=300)
        runs[name] = (p.returncode, stdout, stderr)
    return runs


def test_small_run_is_ok(drill):
    rc, lines, _ = drill
    assert rc == 0, "\n".join(lines)
    assert [x for x in lines if x.startswith("serve-chaos: OK (")]


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_scenario_passed(drill, scenario):
    rc, lines, _ = drill
    rec = next(json.loads(x) for x in lines if x.startswith('{"device"'))
    assert rec["scenarios"][scenario] == "ok", "\n".join(lines)


def test_drained_journal_is_the_jax_clis(drill, jax_runs):
    """The same requests under ``SEQALIGN_DRAIN=1`` through the JAX CLI's
    ``--serve --journal``: the same journal bytes
    (``mpi_openmp_cuda_tpu.serve-journal.v1``)."""
    _, _, out = drill
    rc, _, err = jax_runs["drain"]
    assert rc == 75, err
    port = (out / "drain-a.jsonl").read_bytes()
    assert b"serve-journal.v1" in port
    assert jax_runs["journal"].read_bytes() == port


def test_usage_error_is_the_jax_clis(jax_runs):
    """Exit 64 and the same known-site list, whichever package."""
    jax_rc, _, jax_err = jax_runs["usage"]
    port = subprocess.run([sys.executable, "-m", "mpi_openmp_cuda_tpu_torch", "--device",
                           "cpu", "--serve", "--input", os.devnull, "--faults",
                           "warp-core:fail=1"], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert jax_rc == port.returncode == 64
    assert "known sites" in port.stderr
    assert port.stderr.split("error: ", 1)[1] == jax_err.split("error: ", 1)[1]


@pytest.mark.parametrize("scenario", sorted(FAULTS))
def test_answers_are_the_jax_clis(drill, jax_runs, scenario):
    """The JAX CLI's ``--serve`` on the scenario's request file under the
    same fault: the same answered ids and the same typed error kinds."""
    _, _, out = drill
    rc, jax_out, err = jax_runs[scenario]
    assert rc == 0, err

    def answers(text):
        recs = [json.loads(x) for x in text.splitlines() if x.strip()]
        done = {r["id"] for r in recs if r.get("done")}
        errors = {r["id"]: r["error"] for r in recs if "error" in r}
        return done, errors

    assert answers((out / f"{scenario}.out.ndjson").read_text()) == answers(jax_out)


def test_without_a_card_it_exits_non_zero(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device can score")
    proc = subprocess.run([sys.executable, str(SCRIPT), "--small"], cwd=REPO,
                          env={**os.environ, "TMPDIR": str(tmp_path)},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1
    assert "no CUDA device is available" in proc.stderr
    assert "OK" not in proc.stdout
