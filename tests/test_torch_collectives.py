"""The port's comms audit (``analysis/collectives.py``) over
``parallel/comm.py``'s per-slot logs and the ``parallel/`` source, held
against ``tests/test_collectives.py`` where the contract carries over: the
inventory per slot, ordering consistency, hygiene, the ring cross-check,
the golden, the schema, seeded hazards, and one two-process ``gloo`` job
whose ``ProcessCollectives`` sequences equal the one-process run's.

JAX tests with no counterpart here, and why: ``TestHloParser`` and
``test_implicit_reshard_on_large_intermediate`` /
``test_annotated_counterpart_not_flagged`` read collectives the SPMD
partitioner inserts into optimized HLO; the port has no partitioner, every
collective is a logged call (a crossing outside ``comm.py`` is the
``device-crossing`` finding instead).  ``test_scan_multiplies_count`` and
``test_collective_under_while_fails_closed`` walk jaxpr control flow; the
port's static form is the rank-dependent-branch pass.  ``test_unregistered_
axis`` has none either: the port's collectives take no axis name (``shift``
and ``all_gather`` act on the mesh's ``seq`` rows by construction), and
``test_small_host_operand_is_fine`` guards a bare host array entering a
``shard_map``; the port's shards are placed by hand, and every operand's
device is checked instead.
"""

from __future__ import annotations

import json
import os
import shutil
import socket
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mpi_openmp_cuda_tpu.analysis import collectives as jcollectives
from mpi_openmp_cuda_tpu.parallel.ring import ring_plan as jring_plan
from mpi_openmp_cuda_tpu_torch.analysis import CollectiveAuditError, collectives, costmodel
from mpi_openmp_cuda_tpu_torch.obs.metrics import validate_report, wrap_report
from mpi_openmp_cuda_tpu_torch.ops.dispatch import pad_problem
from mpi_openmp_cuda_tpu_torch.parallel.ring import ring_plan

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "mpi_openmp_cuda_tpu_torch"
GOLDEN = REPO / "tests" / "golden" / "torch_comms_audit.json"


@pytest.fixture(scope="module")
def real_audit():
    return collectives.audit_collectives()


# -- the real tree -------------------------------------------------------------------


class TestRealTree:
    def test_zero_findings(self, real_audit):
        assert real_audit["findings"] == []

    def test_every_spec_form_audited(self, real_audit):
        assert [e["spec"] for e in real_audit["entries"]] == list(collectives.AUDIT_SPECS)

    def test_batch_mesh_gathers_once_and_collects_nothing_in_the_compute(self, real_audit):
        for e in real_audit["entries"][:2]:
            assert e["counts"] == {"gather": 1}
            assert [op["kind"] for op in e["collectives"]] == ["gather"]
            assert e["collectives"][0]["elements"] == 6 * 3  # the [B, 3] rows

    def test_ring_inventory_nonempty_and_crosschecked(self, real_audit):
        rings = [e for e in real_audit["entries"] if "seq" in e["mesh_axes"]]
        assert len(rings) == 2
        for e in rings:
            kinds = [op["kind"] for op in e["collectives"]]
            assert kinds == ["shift", "shift", "all_gather", "gather"]
        assert [r["match"] for r in real_audit["ring_crosscheck"]] == [True, True]

    def test_positions_consistent(self, real_audit):
        for e in real_audit["entries"]:
            assert e["consistent"]
            assert e["positions"] == collectives.AUDIT_SPECS[e["spec"]]
            assert {p["signature"] for p in e["per_position"]} == {e["signature"]}

    def test_slot_logs_partition_the_flat_log(self):
        sh, _, _ = collectives.run_spec("2x2", [torch.device("cpu")] * 4)
        comm = sh.comm
        shifts = sum(1 for s in comm.slot_log.values() for op in s if op[0] == "shift")
        assert shifts == comm.counts["shift"] == len([k for k, _ in comm.log if k == "shift"])
        # The ring shifts uint8 Seq1 codes; the candidates and rows are int32.
        assert all(b == (1 if k == "shift" else 4) * e
                   for s in comm.slot_log.values() for k, e, b in s)

    def test_rows_equal_the_one_device_scorer(self):
        from mpi_openmp_cuda_tpu_torch.ops.dispatch import AlignmentScorer

        seq1, seqs, w = collectives.representative_problem()
        want = AlignmentScorer("cuda", device="cpu").score_codes(seq1, seqs, w)
        for spec, n in collectives.AUDIT_SPECS.items():
            _, rows, _ = collectives.run_spec(spec, [torch.device("cpu")] * n)
            assert np.array_equal(rows, want), spec

    def test_scaling_rows_finite_for_2_4_8(self, real_audit):
        rows = real_audit["comms"]["scaling"]
        assert sorted({r["mesh"] for r in rows}) == [2, 4, 8]
        assert all(np.isfinite(r["predicted_scaling_efficiency"]) for r in rows)
        assert real_audit["comms"]["measured"] is False

    def test_golden_cross_check(self):
        import importlib.util

        spec = importlib.util.spec_from_file_location(
            "torch_comms_audit", REPO / "scripts" / "torch_comms_audit.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert mod.check(mod.build_report(), json.loads(GOLDEN.read_text())) == []

    def test_report_schema_valid_in_both_packages(self, real_audit):
        from mpi_openmp_cuda_tpu.obs.metrics import validate_report as jvalidate

        rec = wrap_report("comms-audit", json.loads(json.dumps(real_audit)))
        validate_report(rec)
        jvalidate(rec)

    def test_run_or_raise_clean(self):
        assert collectives.run_or_raise()["counts"]["findings"] == 0


def test_representative_batch_is_the_jax_audits():
    """The same rng stream, lengths and weights as the JAX audit's batch."""
    batch, val_flat = jcollectives._representative_batch()
    seq1, seqs, weights = collectives.representative_problem()
    ours = pad_problem(seq1, seqs)
    assert np.array_equal(ours.seq1ext, np.asarray(batch.seq1ext))
    assert np.array_equal(ours.seq2, np.asarray(batch.seq2))
    assert (ours.l1p, ours.l2p) == (batch.l1p, batch.l2p) == (256, 128)
    assert tuple(weights) == jcollectives._REP_WEIGHTS


@pytest.mark.parametrize("spec", ["seq:4", "2x2"])
def test_ring_r_equals_the_jax_plan_with_the_kernel(spec):
    sp = 4 if spec == "seq:4" else 2
    r = ring_plan(256, 128, sp, kernel=True)[1]
    assert r == jring_plan(256, 128, sp, pallas=True)[1] == 2
    seq1, seqs, weights = collectives.representative_problem()
    sheet = costmodel.schedule_cost_sheet(
        SimpleNamespace(seq1_codes=seq1, seq2_codes=seqs, weights=weights))
    assert [row["ring_steps"] for row in sheet["comms"]["scaling"]
            if row["axis"] == "seq" and row["mesh"] == sp] == [[r]]


# -- seeded hazards ------------------------------------------------------------------


def _seeded_package(tmp_path, name, text):
    root = tmp_path / "pkg"
    shutil.copytree(PKG / "parallel", root / "parallel")
    with open(root / "parallel" / name, "a") as f:
        f.write("\n\n" + text)
    return root


def test_collective_under_a_rank_branch_is_divergent(tmp_path):
    root = _seeded_package(tmp_path, "sharding.py", (
        "def seeded(self, blocks):\n"
        "    if self.comm.rank == 0:\n"
        "        blocks = self.comm.shift(blocks)\n"
        "    return blocks\n"))
    (f,) = collectives.divergent_branches(root)
    assert f["kind"] == "divergent-sequence" and f["entry"] == "parallel/sharding.py:seeded"
    assert collectives.divergent_branches(PKG) == []


def test_helper_reaching_a_collective_under_is_coordinator_is_divergent(tmp_path):
    root = _seeded_package(tmp_path, "distributed.py", (
        "def seeded(arr):\n"
        "    return _bcast(arr) if is_coordinator() else arr\n"))
    (f,) = collectives.divergent_branches(root)
    assert "_bcast" in f["detail"]


def test_uniform_branch_is_clean(tmp_path):
    root = _seeded_package(tmp_path, "sharding.py", (
        "def seeded(self, blocks, n):\n"
        "    if n > 1:\n"
        "        blocks = self.comm.shift(blocks)\n"
        "    return blocks\n"))
    assert collectives.divergent_branches(root) == []


def test_device_crossing_outside_comm_is_a_finding(tmp_path):
    root = _seeded_package(tmp_path, "ring.py", (
        "def seeded(t, dev):\n"
        "    return t.to(dev)\n"))
    (f,) = collectives.device_crossings(root)
    assert f["kind"] == "device-crossing" and "seeded" in f["entry"]
    assert collectives.device_crossings(PKG) == []


def test_operand_off_its_slots_device_is_unsharded():
    from mpi_openmp_cuda_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(2, devices=[torch.device("cpu")] * 2)
    calls = [{torch.device("cpu")}, {torch.device("cpu"), torch.device("meta")}]
    (f,) = collectives.operand_placement("seeded", calls, mesh, [0, 1])
    assert f["kind"] == "unsharded-operand" and "slot 1" in f["detail"]


def test_ring_plan_drift(monkeypatch):
    from mpi_openmp_cuda_tpu_torch.parallel import ring

    entries, _ = collectives.audit_spec_entries()
    monkeypatch.setattr(ring, "ring_plan", lambda l1p, l2p, sp, kernel: (64, 3))
    _, findings = collectives.ring_crosscheck(entries)
    assert {f["kind"] for f in findings} == {"ring-plan-drift"} and len(findings) == 2


def test_divergent_slot_sequences_are_found(monkeypatch):
    from mpi_openmp_cuda_tpu_torch.parallel import comm

    real = comm.LocalCollectives.all_gather

    def lopsided(self, parts):
        out = real(self, parts)
        self._note("broadcast", 1, 4, [0])  # slot 0 alone
        return out

    monkeypatch.setattr(comm.LocalCollectives, "all_gather", lopsided)
    _, findings = collectives.audit_spec_entries()
    kinds = {f["kind"] for f in findings}
    assert "divergent-sequence" in kinds and "inventory-drift" in kinds


def test_run_or_raise_names_findings(monkeypatch):
    monkeypatch.setattr(collectives, "audit_collectives", lambda root=None: {
        "entries": [{"collectives": [1]}], "findings": [
            {"kind": "divergent-sequence", "entry": "x", "detail": "y"}]})
    with pytest.raises(CollectiveAuditError, match=r"\[divergent-sequence\] x: y"):
        collectives.run_or_raise()


def test_run_or_raise_rejects_an_empty_inventory(monkeypatch):
    monkeypatch.setattr(collectives, "audit_collectives", lambda root=None: {
        "entries": [{"collectives": []}], "findings": []})
    with pytest.raises(CollectiveAuditError, match="ZERO collectives"):
        collectives.run_or_raise()


# -- two processes over gloo ------------------------------------------------------------

_RANK_SCRIPT = """
import json, sys
sys.path.insert(0, {repo!r})
from mpi_openmp_cuda_tpu_torch.analysis import collectives
from mpi_openmp_cuda_tpu_torch.parallel import distributed
distributed.initialize_distributed("cpu")
out = {{}}
for spec in ("2", "seq:2"):
    sh, rows, _ = collectives.run_spec(spec)
    out[spec] = {{"seq": sh.comm.slot_log[sh.comm.rank], "rows": rows.tolist()}}
print(json.dumps(out))
distributed.shutdown_distributed()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_process_collectives_equal_local_collectives_over_gloo():
    """Each rank's ``ProcessCollectives`` sequence at ``--mesh 2`` and
    ``seq:2`` equals its slot's in the one-process ``LocalCollectives``
    run, and both score the same rows."""
    port = _free_port()
    procs = []
    for rank in (0, 1):
        env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
               "WORLD_SIZE": "2", "RANK": str(rank), "LOCAL_RANK": str(rank)}
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _RANK_SCRIPT.format(repo=str(REPO))], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        outs.append(json.loads(out.strip().splitlines()[-1]))
    for spec in ("2", "seq:2"):
        sh, rows, _ = collectives.run_spec(spec, [torch.device("cpu")] * 2)
        for rank in (0, 1):
            got = outs[rank][spec]
            assert [tuple(op) for op in got["seq"]] == sh.comm.slot_log[rank], (spec, rank)
            assert got["rows"] == rows.tolist()


def test_signature_is_order_sensitive():
    a = [("shift", 128, 512), ("all_gather", 96, 384)]
    assert collectives.signature(a) != collectives.signature(a[::-1])
    assert collectives.signature(a) == collectives.signature(list(a))


def test_bench_comms_record_is_marked_unmeasured():
    from mpi_openmp_cuda_tpu_torch.bench import comms_record
    from mpi_openmp_cuda_tpu_torch.models.workload import input3_class_problem

    rec = comms_record(input3_class_problem())
    assert rec["measured"] is False and rec["link_gbytes_s"] == 450.0
    assert (rec["entries"], rec["findings"]) == (4, 0) and rec["collectives"] > 0
    assert [r["mesh"] for r in rec["scaling"]] == [2, 2, 4, 4, 8, 8]
