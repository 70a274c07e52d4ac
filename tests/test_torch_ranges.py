"""The port's bounds certifier (``mpi_openmp_cuda_tpu_torch/analysis/
ranges.py``): ``derive_constants`` held against ``ops/bounds.py``, a
seeded drift caught, the ``RangeCert``-shaped record schema-valid and
equal to ``tests/golden/torch_ranges_cert.json``
(``scripts/torch_ranges_audit.py``).  The JAX certifier's jaxpr cases
(``tests/test_ranges.py``) have no counterpart: the port has no jaxprs."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import pytest

from mpi_openmp_cuda_tpu_torch.analysis import RangeCertError, ranges
from mpi_openmp_cuda_tpu_torch.ops import bounds

ROOT = Path(__file__).resolve().parent.parent


def _script():
    spec = importlib.util.spec_from_file_location(
        "torch_ranges_audit", ROOT / "scripts" / "torch_ranges_audit.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class TestDerivedConstants:
    def test_every_constant_certifies(self):
        rows = ranges.derive_constants()
        assert rows and all(r.ok for r in rows), [r for r in rows if not r.ok]

    @pytest.mark.parametrize("name,value", [
        ("int32-max", 2**31 - 1),
        ("int32-sentinel", -(2**31)),
        ("f32-exact-window", 2**24),
        ("seq2-cap-kernel-window", 536870),
        ("admitted-max-value-2000", 1073741),
        ("mm-max-exact-value-2048", 4095),
        ("kernel-max-exact-value-128", 8388607),
        ("mm-matmul-precision", "ieee"),
    ])
    def test_known_values(self, name, value):
        row = {r.name: r for r in ranges.derive_constants()}[name]
        assert row.derived == row.wired == value

    def test_wired_values_come_from_bounds(self):
        rows = {r.name: r for r in ranges.derive_constants()}
        assert rows["int32-max"].wired == bounds.INT32_MAX
        assert rows["f32-exact-window"].wired == bounds.F32_EXACT_WINDOW
        for w in (128, 256, 512, 1024, 2000, 2048):
            assert rows[f"kernel-max-exact-value-{w}"].wired == bounds.max_exact_value(w)
            assert rows[f"mm-max-exact-value-{w}"].wired == bounds.mm_max_exact_value(w)

    def test_format_facts(self):
        assert ranges.FP32_SIGNIFICAND_BITS == 24
        assert ranges.TF32_SIGNIFICAND_BITS == 11
        assert ranges.INT32_BITS == 32

    def test_packed_class_rows_cover_every_class(self):
        from mpi_openmp_cuda_tpu_torch.ops.dispatch import pack_classes

        names = {r.name for r in ranges.derive_constants()}
        assert {f"packed-max-exact-value-{c}" for c in pack_classes()} <= names


class TestSeededDrift:
    def test_drifted_window_is_a_finding(self, monkeypatch):
        monkeypatch.setattr(bounds, "F32_EXACT_WINDOW", 1 << 23)
        cert = ranges.certify()
        names = [f["name"] for f in cert["findings"]]
        assert "f32-exact-window" in names
        assert cert["counts"]["findings"] == len(names) > 0

    def test_drifted_gate_raises(self, monkeypatch):
        monkeypatch.setattr(bounds, "max_exact_value",
                            lambda n: bounds.INT32_MAX // max(int(n), 1))
        with pytest.raises(RangeCertError) as exc:
            ranges.run_or_raise()
        assert "kernel-max-exact-value-128" in str(exc.value)

    def test_tf32_left_on_is_a_finding(self, monkeypatch):
        monkeypatch.setattr(ranges, "_mm_precision", lambda: "tf32")
        names = [f["name"] for f in ranges.certify()["findings"]]
        assert names == ["mm-matmul-precision"]

    def test_row_is_ok_only_when_equal(self):
        assert ranges.DerivedConstant("x", 10, 10).ok
        assert not ranges.DerivedConstant("x", 10, 9).ok
        assert not ranges.DerivedConstant("x", [8, 16], [8, 16, 32]).ok


class TestCertRecord:
    def test_cert_is_schema_valid_and_json(self):
        from mpi_openmp_cuda_tpu_torch.obs.metrics import validate_report, wrap_report

        rec = wrap_report("bounds-cert", ranges.certify())
        validate_report(rec)
        assert json.loads(json.dumps(rec))["counts"]["findings"] == 0

    def test_bad_record_is_rejected(self):
        from mpi_openmp_cuda_tpu_torch.obs.metrics import validate_report, wrap_report

        with pytest.raises(ValueError):
            validate_report(wrap_report("bounds-cert", {"derived_constants": []}))

    def test_matches_committed_golden(self):
        mod = _script()
        report = mod.build_report()
        golden = json.loads(Path(mod.GOLDEN_PATH).read_text())
        assert mod.check(report, golden) == []

    def test_cert_rows_name_the_markers(self):
        assert {"int32-max", "f32-exact-window"} <= ranges.cert_rows()

    def test_bench_record_summarises_the_cert(self):
        from mpi_openmp_cuda_tpu_torch import bench

        rec = bench.ranges_record()
        assert rec["constants_ok"] == rec["constants"] > 0
        assert rec["findings"] == 0
