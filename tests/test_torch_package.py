"""The port's public package surface, the twin of ``tests/test_package.py``:
the JAX front door's fifteen names, the lazily exported scorer and
sharding strategies, a domain core that imports no torch, and the README
library example."""

from __future__ import annotations

import importlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import mpi_openmp_cuda_tpu as jpkg
import mpi_openmp_cuda_tpu_torch as pkg
from mpi_openmp_cuda_tpu_torch.utils.env import PROJECT, package_version

# Each exported name and the port module that defines it.
HOMES = {
    "AlignmentScorer": "ops.dispatch",
    "BatchSharding": "parallel.sharding",
    "RingSharding": "parallel.ring",
    "build_class_matrix": "models.classmat",
    "classify_pair": "models.classmat",
    "encode": "models.encoding",
    "encode_normalized": "models.encoding",
    "normalize": "models.encoding",
    "decode": "models.encoding",
    "brute_force_best": "ops.oracle",
    "prefix_best": "ops.oracle",
    "score_batch_oracle": "ops.oracle",
    "signed_weights": "ops.values",
    "value_table": "ops.values",
    "constants": "utils",
}


def test_front_door_names_are_the_jax_packages():
    assert sorted(pkg.__all__) == sorted(jpkg.__all__) == sorted(HOMES)


def test_readme_library_example(monkeypatch):
    """README "Library", on the CPU: eight slots of the host
    (``SEQALIGN_HOST_DEVICES``, the port's forced host device count)."""
    monkeypatch.setenv("SEQALIGN_HOST_DEVICES", "8")
    scorer = pkg.AlignmentScorer(
        "auto", device="cpu", sharding=pkg.BatchSharding.over_devices(8, device="cpu")
    )
    rows = scorer.score("HELLOWORLD", ["OWRL"], [10, 2, 3, 4])
    # Spec PDF p.5 worked pair: OW-RL at offset 4 scores 4 identities.
    assert [tuple(int(x) for x in rows[0])] == [(40, 4, 2)]


def test_lazy_exports_resolve():
    assert pkg.RingSharding.over_devices(seq=1, device="cpu") is not None
    with pytest.raises(AttributeError, match="not_an_export"):
        pkg.not_an_export
    assert not hasattr(pkg, "not_an_export")
    # PEP 562 companion __dir__: lazy names visible to introspection.
    assert {"AlignmentScorer", "BatchSharding", "RingSharding"} <= set(dir(pkg))
    assert set(pkg.__all__) <= set(dir(pkg))


@pytest.mark.parametrize("name", sorted(HOMES))
def test_each_export_is_its_modules_own(name):
    home = importlib.import_module(f"mpi_openmp_cuda_tpu_torch.{HOMES[name]}")
    assert getattr(pkg, name) is getattr(home, name)


def test_domain_core_imports_no_torch():
    """``import mpi_openmp_cuda_tpu_torch`` and the domain core run without
    torch; the first lazy name loads it."""
    code = (
        "import sys\n"
        "import mpi_openmp_cuda_tpu_torch as pkg\n"
        "codes = pkg.encode('HELLOWORLD')\n"
        "assert pkg.prefix_best(codes, pkg.encode('OWRL'), [10, 2, 3, 4]) == (40, 4, 2)\n"
        "assert pkg.value_table([10, 2, 3, 4]).shape == (27, 27)\n"
        "print('torch' in sys.modules)\n"
        "pkg.AlignmentScorer\n"
        "print('torch' in sys.modules)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["False", "True"]


def test_version_is_the_projects():
    pyproject = (Path(__file__).resolve().parent.parent / "pyproject.toml").read_text()
    assert f'version = "{pkg.__version__}"' in pyproject
    assert package_version() == pkg.__version__ and PROJECT in pyproject


# -- the domain core against the JAX package's, on seeded inputs ------------


def _problem(seed: int):
    rng = np.random.default_rng(seed)
    seq1 = rng.integers(1, 27, size=int(rng.integers(20, 90))).astype(np.int8)
    seqs = [rng.integers(1, 27, size=int(n)).astype(np.int8)
            for n in rng.integers(0, 40, size=12)]
    seqs.append(np.concatenate([seq1, seq1[:3]]))  # len2 > len1: the sentinel
    weights = [int(w) for w in rng.integers(-50, 100, size=4)]
    return seq1, seqs, weights


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_oracles_agree_with_the_jax_package(seed):
    seq1, seqs, weights = _problem(seed)
    for q in seqs:
        assert pkg.prefix_best(seq1, q, weights) == jpkg.prefix_best(seq1, q, weights)
    short = seqs[:4]
    for q in short:
        assert pkg.brute_force_best(seq1, q, weights) == jpkg.brute_force_best(seq1, q, weights)
    np.testing.assert_array_equal(pkg.score_batch_oracle(seq1, seqs, weights),
                                  jpkg.score_batch_oracle(seq1, seqs, weights))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tables_agree_with_the_jax_package(seed):
    weights = [int(w) for w in np.random.default_rng(seed).integers(-3000, 3000, size=4)]
    np.testing.assert_array_equal(pkg.signed_weights(weights), jpkg.signed_weights(weights))
    np.testing.assert_array_equal(pkg.value_table(weights), jpkg.value_table(weights))
    np.testing.assert_array_equal(pkg.build_class_matrix(), jpkg.build_class_matrix())


def test_encoding_agrees_with_the_jax_package():
    text = "  HeLLoWorld xyz\n"
    assert pkg.normalize(text) == jpkg.normalize(text)
    np.testing.assert_array_equal(pkg.encode_normalized("HeLLoWorld"),
                                  jpkg.encode_normalized("HeLLoWorld"))
    for bad in ("AB-C", "ABC1"):
        with pytest.raises(ValueError) as port_err:
            pkg.encode(bad)
        with pytest.raises(ValueError) as jax_err:
            jpkg.encode(bad)
        assert str(port_err.value) == str(jax_err.value)
    codes = pkg.encode("HELLOWORLD")
    np.testing.assert_array_equal(codes, jpkg.encode("HELLOWORLD"))
    assert pkg.decode(codes) == jpkg.decode(codes) == "HELLOWORLD"
    for a, b in (("A", "A"), ("S", "T"), ("A", "W"), ("Q", "Z")):
        assert pkg.classify_pair(a, b) == jpkg.classify_pair(a, b)
    assert pkg.constants.PAD_CODE == jpkg.constants.PAD_CODE
