"""A benchmark root at a size the CPU runs in seconds: a copy of
``BENCHMARK.json`` and ``seqbench/`` with two tiny cells added, one a
configuration kind, made only by adding files and entries."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]

TINY_BATCH = {"seq1_len": 60, "seq2_per_job": 6, "seq2_len": [3, 50], "homolog_share": 0.5,
              "homolog_mutation": 0.06, "pool_jobs": 4, "warm_jobs": 1, "check_jobs": 4}
TINY_SERVE = {"rate_rps": 15, "arrival": "poisson", "clients": 3,
              "problems": [{"name": "a", "weights": [100, 2, 3, 4], "seq1_len": 80, "seq2_count": 3,
                            "seq2_len": [30, 70], "homolog_share": 0.5, "homolog_mutation": 0.06},
                           {"name": "b", "weights": [2, 2, 1, 10], "seq1_len": 40, "seq2_count": 2,
                            "seq2_len": [3, 10]},
                           {"name": "c", "weights": [10, 2, 3, 4], "seq1_len": 12, "seq2_count": 1,
                            "seq2_len": [11, 11], "homolog_share": 1.0, "homolog_mutation": 0.0}],
              "warm_requests": 4, "check_requests": 6, "grace_s": 4}


def add_cell(root: Path, name: str, config: str, traffic: dict) -> None:
    """A new cell: its traffic file and its ``BENCHMARK.json`` entries."""
    (root / "seqbench" / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": name, "config": config, "traffic": name, "chips": 1,
                               "why": "a CPU test"})
    kind = json.loads((root / "seqbench" / "configs" / f"{config}.json").read_text())["kind"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and any(w.startswith(kind) for w in m["workloads"]):
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))


def make_root(tmp: Path) -> Path:
    root = tmp / "checkout"
    root.mkdir()
    shutil.copy(REPO / "BENCHMARK.json", root)
    shutil.copytree(REPO / "seqbench", root / "seqbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    add_cell(root, "tiny-batch", "spec-batch", TINY_BATCH)
    add_cell(root, "tiny-serve", "spec-serve", TINY_SERVE)
    return root


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return make_root(tmp_path)
