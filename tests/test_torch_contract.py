"""The port's host contract layer against its JAX-package twins: constants,
groups, class matrix, encoding, value table, oracle, parse, printer and the
dispatch planning helpers, on every fixture and on seeded random inputs."""

from __future__ import annotations

import io
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import mpi_openmp_cuda_tpu_torch as tpkg
from mpi_openmp_cuda_tpu.io import parse as jparse
from mpi_openmp_cuda_tpu.io import printer as jprinter
from mpi_openmp_cuda_tpu.models import classmat as jclassmat
from mpi_openmp_cuda_tpu.models import encoding as jencoding
from mpi_openmp_cuda_tpu.models import groups as jgroups
from mpi_openmp_cuda_tpu.ops import dispatch as jdispatch
from mpi_openmp_cuda_tpu.ops import oracle as joracle
from mpi_openmp_cuda_tpu.ops import values as jvalues
from mpi_openmp_cuda_tpu.utils import constants as jconstants
from mpi_openmp_cuda_tpu_torch.io import parse as tparse
from mpi_openmp_cuda_tpu_torch.io import printer as tprinter
from mpi_openmp_cuda_tpu_torch.models import classmat as tclassmat
from mpi_openmp_cuda_tpu_torch.models import encoding as tencoding
from mpi_openmp_cuda_tpu_torch.models import groups as tgroups
from mpi_openmp_cuda_tpu_torch.ops import dispatch as tdispatch
from mpi_openmp_cuda_tpu_torch.ops import schedule as tschedule
from mpi_openmp_cuda_tpu_torch.ops import oracle as toracle
from mpi_openmp_cuda_tpu_torch.ops import values as tvalues
from mpi_openmp_cuda_tpu_torch.utils import constants as tconstants

FIXTURES = sorted(
    (Path(__file__).parent / "fixtures").glob("*.txt"), key=lambda p: p.name
)
WEIGHT_SETS = [[10, 2, 3, 4], [4, 3, 2, 1], [127, 2, 3, 4], [3000, 7, 1, 2], [0, 0, 0, 0]]


def _ids(paths):
    return [p.stem for p in paths]


def test_seven_fixtures_present():
    assert len(FIXTURES) == 7


def test_constants_match():
    names = [n for n in dir(jconstants) if n.isupper()]
    assert names
    for name in names:
        assert getattr(tconstants, name) == getattr(jconstants, name), name


def test_groups_match():
    assert tgroups.CONSERVATIVE_GROUPS == jgroups.CONSERVATIVE_GROUPS
    assert tgroups.SEMI_CONSERVATIVE_GROUPS == jgroups.SEMI_CONSERVATIVE_GROUPS


def test_class_matrix_matches():
    np.testing.assert_array_equal(
        tclassmat.build_class_matrix(), jclassmat.build_class_matrix()
    )
    for a in "ANSQ":
        for b in "AGKY":
            assert tclassmat.classify_pair(a, b) == jclassmat.classify_pair(a, b)


@pytest.mark.parametrize("weights", WEIGHT_SETS)
def test_value_table_matches(weights):
    got = tvalues.value_table(weights)
    want = jvalues.value_table(weights)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tvalues.signed_weights(weights), jvalues.signed_weights(weights)
    )
    assert tvalues.max_abs_value(got) == jvalues.max_abs_value(want)
    assert tpkg.value_table is tvalues.value_table


@pytest.mark.parametrize("text", ["A", "gattaca", "  MixedCase ", "ZYXWV", ""])
def test_encoding_matches(text):
    got = tencoding.encode_normalized(text)
    want = jencoding.encode_normalized(text)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert tencoding.decode(got) == jencoding.decode(want)
    np.testing.assert_array_equal(tencoding.pad_to(got, 12), jencoding.pad_to(want, 12))
    np.testing.assert_array_equal(tpkg.encode(text.strip().upper()), want)


@pytest.mark.parametrize("bad", ["AB1", "é", "A-B"])
def test_encoding_rejects_like_jax(bad):
    with pytest.raises(jencoding.InvalidSequenceError) as jerr:
        jencoding.encode_normalized(bad)
    with pytest.raises(tencoding.InvalidSequenceError) as terr:
        tencoding.encode_normalized(bad)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_oracle_matches(seed):
    rng = np.random.default_rng(seed)
    seq1 = rng.integers(1, 27, size=40)
    seqs = [rng.integers(1, 27, size=int(n)) for n in rng.integers(0, 43, size=8)]
    w = [5, 1, 2, 3]
    assert toracle.score_batch_oracle(seq1, seqs, w) == joracle.score_batch_oracle(
        seq1, seqs, w
    )
    for s in seqs[:3]:
        assert toracle.brute_force_best(seq1, s, w) == joracle.brute_force_best(
            seq1, s, w
        )
    assert tpkg.prefix_best is toracle.prefix_best


@pytest.mark.parametrize("path", FIXTURES, ids=_ids(FIXTURES))
def test_parse_matches_on_fixture(path):
    got = tparse.load_problem(str(path))
    want = jparse.load_problem(str(path))
    assert got.weights == want.weights
    assert got.seq1 == want.seq1
    assert got.seq2 == want.seq2
    assert got.num_seq2 == want.num_seq2
    np.testing.assert_array_equal(got.seq1_codes, want.seq1_codes)
    assert len(got.seq2_codes) == len(want.seq2_codes)
    for a, b in zip(got.seq2_codes, want.seq2_codes):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize(
    "text",
    ["1 2 3", "1 2 x 4 AAA 1 A", "1 2 3 4 AAA -1", "1 2 3 4 AAA 2 A",
     "1 2 3 4 AAA n A", "1 2 3 2147483648 AAA 1 A", "1 2 3 4 A1A 1 A"],
)
def test_parse_rejects_like_jax(text):
    with pytest.raises(ValueError) as jerr:
        jparse.parse_problem(io.StringIO(text))
    with pytest.raises(ValueError) as terr:
        tparse.parse_problem(io.StringIO(text))
    assert type(terr.value).__name__ == type(jerr.value).__name__
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("path", FIXTURES, ids=_ids(FIXTURES))
def test_printer_matches_on_fixture(path):
    golden = path.with_suffix(".out").read_text()
    rows = [
        tuple(int(x.rstrip(",")) for x in line.split()[2::2])
        for line in golden.splitlines()
    ]
    got, want = io.StringIO(), io.StringIO()
    tprinter.print_results(rows, out=got)
    jprinter.print_results(rows, out=want)
    assert got.getvalue() == want.getvalue() == golden
    for i, (s, n, k) in enumerate(rows):
        assert tprinter.format_result(i, s, n, k) == jprinter.format_result(i, s, n, k)


def test_guarded_stdout_routes_fd1_to_stderr(capfd):
    with tprinter.guarded_stdout() as out:
        os.write(1, b"chatter\n")
        print("#0: score: 1, n: 0, k: 0", file=out)
    cap = capfd.readouterr()
    assert cap.out == "#0: score: 1, n: 0, k: 0\n"
    assert "chatter" in cap.err


def test_json_sidecar_matches(tmp_path):
    rows = [(5, 1, 2), (-3, 0, 0)]
    tprinter.write_json_sidecar(rows, tmp_path / "t.json", meta={"a": 1})
    jprinter.write_json_sidecar(rows, tmp_path / "j.json", meta={"a": 1})
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()


@pytest.mark.parametrize("path", FIXTURES, ids=_ids(FIXTURES))
def test_padding_and_buckets_match_on_fixture(path):
    """Same padded bytes, buckets and packing classes as the JAX package's
    pallas path plans for its i8 feed (every fixture's weights are |v| <= 127),
    both in the planning helpers and in the launches the scorer makes."""
    prob = tparse.load_problem(str(path))
    sizes = [c.size for c in prob.seq2_codes]
    got_groups = tdispatch.plan_buckets(sizes)
    want_groups = jdispatch.plan_buckets(
        sizes, packable=True, classes=jdispatch.pack_classes("i8")
    )
    assert got_groups == want_groups
    assert tdispatch.pack_classes() == jdispatch.pack_classes("i8")
    launches = tdispatch.bucket_launches(
        prob.seq1_codes, prob.seq2_codes, prob.weights, torch.device("cpu")
    )
    # One launch a launch group: the planner's partition of the JAX buckets.
    parts = tschedule.plan_fusion_groups(want_groups, sizes, prob.seq1_codes.size)
    assert [b.keys for b in launches] == parts
    assert [b.idx.tolist() for b in launches] == [
        sorted(i for k in part for i in want_groups[k]) for part in parts
    ]
    singles = tdispatch.bucket_launches(
        prob.seq1_codes, prob.seq2_codes, prob.weights, torch.device("cpu"), fuse=False
    )
    assert [b.idx.tolist() for b in singles] == [
        sorted(want_groups[k]) for k in sorted(want_groups)
    ]
    for launch in launches + singles:
        codes = [prob.seq2_codes[i] for i in launch.idx]
        got = tdispatch.pad_problem(prob.seq1_codes, codes)
        want = jdispatch.pad_problem(prob.seq1_codes, codes)
        for field in ("seq1ext", "seq2", "len2"):
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
        assert (got.len1, got.l1p, got.l2p) == (want.len1, want.l1p, want.l2p)
        st = launch.state
        np.testing.assert_array_equal(st.seq1ext.numpy(), want.seq1ext)
        np.testing.assert_array_equal(st.rows.numpy(), want.seq2)
        np.testing.assert_array_equal(st.lens.numpy(), want.len2)
        want_l2s = jdispatch.choose_rowpack("i8", want.l2p, want.len2)
        assert tdispatch.choose_rowpack(got.l2p, got.len2) == want_l2s
        assert launch.l2s == want_l2s  # off the card every admissible bucket packs
        for a, b in zip(
            tdispatch.pad_batch_rows(got, got.batch_size + 3),
            jdispatch.pad_batch_rows(want, want.batch_size + 3),
        ):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize(
    "sizes", [[1] * 9 + [200] * 8, [64, 65, 8, 9, 2000], [128] * 3, [5] * 8 + [33] * 8]
)
def test_plan_buckets_matches(sizes):
    assert tdispatch.plan_buckets(sizes) == jdispatch.plan_buckets(
        sizes, packable=True, classes=jdispatch.pack_classes("i8")
    )

