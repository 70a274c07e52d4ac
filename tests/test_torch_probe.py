"""The issue-rate probe (``csrc/issue_probe.cu``, ``ops/probe.py``) and the
stage ablation (``csrc/ablate_scorer.cu``, ``scripts/torch_kernel_ablate.py``)
on the CPU: the probe's plain chains against a JAX ``lax.fori_loop`` of the
bodies of ``bench.py::vpu_probe_gelems`` and a numpy gather, the wrapper's
device rules, and the sources' constants and variant lists against the
Python side.  Tests marked ``gpu`` need a CUDA device and skip without one."""

from __future__ import annotations

import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from mpi_openmp_cuda_tpu_torch.models.workload import synthetic_codes
from mpi_openmp_cuda_tpu_torch.ops import costs, probe
from mpi_openmp_cuda_tpu_torch.ops import cuda_scorer as cs
from mpi_openmp_cuda_tpu_torch.ops.dispatch import bucket_launches

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "mpi_openmp_cuda_tpu_torch" / "csrc"
NTHREADS = 2 * probe.THREADS  # two blocks
ITERS = 32


def _ablate():
    spec = importlib.util.spec_from_file_location(
        "torch_kernel_ablate", REPO / "scripts" / "torch_kernel_ablate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _plain(op, iters=ITERS, nthreads=NTHREADS):
    init = torch.from_numpy(probe.probe_init(op, nthreads))
    perm = torch.from_numpy(probe.lookup_table())
    return init, probe.issue_probe_plain(op, init, iters, perm)


def test_arith_plain_equals_jax_fori_loop_exactly():
    """int32 ``y * 3 + 1`` with wrap-around (bench.py:439-440)."""
    init, got = _plain("arith")
    want = lax.fori_loop(0, ITERS, lambda i, y: y * 3 + 1, jnp.asarray(init.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.int32).astype(np.int64)


def test_fma_plain_equals_jax_fori_loop_exactly():
    """f32 ``y * 1.0000001 + 1e-7`` (bench.py:433-434), rounded once per
    step as ``fmaf`` rounds: JAX computes the step in float64, where it is
    exact, and rounds it to float32.  Every value moves at least one ulp
    per step, so a chain that drops a term cannot pass."""
    init, got = _plain("fma")
    x0 = init.numpy().view(np.float32)
    with jax.enable_x64(True):
        c, d = jnp.float64(probe.FMA_C), jnp.float64(probe.FMA_D)
        want = np.asarray(lax.fori_loop(
            0, ITERS, lambda i, y: (y.astype(jnp.float64) * c + d).astype(jnp.float32),
            jnp.asarray(x0)))
    assert want.dtype == np.float32
    np.testing.assert_array_equal(got.view(torch.float32).numpy(), want)
    assert (_bits(want) - _bits(x0) >= ITERS).all()
    assert (probe.FMA_C, probe.FMA_D) == (float(np.float32(1.0000001)), float(np.float32(1e-7)))


@pytest.mark.parametrize("chain", ["unchanged", "no addend", "no multiply", "two roundings"])
def test_fma_check_tells_apart_a_wrong_chain(chain):
    """Each wrong chain a kernel could compute differs from the plain
    version by many ulps in some value after ``ITERS`` steps, so exact
    equality catches it."""
    init, got = _plain("fma")
    c, d = np.float32(probe.FMA_C), np.float32(probe.FMA_D)
    step = {
        "unchanged": lambda y: y,
        "no addend": lambda y: (y.astype(np.float64) * c).astype(np.float32),
        "no multiply": lambda y: (y.astype(np.float64) + d).astype(np.float32),
        "two roundings": lambda y: (y * c).astype(np.float32) + d,
    }[chain]
    y = init.numpy().view(np.float32)
    for _ in range(ITERS):
        y = step(y)
    assert np.abs(_bits(y) - _bits(got.view(torch.float32).numpy())).max() >= 16


def test_lookup_plain_equals_numpy_gather():
    init, got = _plain("lookup")
    perm = probe.lookup_table()
    y = init.numpy()
    for _ in range(ITERS):
        y = perm[y]
    np.testing.assert_array_equal(got.numpy(), y)


def test_lookup_table_keeps_banks_and_lanes_start_in_their_bank():
    perm = probe.lookup_table()
    assert perm.dtype == np.int32 and sorted(perm.tolist()) == list(range(probe.TABLE))
    assert (perm % probe.BANKS == np.arange(probe.TABLE) % probe.BANKS).all()
    assert (perm != np.arange(probe.TABLE)).mean() > 0.9
    init = probe.probe_init("lookup", NTHREADS).reshape(probe.CHAINS, NTHREADS)
    lane = np.arange(NTHREADS) % probe.BANKS
    assert (init % probe.BANKS == lane).all() and init.max() < probe.TABLE
    # Entries differ by warp and chain, so chains do not run in lockstep.
    assert len(set(init[:, 0].tolist())) == probe.CHAINS


@pytest.mark.parametrize("op", probe.OPS)
def test_wrapper_takes_plain_path_only_on_cpu(op):
    init = torch.from_numpy(probe.probe_init(op, NTHREADS))
    perm = torch.from_numpy(probe.lookup_table())
    before = dict(probe.launch_counts)
    got = probe.issue_probe(op, init, ITERS, perm)
    assert torch.equal(got, probe.issue_probe_plain(op, init, ITERS, perm))
    assert probe.launch_counts == before
    with pytest.raises(ValueError, match="cpu or cuda"):
        probe.issue_probe(op, init.to("meta"), ITERS, perm.to("meta"))


@pytest.mark.parametrize(
    "args,msg",
    [
        (("rotate", 16), "unknown probe op"),
        (("arith", 24), "multiple of 16"),
        (("arith", -16), "multiple of 16"),
    ],
)
def test_wrapper_validates(args, msg):
    op, iters = args
    init = torch.from_numpy(probe.probe_init("arith", NTHREADS))
    with pytest.raises(ValueError, match=msg):
        probe.issue_probe(op, init, iters, torch.from_numpy(probe.lookup_table()))


def test_wrapper_validates_operands():
    perm = torch.from_numpy(probe.lookup_table())
    init = torch.from_numpy(probe.probe_init("arith", NTHREADS))
    with pytest.raises(ValueError, match="int32"):
        probe.issue_probe("arith", init.long(), 16, perm)
    with pytest.raises(ValueError, match="729"):
        probe.issue_probe("lookup", init, 16, perm[:100])
    with pytest.raises(ValueError, match="multiple"):
        probe.issue_probe("arith", init[:100], 16, perm)


def test_rate_function_refuses_the_cpu(monkeypatch):
    with pytest.raises(RuntimeError, match="CUDA device"):
        probe.issue_probe_gelems("arith", "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        probe.issue_probe_gelems("fma", "cuda")


def test_resident_blocks_is_zero_off_the_card():
    assert probe.resident_blocks(torch.device("cpu")) == 0


@pytest.mark.parametrize("op", probe.OPS)
def test_rate_check_and_long_chain(op):
    peak = costs.PEAK_PER_S[op]
    probe.check_rate(op, peak)
    probe.check_rate(op, 1.05 * peak)
    for bad in (0.0, -1.0, 1.06 * peak):
        with pytest.raises(RuntimeError, match="data-sheet peak"):
            probe.check_rate(op, bad)
    nthreads = 132 * 16 * probe.THREADS
    iters = probe.long_iters(op, nthreads)
    assert iters % probe.UNROLL == 0
    assert nthreads * probe.CHAINS * iters / peak >= probe.LONG_CHAIN_S


def test_probe_source_constants_match():
    src = (CSRC / "issue_probe.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kThreads"]) == probe.THREADS
    assert int(consts["kChains"]) == probe.CHAINS
    assert int(consts["kUnroll"]) == probe.UNROLL
    assert int(consts["kTable"]) == probe.TABLE
    enum = re.search(r"enum Op : int \{([^}]*)\}", src).group(1)
    assert [e.split("=")[0].strip() for e in enum.split(",")] == ["kFma", "kArith", "kLookup"]
    assert [op.lower() for op in probe.OPS] == ["fma", "arith", "lookup"]


def test_ablation_variants_match_the_source():
    """The stage switches are the template parameter of the kernels in
    ``fused_kernels.cuh``; ``ablate_scorer.cu`` instantiates each of them
    and ``fused_scorer.cu`` only ``base``."""
    abl = _ablate()
    src = (CSRC / "ablate_scorer.cu").read_text()
    shared = (CSRC / "fused_kernels.cuh").read_text()
    enum = re.search(r"enum Variant : int \{([^}]*)\}", shared).group(1)
    assert tuple(e.strip() for e in enum.split(",")) == abl.VARIANTS
    assert abl.VARIANTS == ("base", "nostage", "nolookup", "nodiag", "nomax",
                            "nocombine", "noreduce", "nok", "noskip")
    assert abl.EXACT == ("base", "nostage", "nodiag", "noskip")
    prod = (CSRC / "fused_scorer.cu").read_text()
    assert re.findall(r"launch<([\w:]+)>", prod) == ["fused::base"]
    for text in (src, prod):
        assert '#include "fused_kernels.cuh"' in text
    cases = re.findall(r"ABLATE_CASE\((\w+)\)\n", src)
    assert tuple(cases) == abl.VARIANTS
    for var in abl.VARIANTS:
        assert re.search(rf"^//   {var}\s", src, re.M), var
        assert re.search(rf"^//   {var}\s", shared, re.M), var
    assert set(abl.EXACT) < set(abl.VARIANTS)


def test_ablation_cli_parses():
    abl = _ablate()
    assert abl.parse_synthetic("3000x64x1200-1999") == (3000, 64, 1200, 1999)
    with pytest.raises(ValueError, match="L1xNxLO-HI"):
        abl.parse_synthetic("3000x64")
    with pytest.raises(SystemExit):
        abl.main(["--only", "base,bogus"])
    with pytest.raises(SystemExit):
        abl.main(["--only", "base,base"])


def test_ablation_wrapper_on_cpu():
    """On CPU tensors the variants that keep the production rows run the
    fused kernel's plain version; the others have none and raise."""
    abl = _ablate()
    seq1, seqs = synthetic_codes(300, 6, 20, 120, seed=3)
    launch = bucket_launches(seq1, seqs, [10, 2, 3, 4], torch.device("cpu"))[0]
    want = cs.fused_scorer_plain(launch.state)
    for var in abl.EXACT:
        assert torch.equal(abl.ablate_scorer(launch.state, var), want)
    for var in sorted(set(abl.VARIANTS) - set(abl.EXACT)):
        with pytest.raises(ValueError, match="no plain version"):
            abl.ablate_scorer(launch.state, var)
    with pytest.raises(ValueError, match="unknown variant"):
        abl.ablate_scorer(launch.state, "nooh")
    assert abl.launch_counts == {"ablate_scorer": 0}


@pytest.mark.gpu
@pytest.mark.parametrize("op", probe.OPS)
def test_probe_kernel_matches_plain_on_card(op):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    init, perm = probe.probe_operands(op, "cuda")
    before = probe.launch_counts["issue_probe"]
    got = probe.issue_probe(op, init, ITERS, perm)
    want = probe.issue_probe_plain(op, init, ITERS, perm)
    torch.cuda.synchronize()
    assert probe.launch_counts["issue_probe"] == before + 1
    assert torch.equal(got, want)
