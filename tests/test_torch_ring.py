"""The port's Seq1 ring (``mpi_openmp_cuda_tpu_torch/parallel/ring.py``)
against the JAX package's ``RingSharding`` on its 8 virtual CPU devices
and the numpy oracle, exact int32 equality: random inputs, the 2-D mesh,
tie-break parity on small alphabets, the edge lengths, the mostly-dead
shards, Seq1 past the reference's cap, the CLI's ``--mesh seq:4`` and
``2x4``, the refusal of foreign backends; the fused kernel's plain
version on one ring window (``cuda_scorer.window_state``) against the JAX
kernel (interpret mode) at block-local Seq1 lengths from negative to
past the window; and the collectives the ring calls: exactly R shifts of
one block a shard, one all_gather of the ``[bl, 4]`` candidates a shard,
never a gather of Seq1.  The spec is ``tests/test_ring.py``."""

from __future__ import annotations

from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_openmp_cuda_tpu.ops.dispatch import pad_problem as jpad_problem
from mpi_openmp_cuda_tpu.ops.oracle import prefix_best
from mpi_openmp_cuda_tpu.ops.pallas_scorer import _pallas_best, mxu_feed
from mpi_openmp_cuda_tpu.ops.values import value_table
from mpi_openmp_cuda_tpu.parallel.ring import RingSharding as JRingSharding
from mpi_openmp_cuda_tpu_torch.io import cli as tcli
from mpi_openmp_cuda_tpu_torch.models.encoding import decode
from mpi_openmp_cuda_tpu_torch.ops import cuda_scorer as cs
from mpi_openmp_cuda_tpu_torch.ops.dispatch import AlignmentScorer, pad_problem
from mpi_openmp_cuda_tpu_torch.parallel import ring as tring
from mpi_openmp_cuda_tpu_torch.parallel.ring import RingSharding, ring_plan
from mpi_openmp_cuda_tpu_torch.utils.constants import INT32_MIN

REPO = Path(__file__).resolve().parent.parent
W = [10, 2, 3, 4]
CPU = torch.device("cpu")


def _rows(arr) -> list[tuple[int, int, int]]:
    return [tuple(int(x) for x in r) for r in np.asarray(arr)]


def _ring(sp: int, dp: int = 1) -> RingSharding:
    return RingSharding.over_devices(seq=sp, batch=dp, devices=[CPU] * (sp * dp))


def _score_ring(seq1, seqs, weights=W, sp=8, dp=1, backend="cuda"):
    sc = AlignmentScorer(backend, device="cpu", sharding=_ring(sp, dp))
    return _rows(sc.score_codes(seq1, seqs, weights))


def _jax_ring(seq1, seqs, weights=W, sp=8, dp=1):
    batch = jpad_problem(seq1, seqs, enforce_caps=False)
    val_flat = value_table(weights).astype(np.int32).reshape(-1)
    return _rows(JRingSharding.over_devices(seq=sp, batch=dp).score(batch, val_flat))


def _oracle(seq1, seqs, weights=W):
    return [prefix_best(seq1, s, weights) for s in seqs]


def _rand_seqs(rng, n, lo, hi, alpha=26):
    return [rng.integers(1, alpha + 1, size=int(n)).astype(np.int8)
            for n in rng.integers(lo, hi, size=n)]


@pytest.mark.parametrize("backend", ["cuda", "gather"])
def test_ring_matches_jax_and_oracle_random(rng, backend):
    seq1 = rng.integers(1, 27, size=517).astype(np.int8)
    seqs = _rand_seqs(rng, 9, 1, 400)
    got = _score_ring(seq1, seqs, backend=backend)
    assert got == _oracle(seq1, seqs)
    assert got == _jax_ring(seq1, seqs)


@pytest.mark.parametrize("backend", ["cuda", "gather"])
def test_ring_2d_mesh_batch_and_seq(rng, backend):
    seq1 = rng.integers(1, 27, size=300).astype(np.int8)
    seqs = _rand_seqs(rng, 11, 1, 250)  # uneven across dp=2
    got = _score_ring(seq1, seqs, sp=4, dp=2, backend=backend)
    assert got == _oracle(seq1, seqs)
    assert got == _jax_ring(seq1, seqs, sp=4, dp=2)


@pytest.mark.parametrize("alpha, weights", [(2, [1, 1, 1, 1]), (3, [2, 1, 1, 1])])
@pytest.mark.parametrize("backend", ["cuda", "gather"])
def test_ring_tiebreak_parity_small_alphabet(rng, alpha, weights, backend):
    """A 2- or 3-letter alphabet makes score ties everywhere, across
    shards too; (n, k) must still follow the offset-major first hit."""
    seq1 = rng.integers(1, alpha + 1, size=200).astype(np.int8)
    seqs = _rand_seqs(rng, 7, 1, 60, alpha=alpha) + [
        rng.integers(1, alpha + 1, size=170).astype(np.int8)]
    got = _score_ring(seq1, seqs, weights, sp=4, backend=backend)
    assert got == _oracle(seq1, seqs, weights)
    assert got == _jax_ring(seq1, seqs, weights, sp=4)


@pytest.mark.parametrize("backend", ["cuda", "gather"])
def test_ring_edge_cases(rng, backend):
    seq1 = rng.integers(1, 27, size=64).astype(np.int8)
    seqs = [
        seq1.copy(),  # len2 == len1: the positional score, shard 0's eq
        rng.integers(1, 27, size=100).astype(np.int8),  # len2 > len1: INT_MIN
        np.zeros(0, dtype=np.int8),  # empty
        rng.integers(1, 27, size=63).astype(np.int8),  # one valid offset
    ]
    got = _score_ring(seq1, seqs, backend=backend)
    assert got == _oracle(seq1, seqs) == _jax_ring(seq1, seqs)
    assert got[1] == got[2] == (INT32_MIN, 0, 0)


def test_ring_determinism_duplicates(rng):
    seq1 = rng.integers(1, 27, size=128).astype(np.int8)
    dup = rng.integers(1, 27, size=40).astype(np.int8)
    out = _score_ring(seq1, [dup, dup.copy(), dup.copy()])
    assert out[0] == out[1] == out[2]


def _spy_windows(monkeypatch):
    """Every fused launch of the ring: (len1_eff, L1P of the window)."""
    seen = []
    real = tring.fused_scorer

    def spy(state):
        seen.append((state.len1, state.l1p))
        return real(state)

    monkeypatch.setattr(tring, "fused_scorer", spy)
    return seen


def test_ring_mostly_dead_shards_kernel_path(rng, monkeypatch):
    """The fused kernel on a mesh where most shards hold no valid offset:
    len1 = 205 at sp = 8 gives Bs = 128, len1_eff 205 on shard 0 (above
    the window), 77 on shard 1 and -51 .. -691 on shards 2-7; the combine
    still gives the oracle's rows, equal length and heavy ties included."""
    seen = _spy_windows(monkeypatch)
    seq1 = rng.integers(1, 4, size=205).astype(np.int8)
    seqs = _rand_seqs(rng, 6, 1, 160, alpha=3) + [
        seq1.copy(), rng.integers(1, 4, size=240).astype(np.int8)]
    w = [2, 1, 1, 1]
    got = _score_ring(seq1, seqs, w)
    assert seen == [(205 - 128 * d, 128) for d in range(8)]
    assert got == _oracle(seq1, seqs, w) == _jax_ring(seq1, seqs, w)


def test_ring_kernel_engages_once_a_shard(rng, monkeypatch):
    seen = _spy_windows(monkeypatch)
    seq1 = rng.integers(1, 27, size=333).astype(np.int8)
    seqs = [rng.integers(1, 27, size=n).astype(np.int8) for n in (150, 170, 190)]
    got = _score_ring(seq1, seqs, sp=4)
    assert [e for e, _ in seen] == [333 - 128 * d for d in range(4)]
    assert got == _oracle(seq1, seqs)


def test_ring_huge_weights_take_the_gather_window(rng, monkeypatch):
    """Weights past the kernels' int32 window run the JAX ring's gather
    window body, exactly (as the JAX ring falls back to its gather body)."""
    seen = _spy_windows(monkeypatch)
    seq1 = rng.integers(1, 27, size=150).astype(np.int8)
    seqs = _rand_seqs(rng, 4, 1, 120)
    w = [10_000_000, 50_000, 3, 4]
    got = _score_ring(seq1, seqs, w, sp=4)
    assert seen == [] and got == _oracle(seq1, seqs, w)


def test_ring_long_context_beyond_reference_cap(rng):
    """Seq1 > BUF_SIZE_SEQ1 = 3000: what the reference cannot take."""
    seq1 = rng.integers(1, 27, size=6144).astype(np.int8)
    seqs = _rand_seqs(rng, 4, 100, 2500)
    got = _score_ring(seq1, seqs, sp=8)
    assert got == _oracle(seq1, seqs)
    assert got == _jax_ring(seq1, seqs, sp=8)


@pytest.mark.slow
def test_ring_long_context_4x_cap(rng):
    """Seq1 at 4x the reference cap over 8 shards and Seq2 past its cap:
    Bs 1536, L2P 12288, R = 9 window steps (the kernel's shared memory
    past the 48 KB default on the card).  Slow: the plain version scores
    24 windows of a 12288-wide row on the CPU."""
    seq1 = rng.integers(1, 27, size=12288).astype(np.int8)
    seqs = [rng.integers(1, 27, size=n).astype(np.int8) for n in (300, 3500, 12280)]
    assert _score_ring(seq1, seqs, sp=8) == _oracle(seq1, seqs)


def test_ring_seq2_longer_than_block(rng):
    """L2 spans several ring blocks: the window needs several shifts."""
    seq1 = rng.integers(1, 27, size=512).astype(np.int8)
    seqs = _rand_seqs(rng, 3, 450, 500)
    assert ring_plan(512, 512, 8, kernel=False)[1] == 9
    assert _score_ring(seq1, seqs, backend="gather") == _oracle(seq1, seqs)


@pytest.mark.parametrize("mesh", ["seq:4", "2x4"])
def test_cli_mesh_seq_and_2d(mesh, monkeypatch, capfd):
    monkeypatch.setenv("SEQALIGN_HOST_DEVICES", "8")
    for name in ("equal_len", "stress_small"):
        path = REPO / "tests" / "fixtures" / f"{name}.txt"
        assert tcli.run(["--device", "cpu", "--input", str(path), "--mesh", mesh]) == 0
        assert capfd.readouterr().out == path.with_suffix(".out").read_text()


def test_cli_long_context_via_seq_mesh(tmp_path, monkeypatch, capfd, rng):
    """Seq1 past BUF_SIZE_SEQ1 through the CLI on a seq mesh; without one
    the cap still holds (65)."""
    monkeypatch.setenv("SEQALIGN_HOST_DEVICES", "8")
    seq1 = rng.integers(1, 27, size=3500).astype(np.int8)
    seq2 = rng.integers(1, 27, size=50).astype(np.int8)
    inp = tmp_path / "long.txt"
    inp.write_text(f"10 2 3 4\n{decode(seq1)}\n1\n{decode(seq2)}\n")
    assert tcli.run(["--device", "cpu", "--input", str(inp), "--mesh", "seq:8"]) == 0
    s, n, k = prefix_best(seq1, seq2, W)
    assert capfd.readouterr().out == f"#0: score: {s}, n: {n}, k: {k}\n"
    assert tcli.run(["--device", "cpu", "--input", str(inp)]) == tcli.EX_FATAL
    assert "exceeds BUF_SIZE_SEQ1" in capfd.readouterr().err
    # A batch mesh keeps the cap too.
    assert tcli.run(["--device", "cpu", "--input", str(inp), "--mesh", "2"]) == tcli.EX_FATAL
    assert "exceeds BUF_SIZE_SEQ1" in capfd.readouterr().err


@pytest.mark.parametrize("backend", ["oracle", "mm", "xla"])
def test_ring_rejects_foreign_backend(backend):
    batch = pad_problem(np.array([1, 2, 3], dtype=np.int8), [np.array([1], dtype=np.int8)])
    with pytest.raises(ValueError, match="sequence-parallel"):
        _ring(8).score(batch, value_table(W).astype(np.int32).reshape(-1), backend=backend)


def test_cli_ring_with_mm_backend_exits_65(monkeypatch, capfd):
    monkeypatch.setenv("SEQALIGN_HOST_DEVICES", "4")
    path = REPO / "tests" / "fixtures" / "tiny.txt"
    rc = tcli.run(["--device", "cpu", "--input", str(path), "--mesh", "seq:4",
                   "--backend", "mm"])
    cap = capfd.readouterr()
    assert rc == tcli.EX_FATAL and cap.out == "" and "sequence-parallel" in cap.err


# ---- the kernel module at the window level ----------------------------------

_WIN_BS, _WIN_L2P = 128, 128


@pytest.fixture(scope="module")
def window_operands():
    """One ring window's operands, as the JAX ring builds them: Seq1 codes
    of a 3-letter alphabet (ties), the window's tail past Seq1 zeroed, and
    rows of len2 0, 1, 5, 40, 100, 127, 128 and 60."""
    rng = np.random.default_rng(5)
    win = rng.integers(1, 4, size=_WIN_BS + _WIN_L2P + 1).astype(np.int32)
    win[-20:] = 0
    lens = np.array([0, 1, 5, 40, 100, 127, 128, 60], dtype=np.int32)
    rows = np.zeros((lens.size, _WIN_L2P), dtype=np.int32)
    for i, n in enumerate(lens):
        rows[i, :n] = rng.integers(1, 4, size=n)
    val = value_table([2, 1, 1, 1]).astype(np.int32).reshape(-1)
    kernel = jax.jit(partial(_pallas_best, feed=mxu_feed(val)))
    return win, rows, lens, val, kernel


@pytest.mark.parametrize("len1_eff", [-51, 0, 30, 100, 128, 300],
                         ids=["negative", "zero", "below-len2", "inside", "at-Bs", "past-Bs"])
def test_window_state_plain_equals_jax_kernel(window_operands, len1_eff):
    """``fused_scorer_plain`` on ``window_state(win_k, len1_eff, ...)``
    against JAX ``_pallas_best`` (interpret mode) on the same bytes: the
    score and ``eq`` of every row, and (n, k) wherever an offset is valid
    (``n < len1_eff - len2``).  Where none is, the port writes (INT32_MIN,
    0, 0) and the JAX kernel its sentinel score with n and k undefined; a
    len2 = 0 row's JAX score is a pack sentinel.  The ring's combine reads
    neither."""
    win, rows, lens, val, kernel = window_operands
    st = cs.window_state(win, len1_eff, rows, lens, val, "cpu")
    assert st.l1p == _WIN_BS and st.len1 == len1_eff
    port = cs.fused_scorer_plain(st).numpy().astype(np.int64)
    bv, bi, bk, eq = kernel(jnp.asarray(win), jnp.int32(len1_eff), jnp.asarray(rows),
                            jnp.asarray(lens), jnp.asarray(val))
    bv = np.asarray(bv)
    score = np.where(bv <= np.float32(INT32_MIN), INT32_MIN, bv.astype(np.int64))
    live = (lens > 0) & (lens < len1_eff)
    assert np.array_equal(port[:, 3], np.asarray(eq).astype(np.int64))
    assert np.array_equal(port[live, 0], score[live])
    assert np.array_equal(port[live, 1], np.asarray(bi)[live])
    assert np.array_equal(port[live, 2], np.asarray(bk)[live])
    dead = (lens > 0) & ~live
    assert (port[dead, 0] == INT32_MIN).all() and (score[dead] == INT32_MIN).all()
    assert (port[~live, 1:3] == 0).all()
    assert live.sum() == {-51: 0, 0: 0, 30: 2, 100: 4, 128: 6, 300: 7}[len1_eff]


def test_window_state_takes_len1_outside_the_window_only():
    rows, lens = np.ones((1, 128), np.int32), np.array([3], np.int32)
    val = value_table(W).reshape(-1)
    seq1ext = np.ones(257, np.int32)
    cs.window_state(seq1ext, -1000, rows, lens, val, "cpu")
    cs.window_state(seq1ext, 10_000, rows, lens, val, "cpu")
    with pytest.raises(ValueError, match="lengths outside"):
        cs.state_from_numpy(seq1ext, 10_000, rows, lens, val, "cpu")
    with pytest.raises(ValueError, match="lengths outside"):
        cs.state_from_numpy(seq1ext, -1, rows, lens, val, "cpu")
    with pytest.raises(ValueError, match="bad operand shapes"):
        cs.window_state(np.ones(200, np.int32), 5, rows, lens, val, "cpu")


# ---- the collectives the ring calls -----------------------------------------


def _assert_ring_structure(seq1, seqs, sp, dp, backend):
    """Exactly R shifts a shard, each of one Bs block; one all_gather a
    shard of the [sp, bl, 4] candidates; nothing else inside the compute,
    and nothing of Seq1's size; then one gather of the rows."""
    rs = _ring(sp, dp)
    sc = AlignmentScorer(backend, device="cpu", sharding=rs)
    pend = sc.score_codes_async(seq1, seqs, W)
    batch = pad_problem(seq1, seqs, enforce_caps=False)
    bs, r_steps = ring_plan(batch.l1p, batch.l2p, sp, kernel=backend == "cuda")
    bl = -(-len(seqs) // dp)
    slots = sp * dp
    assert dict(rs.comm.counts) == {"shift": r_steps * slots, "all_gather": slots}
    assert rs.comm.log == ([("shift", bs)] * (r_steps * slots)
                           + [("all_gather", sp * bl * 4)] * slots)
    assert all(e < batch.l1p for _, e in rs.comm.log)
    assert _rows(pend.result()) == _oracle(seq1, seqs)
    assert rs.comm.counts["gather"] == 1 and rs.comm.log[-1] == ("gather", dp * bl * 3)
    return r_steps


@pytest.mark.parametrize("backend", ["cuda", "gather"])
def test_ring_collective_structure(rng, backend):
    """Seq1 2048 over sp = 8 (Bs 256), L2P 384: R = 2."""
    seq1 = rng.integers(1, 27, size=2048).astype(np.int8)
    seqs = [rng.integers(1, 27, size=n).astype(np.int8) for n in (300, 150, 270, 80)]
    assert _assert_ring_structure(seq1, seqs, 8, 1, backend) == 2


def test_ring_collective_structure_2d_mesh(rng):
    """dp x sp: the batch axis adds no collective; the seq axis keeps its
    structure in each row.  Seq1 1024 over sp = 4 (Bs 256), L2P 512: R = 3."""
    seq1 = rng.integers(1, 27, size=1024).astype(np.int8)
    seqs = [rng.integers(1, 27, size=n).astype(np.int8) for n in (500, 80, 200)]
    assert _assert_ring_structure(seq1, seqs, 4, 2, "gather") == 3
    assert _assert_ring_structure(seq1, seqs, 4, 2, "cuda") == 3
