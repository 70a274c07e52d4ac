#!/usr/bin/env python3
"""Singleton against fused launches of the fused scorer, and the fit of
the launch model of ``ops/schedule.py``.

    python3 scripts/torch_fusion_sweep.py               # Seq1 3000 and 1489
    python3 scripts/torch_fusion_sweep.py --len1 3000   # one CUDA device

For each Seq1 length (``--len1``), each launch width L in
:data:`WIDTHS` below it and each row count in :data:`ROWS` (every Seq2 of
L-127..L chars, seeded), it times one launch of the fused kernel (CUDA
events over back-to-back launches, ``utils.timing.time_ms``).  Then, for
each pair of widths La < Lb and row count, it times the two singleton
launches back to back against one launch of all the rows at Lb (a launch
group), after checking that the group's rows equal the singletons'
exactly.  Every launch is built by ``ops/_build.py`` and called through
``cuda_scorer.call_entry``, uncounted.

It then fits the model of ``schedule.launch_us`` — ``LAUNCH_US +
LAT_US * longest + SLOT_US * waves``, with ``CLUSTER_STEPS`` char steps
a cluster — to every timed launch (least relative squares for the three
linear constants at each ``CLUSTER_STEPS`` on a grid), prints the
constants, each launch's time beside the model's, and, for each pair,
which of singletons and group was faster and which the planner (with the
fitted constants) would pick.  The last line is a JSON object with every
row and the fit.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

WIDTHS = (256, 512, 768, 1024, 1408, 1664, 2048)
ROWS = (1, 4, 16, 64, 256)
PAIR_ROWS = (4, 16, 64)


def fit_model(points) -> float:
    """Fit ``schedule``'s four constants to ``points`` = [(len1, lens, l2p,
    us)] in place; returns the rms relative error."""
    import numpy as np

    from mpi_openmp_cuda_tpu_torch.ops import schedule

    best = None
    y = np.array([t for *_, t in points])
    for c in np.arange(0.0, 200.0, 2.0):
        schedule.CLUSTER_STEPS = float(c)
        x = np.array([[1.0, *schedule.launch_work(l1, lens, l2p)[:0:-1]]
                      for l1, lens, l2p, _ in points])  # [1, longest, waves]
        a = x / y[:, None]
        coef, *_ = np.linalg.lstsq(a, np.ones_like(y), rcond=None)
        err = float(np.sqrt(np.mean((a @ coef - 1.0) ** 2)))
        if (coef > 0).all() and (best is None or err < best[0]):
            best = (err, float(c), *(float(v) for v in coef))
    err, schedule.CLUSTER_STEPS, schedule.LAUNCH_US, schedule.LAT_US, schedule.SLOT_US = best
    return err


def main(argv=None) -> int:
    import argparse

    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--len1", default="3000,1489",
                    help="comma-separated Seq1 lengths (at most 3000)")
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_fusion_sweep: no CUDA device is available", file=sys.stderr)
        return 1
    from mpi_openmp_cuda_tpu_torch.ops import _build, schedule
    from mpi_openmp_cuda_tpu_torch.ops import cuda_scorer as cs
    from mpi_openmp_cuda_tpu_torch.ops.dispatch import pad_problem
    from mpi_openmp_cuda_tpu_torch.ops.values import value_table
    from mpi_openmp_cuda_tpu_torch.utils.constants import BUF_SIZE_SEQ2
    from mpi_openmp_cuda_tpu_torch.utils.timing import card_line, time_ms

    entry = cs.typed_entry(_build.load("fused_scorer"), "fused_scorer")
    dev = torch.device("cuda")
    card = card_line()
    print(f"card {card}", flush=True)
    val = value_table([10, 2, 3, 4]).reshape(-1)
    rng = np.random.default_rng(11)

    def state(seq1, seqs):
        b = pad_problem(seq1, seqs)
        return cs.state_from_numpy(b.seq1ext, b.len1, b.seq2, b.len2, val, dev)

    def rows_of(seq1, width, count):
        lens = rng.integers(width - 127, width + 1, size=count)
        lens = np.minimum(lens, min(seq1.size - 1, BUF_SIZE_SEQ2))
        return [rng.integers(1, 27, size=int(n)).astype(np.int8) for n in lens]

    singles, pairs = [], []
    for len1 in (int(x) for x in args.len1.split(",")):
        seq1 = rng.integers(1, 27, size=len1).astype(np.int8)
        widths = [w for w in WIDTHS if w - 127 < len1]
        for width in widths:
            for count in ROWS:
                st = state(seq1, rows_of(seq1, width, count))
                ms = time_ms(lambda: cs.call_entry(entry, st), reps=args.reps)
                lens = st.lens.tolist()
                singles.append({"len1": len1, "l2p": st.rows.shape[1], "lens": lens,
                                "us": ms * 1e3})
                print(f"single len1 {len1} L2P {st.rows.shape[1]} rows {count}: "
                      f"{ms * 1e3:.3f} us", flush=True)
        for ia, wa in enumerate(widths):
            for wb in widths[ia + 1:]:
                for count in PAIR_ROWS:
                    a, b = rows_of(seq1, wa, count), rows_of(seq1, wb, count)
                    sa, sb, sg = state(seq1, a), state(seq1, b), state(seq1, a + b)
                    want = torch.cat([cs.call_entry(entry, sa), cs.call_entry(entry, sb)])
                    if not torch.equal(cs.call_entry(entry, sg), want):
                        raise SystemExit(f"group != singletons at len1 {len1}, "
                                         f"L2P {wa}+{wb}, rows {count}")

                    def two():
                        cs.call_entry(entry, sa)
                        cs.call_entry(entry, sb)

                    s0, g0, g1, s1 = (time_ms(fn, reps=args.reps) for fn in (
                        two, lambda: cs.call_entry(entry, sg),
                        lambda: cs.call_entry(entry, sg), two))
                    rec = {"len1": len1, "la": sa.rows.shape[1], "lb": sb.rows.shape[1],
                           "rows": count, "lens_a": sa.lens.tolist(),
                           "lens_b": sb.lens.tolist(), "singles_us": (s0 + s1) * 500,
                           "group_us": (g0 + g1) * 500}
                    pairs.append(rec)
                    print(f"pair len1 {len1} L2P {rec['la']}+{rec['lb']} rows {count}+"
                          f"{count}: singletons {rec['singles_us']:.3f} us, group "
                          f"{rec['group_us']:.3f} us", flush=True)

    # Every timed launch is a data point: singles, and each pair's group.
    points = [(p["len1"], p["lens"], p["l2p"], p["us"]) for p in singles]
    points += [(p["len1"], p["lens_a"] + p["lens_b"], p["lb"], p["group_us"]) for p in pairs]
    err = fit_model(points)
    print(f"fit [{card}]: LAUNCH_US = {schedule.LAUNCH_US:.4f}, LAT_US = "
          f"{schedule.LAT_US:.6f}, SLOT_US = {schedule.SLOT_US:.6f}, CLUSTER_STEPS = "
          f"{schedule.CLUSTER_STEPS:.1f}; rms relative error {100 * err:.2f} %", flush=True)
    for l1, lens, l2p, t in points:
        print(f"model len1 {l1} L2P {l2p} rows {len(lens)}: measured {t:.3f} us, "
              f"model {schedule.launch_us(l1, lens, l2p):.3f} us")
    agree = 0
    for p in pairs:
        model_s = (schedule.launch_us(p["len1"], p["lens_a"], p["la"])
                   + schedule.launch_us(p["len1"], p["lens_b"], p["lb"]))
        model_g = schedule.launch_us(p["len1"], p["lens_a"] + p["lens_b"], p["lb"])
        fuse = model_g <= model_s * (1 + schedule.FUSED_TIE_FRACTION)
        faster = "group" if p["group_us"] <= p["singles_us"] else "singletons"
        ok = (p["group_us"] if fuse else p["singles_us"]) <= 1.03 * min(
            p["group_us"], p["singles_us"])
        agree += ok
        p.update(model_singles_us=model_s, model_group_us=model_g, planner_fuses=fuse)
        print(f"plan len1 {p['len1']} L2P {p['la']}+{p['lb']} rows {p['rows']}: faster "
              f"{faster}; planner {'fuses' if fuse else 'keeps singletons'}"
              f"{'' if ok else ' (more than 3 % slower)'}")
    print(f"planner within 3 % of the faster choice on {agree} of {len(pairs)} pairs [{card}]")
    print(json.dumps({"card": card, "fit": {
        "LAUNCH_US": schedule.LAUNCH_US, "LAT_US": schedule.LAT_US,
        "SLOT_US": schedule.SLOT_US,
        "CLUSTER_STEPS": schedule.CLUSTER_STEPS, "rms_rel_err": err},
        "singles": singles, "pairs": pairs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
