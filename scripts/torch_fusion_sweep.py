#!/usr/bin/env python3
"""Singleton against fused launches of the fused scorer, and the fit of
the launch model of ``ops/schedule.py``.

    python3 scripts/torch_fusion_sweep.py               # Seq1 3000 and 1489
    python3 scripts/torch_fusion_sweep.py --len1 3000   # one CUDA device
    python3 scripts/torch_fusion_sweep.py --splits      # the split sweep

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
a warp of a cluster and ``PAIR_STEPS`` a cluster's second block — to
every timed launch (least relative squares for the three linear
constants at each pair of step constants on a grid), prints the
constants, each launch's time beside the model's, and, for each pair,
which of singletons and group was faster and which the planner (with the
fitted constants) would pick.  The last line is a JSON object with every
row and the fit.

``--splits`` times instead one launch of each shape of :func:`split_shapes`
at every split the kernel runs at its width (``schedule.SPLITS`` that
``schedule._allowed`` admits), each held exactly equal to the width's
default split first: a database scan's chunks (Seq1 2504, 256 rows of the
scan law's lengths, ``seqbench/scanjobs.py``), each as its rows of at
most 256 chars, the rest, and all of them in one launch; batch-long's job
(Seq1 3000, 64 rows of 1200-1999) and one card's shard of a four-card
mesh (every 4th of its sorted rows); rows of L-127..L chars at widths
256..2048, 8, 64 and 256 of them, against Seq1 3000.  It prints each launch beside the
model at the current constants, the model's rms relative error over all
launches and over those below the default split, and the split the model
chooses (``schedule.choose_split``) against the fastest measured.

``--fit RECORD ...`` refits the five constants to the launches of earlier
runs' JSON records (each file's last line; both kinds), with no card:
the constants in ``ops/schedule.py`` are those of the records in
``docs/sweeps/``.
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
    """Fit ``schedule``'s five constants to ``points`` = [(len1, lens, l2p,
    split, us)] (split None: the width's default) in place; returns the rms
    relative error.  ``CLUSTER_STEPS`` and ``PAIR_STEPS`` on a grid, the
    three linear constants by least relative squares at each: the model's
    longest cluster and waves are linear in the two step constants, so each
    launch's terms are read at three settings of them."""
    import numpy as np

    from mpi_openmp_cuda_tpu_torch.ops import schedule

    def terms(cs, ps):
        schedule.CLUSTER_STEPS, schedule.PAIR_STEPS = cs, ps
        return np.array([schedule.launch_work(l1, lens, l2p, split)[:0:-1]
                         for l1, lens, l2p, split, _ in points])  # [longest, waves]

    base, d_cs, d_ps = terms(0.0, 0.0), terms(1.0, 0.0), terms(0.0, 1.0)
    d_cs, d_ps = d_cs - base, d_ps - base
    y = np.array([t for *_, t in points])
    best = None
    for cs in np.arange(0.0, 200.0, 2.0):
        for ps in np.arange(0.0, 600.0, 10.0):
            x = np.hstack([np.ones((len(y), 1)), base + cs * d_cs + ps * d_ps])
            a = x / y[:, None]
            coef, *_ = np.linalg.lstsq(a, np.ones_like(y), rcond=None)
            err = float(np.sqrt(np.mean((a @ coef - 1.0) ** 2)))
            if (coef > 0).all() and (best is None or err < best[0]):
                best = (err, float(cs), float(ps), *(float(v) for v in coef))
    (err, schedule.CLUSTER_STEPS, schedule.PAIR_STEPS, schedule.LAUNCH_US, schedule.LAT_US,
     schedule.SLOT_US) = best
    return err


def record_points(records) -> list:
    """The timed launches of this script's JSON records (its last line, a
    default run's or a ``--splits`` run's) as :func:`fit_model` points."""
    points = []
    for rec in records:
        points += [(p["len1"], p["lens"], p["l2p"], None, p["us"]) for p in rec.get("singles", [])]
        points += [(p["len1"], p["lens_a"] + p["lens_b"], p["lb"], None, p["group_us"])
                   for p in rec.get("pairs", [])]
        for sh in rec.get("shapes", []):
            points += [(sh["len1"], sh["lens"], sh["l2p"], int(k), us)
                       for k, us in sh["us"].items()]
    return points


def constants() -> dict:
    from mpi_openmp_cuda_tpu_torch.ops import schedule

    return {k: getattr(schedule, k)
            for k in ("LAUNCH_US", "LAT_US", "SLOT_US", "CLUSTER_STEPS", "PAIR_STEPS")}


def refit(paths) -> int:
    """``--fit``: the five constants fitted to every launch of the records
    at ``paths``, beside the model's error at the current ones, the
    error over the launches below their width's default split, and each
    split shape's chosen split against its fastest, at both."""
    import numpy as np

    from mpi_openmp_cuda_tpu_torch.ops import schedule

    records = [json.loads(Path(p).read_text().strip().splitlines()[-1]) for p in paths]
    points = record_points(records)
    shapes = [sh for rec in records for sh in rec.get("shapes", [])]

    def report(tag):
        rel = np.array([schedule.launch_us(l1, ln, w, sp) / t - 1.0
                        for l1, ln, w, sp, t in points])
        narrow = np.array([sp is not None and sp < schedule.segments(w)
                           for _, _, w, sp, _ in points])
        print(f"{tag}: " + ", ".join(f"{k} = {v:.6g}" for k, v in constants().items())
              + f"; rms relative error {100 * np.sqrt(np.mean(rel ** 2)):.2f} % over "
              f"{len(points)} launches, {100 * np.sqrt(np.mean(rel[narrow] ** 2)):.2f} % "
              f"over the {int(narrow.sum())} below their default split")
        for sh in shapes:
            us = {int(k): v for k, v in sh["us"].items()}
            chosen, _ = schedule.choose_split(sh["len1"], sh["lens"], sh["l2p"])
            fastest = min(us, key=us.get)
            print(f"  {sh['name']}: chosen {chosen} ({us[chosen]:.3f} us, "
                  f"{100 * (us[chosen] / us[fastest] - 1):+.1f} % on the fastest, {fastest}); "
                  f"default {sh['default']} ({us[sh['default']]:.3f} us)")

    report("current")
    err = fit_model(points)
    report(f"refit (rms {100 * err:.2f} %)")
    print(json.dumps({"fit": {**constants(), "rms_rel_err": err}, "points": len(points)}))
    return 0


def split_shapes(seed: int = 5):
    """``[(name, len1, lens)]`` of the split sweep (the module's note)."""
    import numpy as np

    from seqbench.scanjobs import quantile_lengths

    rng = np.random.default_rng(seed)
    scan = rng.permutation(quantile_lengths(
        4096, {"law": "lognormal", "median": 300, "sigma": 0.6}, 5, 2000))
    out = []
    for c in range(3):
        chunk = scan[c * 256:(c + 1) * 256]
        out += [(f"scan{c}.short", 2504, chunk[chunk <= 256]),
                (f"scan{c}.long", 2504, chunk[chunk > 256]),
                (f"scan{c}.all", 2504, chunk)]
    job = np.sort(rng.integers(1200, 2000, size=64))
    out += [("batch-long", 3000, job), ("batch-long.shard4", 3000, job[::4])]
    for width in (256, 512, 1024, 1536, 2048):
        for rows in (8, 64, 256):
            out.append((f"w{width}.r{rows}", 3000,
                        np.sort(rng.integers(width - 127, min(width, 2000) + 1, size=rows))))
    return out


def split_sweep(entry, reps: int, card: str) -> dict:
    """The ``--splits`` sweep (the module's note); its JSON record."""
    import numpy as np
    import torch

    from mpi_openmp_cuda_tpu_torch.ops import cuda_scorer as cs
    from mpi_openmp_cuda_tpu_torch.ops import schedule
    from mpi_openmp_cuda_tpu_torch.ops.dispatch import pad_problem
    from mpi_openmp_cuda_tpu_torch.ops.values import value_table
    from mpi_openmp_cuda_tpu_torch.utils.timing import time_ms

    val = value_table([10, 2, 3, 4]).reshape(-1)
    rng = np.random.default_rng(17)
    points, shapes = [], []
    for name, len1, lens in split_shapes():
        seq1 = rng.integers(1, 27, size=len1).astype(np.int8)
        seqs = [rng.integers(1, 27, size=int(n)).astype(np.int8) for n in lens]
        b = pad_problem(seq1, seqs)
        st = cs.state_from_numpy(b.seq1ext, b.len1, b.seq2, b.len2, val, "cuda")
        l2p = st.rows.shape[1]
        want = cs.call_entry(entry, st, 0)
        times = {}
        for split, ok in zip(schedule.SPLITS, schedule._allowed(l2p)):
            if not ok:
                continue
            if not torch.equal(cs.call_entry(entry, st, split), want):
                raise SystemExit(f"split {split} != the default at {name}")
            us = time_ms(lambda: cs.call_entry(entry, st, split), reps=reps) * 1e3
            model = schedule.launch_us(len1, lens, l2p, split)
            times[split] = us
            points.append((len1, [int(x) for x in lens], l2p, split, us))
            print(f"split {name} len1 {len1} L2P {l2p} rows {len(lens)} split {split}: "
                  f"{us:.3f} us, model {model:.3f} us", flush=True)
        chosen, _ = schedule.choose_split(len1, lens, l2p)
        fastest = min(times, key=times.get)
        dflt = schedule.segments(l2p)
        shapes.append({"name": name, "len1": len1, "l2p": l2p, "lens": [int(x) for x in lens],
                       "us": times, "chosen": chosen, "fastest": fastest,
                       "default": dflt})
        print(f"choice {name}: model {chosen} ({times[chosen]:.3f} us), fastest {fastest} "
              f"({times[fastest]:.3f} us), default {dflt} ({times[dflt]:.3f} us) [{card}]",
              flush=True)

    def rms(pts):
        rel = [schedule.launch_us(l1, ln, w, sp) / t - 1.0 for l1, ln, w, sp, t in pts]
        return float(np.sqrt(np.mean(np.square(rel))))

    narrow = [p for p in points if p[3] < schedule.segments(p[2])]
    err_all, err_narrow = rms(points), rms(narrow)
    print(f"model at the current constants: rms relative error {100 * err_all:.2f} % over "
          f"{len(points)} launches, {100 * err_narrow:.2f} % over the {len(narrow)} below "
          f"their default split [{card}]", flush=True)
    return {"card": card, "constants": constants(), "rms_rel_err": err_all,
            "rms_rel_err_narrow": err_narrow, "shapes": shapes}


def main(argv=None) -> int:
    import argparse

    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--len1", default="3000,1489",
                    help="comma-separated Seq1 lengths (at most 3000)")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--splits", action="store_true",
                    help="time every shape of split_shapes at every split instead")
    ap.add_argument("--fit", nargs="+", metavar="RECORD",
                    help="refit the model to these runs' JSON records (no card needed)")
    args = ap.parse_args(argv)
    if args.fit:
        return refit(args.fit)
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
    if args.splits:
        print(json.dumps(split_sweep(entry, args.reps, card)))
        return 0
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
                ms = time_ms(lambda: cs.call_entry(entry, st, 0), reps=args.reps)
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
                    want = torch.cat([cs.call_entry(entry, sa, 0), cs.call_entry(entry, sb, 0)])
                    if not torch.equal(cs.call_entry(entry, sg, 0), want):
                        raise SystemExit(f"group != singletons at len1 {len1}, "
                                         f"L2P {wa}+{wb}, rows {count}")

                    def two():
                        cs.call_entry(entry, sa, 0)
                        cs.call_entry(entry, sb, 0)

                    s0, g0, g1, s1 = (time_ms(fn, reps=args.reps) for fn in (
                        two, lambda: cs.call_entry(entry, sg, 0),
                        lambda: cs.call_entry(entry, sg, 0), two))
                    rec = {"len1": len1, "la": sa.rows.shape[1], "lb": sb.rows.shape[1],
                           "rows": count, "lens_a": sa.lens.tolist(),
                           "lens_b": sb.lens.tolist(), "singles_us": (s0 + s1) * 500,
                           "group_us": (g0 + g1) * 500}
                    pairs.append(rec)
                    print(f"pair len1 {len1} L2P {rec['la']}+{rec['lb']} rows {count}+"
                          f"{count}: singletons {rec['singles_us']:.3f} us, group "
                          f"{rec['group_us']:.3f} us", flush=True)

    # Every timed launch is a data point: singles, and each pair's group.
    points = [(p["len1"], p["lens"], p["l2p"], None, p["us"]) for p in singles]
    points += [(p["len1"], p["lens_a"] + p["lens_b"], p["lb"], None, p["group_us"])
               for p in pairs]
    err = fit_model(points)
    print(f"fit [{card}]: " + ", ".join(f"{k} = {v:.6g}" for k, v in constants().items())
          + f"; rms relative error {100 * err:.2f} %", flush=True)
    for l1, lens, l2p, _, t in points:
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
    print(json.dumps({"card": card, "fit": {**constants(), "rms_rel_err": err},
                      "singles": singles, "pairs": pairs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
