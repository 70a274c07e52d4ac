"""The served deployment's process: the port's CLI with ``--serve``, plus
what the benchmark reads from inside it.

    python -m seqbench.serve_child [--trace] -- <the port's CLI arguments>

runs ``mpi_openmp_cuda_tpu_torch.io.cli.run(<arguments>)`` as ``python
-m mpi_openmp_cuda_tpu_torch <arguments>`` would.  When it returns (a
drain on SIGTERM), one line ``SEQBENCH_CHILD <json>`` goes to stderr with
the card's name, its peak memory in this process, the kernel launches of
the whole run (``ops/cuda_scorer.launch_counts``) and the JAX modules
this process holds (``harness.forbidden_modules``), which the benchmark
refuses.

With ``--trace``, the device is profiled from the start (CUDA activity
only, :mod:`seqbench.devtrace`) and a thread reads ``start`` and ``stop``
lines on stdin that open and close the window read from it; the serve loop's spans, read through a listener on its
phase recorder, label the idle gaps, and the summary rides in the same
line.
"""

from __future__ import annotations

import json
import sys
import threading

MARK = "SEQBENCH_CHILD "


def main(argv: list[str]) -> int:
    split = argv.index("--")
    own, cli_args = argv[:split], argv[split + 1 :]
    import torch
    from mpi_openmp_cuda_tpu_torch.io import cli
    from mpi_openmp_cuda_tpu_torch.ops import cuda_scorer

    from seqbench.devtrace import DeviceTrace, span_sink, tap_phases
    from seqbench.harness import forbidden_modules

    trace = None
    if "--trace" in own:
        trace = DeviceTrace()
        tap_phases(cli, span_sink(trace))
        trace.start()

        def commands() -> None:
            for line in sys.stdin:
                if line.strip() == "start":
                    trace.open()
                elif line.strip() == "stop":
                    trace.close()
                    return

        threading.Thread(target=commands, daemon=True).start()
    rc = cli.run(cli_args)
    on_card = torch.cuda.is_available() and torch.cuda.is_initialized()
    report = {
        "rc": rc,
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "memory_peak_bytes": int(torch.cuda.max_memory_allocated()) if on_card else 0,
        "launches": dict(cuda_scorer.launch_counts),
        "held": forbidden_modules(),
    }
    if trace is not None:
        trace.stop()
        if trace.t1 is not None:
            report["trace"] = trace.summary(outside="serve loop")
    print(MARK + json.dumps(report), file=sys.stderr, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
