"""Result printer (reference parity: C8, main.c:199-211).

Byte-identical output contract: one line per Seq2, in input order:
``#i: score: S, n: N, k: K``.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
from typing import Iterable, Sequence, TextIO


def format_result(i: int, score: int, n: int, k: int) -> str:
    return f"#{i}: score: {score}, n: {n}, k: {k}"


def print_results(
    results: Iterable[Sequence[int]],
    out: TextIO | None = None,
    start: int = 0,
) -> None:
    """``start`` offsets the printed indices — the streaming pipeline
    prints chunk by chunk while keeping global input-order numbering."""
    out = out or sys.stdout
    for i, (score, n, k) in enumerate(results, start=start):
        print(format_result(i, int(score), int(n), int(k)), file=out)


@contextlib.contextmanager
def guarded_stdout():
    """Protect the result stream from native-library chatter.

    Multi-process collective backends can write status lines directly to
    file descriptor 1 from C++ (e.g. Gloo's peer-connection banner on the
    CPU backend), interleaving with — and corrupting — the byte-exact
    result contract.  This redirects fd 1 to stderr for the duration and
    yields a stream on a private duplicate of the real stdout, so only
    deliberate result printing reaches it.
    """
    sys.stdout.flush()
    saved = os.dup(1)
    try:
        real_stdout = os.fdopen(saved, "w")
    except OSError:
        os.close(saved)
        raise
    try:
        os.dup2(2, 1)
        yield real_stdout
    finally:
        # fd 1 must be restored even if flushing raises (e.g. BrokenPipeError
        # when the consumer of the real stdout has gone away).
        try:
            real_stdout.flush()
            sys.stdout.flush()
        finally:
            os.dup2(saved, 1)
            real_stdout.close()  # closes the dup; fd 1 is restored above


def write_json_sidecar(
    results: Iterable[Sequence[int]], path: str, meta: dict | None = None
) -> None:
    """Optional structured sidecar (§5 observability); stdout stays canonical."""
    payload = {
        "results": [
            {"index": i, "score": int(s), "n": int(n), "k": int(k)}
            for i, (s, n, k) in enumerate(results)
        ],
    }
    if meta:
        payload["meta"] = meta
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=2)
        f.write("\n")
