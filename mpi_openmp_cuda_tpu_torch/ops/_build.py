"""Build and load the CUDA kernels of ``csrc/`` (nvcc + ctypes).

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use, on the machine with the card, into its own shared library under
``build/torch_kernels/`` beside the package:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
         -Xcompiler -fPIC -Xptxas -v -o <name>-<hash>.so csrc/<name>.cu

The file name carries a hash of the sources (the ``.cu`` file and the
shared ``.cuh`` headers) and flags, so an edited source is rebuilt and a
stale library is never loaded.  Processes that share the build directory
(the ranks of a ``--distributed`` job) build each library once: a build
holds an exclusive file lock on ``build/torch_kernels/.lock`` while it
checks what is missing and compiles it, each compiler writes a
temporary file of its own, and ``os.replace`` publishes it whole.  ``build()`` starts one ``nvcc`` per
source, all at once, and returns each compiler's ``-Xptxas -v`` report
(registers, shared memory, spills); ``build_variants()`` does the same
for the sweep scripts' builds of one source under other ``-D`` settings.
Each successful nvcc build publishes one ``recompile`` event on the obs
bus (the run report's ``recompiles`` counter).  :func:`build_count` counts
every build, every library load and every lazy per-width setup
(:func:`note_setup`) of this process: the serve loop's
``serve_steady_compiles`` gauge is its delta after the first block.
Nothing here runs at import: the CPU tests import every module.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from ..obs.events import publish
from ..resilience.policy import KernelUnavailableError
from ..utils.env import env_str

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_count = 0  # builds + library loads + per-width setups (build_count)


def build_count() -> int:
    """The nvcc builds, library loads and lazy per-width setups this
    process has made so far (each one a cold start of a launch shape)."""
    return _count


def note_setup() -> None:
    """Count one lazy per-width setup (e.g. a shared-memory opt-in)."""
    global _count
    _count += 1


def _nvcc() -> str:
    cuda_home = env_str("CUDA_HOME") or env_str("CUDA_PATH")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").exists():
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise KernelUnavailableError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels are compiled at first use"
    )


def source_digest(name: str) -> str:
    """sha256 hex of the flags and sources a build of ``csrc/<name>.cu``
    depends on (the ``.cu`` file and the shared ``.cuh`` headers)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        digest.update(path.read_bytes())
    return digest.hexdigest()


def _target(name: str) -> Path:
    return BUILD_DIR / f"{name}-{source_digest(name)[:16]}.so"


def _compile(jobs: dict[str, tuple[Path, Path, tuple[str, ...]]]) -> dict[str, str]:
    """Run one ``nvcc`` per job ``{tag: (source, library, extra flags)}``,
    all started together, each into a temporary file moved onto its
    library when it succeeds; returns ``{tag: ptxas report}``.  Raises
    ``KernelUnavailableError`` with the compiler's output when one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, (src, out, flags) in jobs.items():
        tmp = out.with_suffix(f".{os.getpid()}-{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *flags, "-o", str(tmp), str(src)]
        procs[tag] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
            out,
        )
    failed = []
    reports = {}
    for tag, (proc, tmp, out) in procs.items():
        report, _ = proc.communicate()
        reports[tag] = report
        if proc.returncode != 0:
            failed.append(f"{tag} (nvcc exit {proc.returncode}):\n{report}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
            note_setup()
            publish("recompile", kernel=tag)
    if failed:
        raise KernelUnavailableError("kernel build failed: " + "\n".join(failed))
    return reports


@contextlib.contextmanager
def _build_lock():
    """The build directory's exclusive file lock, for one build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build(names) -> dict[str, str]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    per source, all started together, under the build directory's lock
    (another process's build of the same sources waits, then finds them
    built); returns ``{name: ptxas report}`` for the kernels compiled by
    this call.  Raises ``KernelUnavailableError`` (fatal to the run, never
    retried) with the compiler's output when one fails."""
    with _build_lock():
        jobs = {}
        for name in names:
            out = _target(name)
            if not out.exists():
                jobs[name] = (CSRC_DIR / f"{name}.cu", out, ())
        return _compile(jobs)


def build_variants(
    source: Path, variants: dict[str, tuple[str, ...]]
) -> dict[str, tuple[ctypes.CDLL, str]]:
    """Compile ``source`` once per variant ``{tag: extra nvcc flags}`` (a
    sweep's ``-D`` settings), all started together, and load each:
    ``{tag: (library, ptxas report)}``.  Always rebuilds; the libraries
    are named by this process, so two sweeps never share one."""
    jobs = {
        tag: (source, BUILD_DIR / f"sweep-{source.stem}-{tag}-{os.getpid()}.so",
              (*flags, f"-I{CSRC_DIR}"))
        for tag, flags in variants.items()
    }
    reports = _compile(jobs)
    return {tag: (ctypes.CDLL(str(jobs[tag][1])), reports[tag]) for tag in jobs}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            try:
                lib = ctypes.CDLL(str(_target(name)))
            except OSError as e:
                raise KernelUnavailableError(f"cannot load the {name} kernel: {e}") from e
            _libs[name] = lib
            note_setup()
        return lib
