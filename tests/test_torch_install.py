"""The installed port, the twin of ``tests/test_install.py``: the port
installs (editable, or as a wheel) with ``--no-build-isolation --no-deps``
and runs byte-exact from a foreign working directory through the
``tpu-seqalign-torch`` console script and ``python -m
mpi_openmp_cuda_tpu_torch``, and its kernels are built where
``ops/_build.py::resolve_build_dir`` says: ``build/torch_kernels`` in a
checkout, ``<cache home>/torch_kernels`` in an installed copy, a
temporary directory removed at exit with caching off, never inside
site-packages.

Each venv is chained to the running interpreter's site-packages by a
``.pth`` file (no network: no build isolation, no dependency downloads),
and the package is built from a copy of the checkout, so the checkout
itself gains no ``build/`` or ``.egg-info``."""

from __future__ import annotations

import glob
import json
import os
import shutil
import subprocess
import sys
import sysconfig
import tempfile
import zipfile
from pathlib import Path

import pytest

from mpi_openmp_cuda_tpu_torch.io import cli as tcli
from mpi_openmp_cuda_tpu_torch.ops import _build
from mpi_openmp_cuda_tpu_torch.ops import cuda_scorer as cs
from mpi_openmp_cuda_tpu_torch.resilience.policy import KernelUnavailableError
from mpi_openmp_cuda_tpu_torch.utils.env import package_version

REPO = Path(__file__).resolve().parent.parent
PKG = "mpi_openmp_cuda_tpu_torch"
FIXTURES = sorted((REPO / "tests" / "fixtures").glob("*.txt"), key=lambda p: p.name)
IDS = [p.stem for p in FIXTURES]
PIP = ("--no-index", "--no-deps", "--no-build-isolation", "-q")
KINDS = ("wheel", "editable")


def _tree(root: Path) -> set[str]:
    """Every file and directory under ``root``."""
    out = set()
    for d, dirs, files in os.walk(root):
        out.update(os.path.join(d, n) for n in dirs + files)
    return out


def _env(cache: Path, **extra) -> dict:
    """The runs' environment: the install, not an inherited path, must
    resolve the package, and the cache home is ``cache``."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "TPU_SEQALIGN_COMPILE_CACHE")}
    return {**env, "SEQALIGN_CACHE_DIR": str(cache), **extra}


def _venv(path: Path) -> Path:
    subprocess.run([sys.executable, "-m", "venv", str(path)], check=True, timeout=120)
    site = Path(glob.glob(str(path / "lib" / "python*" / "site-packages"))[0])
    live = {sysconfig.get_paths()[k] for k in ("purelib", "platlib")}
    (site / "chain.pth").write_text("".join(f"{p}\n" for p in sorted(live)))
    return site


@pytest.fixture(scope="module")
def installs(tmp_path_factory):
    """``{kind: (venv, site-packages, its files after the install, source)}``
    for a wheel install and an editable install of a copy of the checkout."""
    root = tmp_path_factory.mktemp("install")
    src = root / "src"
    src.mkdir()
    for name in ("pyproject.toml", "README.md"):
        shutil.copy(REPO / name, src)
    for name in ("mpi_openmp_cuda_tpu", PKG):
        shutil.copytree(REPO / name, src / name,
                        ignore=shutil.ignore_patterns("__pycache__"))
    subprocess.run([sys.executable, "-m", "pip", "wheel", *PIP, "-w", str(root / "dist"),
                    str(src)], check=True, timeout=300)
    wheel = glob.glob(str(root / "dist" / "*.whl"))[0]
    out = {}
    for kind, target in (("wheel", [wheel]), ("editable", ["-e", str(src)])):
        venv = root / kind
        site = _venv(venv)
        subprocess.run([str(venv / "bin" / "pip"), "install", *PIP, *target],
                       check=True, timeout=300)
        out[kind] = (venv, site, _tree(site), src)
    (root / "elsewhere").mkdir()
    out["wheel_file"] = Path(wheel)
    out["foreign"] = root / "elsewhere"
    return out


def test_wheel_ships_the_kernel_sources_and_both_scripts(installs):
    with zipfile.ZipFile(installs["wheel_file"]) as whl:
        names = set(whl.namelist())
        scripts = next(whl.read(n).decode() for n in names
                       if n.endswith(".dist-info/entry_points.txt"))
    for src in (*_build.CSRC_DIR.glob("*.cu"), *_build.CSRC_DIR.glob("*.cuh")):
        assert f"{PKG}/csrc/{src.name}" in names  # what source_digest hashes
    assert "tpu-seqalign = mpi_openmp_cuda_tpu.io.cli:main" in scripts
    assert "tpu-seqalign-torch = mpi_openmp_cuda_tpu_torch.io.cli:main" in scripts


@pytest.mark.parametrize("path", FIXTURES, ids=IDS)
@pytest.mark.parametrize("entry", ["script", "module"])
@pytest.mark.parametrize("kind", KINDS)
def test_installed_cli_prints_the_golden(installs, kind, entry, path, tmp_path):
    venv = installs[kind][0]
    cmd = ([str(venv / "bin" / "tpu-seqalign-torch")] if entry == "script"
           else [str(venv / "bin" / "python"), "-m", PKG])
    with path.open("rb") as fh:
        proc = subprocess.run([*cmd, "--device", "cpu"], stdin=fh, capture_output=True,
                              cwd=installs["foreign"], env=_env(tmp_path / "cache"),
                              timeout=300)
    assert proc.returncode == 0, proc.stderr.decode()
    assert proc.stdout == path.with_suffix(".out").read_bytes()


@pytest.mark.parametrize("kind", KINDS)
def test_installed_package_resolves_its_build_dir(installs, kind, tmp_path):
    venv, site, _, src = installs[kind]
    code = (f"import {PKG} as p; from {PKG}.ops import _build; "
            "print(p.__file__); print(_build.BUILD_DIR); print(p.__version__)")
    proc = subprocess.run([str(venv / "bin" / "python"), "-c", code], capture_output=True,
                          text=True, cwd=installs["foreign"], env=_env(tmp_path / "cache"),
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    where, build_dir, version = proc.stdout.split("\n")[:3]
    assert version == package_version()  # the checkout's pyproject.toml value
    if kind == "wheel":
        assert Path(where).is_relative_to(site)
        assert build_dir == str(tmp_path / "cache" / "torch_kernels")
    else:  # an editable install runs from its checkout
        assert Path(where).is_relative_to(src)
        assert build_dir == str(src / "build" / "torch_kernels")


def test_two_installed_processes_build_at_once(installs, tmp_path):
    """Two installed processes that share one cache home build both kernels
    at once: both succeed, each library is compiled once (the second
    process waits on the build lock, then finds them built), the libraries
    land in ``<cache home>/torch_kernels`` and site-packages gains no file."""
    venv, site, files, _ = installs["wheel"]
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    log = tmp_path / "nvcc.log"
    nvcc.write_text(f'#!/bin/sh\necho "$$" >> {log}\nsleep 1\n'
                    'while [ "$1" != "-o" ]; do shift; done\ntouch "$2"\n')
    nvcc.chmod(0o755)
    code = (f"from {PKG}.ops import _build; "
            "print(sorted(_build.build(['fused_scorer', 'packed_scorer'])))")
    env = _env(tmp_path / "cache", CUDA_HOME=str(tmp_path / "cuda"))
    procs = [subprocess.Popen([str(venv / "bin" / "python"), "-c", code], env=env,
                              cwd=installs["foreign"], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [err for _, err in outs]
    built = sorted(out.strip() for out, _ in outs)
    assert built == ["['fused_scorer', 'packed_scorer']", "[]"]
    assert len(log.read_text().split()) == 2
    libs = sorted(p.name.split("-")[0] for p in (tmp_path / "cache" / "torch_kernels").glob("*.so"))
    assert libs == ["fused_scorer", "packed_scorer"]
    assert _tree(site) == files


# -- the build-directory rule, in-process -----------------------------------


@pytest.fixture
def installed_pkg(tmp_path, monkeypatch):
    """A package directory that is not in a checkout (nothing beside it
    names this project), with the cache variables cleared and HOME moved."""
    pkg = tmp_path / "site-packages" / PKG
    pkg.mkdir(parents=True)
    monkeypatch.delenv("TPU_SEQALIGN_COMPILE_CACHE", raising=False)
    monkeypatch.delenv("SEQALIGN_CACHE_DIR", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    return pkg


def test_checkout_builds_beside_the_package():
    assert _build.BUILD_DIR == REPO / "build" / "torch_kernels"
    assert _build.resolve_build_dir() == _build.BUILD_DIR


def test_installed_copy_builds_under_the_cache_home(installed_pkg, tmp_path, monkeypatch):
    home = tmp_path / "home" / ".cache" / PKG / "torch_kernels"
    assert _build.resolve_build_dir(installed_pkg) == home
    # Another project's pyproject.toml above site-packages is no checkout.
    (installed_pkg.parent / "pyproject.toml").write_text('[project]\nname = "other"\n')
    assert _build.resolve_build_dir(installed_pkg) == home
    monkeypatch.setenv("TPU_SEQALIGN_COMPILE_CACHE", str(tmp_path / "legacy"))
    assert _build.resolve_build_dir(installed_pkg) == tmp_path / "legacy" / "torch_kernels"
    monkeypatch.setenv("SEQALIGN_CACHE_DIR", str(tmp_path / "explicit"))
    assert _build.resolve_build_dir(installed_pkg) == tmp_path / "explicit" / "torch_kernels"
    # This project's pyproject.toml beside the package is a checkout.
    shutil.copy(REPO / "pyproject.toml", installed_pkg.parent)
    assert _build.resolve_build_dir(installed_pkg) == installed_pkg.parent / "build" / "torch_kernels"


def test_caching_off_builds_in_a_temporary_directory_removed_at_exit(installed_pkg, tmp_path):
    env = _env(tmp_path / "unused", TPU_SEQALIGN_COMPILE_CACHE="off",
               PYTHONPATH=str(REPO))
    code = ("import sys; from pathlib import Path; "
            f"from {PKG}.ops import _build; "
            "d = _build.resolve_build_dir(Path(sys.argv[1])); "
            "assert d != _build.resolve_build_dir(Path(sys.argv[1])); "
            "d.mkdir(); (d / 'k.so').write_text(''); print(d)")
    proc = subprocess.run([sys.executable, "-c", code, str(installed_pkg)], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    made = Path(proc.stdout.strip())
    assert made.parent == Path(tempfile.gettempdir()) and PKG in made.name
    assert not made.exists()


@pytest.fixture
def unwritable_build_dir(monkeypatch, tmp_path):
    """Kernel launches on CPU tensors go to the kernel, and the build
    directory cannot be created: its parent is a file."""
    blocker = tmp_path / "not-a-directory"
    blocker.write_text("")
    monkeypatch.setattr(cs, "_device_of", lambda state: "cuda")
    monkeypatch.setattr(_build, "BUILD_DIR", blocker / "torch_kernels")
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")
    monkeypatch.setattr(_build, "_libs", {})
    cs._entry.cache_clear()
    yield blocker / "torch_kernels"
    cs._entry.cache_clear()


def test_unwritable_build_dir_raises_naming_it(unwritable_build_dir):
    with pytest.raises(KernelUnavailableError, match=str(unwritable_build_dir)):
        _build.build(["fused_scorer"])
    with pytest.raises(KernelUnavailableError, match=str(unwritable_build_dir)):
        _build.build_variants(_build.CSRC_DIR / "fused_scorer.cu", {"a": ()})


def _port(*args, capfd, rc_want=0):
    rc = tcli.run(["--device", "cpu", *args])
    cap = capfd.readouterr()
    assert rc == rc_want, cap.err
    return cap.out, cap.err


def test_unwritable_build_dir_is_the_clis_typed_exit(unwritable_build_dir, capfd):
    """Without --degrade the run ends 65 naming the directory, never a
    PermissionError traceback and never a quiet plain-version run."""
    fixture = REPO / "tests" / "fixtures" / "tiny.txt"
    out, err = _port("--input", str(fixture), "--retries", "2", capfd=capfd, rc_want=65)
    assert out == "" and str(unwritable_build_dir) in err
    assert "Traceback" not in err and "degrading" not in err


def test_unwritable_build_dir_degrades_under_degrade(unwritable_build_dir, capfd):
    fixture = REPO / "tests" / "fixtures" / "tiny.txt"
    out, err = _port("--input", str(fixture), "--degrade", capfd=capfd)
    assert out == fixture.with_suffix(".out").read_text()
    assert "backend 'cuda' cannot run its kernel here; degrading to 'mm'" in err


@pytest.mark.parametrize("flag", ["", "--metrics-out", "--profile"])
def test_run_names_its_kernels_directory_under_metrics_or_profile(
        flag, monkeypatch, capfd, tmp_path):
    """A run that loaded kernels writes where they are to stderr under
    --metrics or --profile, and says nothing of it otherwise; the run
    report counts it as no log line (a rank's report stays equal to the
    snapshot it posted before the line)."""
    monkeypatch.setattr(_build, "_libs", {"fused_scorer": object()})
    fixture = REPO / "tests" / "fixtures" / "tiny.txt"
    report = tmp_path / "report.json"
    args = {"": [], "--metrics-out": ["--metrics-out", str(report)],
            "--profile": ["--profile"]}[flag]
    out, err = _port("--input", str(fixture), *args, capfd=capfd)
    assert out == fixture.with_suffix(".out").read_text()
    line = f"kernels fused_scorer in {_build.BUILD_DIR}"
    assert (line in err) == bool(flag)
    if report.exists():
        assert "log_lines" not in json.loads(report.read_text())["counters"]
