"""Build the package's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its
own by ``nvcc`` for Hopper (``sm_90a``) into
``<build dir>/lib<name>-<hash>.so``, where the hash covers the source, the
headers it may include (``csrc/*.cuh``) and the flags, so an edited source
or header is rebuilt and an unchanged one is reused.
The build directory is ``csrc/build/``, or ``CS230_AOT_DIR`` when set (the
JAX package's name for where its persistent artifacts live).
The libraries are loaded with ``ctypes``; no PyTorch headers are compiled,
which keeps a build to seconds. Several sources compile in parallel, one
``nvcc`` process each.

The compiler's resource report (``-Xptxas -v``: registers, shared memory,
spills per kernel) is kept beside each library as ``.log``.

``load_seconds()`` is the calling thread's running total of seconds spent
building and loading libraries at first use: the trial engine reads it
before and after a run for ``TrialRunResult.compile_time_s`` (0 once every
library a run needs is loaded).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
#: the default build directory
BUILD_DIR = CSRC_DIR / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
#: per thread: seconds spent in ``load`` building or opening a library
_tls = threading.local()


def load_seconds() -> float:
    """Seconds this thread has spent building and loading libraries."""
    return getattr(_tls, "seconds", 0.0)


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or the
    toolkit's default location."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked at $CUDA_HOME/bin, PATH, /usr/local/cuda/bin): "
        "the CUDA kernels are built at first use and need the CUDA toolkit"
    )


def build_dir() -> Path:
    """Where the libraries are built and kept: ``CS230_AOT_DIR`` when set,
    else ``csrc/build/``."""
    override = os.environ.get("CS230_AOT_DIR")
    return Path(override) if override else BUILD_DIR


def headers() -> bytes:
    """The shared headers ``csrc/*.cuh``, in name order, as one string."""
    return b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + headers() + " ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every named source whose library is missing (all sources in
    ``csrc/`` by default), one ``nvcc`` each, all started together. Returns
    ``{name: seconds}`` for the sources compiled now; raises with the
    compiler's output when one fails."""
    if names is None:
        names = source_names()
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    build_dir().mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    seconds: Dict[str, float] = {}
    failures = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"nvcc failed for csrc/{name}.cu:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failures:
        raise RuntimeError("\n".join(failures))
    # a new generation landed: superseded libraries may go (age-guarded)
    from ..utils.aot_cache import _prune_stale_generations

    _prune_stale_generations()
    return seconds


def source_names() -> list:
    """The stems of every ``csrc/*.cu``."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def warm_libraries(names: Optional[Iterable[str]] = None) -> None:
    """Build the missing libraries (one ``nvcc`` each, all started
    together) and load every one, so a later first launch pays nothing.
    The seconds count toward this thread's ``load_seconds``."""
    names = list(source_names() if names is None else names)
    t0 = time.perf_counter()
    try:
        with _lock:
            build([n for n in names if n not in _loaded])
    finally:
        _tls.seconds = load_seconds() + time.perf_counter() - t0
    for name in names:
        load(name)


def build_log(name: str) -> str:
    """The compiler's output (ptxas resource report) for a built source."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    t0 = time.perf_counter()
    try:
        with _lock:
            lib = _loaded.get(name)
            if lib is None:
                build([name])
                lib = ctypes.CDLL(str(library_path(name)))
                _loaded[name] = lib
            return lib
    finally:
        _tls.seconds = load_seconds() + time.perf_counter() - t0
