"""The persistent kernel artifacts of a process's cold start.

Counterpart of the JAX package's ``utils/aot_cache.py``. There the
persistent artifacts are serialized traced executables (``jax.export``
blobs) that spare a fresh process its tracing. Eager PyTorch traces
nothing, so the port has no executables to serialize: what a fresh
process pays before its first launch is the kernel libraries' build
(``nvcc``) and load, and those libraries already persist under
``csrc/build/`` keyed by a hash of their source, headers and flags
(ops/cuda_build.py; ``CS230_AOT_DIR`` moves them, as it moves the JAX
package's). This module keeps the surface the JAX module's
callers read — ``cache_dir``, ``enabled``, ``generation_inventory`` (the
prewarm worker's log line, runtime/prewarm.py) — over those libraries.

A generation is the hash of every ``csrc/*.cu``, the shared ``csrc/*.cuh``,
``NVCC_FLAGS`` and the torch / CUDA versions; its libraries are those whose file names carry the
current per-source hashes. ``_prune_stale_generations`` removes the
libraries of older hashes from ``csrc/build/``. JAX's ``aot_jit`` has no
counterpart (nothing to export).
"""

from __future__ import annotations

import hashlib
import os
import time
from typing import Dict, Optional

from ..ops import cuda_build

#: a superseded library untouched this long is pruned (JAX: the same age
#: floor, so two live checkouts never delete each other's artifacts)
_PRUNE_AGE_S = 7 * 24 * 3600
_PRUNED = False


def cache_dir() -> str:
    """Where the kernel libraries persist: ``CS230_AOT_DIR`` when set (the
    JAX package's valve), else ``csrc/build/``."""
    return str(cuda_build.build_dir())


def enabled() -> bool:
    """On where the libraries can exist (a CUDA build of torch);
    ``CS230_AOT_CACHE=0`` turns the inventory off everywhere."""
    if os.environ.get("CS230_AOT_CACHE", "1") == "0":
        return False
    import torch

    return torch.version.cuda is not None


def generation() -> str:
    """Hash of the sources, the flags and the torch / CUDA versions."""
    import torch

    h = hashlib.sha256()
    for name in cuda_build.source_names():
        h.update(name.encode())
        h.update((cuda_build.CSRC_DIR / f"{name}.cu").read_bytes())
    h.update(cuda_build.headers())
    h.update(" ".join(cuda_build.NVCC_FLAGS).encode())
    h.update(f"{torch.__version__}|{torch.version.cuda}".encode())
    return h.hexdigest()[:16]


def _current_files() -> Dict[str, str]:
    """``{file name: source}`` of the current libraries."""
    return {cuda_build.library_path(n).name: n for n in cuda_build.source_names()}


def generation_inventory() -> dict:
    """Libraries of the current generation already built, and their bytes:
    what a fresh process loads without compiling. Zeros when disabled or
    none is built."""
    out = {"n_blobs": 0, "bytes": 0, "dir": None, "generation": None}
    try:
        if not enabled():
            return out
        out["dir"] = cache_dir()
        out["generation"] = generation()
        for fname in _current_files():
            path = cuda_build.build_dir() / fname
            if path.exists():
                out["n_blobs"] += 1
                out["bytes"] += path.stat().st_size
    except OSError:
        pass
    return out


def _prune_stale_generations(max_age_s: Optional[float] = None) -> int:
    """Remove ``csrc/build/lib<name>-<hash>.so`` (and its ``.log``) of
    hashes other than the current sources', untouched for ``max_age_s``
    (default ``_PRUNE_AGE_S``); once a process unless ``max_age_s`` is
    given. Returns the files removed."""
    global _PRUNED
    if max_age_s is None:
        if _PRUNED:
            return 0
        _PRUNED = True
        max_age_s = _PRUNE_AGE_S
    keep = set(_current_files())
    names = set(cuda_build.source_names())
    removed = 0
    now = time.time()
    try:
        entries = list(cuda_build.build_dir().iterdir())
    except OSError:
        return 0
    for path in entries:
        if not (path.suffix == ".so" and path.name.startswith("lib")):
            continue
        stem = path.name[len("lib"):-len(".so")]
        if "-" not in stem or stem.rsplit("-", 1)[0] not in names or path.name in keep:
            continue
        try:
            if now - path.stat().st_mtime < max_age_s:
                continue
            for p in (path, path.with_suffix(".log")):
                if p.exists():
                    p.unlink()
                    removed += 1
        except OSError:
            continue
    return removed
