"""The valve and the journal writer of the JAX package's ``obs/tracing.py``.

Only the two pieces the flight recorder (``obs/recorder.py``) needs are
ported: ``_enabled`` (the ``CS230_OBS`` master valve) and
``journal_append`` (the size-rotated, best-effort JSONL appender under the
journal directory), which here buffers its lines until ``flush_journal``.
Spans and their propagation are not ported yet.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
from typing import Any, Dict, List


def _enabled() -> bool:
    return os.environ.get("CS230_OBS", "1") != "0"


def _journal_max_bytes() -> int:
    """Size cap per journal file before a rotation to ``<name>.1`` (one
    rotated generation kept)."""
    try:
        return int(float(os.environ.get("CS230_JOURNAL_MAX_MB", "64")) * 1e6)
    except ValueError:
        return int(64e6)


def journal_dir() -> str:
    """``CS230_JOURNAL_DIR`` when set, else the configured storage root's
    journal directory."""
    d = os.environ.get("CS230_JOURNAL_DIR")
    if not d:
        from ..utils.config import get_config

        d = get_config().storage.journal_dir
    return d


#: journal path -> its lines not yet written, in order. A search journals
#: a few events a trial, and on a slow filesystem an open and a close a
#: line cost more than the line (tools/job_ab.py measures both)
_PENDING: Dict[str, List[str]] = {}
_LOCK = threading.Lock()
#: lines a file holds before they are written without waiting for a flush
_MAX_PENDING = 1024


def _write(path: str, lines: List[str]) -> None:
    """Append ``lines`` to ``path`` (its directory made when missing) and
    roll the file to ``<name>.1`` once the append leaves it past the cap.
    Any filesystem failure drops the lines."""
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "a") as f:
            f.write("".join(lines))
            size = f.tell()
        if size > _journal_max_bytes():
            os.replace(path, path + ".1")
    except Exception:  # noqa: BLE001 — observability must never fail a job
        pass


def journal_append(basename: str, obj: Dict[str, Any]) -> None:
    """Best-effort size-rotated JSONL append under the journal dir: the
    same lines as the JAX package's writer, buffered until
    ``flush_journal`` (the coordinator flushes before a job is finalized,
    and the process at exit) or until a file holds ``_MAX_PENDING``."""
    try:
        path = os.path.join(journal_dir(), basename)
        line = json.dumps(obj, default=str) + "\n"
    except Exception:  # noqa: BLE001
        return
    with _LOCK:
        pending = _PENDING.setdefault(path, [])
        pending.append(line)
        if len(pending) >= _MAX_PENDING:
            _write(path, pending)
            del _PENDING[path]


def flush_journal() -> None:
    """Write every buffered journal line, each file's in order."""
    with _LOCK:
        for path, lines in _PENDING.items():
            _write(path, lines)
        _PENDING.clear()


atexit.register(flush_journal)
