"""Shared logging setup: a copy of the JAX package's ``utils/logging.py``.

One console handler per named logger, plus an optional daily-rotating file
handler (``log_dir``) with 7 backups, funcName in the format.

``CS230_LOG_JSON=1`` opts into structured JSON lines (one object per
record) stamped with the active ``trace_id``/``span_id`` from the obs
context — so logs, metrics, and traces join on one id
(docs/OBSERVABILITY.md "Structured logs"). The env var is read when a
logger is first configured; already-configured loggers keep their format.
"""

from __future__ import annotations

import json
import logging
import os
import time
from logging.handlers import TimedRotatingFileHandler

_FORMAT = "%(asctime)s %(levelname)s %(name)s:%(funcName)s - %(message)s"
_configured: set = set()


def _json_logs_enabled() -> bool:
    return os.environ.get("CS230_LOG_JSON", "0") == "1"


class JsonFormatter(logging.Formatter):
    """One JSON object per record. Keys: ``ts`` (epoch seconds), ``level``,
    ``logger``, ``func``, ``msg``, plus ``trace_id``/``span_id`` when a
    trace is active in the emitting context (the obs contextvar — handlers
    run on the emitting thread, so the ids are the caller's) and ``exc``
    for records carrying exception info."""

    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(record.created, 6),
            "level": record.levelname,
            "logger": record.name,
            "func": record.funcName,
            "msg": record.getMessage(),
        }
        # lazy import: utils.logging must stay importable before obs (and
        # obs logs through here) — no import cycle at module load
        try:
            from ..obs.tracing import current_span_id, current_trace_id

            tid = current_trace_id()
            if tid:
                out["trace_id"] = tid
            sid = current_span_id()
            if sid:
                out["span_id"] = sid
        except Exception:  # noqa: BLE001 — a log line must never raise
            pass
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, default=str)

    def formatTime(self, record, datefmt=None):  # pragma: no cover - unused
        return time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(record.created))


def _make_formatter() -> logging.Formatter:
    if _json_logs_enabled():
        return JsonFormatter()
    return logging.Formatter(_FORMAT)


def get_logger(name: str = "tpuml", log_dir: str | None = None) -> logging.Logger:
    logger = logging.getLogger(name)
    if name in _configured:
        return logger
    logger.setLevel(logging.INFO)
    logger.propagate = False
    fmt = _make_formatter()
    console = logging.StreamHandler()
    console.setFormatter(fmt)
    logger.addHandler(console)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        fh = TimedRotatingFileHandler(
            os.path.join(log_dir, "app.log"), when="midnight", backupCount=7
        )
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    _configured.add(name)
    return logger
