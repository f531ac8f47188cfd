"""Shared logging setup: one console handler per named logger, funcName in
the format (the JAX package's ``utils/logging.py`` without its JSON and
file handlers, which the ported path does not use)."""

from __future__ import annotations

import logging

_FORMAT = "%(asctime)s %(levelname)s %(name)s:%(funcName)s - %(message)s"
_configured: set = set()


def get_logger(name: str = "tpuml") -> logging.Logger:
    logger = logging.getLogger(name)
    if name in _configured:
        return logger
    logger.setLevel(logging.INFO)
    logger.propagate = False
    console = logging.StreamHandler()
    console.setFormatter(logging.Formatter(_FORMAT))
    logger.addHandler(console)
    _configured.add(name)
    return logger
