"""Typed, layered configuration system.

One dataclass hierarchy resolved as: defaults <- environment variables
(``TPUML_SECTION__FIELD``) <- explicit overrides.
The sections and defaults are the subset of the JAX package's
``utils/config.py`` that the ported direct-mode path reads.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional

_ENV_PREFIX = "TPUML_"


@dataclasses.dataclass
class StorageConfig:
    """Filesystem layout: ``<root>/datasets/<id>/*.csv`` with a
    ``preprocessed/`` subdirectory, ``<root>/configs/<id>/*.yaml``
    preprocessing configs, ``<root>/models/<subtask_id>_model.pkl`` winner
    artifacts (runtime/artifacts.py), plus the job journal."""

    root: str = os.path.expanduser("~/.tpuml")

    @property
    def datasets_dir(self) -> str:
        return os.path.join(self.root, "datasets")

    @property
    def configs_dir(self) -> str:
        return os.path.join(self.root, "configs")

    @property
    def models_dir(self) -> str:
        return os.path.join(self.root, "models")

    @property
    def journal_dir(self) -> str:
        return os.path.join(self.root, "journal")


@dataclasses.dataclass
class ExecutionConfig:
    """Trial-execution knobs."""

    # max trials fused into one batched dispatch on the generic path
    max_trials_per_batch: int = 256
    # cv defaults matching sklearn cross_val_score(cv=5)
    default_cv_folds: int = 5
    default_test_size: float = 0.2


@dataclasses.dataclass
class ServiceConfig:
    """Client-side waiting knobs."""

    client_timeout_s: float = 600.0


@dataclasses.dataclass
class FrameworkConfig:
    storage: StorageConfig = dataclasses.field(default_factory=StorageConfig)
    execution: ExecutionConfig = dataclasses.field(default_factory=ExecutionConfig)
    service: ServiceConfig = dataclasses.field(default_factory=ServiceConfig)

    @classmethod
    def load(cls, env: Optional[dict] = None, **overrides: Any) -> "FrameworkConfig":
        cfg = cls().merged(_env_overrides(env if env is not None else os.environ))
        if overrides:
            cfg = cfg.merged(overrides)
        return cfg

    def merged(self, updates: dict) -> "FrameworkConfig":
        return _merge_dataclass(self, updates)


def _merge_dataclass(obj, updates: dict):
    if not dataclasses.is_dataclass(obj):
        return updates
    kwargs = {}
    for f in dataclasses.fields(obj):
        cur = getattr(obj, f.name)
        if f.name in updates:
            upd = updates[f.name]
            if dataclasses.is_dataclass(cur) and isinstance(upd, dict):
                kwargs[f.name] = _merge_dataclass(cur, upd)
            else:
                kwargs[f.name] = upd
        else:
            kwargs[f.name] = cur
    return type(obj)(**kwargs)


def _env_overrides(env) -> dict:
    """TPUML_SECTION__FIELD=value -> {"section": {"field": parsed}}. Keys
    naming a section or field this package lacks are dropped by the merge."""
    out: dict = {}
    for key, raw in env.items():
        if not key.startswith(_ENV_PREFIX):
            continue
        parts = key[len(_ENV_PREFIX):].lower().split("__")
        if len(parts) != 2:
            continue
        section, field = parts
        try:
            value: Any = json.loads(raw)
        except (json.JSONDecodeError, ValueError):
            value = raw
        out.setdefault(section, {})[field] = value
    return out


_GLOBAL_CONFIG: Optional[FrameworkConfig] = None


def get_config() -> FrameworkConfig:
    global _GLOBAL_CONFIG
    if _GLOBAL_CONFIG is None:
        _GLOBAL_CONFIG = FrameworkConfig.load()
    return _GLOBAL_CONFIG


def set_config(cfg: FrameworkConfig) -> None:
    global _GLOBAL_CONFIG
    _GLOBAL_CONFIG = cfg
