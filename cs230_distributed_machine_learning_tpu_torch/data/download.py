"""Dataset ingestion: kaggle / huggingface / local / builtin sources.

Port of the JAX package's ``data/download.py`` (framework-free). External
sources are imported only when asked for, and a missing package raises
``RuntimeError``, so the framework runs where they are not installed.
"""

from __future__ import annotations

import os
import shutil
from typing import Iterator, Optional, Sequence

from ..utils.logging import get_logger
from .datasets import dataset_dir, materialize_builtin

logger = get_logger("tpuml.data")


def iter_csv_chunks(
    path: str,
    chunk_rows: int = 65536,
    columns: Optional[Sequence[str]] = None,
) -> Iterator["object"]:
    """Stream a CSV's rows in bounded-height DataFrame chunks: the ingest
    half of out-of-core streaming (data/streaming.py). A CSV larger than
    host memory is consumed one ``chunk_rows`` slice at a time —
    ``data/preprocess.py``'s two-pass scaler folds these into running
    stats, then re-reads them as design blocks for ``CsvBlockSource``.
    ``pandas.read_csv(chunksize=)``, so dtype inference and header
    handling match the whole-file reader."""
    import pandas as pd

    reader = pd.read_csv(
        path, chunksize=max(int(chunk_rows), 1),
        usecols=list(columns) if columns is not None else None,
    )
    for chunk in reader:
        yield chunk


def download_dataset(
    dataset_url: str,
    dataset_name: str,
    dataset_type: str,
    root: Optional[str] = None,
) -> str:
    """Stage a dataset under <root>/datasets/<name>/. Returns the directory."""
    target = dataset_dir(dataset_name, root)
    os.makedirs(target, exist_ok=True)

    if dataset_type == "kaggle":
        try:
            import kaggle
        except ImportError as e:
            raise RuntimeError("kaggle package not available in this environment") from e
        except OSError as e:
            # the kaggle client authenticates at import time
            raise RuntimeError(
                "kaggle credentials not found: set KAGGLE_USERNAME/KAGGLE_KEY "
                "in the coordinator's environment or mount kaggle.json "
                "(KAGGLE_CONFIG_DIR)"
            ) from e
        kaggle.api.dataset_download_files(dataset_url, path=target, unzip=True)
    elif dataset_type in ("huggingface", "hf"):
        try:
            from datasets import load_dataset
        except ImportError as e:
            raise RuntimeError("huggingface datasets package not available") from e
        ds = load_dataset(dataset_url)
        split = next(iter(ds))
        ds[split].to_csv(os.path.join(target, f"{dataset_name}.csv"))
    elif dataset_type == "local":
        if os.path.isdir(dataset_url):
            for name in os.listdir(dataset_url):
                if name.endswith(".csv"):
                    shutil.copy(os.path.join(dataset_url, name), target)
        elif os.path.isfile(dataset_url):
            shutil.copy(dataset_url, target)
        else:
            raise FileNotFoundError(dataset_url)
    elif dataset_type == "builtin":
        if materialize_builtin(dataset_name, root=root) is None:
            raise ValueError(f"Unknown builtin dataset {dataset_name!r}")
    else:
        raise ValueError(f"Unknown dataset_type {dataset_type!r}")

    logger.info("Staged dataset %s (%s) at %s", dataset_name, dataset_type, target)
    return target
