"""YAML-driven tabular preprocessing pipeline.

Port of ``preprocess_dataframe`` of the JAX package's
``data/preprocess.py``: the same operations in the same order, the same
config schema (``examples/titanic_preprocess.yaml``):

1. drop_columns            5. drop_duplicates
2. drop_null (all-or)      6. categorical encode: onehot | label | freq
3. impute: mean|median|mode 7. scale: standard over listed columns
4. outliers: clip|iqr       8. target_column moved to last position

Training reads the last column as the target. The ``label`` encoding is
the port's numpy copy of scikit-learn's ``LabelEncoder``.

``chunked_column_stats`` and ``iter_design_blocks`` (copies of the JAX
package's) are the two passes of an out-of-core ``scale: standard`` over
``data/download.py::iter_csv_chunks``, feeding
``data/streaming.py::CsvBlockSource``.
"""

from __future__ import annotations

from typing import Any, Dict

import pandas as pd

from ..utils.sklearn_compat import label_encode


def preprocess_dataframe(df: pd.DataFrame, config: Dict[str, Any]) -> pd.DataFrame:
    config = _normalize(config)

    if "drop_columns" in config:
        df = df.drop(columns=config["drop_columns"], errors="ignore")

    if config.get("drop_null", False):
        df = df.dropna()
    else:
        for col, method in config.get("impute", {}).items():
            if col not in df.columns:
                continue
            if method == "mean":
                df[col] = df[col].fillna(df[col].mean())
            elif method == "median":
                df[col] = df[col].fillna(df[col].median())
            elif method == "mode":
                df[col] = df[col].fillna(df[col].mode()[0])

    for col, method in config.get("outliers", {}).items():
        if col not in df.columns:
            continue
        if method == "clip":
            lower, upper = df[col].quantile(0.01), df[col].quantile(0.99)
            df[col] = df[col].clip(lower, upper)
        elif method == "iqr":
            q1, q3 = df[col].quantile(0.25), df[col].quantile(0.75)
            iqr = q3 - q1
            df = df[(df[col] >= q1 - 1.5 * iqr) & (df[col] <= q3 + 1.5 * iqr)]

    if config.get("drop_duplicates", False):
        df = df.drop_duplicates()

    for col, method in config.get("categorical", {}).items():
        if col not in df.columns:
            continue
        if method == "onehot":
            dummies = pd.get_dummies(df[col], prefix=col, drop_first=False)
            df = pd.concat([df.drop(columns=[col]), dummies], axis=1)
        elif method == "label":
            df[col] = label_encode(df[col].astype(str))
        elif method == "freq":
            df[col] = df[col].map(df[col].value_counts(normalize=True))

    scale = config.get("scale", {})
    if scale.get("method") == "standard":
        for col in scale.get("columns", []):
            if col not in df.columns:
                continue
            std = df[col].std()
            df[col] = (df[col] - df[col].mean()) / std if std != 0 else 0

    target = config.get("target_column")
    if target and target in df.columns:
        df[target] = df.pop(target)

    return df


def chunked_column_stats(
    chunks: "Any", columns: "Any" = None
) -> Dict[str, Dict[str, float]]:
    """Single streaming pass over DataFrame chunks -> per-column
    ``{count, mean, std}`` via Chan/Welford parallel merge — the stats
    half of an out-of-core ``scale: standard`` (data/streaming.py): the
    full column never materializes, yet mean/std match the whole-frame
    computation to f32 round-off."""
    import numpy as np

    acc: Dict[str, list] = {}
    for chunk in chunks:
        cols = list(columns) if columns is not None else [
            c for c in chunk.columns
            if np.issubdtype(np.asarray(chunk[c]).dtype, np.number)
        ]
        for c in cols:
            v = np.asarray(chunk[c], np.float64)
            v = v[np.isfinite(v)]
            if v.size == 0:
                continue
            cnt, mean = float(v.size), float(v.mean())
            m2 = float(((v - mean) ** 2).sum())
            if c not in acc:
                acc[c] = [cnt, mean, m2]
            else:
                n0, mu0, m20 = acc[c]
                delta = mean - mu0
                tot = n0 + cnt
                acc[c] = [
                    tot,
                    mu0 + delta * cnt / tot,
                    m20 + m2 + delta * delta * n0 * cnt / tot,
                ]
    return {
        c: {
            "count": n0,
            "mean": mu0,
            "std": (m20 / n0) ** 0.5 if n0 > 0 else 0.0,
        }
        for c, (n0, mu0, m20) in acc.items()
    }


def iter_design_blocks(
    chunks: "Any",
    stats: Dict[str, Dict[str, float]] = None,
    target_column: str = None,
):
    """Second streaming pass: yield standardized float32 feature blocks
    (target column dropped) — the host block source ``CsvBlockSource``
    re-chunks into uniform streamer rows. With ``stats`` from
    :func:`chunked_column_stats`, columns named there are standardized
    ``(x - mean) / std`` (std 0 -> column zeroed, matching
    ``preprocess_dataframe``'s whole-frame scaler)."""
    import numpy as np

    for chunk in chunks:
        df = chunk
        if target_column is not None and target_column in df.columns:
            df = df.drop(columns=[target_column])
        X = np.asarray(df, np.float32)
        if stats:
            for j, c in enumerate(df.columns):
                s = stats.get(c)
                if s is None:
                    continue
                std = s["std"]
                if std != 0:
                    X[:, j] = (X[:, j] - s["mean"]) / std
                else:
                    X[:, j] = 0.0
        yield X


def _normalize(config: Dict[str, Any]) -> Dict[str, Any]:
    """Accept both mapping and list-of-single-key-mapping YAML styles for
    ``categorical``/``impute``/``outliers`` (the example YAML lists
    ``categorical``)."""
    out = dict(config)
    for key in ("categorical", "impute", "outliers"):
        val = out.get(key)
        if isinstance(val, list):
            merged: Dict[str, Any] = {}
            for item in val:
                if isinstance(item, dict):
                    merged.update(item)
            out[key] = merged
    return out
