"""Dataset staging, metadata, and the host-side columnar cache.

Port of the JAX package's ``data/datasets.py`` for the ported path. Layout:
``<root>/datasets/<id>/*.csv`` with a ``preprocessed/`` subdirectory; the
last column is the label. A per-process ``DatasetCache`` parses each CSV
once and keeps float32 numpy arrays that every trial reuses; the trial
engine moves them to the device.

The builtins stage byte-identical CSVs to the JAX package's without
scikit-learn: iris is read from the package's copy of scikit-learn's
``iris.csv`` as ``load_iris`` reads it, the synthetic generators call
the port's draw-for-draw copy of ``make_classification``
(utils/sklearn_compat.py), and titanic is the reference's numpy draw,
staged raw for ``preprocess``. CSVs are parsed by the native C++ loader
(``native/``, a copy of the JAX package's: mmap + threaded float32 parse)
when every column is numeric, and by pandas otherwise, by the JAX
package's rules; the parsed arrays go to the same ``<csv>.npz`` sidecar,
same format and version. A worker agent's ``FetchingDatasetCache`` fetches
what it lacks from the coordinator's ``GET /dataset/<id>``.
"""

from __future__ import annotations

import csv
import glob
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..models.base import TrialData
from ..utils.config import get_config
from ..utils.sklearn_compat import make_classification

# parsed-columnar sidecar format, shared with the JAX package's loader
_SIDECAR_VERSION = 2


def dataset_dir(dataset_id: str, root: Optional[str] = None) -> str:
    root = root or get_config().storage.datasets_dir
    return os.path.join(root, dataset_id)


def find_csv(dataset_id: str, *, preprocessed: bool = False, root: Optional[str] = None):
    base = dataset_dir(dataset_id, root)
    if preprocessed:
        base = os.path.join(base, "preprocessed")
    hits = sorted(glob.glob(os.path.join(base, "*.csv")))
    return hits[0] if hits else None


def stage_arrays(dataset_id: str, X, y, *, root: Optional[str] = None) -> str:
    """Stage (X, y) as a preprocessed CSV dataset (target last column),
    atomically, skipping when already staged with the same row count.
    Returns the CSV path."""
    import pandas as pd

    n = len(X)
    ddir = os.path.join(dataset_dir(dataset_id, root), "preprocessed")
    os.makedirs(ddir, exist_ok=True)
    path = os.path.join(ddir, f"{dataset_id}_preprocessed.csv")

    def _rows(p):
        with open(p) as f:
            return sum(1 for _ in f) - 1

    if not os.path.exists(path) or _rows(path) != n:
        df = pd.DataFrame(np.asarray(X))
        df["target"] = np.asarray(y)
        tmp = path + f".tmp.{os.getpid()}"
        df.to_csv(tmp, index=False)
        os.replace(tmp, path)  # atomic: a torn write can't pass the row check
    return path


def collect_csv_metadata(path: str) -> Dict[str, Any]:
    """n_rows / n_cols / size_mb of a staged CSV: the native scanner's
    dimensions, or pandas and a line count without a toolchain."""
    size_mb = round(os.path.getsize(path) / (1024 * 1024), 2)

    from ..native import csv_dims

    dims = csv_dims(path)
    if dims is not None:
        return {"n_rows": dims[0], "n_cols": dims[1], "size_mb": size_mb}

    import pandas as pd

    n_cols = pd.read_csv(path, nrows=1).shape[1]
    with open(path, "rb") as f:
        n_rows = sum(1 for _ in f) - 1
    return {"n_rows": int(n_rows), "n_cols": int(n_cols), "size_mb": size_mb}


def load_table(path: str) -> Tuple[np.ndarray, np.ndarray, list]:
    """Load a staged CSV: features = all but last column, target = last.
    Non-numeric feature columns are label-encoded; returns (X, y_raw,
    columns). A fresh ``<csv>.npz`` sidecar is reused instead of re-parsing.

    The cold parse is native (``native.csv_parse_f32``) when every column
    is numeric; pandas parses a table with a string column, a quoted
    header (its phantom column reads non-numeric) or labels at or above
    2^24, which f32 cannot hold exactly (the JAX package's rules)."""
    import pandas as pd

    sidecar = path + ".npz"
    if os.path.exists(sidecar) and os.path.getmtime(sidecar) >= os.path.getmtime(path):
        try:
            z = np.load(sidecar, allow_pickle=True)
            if int(z["version"]) >= _SIDECAR_VERSION:
                return z["X"], z["y"], list(z["columns"])
        except (OSError, KeyError, ValueError):
            pass  # unreadable or foreign sidecar: re-parse

    from .. import native

    parsed = native.csv_parse_f32(path)
    if parsed is not None and bool(parsed[1].all()) and parsed[0].shape[1] >= 1:
        mat, _ = parsed
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            columns = [c.strip().strip('"').strip("'")
                       for c in f.readline().rstrip("\r\n").split(",")]
        X, y = mat[:, :-1], mat[:, -1].astype(np.float64)
        if not np.any(np.abs(y) >= 2**24):
            _save_sidecar(sidecar, X, y, columns)
            return X, y, columns

    df = pd.read_csv(path)
    X_df = df.iloc[:, :-1]
    y = df.iloc[:, -1].to_numpy()
    X_cols = []
    for col in X_df.columns:
        series = X_df[col]
        if pd.api.types.is_numeric_dtype(series):
            X_cols.append(series.to_numpy(dtype=np.float32))
        else:  # object / category / string: label-encode
            _, codes = np.unique(series.astype(str).to_numpy(), return_inverse=True)
            X_cols.append(codes.astype(np.float32))
    X = np.stack(X_cols, axis=1) if X_cols else np.zeros((len(df), 0), np.float32)
    _save_sidecar(sidecar, X, y, list(df.columns))
    return X, y, list(df.columns)


def _save_sidecar(sidecar: str, X, y, columns) -> None:
    try:
        np.savez(sidecar, X=X, y=y, columns=np.asarray(list(columns), object),
                 version=_SIDECAR_VERSION)
    except OSError:
        pass


# ---------------------------------------------------------------------------
# builtin datasets (no-egress benchmark data)
# ---------------------------------------------------------------------------


def materialize_builtin(name: str, root: Optional[str] = None) -> Optional[str]:
    """Write a builtin dataset as a staged CSV (both raw and preprocessed
    locations, since builtins are already clean; titanic only raw). Returns
    the csv path, or None when ``name`` is not a builtin."""
    name_l = name.lower()
    if name_l == "iris":
        df = _iris_frame()
    elif name_l in ("covertype", "covtype"):
        df = _synthetic_covertype()
    elif name_l == "titanic":
        # raw only (nulls, categoricals): preprocessing is part of its flow
        base = dataset_dir(name, root)
        os.makedirs(base, exist_ok=True)
        raw_path = os.path.join(base, f"{name}.csv")
        if not os.path.exists(raw_path):
            _synthetic_titanic().to_csv(raw_path, index=False)
        return raw_path
    elif name_l.startswith("synthetic"):
        df = _synthetic_classification(name_l)
    else:
        return None

    base = dataset_dir(name, root)
    pre = os.path.join(base, "preprocessed")
    os.makedirs(pre, exist_ok=True)
    raw_path = os.path.join(base, f"{name}.csv")
    pre_path = os.path.join(pre, f"{name}_preprocessed.csv")
    if not os.path.exists(raw_path):
        df.to_csv(raw_path, index=False)
    if not os.path.exists(pre_path):
        # the same bytes: copy rather than format the table a second time
        shutil.copyfile(raw_path, pre_path)
    return pre_path


_IRIS_FEATURES = [
    "sepal length (cm)", "sepal width (cm)", "petal length (cm)", "petal width (cm)",
]


def _iris_frame() -> "Any":
    """``load_iris(as_frame=True).frame``: the four f64 features and the
    int ``target`` column, from the package's ``iris.csv`` (scikit-learn's
    file: a header row ``n_samples,n_features,class names``, then rows of
    features and class id)."""
    import pandas as pd

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "iris.csv")
    with open(path, encoding="utf-8") as f:
        rows = csv.reader(f)
        header = next(rows)
        data = np.empty((int(header[0]), int(header[1])))
        target = np.empty(int(header[0]), dtype=int)
        for i, row in enumerate(rows):
            data[i] = np.asarray(row[:-1], dtype=np.float64)
            target[i] = int(row[-1])
    df = pd.DataFrame(data, columns=_IRIS_FEATURES)
    df["target"] = target
    return df


def _synthetic_covertype(n: int = 116_202) -> "Any":
    """Covertype-shaped synthetic data (54 features, 7 classes, 20% of the
    real 581k rows)."""
    import pandas as pd

    X, y = make_classification(
        n_samples=n,
        n_features=54,
        n_informative=30,
        n_redundant=10,
        n_classes=7,
        n_clusters_per_class=2,
        random_state=0,
    )
    df = pd.DataFrame(X.astype(np.float32), columns=[f"f{i}" for i in range(54)])
    df["Cover_Type"] = y + 1
    return df


def _synthetic_titanic(n: int = 891) -> "Any":
    """Titanic-shaped synthetic table: the Kaggle dataset's columns, nulls
    and categorical mix, so the download -> preprocess -> train flow runs
    with no network."""
    import pandas as pd

    rng = np.random.RandomState(7)
    pclass = rng.choice([1, 2, 3], n, p=[0.24, 0.21, 0.55])
    sex = rng.choice(["male", "female"], n, p=[0.65, 0.35])
    age = np.round(rng.normal(29.7, 14.5, n).clip(0.4, 80), 1)
    age[rng.rand(n) < 0.2] = np.nan
    sibsp = rng.choice([0, 1, 2, 3, 4], n, p=[0.68, 0.23, 0.05, 0.03, 0.01])
    parch = rng.choice([0, 1, 2], n, p=[0.76, 0.13, 0.11])
    fare = np.round(np.exp(rng.normal(2.9, 1.0, n)).clip(0, 512), 4)
    embarked = rng.choice(["S", "C", "Q"], n, p=[0.72, 0.19, 0.09]).astype(object)
    embarked[rng.rand(n) < 0.002] = None
    # survival correlated with sex, class and age as in the real data
    logit = (1.2 - 0.9 * (pclass - 1) + 2.4 * (sex == "female")
             - 0.015 * np.nan_to_num(age, nan=29.7))
    survived = (rng.rand(n) < 1 / (1 + np.exp(-logit))).astype(int)
    return pd.DataFrame(
        {
            "PassengerId": np.arange(1, n + 1),
            "Survived": survived,
            "Pclass": pclass,
            "Name": [f"Passenger {i}" for i in range(n)],
            "Sex": sex,
            "Age": age,
            "SibSp": sibsp,
            "Parch": parch,
            "Ticket": [f"T{100000+i}" for i in range(n)],
            "Fare": fare,
            "Cabin": [None] * n,
            "Embarked": embarked,
        }
    )


def _synthetic_classification(spec: str) -> "Any":
    """`synthetic[_<n>x<d>x<c>]` generator for tests/benchmarks."""
    import pandas as pd

    n, d, c = 10_000, 20, 2
    parts = spec.split("_")
    if len(parts) > 1:
        try:
            dims = parts[1].split("x")
            n, d = int(dims[0]), int(dims[1])
            c = int(dims[2]) if len(dims) > 2 else 2
        except (ValueError, IndexError):
            pass
    X, y = make_classification(
        n_samples=n,
        n_features=d,
        n_informative=max(2, d // 2),
        n_classes=c,
        random_state=0,
    )
    df = pd.DataFrame(X.astype(np.float32), columns=[f"f{i}" for i in range(d)])
    df["target"] = y
    return df


# ---------------------------------------------------------------------------
# columnar cache
# ---------------------------------------------------------------------------


class DatasetCache:
    """Parse-once cache of staged datasets as TrialData, keyed by dataset id
    and task kind. Classification labels are encoded by np.unique order —
    identical to sklearn's LabelEncoder ordering."""

    def __init__(self, root: Optional[str] = None):
        self._root = root
        self._lock = threading.Lock()
        self._cache: Dict[Tuple[str, str], TrialData] = {}
        self._meta: Dict[str, Dict[str, Any]] = {}

    def resolve_csv(self, dataset_id: str) -> str:
        path = find_csv(dataset_id, preprocessed=True, root=self._root) or find_csv(
            dataset_id, root=self._root
        )
        if path is None:
            path = materialize_builtin(dataset_id, root=self._root)
        if path is None:
            raise FileNotFoundError(
                f"Dataset {dataset_id!r} not staged (and not a builtin). "
                f"Call download_data/preprocess first."
            )
        return path

    def metadata(self, dataset_id: str) -> Dict[str, Any]:
        with self._lock:
            if dataset_id not in self._meta:
                self._meta[dataset_id] = collect_csv_metadata(self.resolve_csv(dataset_id))
            return dict(self._meta[dataset_id])

    def get(self, dataset_id: str, task: str) -> TrialData:
        key = (dataset_id, task)
        with self._lock:
            if key in self._cache:
                return self._cache[key]
        X, y_raw, _ = load_table(self.resolve_csv(dataset_id))
        if task == "classification":
            classes, y = np.unique(y_raw, return_inverse=True)
            data = TrialData(X=X, y=y.astype(np.int32), n_classes=len(classes))
        else:
            data = TrialData(X=X, y=y_raw.astype(np.float32), n_classes=0)
        with self._lock:
            self._cache[key] = data
        return data

    def invalidate(self, dataset_id: str) -> None:
        """Forget a dataset's parsed arrays and metadata (after a download or
        a preprocess restaged it)."""
        with self._lock:
            for key in [k for k in self._cache if k[0] == dataset_id]:
                del self._cache[key]
            self._meta.pop(dataset_id, None)


class FetchingDatasetCache(DatasetCache):
    """DatasetCache that fetches missing datasets from the coordinator
    (``GET /dataset/<id>``), for a worker agent on another host: a dataset
    downloaded, preprocessed or staged (``stage_arrays``) on the coordinator
    reaches every agent, fetched once and then read from the local staged
    layout.

    Resolution per lookup: the local preprocessed copy, then a cheap probe
    of the coordinator (``?probe=1``: the staged kind only), then a download
    when the coordinator holds something better than what is local
    (preprocessed beats raw), then local raw or builtin staging. Nothing is
    negative-cached. ``fetches`` records each download's dataset, kind,
    bytes and seconds. Port of the JAX package's class over
    ``utils/http.py``."""

    def __init__(self, coordinator_url: str, root: Optional[str] = None,
                 timeout_s: float = 120.0):
        super().__init__(root=root)
        self._url = coordinator_url.rstrip("/")
        self._timeout_s = timeout_s
        self.fetches: list = []

    def resolve_csv(self, dataset_id: str) -> str:
        local_pre = find_csv(dataset_id, preprocessed=True, root=self._root)
        if local_pre is not None:
            return local_pre
        remote_kind = self._probe(dataset_id)
        if remote_kind is not None:
            local_raw = find_csv(dataset_id, root=self._root)
            if remote_kind == "raw" and local_raw is not None:
                return local_raw
            path = self._fetch(dataset_id)
            if path is not None:
                return path
        return super().resolve_csv(dataset_id)

    def _dataset_url(self, dataset_id: str) -> str:
        import urllib.parse

        return f"{self._url}/dataset/{urllib.parse.quote(dataset_id, safe='')}"

    def _probe(self, dataset_id: str) -> Optional[str]:
        """The coordinator's staged kind ('preprocessed' / 'raw'), or None
        when it has none or cannot be reached."""
        from ..utils import http

        try:
            resp = http.request("GET", self._dataset_url(dataset_id), params={"probe": "1"},
                                timeout=min(self._timeout_s, 15.0))
            return resp.raise_for_status().json().get("kind", "raw")
        except Exception:  # noqa: BLE001 — 404 and unreachable alike: no remote copy
            return None

    def _fetch(self, dataset_id: str) -> Optional[str]:
        import time

        from ..utils import http
        from ..utils.logging import get_logger

        logger = get_logger("tpuml.data")
        t0 = time.perf_counter()
        try:
            resp = http.open_request("GET", self._dataset_url(dataset_id),
                                     timeout=self._timeout_s)
        except http.TransportError:
            logger.exception("Dataset fetch for %r failed; trying local staging", dataset_id)
            return None
        with resp:
            status = getattr(resp, "status", None) or resp.code
            if status >= 400:
                if status != 404:
                    logger.error("Dataset fetch for %r failed (%d); trying local staging",
                                 dataset_id, status)
                return None
            kind = resp.headers.get("X-Dataset-Kind", "raw")
            base = dataset_dir(dataset_id, self._root)
            if kind == "preprocessed":
                out_dir = os.path.join(base, "preprocessed")
                out = os.path.join(out_dir, f"{dataset_id}_preprocessed.csv")
            else:
                out_dir, out = base, os.path.join(base, f"{dataset_id}.csv")
            os.makedirs(out_dir, exist_ok=True)
            tmp = f"{out}.tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                shutil.copyfileobj(resp, f, 1 << 20)
        os.replace(tmp, out)
        nbytes = os.path.getsize(out)
        self.fetches.append({"dataset_id": dataset_id, "kind": kind, "bytes": nbytes,
                             "seconds": time.perf_counter() - t0})
        logger.info("Fetched dataset %s (%s, %d bytes) from the coordinator",
                    dataset_id, kind, nbytes)
        return out
