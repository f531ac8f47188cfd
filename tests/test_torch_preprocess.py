"""The port's data path (data/preprocess.py, data/download.py, the titanic
builtin, ``load_table`` and the coordinator's data routes) against the JAX
package, on the CPU.

The same raw CSV goes through both packages' ``preprocess_dataframe``: the
frames must be equal, dtypes included (pandas' ``get_dummies`` gives bool
columns). The ``label`` encoding is the port's numpy copy of scikit-learn's
``LabelEncoder`` and must give its codes. The CSV written from the frame
must load to the same X and y in both packages (the bool columns as 0/1
floats). chip_smoke.py carries the example YAML as a dict literal (the
chip's machine may have no PyYAML); it must equal the parsed file.
"""

import os
import sys

import numpy as np
import pandas as pd
import pytest
import torch
import yaml
from sklearn.preprocessing import LabelEncoder

from cs230_distributed_machine_learning_tpu.data import datasets as jds
from cs230_distributed_machine_learning_tpu.data import preprocess as jpre
from cs230_distributed_machine_learning_tpu_torch import MLTaskManager as TorchManager
from cs230_distributed_machine_learning_tpu_torch.data import datasets as tds
from cs230_distributed_machine_learning_tpu_torch.data import preprocess as tpre
from cs230_distributed_machine_learning_tpu_torch.data.download import download_dataset
from cs230_distributed_machine_learning_tpu_torch.utils import config as tcfg
from cs230_distributed_machine_learning_tpu_torch.utils.sklearn_compat import label_encode

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE_YAML = os.path.join(ROOT, "examples", "titanic_preprocess.yaml")


@pytest.fixture(autouse=True)
def _torch_storage(tmp_path):
    cfg = tcfg.FrameworkConfig.load(env={})
    cfg.storage.root = str(tmp_path / "tpuml_torch")
    tcfg.set_config(cfg)
    yield
    tcfg.set_config(tcfg.FrameworkConfig.load(env={}))


def _config():
    with open(EXAMPLE_YAML) as f:
        return yaml.safe_load(f)


def test_synthetic_titanic_matches_jax():
    pd.testing.assert_frame_equal(tds._synthetic_titanic(), jds._synthetic_titanic())


def test_preprocess_example_yaml_matches_jax():
    raw = tds._synthetic_titanic()
    got = tpre.preprocess_dataframe(raw.copy(), _config())
    want = jpre.preprocess_dataframe(raw.copy(), _config())
    pd.testing.assert_frame_equal(got, want)
    assert got.shape == (867, 13) and list(got.columns)[-1] == "Survived"


@pytest.mark.parametrize("categorical", [
    {"Sex": "label", "Embarked": "label", "Pclass": "label"},
    {"Embarked": "freq", "Sex": "onehot"},
])
def test_preprocess_label_and_freq_match_jax(categorical):
    """The ``label`` branch (scikit-learn's LabelEncoder in the JAX package,
    the numpy copy in the port; on pandas 3 Embarked's nulls stay NaN
    through ``astype(str)`` and take the last code) and ``freq``, with mean
    imputation and with null dropping."""
    raw = tds._synthetic_titanic()
    for cfg in ({"categorical": categorical, "impute": {"Age": "mean"}},
                {"categorical": categorical, "drop_null": True, "drop_columns": ["Cabin"]}):
        pd.testing.assert_frame_equal(tpre.preprocess_dataframe(raw.copy(), cfg),
                                      jpre.preprocess_dataframe(raw.copy(), cfg))


@pytest.mark.parametrize("values", [
    ["b", "a", "c", "a"],
    np.array([3, 1, 2, 3, 10]).astype(str),
    pd.Series(["S", "Q", "C", "S"]).astype(str),
    pd.Series(["S", None, "Q", "C", None]).astype(str),  # nulls stay NaN on pandas 3
    np.array(["b", None, "a", np.nan, "b", None], dtype=object),
    np.array([2.5, 1.0, 2.5, 0.5]),
])
def test_label_encode_matches_scikit_learn(values):
    want = LabelEncoder().fit_transform(values)
    got = label_encode(values)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64


def test_load_table_reads_bool_columns_as_jax_does(tmp_path):
    """get_dummies' bool columns written to CSV ("True"/"False") load as 0/1
    floats, the same X and y as the JAX package's loader."""
    df = tpre.preprocess_dataframe(tds._synthetic_titanic(), _config())
    assert (df.dtypes == bool).sum() == 8
    path = str(tmp_path / "t.csv")
    df.to_csv(path, index=False)
    os.makedirs(tmp_path / "j")
    jpath = str(tmp_path / "j" / "t.csv")
    df.to_csv(jpath, index=False)
    X, y, cols = tds.load_table(path)
    jX, jy, jcols = jds.load_table(jpath)
    assert cols == jcols and X.dtype == jX.dtype == np.float32
    np.testing.assert_array_equal(X, jX)
    np.testing.assert_array_equal(y.astype(np.float64), jy.astype(np.float64))
    assert set(np.unique(X[:, [c for c, t in zip(range(X.shape[1]), df.dtypes) if t == bool]])) \
        == {0.0, 1.0}


def test_download_builtin_and_local_and_check_data(tmp_path):
    m = TorchManager(device="cpu")
    assert not m.check_data("titanic")["exists"]
    out = m.download_data("titanic", "titanic", "builtin")
    assert out["status"] == "success"
    check = m.check_data("titanic")
    assert check["exists"] and check["path"].endswith("titanic.csv")
    assert not os.path.exists(os.path.join(out["dataset_path"], "preprocessed"))
    src = tmp_path / "src"
    src.mkdir()
    pd.DataFrame({"a": [1, 2], "t": [0, 1]}).to_csv(src / "one.csv", index=False)
    (src / "notes.txt").write_text("not a table")
    m.download_data(str(src), "from_dir", "local")
    assert sorted(os.listdir(tds.dataset_dir("from_dir"))) == ["one.csv"]
    m.download_data(str(src / "one.csv"), "from_file", "local")
    assert m.check_data("from_file")["exists"]
    with pytest.raises(FileNotFoundError):
        m.download_data(str(src / "missing.csv"), "x", "local")
    with pytest.raises(ValueError, match="Unknown builtin"):
        m.download_data("x", "no_such_builtin", "builtin")
    with pytest.raises(ValueError, match="Unknown dataset_type"):
        m.download_data("x", "x", "ftp")


@pytest.mark.parametrize("kind,module", [("kaggle", "kaggle"), ("hf", "datasets")])
def test_remote_sources_raise_without_their_package(kind, module, monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, module, None)  # import raises ImportError
    with pytest.raises(RuntimeError, match="not available"):
        download_dataset("owner/name", "remote", kind, root=str(tmp_path))


def test_preprocess_route_with_dict_and_yaml_configs(monkeypatch):
    """A dict config stages the preprocessed CSV and the cache serves the
    new table; config=None reads <configs_dir>/<id>/*.yaml, and without
    PyYAML that raises ImportError."""
    m = TorchManager(device="cpu")
    m.download_data("titanic", "titanic", "builtin")
    coord = m._coordinator
    assert coord.cache.metadata("titanic")["n_rows"] == 891  # the raw table
    out = m.preprocess("titanic", _config())
    assert out["n_rows"] == 867 and out["preprocessed_path"].endswith(
        os.path.join("preprocessed", "titanic_preprocessed.csv"))
    data = coord.cache.get("titanic", "regression")
    assert data.X.shape == (867, 12) and coord.cache.metadata("titanic")["n_rows"] == 867
    with pytest.raises(FileNotFoundError, match="No preprocess config"):
        m.preprocess("titanic")
    cfg_dir = os.path.join(tcfg.get_config().storage.configs_dir, "titanic")
    os.makedirs(cfg_dir)
    with open(EXAMPLE_YAML) as src, open(os.path.join(cfg_dir, "titanic.yaml"), "w") as dst:
        dst.write(src.read())
    assert m.preprocess("titanic")["n_rows"] == 867
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError):
        m.preprocess("titanic")
    with pytest.raises(FileNotFoundError, match="not staged"):
        m.preprocess("never_staged", _config())


def test_chip_smoke_config_literal_equals_the_example_yaml():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    assert chip_smoke.TITANIC_PREPROCESS == _config()
