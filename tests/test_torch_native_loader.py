"""The port's native CSV loader (native/, a copy of the JAX package's) and
its use in data/datasets.py, against the JAX package's loader and pandas,
on the CPU.

Parses are equal to the bit (NaN where a cell is missing). pandas parses
a table with a string column, a quoted header or labels at or above 2^24,
in both packages: those rules are semantics and are pinned here.
"""

import os
import shutil

import numpy as np
import pandas as pd
import pytest

from cs230_distributed_machine_learning_tpu import native as jnative
from cs230_distributed_machine_learning_tpu.data import datasets as jds
from cs230_distributed_machine_learning_tpu_torch import native
from cs230_distributed_machine_learning_tpu_torch.data import datasets as ds
from cs230_distributed_machine_learning_tpu_torch.utils import config as tcfg


@pytest.fixture(autouse=True)
def _port_storage(tmp_path):
    """The port's storage root (where the loader builds) in a tmpdir."""
    cfg = tcfg.FrameworkConfig.load(env={})
    cfg.storage.root = str(tmp_path / "tpuml_torch")
    tcfg.set_config(cfg)
    yield
    tcfg.set_config(tcfg.FrameworkConfig.load(env={}))


def _numeric(p):
    rng = np.random.RandomState(7)
    df = pd.DataFrame(rng.randn(5000, 12).astype(np.float32), columns=[f"c{i}" for i in range(12)])
    df["label"] = rng.randint(0, 5, 5000)
    df.to_csv(p, index=False)


def _crlf(p):
    with open(p, "wb") as f:
        f.write(b"a,b\r\n1,2\r\n3,4")  # CRLF and no trailing newline


def _page(p):
    """A file of exactly one page ending in a digit with no newline: the
    last cell is flush against the mapping's end."""
    body = b"a,b\n"
    while 4096 - len(body) - len(b"1,2\n") > 8:
        body += b"1,2\n"
    body += b"1," + b"9" * (4096 - len(body) - 2)
    with open(p, "wb") as f:
        f.write(body)
    assert os.path.getsize(p) == 4096


def _missing(p):
    with open(p, "w") as f:
        f.write("a,b,y\n1,,0\n,2,1\n3,4,0\n")


def _strings(p):
    pd.DataFrame({"x": [1.0, 2.0, 3.0, 4.0], "s": ["a", "b", "a", "c"],
                  "y": [0, 1, 0, 1]}).to_csv(p, index=False)


def _quoted(p):
    with open(p, "w") as f:
        f.write('x,"lat,lon",y\n1.0,2.5,0\n3.0,4.5,1\n')


def _big_labels(p):
    pd.DataFrame({"x": [1.0, 2.0, 3.0], "y": [2**24, 2**24 + 1, 5]}).to_csv(p, index=False)


CASES = {"numeric": (_numeric, True), "crlf": (_crlf, True), "page": (_page, True),
         "missing": (_missing, True), "strings": (_strings, False),
         "quoted_header": (_quoted, False), "labels_2_24": (_big_labels, True)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_parse_and_load_match_jax_and_pandas(tmp_path, case):
    write, numeric = CASES[case]
    path = str(tmp_path / f"{case}.csv")
    write(path)
    assert native.get_lib() is not None
    mat, ok = native.csv_parse_f32(path)
    jmat, jok = jnative.csv_parse_f32(path)
    assert np.array_equal(mat, jmat, equal_nan=True) and np.array_equal(ok, jok)
    assert bool(ok.all()) == numeric
    if numeric:
        ref = pd.read_csv(path).to_numpy(dtype=np.float32)
        assert np.array_equal(mat, ref, equal_nan=True)
    assert native.csv_dims(path) == jnative.csv_dims(path)
    # load_table of each package on its own copy (each writes a sidecar)
    jpath = str(tmp_path / f"{case}_jax.csv")
    shutil.copyfile(path, jpath)
    for _ in range(2):  # the parse, then the sidecar
        X, y, cols = ds.load_table(path)
        jX, jy, jcols = jds.load_table(jpath)
        assert np.array_equal(X, jX, equal_nan=True) and X.dtype == jX.dtype
        assert np.array_equal(y, jy) and y.dtype == jy.dtype and cols == jcols
    if case == "quoted_header":
        assert cols == ["x", "lat,lon", "y"] and X.shape == (2, 2)
    if case == "labels_2_24":  # f32 cannot hold them: pandas' int64 labels
        assert y.dtype == np.int64 and list(y) == [2**24, 2**24 + 1, 5]


def test_metadata_and_native_equals_pandas_path(tmp_path, monkeypatch):
    rng = np.random.RandomState(1)
    df = pd.DataFrame(rng.randn(200, 6).astype(np.float32), columns=[f"f{i}" for i in range(6)])
    df["target"] = rng.randn(200).astype(np.float32)
    p_native, p_pandas = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    df.to_csv(p_native, index=False)
    df.to_csv(p_pandas, index=False)
    meta = ds.collect_csv_metadata(p_native)
    assert meta == jds.collect_csv_metadata(p_native)
    assert (meta["n_rows"], meta["n_cols"]) == (200, 7)
    X1, y1, cols1 = ds.load_table(p_native)
    monkeypatch.setattr(native, "csv_parse_f32", lambda _p: None)  # the pandas path
    X2, y2, cols2 = ds.load_table(p_pandas)
    assert np.array_equal(X1, X2) and cols1 == cols2
    assert np.array_equal(y1.astype(np.float32), y2.astype(np.float32))
