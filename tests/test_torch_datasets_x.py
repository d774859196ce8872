"""The port's dataset parsers (utils/datasets2.py, datasets3.py, datasets4.py)
against the JAX package's, on the same fixture trees.

Each test of tests/test_datasets3.py, tests/test_datasets4.py and
tests/test_breadth11.py::TestDatasets2 runs as it is, its module's `ds` /
`ds2` swapped for `Both`: every loader call runs both packages on the
fixture the test wrote, asserts the two results equal (arrays bit for bit,
records field by field) and hands the port's result to the test's own
assertions."""

import dataclasses

import numpy as np
import pytest
import test_breadth11 as t11
import test_datasets3 as t3
import test_datasets4 as t4

from opencv_contrib_tpu.utils import datasets2 as j2
from opencv_contrib_tpu.utils import datasets3 as j3
from opencv_contrib_tpu.utils import datasets4 as j4
from opencv_contrib_tpu_torch.utils import datasets2 as p2
from opencv_contrib_tpu_torch.utils import datasets3 as p3
from opencv_contrib_tpu_torch.utils import datasets4 as p4


def assert_same(a, b, where="result"):
    """a (the port's) equals b (the JAX package's): the same record class
    names and fields, arrays of one dtype and the same values."""
    if dataclasses.is_dataclass(a) or (isinstance(a, tuple) and hasattr(a, "_fields")):
        assert type(a).__name__ == type(b).__name__, where
        fa = dataclasses.asdict(a) if dataclasses.is_dataclass(a) else a._asdict()
        fb = dataclasses.asdict(b) if dataclasses.is_dataclass(b) else b._asdict()
        assert list(fa) == list(fb), where
        for k in fa:
            assert_same(fa[k], fb[k], f"{where}.{k}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), where
        for k in a:
            assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


class Both:
    """A stand-in for a dataset module: loaders run in both packages and
    must agree; writers and record classes are the port's."""

    def __init__(self, port, jax):
        self.port, self.jax = port, jax

    def __getattr__(self, name):
        mine = getattr(self.port, name)
        if not (name.startswith(("load_", "read_")) and callable(mine)):
            return mine
        theirs = getattr(self.jax, name)

        def both(*args, **kwargs):
            out = mine(*args, **kwargs)
            assert_same(out, theirs(*args, **kwargs), name)
            return out

        return both


def _tests(mod):
    return sorted(n for n in dir(mod) if n.startswith("test_") and callable(getattr(mod, n)))


@pytest.mark.parametrize("name", _tests(t3))
def test_datasets3_twin(monkeypatch, tmp_path, name):
    monkeypatch.setattr(t3, "ds", Both(p3, j3))
    getattr(t3, name)(tmp_path)


@pytest.mark.parametrize("name", _tests(t4))
def test_datasets4_twin(monkeypatch, tmp_path, name):
    monkeypatch.setattr(t4, "ds", Both(p4, j4))
    getattr(t4, name)(tmp_path)


@pytest.mark.parametrize("name", _tests(t11.TestDatasets2))
def test_datasets2_twin(monkeypatch, tmp_path, name):
    monkeypatch.setattr(t11, "ds2", Both(p2, j2))
    getattr(t11.TestDatasets2(), name)(tmp_path)


def test_the_proxy_catches_a_difference(tmp_path):
    """A loader that parts from its twin fails the test."""

    class Off:
        @staticmethod
        def load_image_sequence(root):
            return p2.load_image_sequence(root)[1:]

    (tmp_path / "a.png").write_bytes(b"x")
    (tmp_path / "b.png").write_bytes(b"x")
    with pytest.raises(AssertionError):
        Both(Off, j2).load_image_sequence(str(tmp_path))


def test_port_modules_are_the_port_s():
    for mod in (p2, p3, p4):
        assert mod.__name__.startswith("opencv_contrib_tpu_torch.")
