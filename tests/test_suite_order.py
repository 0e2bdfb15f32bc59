"""The order in which whole test files are dealt out to xdist workers
(tests/_order.py), on made-up node ids."""
from pathlib import Path
from types import SimpleNamespace

import pytest

from _order import FILE_SECONDS, by_file, file_of

SECONDS = {"tests/test_long.py": 900, "tests/test_longer.py": 1200}
IDS = (
    ["tests/test_few.py::test_a", "tests/test_few.py::test_b"]
    + [f"tests/test_many.py::test_{i}" for i in range(5)]
    + ["tests/test_long.py::test_x", "tests/test_long.py::test_y[1]",
       "tests/test_long.py::test_y[2]"]
    + [f"tests/test_mid.py::test_{i}" for i in range(3)]
    + ["tests/test_longer.py::test_z"]
    + [f"tests/test_also_mid.py::Case::test_{i}" for i in range(3)]
)


def _files(ids):
    """The files of ``ids`` in the order they first appear."""
    return list(dict.fromkeys(file_of(n) for n in ids))


def _check_listed_first_longest_first(out):
    assert _files(out)[:2] == ["tests/test_longer.py", "tests/test_long.py"]


def _check_unlisted_most_tests_first(out):
    # test_mid and test_also_mid tie at 3 tests: collection order holds
    assert _files(out)[2:] == ["tests/test_many.py", "tests/test_mid.py",
                               "tests/test_also_mid.py", "tests/test_few.py"]


def _check_every_id_once(out):
    assert sorted(out) == sorted(IDS) and len(out) == len(IDS)


def _check_files_whole_and_in_order(out):
    files = [file_of(n) for n in out]
    for f in set(files):
        idx = [i for i, g in enumerate(files) if g == f]
        assert idx == list(range(idx[0], idx[-1] + 1)), f
        assert [out[i] for i in idx] == [n for n in IDS if file_of(n) == f]


@pytest.mark.parametrize("check", [
    _check_listed_first_longest_first,
    _check_unlisted_most_tests_first,
    _check_every_id_once,
    _check_files_whole_and_in_order,
], ids=lambda c: c.__name__.removeprefix("_check_"))
def test_by_file(check):
    items = [SimpleNamespace(nodeid=n) for n in IDS]
    check([it.nodeid for it in by_file(items, seconds=SECONDS)])


@pytest.mark.parametrize("name", sorted(FILE_SECONDS))
def test_listed_file_exists(name):
    assert (Path(__file__).resolve().parents[1] / name).is_file()
