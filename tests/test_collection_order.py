"""The test order of the repo's conftest.py: the files marked `minutes` are
queued first under pytest-xdist, each file's tests in their order, and a run
without xdist collects the same items."""
import importlib.util
import re
from pathlib import Path
from types import SimpleNamespace

pytest_plugins = "pytester"

ROOT_CONFTEST = Path(__file__).resolve().parents[1] / "conftest.py"
#: three files in collection order; the one with the fewest tests is marked,
#: so that xdist's count-based reorder would queue it last
FILES = {
    "test_a": "def test_0(): pass\ndef test_1(): pass\ndef test_2(): pass\n",
    "test_b": "import pytest\npytestmark = pytest.mark.minutes\ndef test_0(): pass\n",
    "test_c": "def test_0(): pass\ndef test_1(): pass\n",
}
#: the node ids in pytest's own order, and in the order the conftest keeps
PLAIN = ["test_a.py::test_0", "test_a.py::test_1", "test_a.py::test_2",
         "test_b.py::test_0", "test_c.py::test_0", "test_c.py::test_1"]
ORDERED = PLAIN[3:4] + PLAIN[:3] + PLAIN[4:]


def _root_conftest():
    spec = importlib.util.spec_from_file_location("root_conftest", ROOT_CONFTEST)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _suite(pytester, monkeypatch):
    # no plugin loads but those named, each run in a second or less
    monkeypatch.setenv("PYTEST_DISABLE_PLUGIN_AUTOLOAD", "1")
    pytester.makeini("[pytest]\nmarkers =\n    minutes: queued first\n")
    pytester.makeconftest(ROOT_CONFTEST.read_text())
    pytester.makepyfile(**FILES)


def _collected(pytester, *opts):
    result = pytester.runpytest_inprocess("--collect-only", "-q", "-p", "no:xdist", *opts)
    assert result.ret == 0, result.outlines
    return [line for line in result.outlines if "::" in line]


def test_xdist_reorder_off_only_where_the_option_exists(request):
    conftest = _root_conftest()
    with_xdist = SimpleNamespace(option=SimpleNamespace(loadscopereorder=True))
    conftest.pytest_configure(with_xdist)
    assert with_xdist.option.loadscopereorder is False
    without = SimpleNamespace(option=SimpleNamespace())
    conftest.pytest_configure(without)
    assert not hasattr(without.option, "loadscopereorder")
    assert getattr(request.config.option, "loadscopereorder", False) is False


def test_marked_files_first_in_file_order(pytester, monkeypatch):
    _suite(pytester, monkeypatch)
    assert _collected(pytester, "--noconftest") == PLAIN
    assert _collected(pytester) == ORDERED


def test_same_items_without_xdist_and_in_a_single_file_run(pytester, monkeypatch):
    _suite(pytester, monkeypatch)
    assert sorted(_collected(pytester)) == sorted(_collected(pytester, "--noconftest"))
    for name in FILES:
        one = [i for i in PLAIN if i.startswith(name + ".py::")]
        assert _collected(pytester, name + ".py") == one


def test_xdist_loadfile_queues_the_marked_file_first(pytester, monkeypatch):
    _suite(pytester, monkeypatch)

    def ran(*opts):
        result = pytester.runpytest_subprocess("-p", "xdist", "-n", "1", "--dist", "loadfile",
                                               "-v", *opts)
        assert result.ret == 0, result.outlines
        return re.findall(r"PASSED (\S+::\S+)", "\n".join(result.outlines))

    assert ran() == ORDERED
    # without the conftest, xdist queues the files by their number of tests
    assert ran("--noconftest") == PLAIN[:3] + PLAIN[4:] + PLAIN[3:4]
