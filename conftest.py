"""Test order for the whole repo: the files marked `minutes` start first."""
import pytest


def pytest_configure(config):
    # pytest-xdist queues the files of --dist loadfile by their number of
    # tests, most first, so a file of a few long tests starts late and
    # ends the run; keep the collection order below instead.
    if hasattr(config.option, "loadscopereorder"):
        config.option.loadscopereorder = False


def pytest_collection_modifyitems(config, items):
    # the files marked `minutes` first, each file's items in their order:
    # the xdist workers' collection order is the order the files are queued
    items.sort(key=lambda item: item.getparent(pytest.Module).get_closest_marker("minutes") is None)
