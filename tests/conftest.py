import contextlib
import os
import signal
import sys
import threading
from pathlib import Path

import pytest

from _order import FILE_SECONDS, by_file, file_of

# tests see ONE CPU device (dry-run device forcing must stay out of here)
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

# The suite manages its own device topology: the main pytest process must
# see exactly one CPU device (test_system asserts it) and multi-device cases
# re-exec in subprocesses with their own forcing.  Strip any INHERITED
# forcing (e.g. CI exports XLA_FLAGS=--xla_force_host_platform_device_count
# for direct module runs) before jax initializes.
_flags = os.environ.get("XLA_FLAGS", "")
if "--xla_force_host_platform_device_count" in _flags:
    os.environ["XLA_FLAGS"] = " ".join(
        f for f in _flags.split()
        if not f.startswith("--xla_force_host_platform_device_count"))

# ---------------------------------------------------------------------------
# Under `-n N --dist loadfile` the workers take whole files in the order they
# collected them, longest first (tests/_order.py).  xdist's own sort by test
# count is turned off so that it cannot undo that order.  A run without
# workers keeps collection order.
#
# The listed files set the run's length, and they slow down when they share
# the CPU with every other worker: the executor file's tests took 1405 s in
# place of 1222 s when it started with the run (8-core host, 6 workers).  So
# a worker lowers its priority, and its subprocesses', once it runs a test of
# any other file: the listed files keep their cores, the rest fill the others.
# ---------------------------------------------------------------------------
def pytest_configure(config):
    if hasattr(config.option, "loadscopereorder"):
        config.option.loadscopereorder = False


def pytest_collection_modifyitems(config, items):
    if hasattr(config, "workerinput"):
        items[:] = by_file(items)


def pytest_runtest_setup(item):
    if (hasattr(item.config, "workerinput")
            and file_of(item.nodeid) not in FILE_SECONDS):
        # niceness is per thread on Linux: lower every thread of the worker
        for tid in os.listdir("/proc/self/task"):
            with contextlib.suppress(ProcessLookupError):  # thread ended
                os.setpriority(os.PRIO_PROCESS, int(tid), 19)


# ---------------------------------------------------------------------------
# Per-test hard timeout ("timeout" ini key, see pyproject.toml).  When the
# pytest-timeout plugin is installed it owns the key; this SIGALRM fallback
# covers bare environments so CPU-only runs cannot hang the suite.
# ---------------------------------------------------------------------------
try:
    import pytest_timeout  # noqa: F401
    _HAVE_TIMEOUT_PLUGIN = True
except ImportError:
    _HAVE_TIMEOUT_PLUGIN = False


def pytest_addoption(parser):
    if not _HAVE_TIMEOUT_PLUGIN:
        parser.addini("timeout", "per-test hard timeout in seconds "
                      "(SIGALRM fallback; 0 disables)", default="0")


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    limit = 0
    if not _HAVE_TIMEOUT_PLUGIN:
        try:
            limit = int(float(item.config.getini("timeout") or 0))
        except (ValueError, KeyError):
            limit = 0
    usable = (limit > 0 and hasattr(signal, "SIGALRM")
              and threading.current_thread() is threading.main_thread())
    if not usable:
        return (yield)

    def _on_alarm(signum, frame):
        raise TimeoutError(f"test exceeded {limit}s hard timeout (conftest "
                           "SIGALRM fallback)")

    old = signal.signal(signal.SIGALRM, _on_alarm)
    signal.alarm(limit)
    try:
        return (yield)
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
