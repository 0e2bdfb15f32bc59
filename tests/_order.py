"""Order in which whole test files are dealt out to pytest-xdist workers.

Under ``pytest -n 6 --dist loadfile`` each worker runs one whole file at a
time, and the run lasts at least as long as its longest file.  That file
must start when the run starts: hand files out longest first (the
longest-processing-time-first rule for parallel machines).  xdist's own
order counts tests, not seconds, and deals the 10-test executor file out
30th of 38.  ``conftest.py`` applies :func:`by_file` to the collected
items and turns xdist's count sort off, so the workers take files in this
order.
"""
from collections import Counter

# Seconds of test time of the files that set the critical path: each file's
# sum of junit test times in one run of the whole suite under
# `pytest -n 6 --dist loadfile` on an 8-core CPU host, in xdist's own order
# (2026-10-18).  A new file over ~300 s belongs here.
FILE_SECONDS = {
    "tests/test_pipeline_executor.py": 1222,
}


def file_of(nodeid):
    return nodeid.split("::", 1)[0]


def by_file(items, seconds=FILE_SECONDS):
    """Test ``items`` regrouped by file: listed files first, longest first,
    then the rest with the most tests first.  Ties keep collection order,
    and the tests inside a file keep theirs."""
    files = [file_of(it.nodeid) for it in items]
    count = Counter(files)
    first = {}
    for i, f in enumerate(files):
        first.setdefault(f, i)
    key = {f: (-seconds.get(f, 0), -count[f], first[f]) for f in count}
    order = sorted(range(len(items)), key=lambda i: key[files[i]])
    return [items[i] for i in order]
