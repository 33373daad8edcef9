"""A pytest plugin that logs each finished test's memory-mapping count.

Load it by name to see how close a run comes to ``vm.max_map_count`` (the
reference's fuzz cases leave about 5,400 mappings each; ROADMAP.md queue 3)::

    MAPLOG=/tmp/maps.log PYTHONPATH=src:tests python -m pytest -p torch_mapcount ...

Each line of ``$MAPLOG`` is ``worker<TAB>mappings<TAB>nodeid``; the worker is
``PYTEST_XDIST_WORKER`` (``main`` in one process, and for the controller's
own copy of each report under xdist).
"""

import os


def pytest_runtest_logfinish(nodeid, location):
    with open("/proc/self/maps") as f:
        n = sum(1 for _ in f)
    with open(os.environ["MAPLOG"], "a") as f:
        f.write(f"{os.environ.get('PYTEST_XDIST_WORKER', 'main')}\t{n}\t{nodeid}\n")
