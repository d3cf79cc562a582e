"""Meta checks that keep the documentation from drifting (README once
said 181 tests while 183 were collected)."""

import glob
import os
import re

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _readme():
    with open(os.path.join(REPO, "README.md")) as fh:
        return fh.read()


def test_readme_test_count_matches_source():
    # README cites the STATIC test-function count (stable under
    # parametrization, countable without a collection pass); this test is
    # the drift gate.
    n = 0
    for path in glob.glob(os.path.join(REPO, "tests", "test_*.py")):
        with open(path) as fh:
            n += len(re.findall(r"^def test_", fh.read(), re.M))
    m = re.search(r"(\d+) test functions", _readme())
    assert m, "README must state the test-function count"
    assert int(m.group(1)) == n, (
        f"README says {m.group(1)} test functions; tests/ defines {n} — "
        f"update README.md")
