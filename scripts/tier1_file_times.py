"""Seconds of one worker a unit of work takes in a pytest JUnit file.

Under ``pytest -n 6 --dist loadfile`` a unit of work (a test file, or a group
of one that the root ``conftest.py`` names in ``GROUPS``) runs whole on one
worker, so the largest unit bounds the suite's wall time. This prints each
unit's summed ``time`` and test count, largest first, then the 10 slowest
tests; the root ``conftest.py``'s ``COST_S`` is read off the first list:

    python scripts/tier1_file_times.py RUN.xml

where ``RUN.xml`` is the file that ``pytest --junitxml=RUN.xml`` wrote. Run
it from the repo root (test ids are mapped back to files there).
"""

import importlib.util
import os
import sys
import xml.etree.ElementTree as ET
from collections import defaultdict

_spec = importlib.util.spec_from_file_location("root_conftest", "conftest.py")
_conftest = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_conftest)
scope_of = _conftest.scope_of


def file_of(case: ET.Element) -> str:
    """The test's file: the longest prefix of its dotted classname that names
    a ``.py`` file (the rest is a class). A file that failed to collect has
    no classname and its dotted path as the name."""

    parts = (case.get("classname") or case.get("name", "")).split(".")
    for i in range(len(parts), 0, -1):
        path = "/".join(parts[:i]) + ".py"
        if os.path.exists(path):
            return path
    return ".".join(parts)


def main() -> None:
    if len(sys.argv) != 2:
        sys.exit(f"usage: python {sys.argv[0]} RUN.xml")
    cases = list(ET.parse(sys.argv[1]).getroot().iter("testcase"))
    secs, count = defaultdict(float), defaultdict(int)
    for c in cases:
        unit = scope_of(f"{file_of(c)}::{c.get('name')}")
        secs[unit] += float(c.get("time", 0))
        count[unit] += 1
    print(f"{'seconds':>9} {'tests':>5}  unit  ({len(cases)} tests, {sum(secs.values()):.1f} s in all)")
    for u in sorted(secs, key=secs.get, reverse=True):
        print(f"{secs[u]:9.1f} {count[u]:5d}  {u}")
    print(f"\n{'seconds':>9}  the 10 slowest tests")
    for c in sorted(cases, key=lambda c: float(c.get("time", 0)), reverse=True)[:10]:
        print(f"{float(c.get('time', 0)):9.1f}  {file_of(c)}::{c.get('name')}")


if __name__ == "__main__":
    main()
