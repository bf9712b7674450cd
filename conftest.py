"""Registers the tier-1 suite's clock (``tests/suite_clock.py``: one XLA
compile cache a run, a time limit on every test) for every pytest run that
collects ``tests/``. Runs of ``benchmark/tests`` alone do not get it: they
import no JAX."""

import os
import sys

TESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")


def _collects_tests(config):
    for arg in config.args:
        path = os.path.realpath(os.path.join(config.invocation_params.dir,
                                             arg.split("::")[0]))
        if os.path.commonpath([path, TESTS]) in (path, TESTS):
            return True
    return False


def pytest_configure(config):
    if _collects_tests(config) and not config.pluginmanager.has_plugin(
            "suite_clock"):
        if TESTS not in sys.path:
            sys.path.insert(0, TESTS)
        import suite_clock

        config.pluginmanager.register(suite_clock, "suite_clock")
