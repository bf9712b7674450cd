"""The tier-1 suite's clock: a pytest plugin that the repo's root
``conftest.py`` registers for every run that collects ``tests/``.

- One persistent XLA compilation cache a run. The controlling process (the
  only one without pytest-xdist) makes a fresh directory and exports it as
  ``JAX_COMPILATION_CACHE_DIR``, with a minimum compile time of 0 s, before
  the workers start, and removes it when the run ends. Every pytest process
  sets JAX's cache up on that directory before any test compiles, caching
  every program whatever its compile time or size, so a program that
  several test files compile is compiled once a run. JAX sets its cache up
  once a process, so a driver's ``_enable_compile_cache`` no longer moves
  it: the directory the driver names (``output_dir/.jax_cache``) instead
  gets a copy of every entry its compiles read or write, and the settings
  it rewrites are put back after each test. The export also turns off the
  GPU-only XLA caches that JAX places under the cache directory: their path
  is part of the cache key, so a driver naming its own directory would
  otherwise miss every entry another test wrote. A hit returns the
  executable that the same program, options and flags compiled to, so no
  result changes. A subprocess inherits the directory, but one that names
  its own before its first compile, as the train and valid drivers do
  (``test_cli``, ``test_multihost``), uses its own alone.
- A time limit of ``TIME_LIMIT_S`` on each phase (setup, call, teardown) of
  every test. A phase over it fails with a message that names the limit; a
  phase stuck where Python cannot interrupt it dumps every thread's stack
  ``TIME_LIMIT_GRACE_S`` later and ends its process, which under xdist
  fails that one test and leaves the rest of the run going.
"""

import contextlib
import faulthandler
import os
import shutil
import signal
import tempfile

import pytest

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
# exported beside it, so that the run's subprocesses cache as its workers do
RUN_ENV = {"JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS": "0",
           "JAX_PERSISTENT_CACHE_ENABLE_XLA_CACHES": ""}
TIME_LIMIT_S = 600
TIME_LIMIT_GRACE_S = 60

_run = {}  # what pytest_configure set up and pytest_unconfigure undoes


class RunCache:
    """JAX's persistent cache for a pytest process: the run's directory,
    plus a copy of each entry read or written in the directory that
    ``jax_compilation_cache_dir`` names when that is another one."""

    def __init__(self, run):
        self.run = run
        self._path = run._path  # JAX logs it when the cache is reset
        self.named = {}

    def _named(self):
        import jax
        from jax._src import compilation_cache

        path = jax.config.jax_compilation_cache_dir
        if not path or path == os.environ[CACHE_ENV]:
            return None
        if path not in self.named:
            self.named[path] = compilation_cache.get_file_cache(path)[0]
        return self.named[path]

    def get(self, key):
        val = self.run.get(key)
        named = self._named()
        if val is not None and named is not None:
            named.put(key, val)
        return val

    def put(self, key, val):
        self.run.put(key, val)
        named = self._named()
        if named is not None:
            named.put(key, val)


def use_run_cache():
    """Point this process's JAX at the run's cache and set the cache up."""
    import jax
    from jax._src import compilation_cache

    jax.config.update("jax_compilation_cache_dir", os.environ[CACHE_ENV])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_enable_xla_caches", "")
    compilation_cache._initialize_cache()  # at most once a process
    if not isinstance(compilation_cache._cache, (RunCache, type(None))):
        compilation_cache._cache = RunCache(compilation_cache._cache)


def pytest_configure(config):
    if not hasattr(config, "workerinput"):  # the controller, or no xdist
        _run["cache_dir"] = tempfile.mkdtemp(prefix="avdn-jaxcache-")
        env = dict(RUN_ENV, **{CACHE_ENV: _run["cache_dir"]})
        _run["env_before"] = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
    use_run_cache()
    # stack dumps go to the real stderr, not to a test's captured output
    _run["stderr"] = os.dup(2)


def pytest_unconfigure(config):
    if "stderr" in _run:
        os.close(_run.pop("stderr"))
    if "cache_dir" in _run:
        shutil.rmtree(_run.pop("cache_dir"), ignore_errors=True)
        for k, v in _run.pop("env_before").items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.fixture(autouse=True)
def _run_compile_cache():
    """Undo what a test's driver set through ``_enable_compile_cache``."""
    yield
    use_run_cache()


@contextlib.contextmanager
def _time_limit(item, phase):
    limit = TIME_LIMIT_S

    def overran(signum, frame):
        pytest.fail(f"{item.nodeid}: {phase} exceeded the per-test time "
                    f"limit of {limit} s (tests/suite_clock.py TIME_LIMIT_S)")

    # pytest, and pytest-xdist in each worker, runs tests on the main thread,
    # where Python delivers SIGALRM
    previous = signal.signal(signal.SIGALRM, overran)
    signal.setitimer(signal.ITIMER_REAL, limit)
    faulthandler.dump_traceback_later(limit + TIME_LIMIT_GRACE_S, exit=True,
                                      file=_run["stderr"])
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    with _time_limit(item, "setup"):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with _time_limit(item, "call"):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item):
    with _time_limit(item, "teardown"):
        return (yield)
