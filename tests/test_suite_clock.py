"""The suite's own clock (tests/suite_clock.py): one persistent XLA
compilation cache that every pytest process of a run shares, and a time
limit on every test."""

import os
import subprocess
import sys
import textwrap
import time
import uuid

import jax
import numpy as np

import suite_clock

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))

# Compiles one jitted function whose constant is unique to the calling test,
# then prints how many persistent-cache hits that compile made. With a
# second argument it first points jax_compilation_cache_dir elsewhere, as
# the train and valid drivers' _enable_compile_cache does before they
# compile anything.
_PROBE = """
import sys
import numpy as np
import jax
from jax import monitoring

if len(sys.argv) > 2:
    jax.config.update("jax_compilation_cache_dir", sys.argv[2])

hits = []
monitoring.register_event_listener(
    lambda event, **kw: hits.append(event)
    if event == "/jax/compilation_cache/cache_hits" else None)

def suite_clock_probe(x):
    return x * float(sys.argv[1]) + 1.0

jax.jit(suite_clock_probe)(np.ones(4, np.float32)).block_until_ready()
print("HITS", len(hits))
"""


def _probe(*argv):
    r = subprocess.run([sys.executable, "-c", _PROBE, *argv],
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr[-3000:]
    return int(r.stdout.split("HITS")[-1])


def test_processes_share_one_compile_cache(tmp_path):
    cache_dir = os.environ[suite_clock.CACHE_ENV]
    assert os.path.isdir(cache_dir)
    assert jax.config.jax_compilation_cache_dir == cache_dir
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 0.0

    def entries():
        return [n for n in os.listdir(cache_dir)  # not LRU "-atime" files
                if n.startswith("jit_suite_clock_probe-")
                and n.endswith("-cache")]

    constant = str(1.0 + uuid.uuid4().int % 10**6)
    before = entries()
    assert _probe(constant) == 0  # compiled, and written to the cache
    assert len(entries()) == len(before) + 1
    assert _probe(constant) == 1  # a fresh process reads it back
    # a process that names its own directory before it compiles, as a
    # driver's subprocess does, uses that directory alone
    own = tmp_path / "driver_cache"
    assert _probe(constant, str(own)) == 0
    assert len(entries()) == len(before) + 1
    assert any(n.startswith("jit_suite_clock_probe-") for n in os.listdir(own))


def test_a_drivers_own_directory_gets_its_entries(tmp_path):
    constant = 1.0 + uuid.uuid4().int % 10**6

    def compile_in(directory, min_compile_time_secs):
        def suite_clock_named(x):  # a new function: traced and compiled anew
            return x * constant - 1.0

        # as a driver's _enable_compile_cache does; the plugin's autouse
        # fixture puts the run's settings back after the test
        jax.config.update("jax_compilation_cache_dir", str(directory))
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          min_compile_time_secs)
        jax.jit(suite_clock_named)(np.ones(4, np.float32)).block_until_ready()

    def entries(directory):
        return [n for n in os.listdir(directory)
                if n.startswith("jit_suite_clock_named-")
                and n.endswith("-cache")]

    run_dir = os.environ[suite_clock.CACHE_ENV]
    before = entries(run_dir)
    compile_in(tmp_path / "first", 0.0)  # a miss: written to both
    written = entries(tmp_path / "first")
    assert len(written) == 1 and len(entries(run_dir)) == len(before) + 1
    # a hit: copied to the directory named now, where a miss would not be
    # written (this compile takes far less than 2 s)
    compile_in(tmp_path / "second", 2.0)
    assert entries(tmp_path / "second") == written
    assert len(entries(run_dir)) == len(before) + 1


def test_overrunning_test_fails_at_the_limit(tmp_path):
    (tmp_path / "test_sleeper.py").write_text(textwrap.dedent("""
        import time
        import suite_clock

        suite_clock.TIME_LIMIT_S = 1


        def test_sleeps_past_the_limit():
            time.sleep(120)
    """))
    env = dict(os.environ, PYTHONPATH=TESTS_DIR)  # for -p suite_clock
    t0 = time.monotonic()
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "suite_clock",
         "-p", "no:cacheprovider", str(tmp_path / "test_sleeper.py")],
        capture_output=True, text=True, timeout=300, cwd=tmp_path, env=env)
    took = time.monotonic() - t0
    assert r.returncode == 1, r.stdout[-3000:] + r.stderr[-3000:]
    assert "1 failed" in r.stdout, r.stdout[-3000:]
    assert "exceeded the per-test time limit of 1 s" in r.stdout, (
        r.stdout[-3000:])
    assert took < 100, took  # the limit stopped the sleep, not the sleep's end
