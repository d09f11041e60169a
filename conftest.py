"""Rules every test of the repository runs under when pytest starts at its root.

Each pytest-xdist worker takes an equal share of the CPUs for torch's and
OpenMP's thread pools, written to the environment so that a child started
with ``subprocess`` inherits it: workers that each take every core spin
against each other. Outside xdist the share is every CPU, torch's default.

Each test has a time limit over its setup, call and teardown. Past it the
test fails where it waits (``subprocess.run`` kills its child on the way
out) and the next test runs. A hang inside native code, which never returns
to the interpreter to take the alarm, ends the worker a fifth later.
"""
import faulthandler
import os
import signal

import pytest

# The longest test measured at one thread a worker takes under a minute;
# a hang must end well inside the whole run's limit.
TEST_TIME_LIMIT_S = 300

_STDERR_FD = pytest.StashKey[int]()


def pytest_configure(config):
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    n = max(1, len(os.sched_getaffinity(0)) // workers)
    os.environ["OMP_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = str(n)
    import torch
    torch.set_num_threads(n)
    # the real stderr, taken before any test's output capture replaces fd 2
    config.stash[_STDERR_FD] = os.dup(2)


def pytest_unconfigure(config):
    os.close(config.stash[_STDERR_FD])


@pytest.hookimpl(wrapper=True)
def pytest_runtest_protocol(item):
    def expire(signum, frame):
        pytest.fail(f"{item.nodeid} exceeded the {TEST_TIME_LIMIT_S} s limit")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, TEST_TIME_LIMIT_S)
    faulthandler.dump_traceback_later(
        TEST_TIME_LIMIT_S * 1.2, exit=True,
        file=item.config.stash[_STDERR_FD])
    try:
        return (yield)
    finally:
        faulthandler.cancel_dump_traceback_later()
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)
