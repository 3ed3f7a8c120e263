"""A hard time limit on every test collected under this directory.

A test that hits the limit fails by name and the run goes on, instead of
the whole run stopping at its own limit with no test named.  The limit
covers the test's setup, call and teardown, module and session fixtures
included: a cluster's shutdown() can hang there.  When it runs out,
faulthandler prints every thread's stack to stderr and ends the process.
Under xdist that is the test's worker: xdist reports "worker 'gwN'
crashed while running '<nodeid>'", starts a new worker and runs the rest
of the file there, so the run reaches its end.  Without xdist the run
ends there.

faulthandler's watchdog is a C thread that needs no GIL, so it fires even
when the main thread waits on a lock inside __del__ during a garbage
collection, where a SIGALRM handler or a Python thread may never run.
faulthandler has one timer: leave pytest's faulthandler_timeout unset,
or it replaces this one.

A marker file per running test, keyed by the xdist run, outlives a test
whose worker ended while running it.  When xdist hands that test to the
new worker, it fails in setup at once instead of hanging again: a test
that always hangs costs one limit and two reports, not xdist's whole
budget of worker restarts (4 per worker), after which the run stops.
That holds for a hang inside the test.  A module fixture whose setup
hangs every time costs one limit for each test of its module, since each
test sets the module up again on a new worker.

When a worker ends mid-test, the processes its tests started live on: a
ray_tpu cluster's head and agents run in sessions of their own.  The
xdist controller then ends every process that inherited that worker's
xdist environment (PYTEST_XDIST_WORKER, PYTEST_XDIST_TESTRUNUID).  A
process started with an environment of its own is not found.
"""

import contextlib
import faulthandler
import hashlib
import os
import signal
import tempfile
import time

import pytest

# The slowest tier-1 test took 137.8-167.3 s over three whole runs on
# 6 xdist workers (its setup, charged the rank jobs of its module:
# tests/test_torch_entry.py::test_dryrun_body_matches_the_jax_step
# [4-float32]).  3x that would be 502 s; 300 s caps what one hang costs
# the run, at 1.8x.  Tests marked slow, outside tier-1, get 4x.
_TEST_LIMIT_S = 300.0
_LIMIT_STDERR_FD = None  # stderr as it was before capture started
_LIMIT_DEADLINE = None   # time.monotonic() at which the running test ends


def pytest_configure(config):
    global _LIMIT_STDERR_FD
    _LIMIT_STDERR_FD = os.dup(2)


def pytest_unconfigure(config):
    faulthandler.cancel_dump_traceback_later()
    os.close(_LIMIT_STDERR_FD)


def _limit_marker(item):
    """The marker file of `item` in this xdist run; None without xdist,
    where hitting the limit ends the run itself."""
    workerinput = getattr(item.config, "workerinput", None)
    if workerinput is None:
        return None
    digest = hashlib.sha1(item.nodeid.encode()).hexdigest()[:16]
    return os.path.join(
        tempfile.gettempdir(),
        f"pytest-limit-{workerinput['testrunuid']}-{digest}")


def _arm_limit():
    faulthandler.dump_traceback_later(
        max(_LIMIT_DEADLINE - time.monotonic(), 0.001), exit=True,
        file=_LIMIT_STDERR_FD)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_protocol(item, nextitem):
    global _LIMIT_DEADLINE
    limit = _TEST_LIMIT_S * (4 if item.get_closest_marker("slow") else 1)
    _LIMIT_DEADLINE = time.monotonic() + limit
    _arm_limit()
    try:
        return (yield)
    finally:
        faulthandler.cancel_dump_traceback_later()
        _LIMIT_DEADLINE = None
        marker = _limit_marker(item)
        if marker is not None:
            with contextlib.suppress(FileNotFoundError):
                os.unlink(marker)


@pytest.hookimpl(tryfirst=True)
def pytest_runtest_setup(item):
    marker = _limit_marker(item)
    if marker is None:
        return
    if os.path.exists(marker):
        pytest.fail("its worker ended while running it earlier in this run "
                    "(at its time limit, whose stacks were printed then, or "
                    "in a crash): not run again", pytrace=False)
    open(marker, "w").close()


@pytest.hookimpl(trylast=True)
def pytest_exception_interact():
    # pytest's faulthandler plugin cancels the timer at every failure;
    # the rest of the failed test, its teardown, stays limited
    if _LIMIT_DEADLINE is not None:
        _arm_limit()


@pytest.hookimpl(optionalhook=True)
def pytest_testnodedown(node, error):
    """On the xdist controller: end what a worker that went down mid-test
    left running."""
    if error is None:
        return
    tags = {f"PYTEST_XDIST_WORKER={node.workerinput['workerid']}".encode(),
            f"PYTEST_XDIST_TESTRUNUID={node.workerinput['testrunuid']}"
            .encode()}
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/environ", "rb") as f:
                environ = set(f.read().split(b"\0"))
        except OSError:
            continue
        if tags <= environ:
            with contextlib.suppress(OSError):
                os.kill(int(pid), signal.SIGKILL)
