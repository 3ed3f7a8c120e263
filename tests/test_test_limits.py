"""The per-test time limit of the repository's root conftest.py, under
xdist.

Each case writes a small test file beside a conftest that takes the
limit's hooks from the root conftest.py with a 2 s limit, runs it with
`pytest -p xdist -n 1 --dist loadfile` in a subprocess, and reads the
junit XML and the output.
"""

import contextlib
import os
import signal
import subprocess
import sys
import textwrap
import xml.etree.ElementTree as ET

_CONFTEST = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "conftest.py")

_LIMITED_CONFTEST = f"""
import importlib.util

_spec = importlib.util.spec_from_file_location("test_limits",
                                               {_CONFTEST!r})
_limits = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_limits)
_limits._TEST_LIMIT_S = 2.0

globals().update({{name: hook for name, hook in vars(_limits).items()
                  if name.startswith("pytest_")}})
"""


def _run(tmp_path, source):
    """Run `source` as test_case.py under the 2 s limit: (outcomes, out),
    where outcomes maps each test name to its reports in order."""
    (tmp_path / "conftest.py").write_text(_LIMITED_CONFTEST)
    (tmp_path / "test_case.py").write_text(textwrap.dedent(source))
    junit = tmp_path / "junit.xml"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PYTEST_")}
    env["PYTEST_DISABLE_PLUGIN_AUTOLOAD"] = "1"
    # a session of its own, so a worker left hanging is killed with it
    proc = subprocess.Popen(
        [sys.executable, "-m", "pytest", "-p", "xdist", "-n", "1",
         "--dist", "loadfile", f"--junitxml={junit}", "test_case.py"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=60)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"the run did not end in 60 s:\n{out}")
    assert proc.returncode in (0, 1), out
    outcomes = {}
    for case in ET.parse(junit).iter("testcase"):
        kinds = [child.tag for child in case
                 if child.tag in ("failure", "error", "skipped")]
        outcomes.setdefault(case.get("name"), []).extend(kinds or ["passed"])
    return outcomes, out


def _running(pid):
    """Whether `pid` runs: it exists and is not a zombie."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] not in ("Z", "X")
    except FileNotFoundError:
        return False


def test_test_over_limit_fails_by_name_and_run_continues(tmp_path):
    outcomes, out = _run(tmp_path, """
        import time

        def test_sleeper():
            time.sleep(30)

        def test_after():
            pass
    """)
    assert "crashed while running 'test_case.py::test_sleeper'" in out
    assert "passed" not in outcomes["test_sleeper"]
    assert outcomes["test_after"] == ["passed"]
    # the stuck thread's stack, as faulthandler prints it
    assert "Timeout (0:00:0" in out
    assert "line 5 in test_sleeper" in out


def test_test_that_always_hangs_runs_at_most_twice(tmp_path):
    outcomes, out = _run(tmp_path, """
        import threading

        def test_hangs():
            threading.Event().wait()

        def test_after():
            pass
    """)
    assert len(outcomes["test_hangs"]) <= 2
    assert "passed" not in outcomes["test_hangs"]
    assert "ended while running it earlier in this run" in out
    assert out.count("Timeout (0:00:0") == 1
    assert "maximum crashed workers reached" not in out
    assert outcomes["test_after"] == ["passed"]


def test_main_thread_lock_deadlock_is_caught(tmp_path):
    # a collection while the store's lock is held runs a __del__ that
    # waits on the same lock: the main thread never runs Python again
    outcomes, out = _run(tmp_path, """
        import gc
        import threading

        _store_lock = threading.Lock()

        class _Ref:
            def __del__(self):
                with _store_lock:
                    pass

        def test_deadlock():
            ref = _Ref()
            ref.cycle = ref
            del ref
            with _store_lock:
                gc.collect()

        def test_after():
            pass
    """)
    assert "crashed while running 'test_case.py::test_deadlock'" in out
    assert "in __del__" in out
    assert "passed" not in outcomes["test_deadlock"]
    assert outcomes["test_after"] == ["passed"]


def test_teardown_of_failed_test_stays_limited(tmp_path):
    # pytest's faulthandler plugin cancels the timer when a test fails
    outcomes, out = _run(tmp_path, """
        import threading

        import pytest

        @pytest.fixture
        def hangs_in_teardown():
            yield
            threading.Event().wait()

        def test_fails(hangs_in_teardown):
            assert False

        def test_after():
            pass
    """)
    assert "crashed while running 'test_case.py::test_fails'" in out
    assert "in hangs_in_teardown" in out
    assert outcomes["test_after"] == ["passed"]


def test_processes_of_a_test_over_limit_are_ended(tmp_path):
    # as a hung test holding a cluster leaves its head and agents (each
    # in a session of its own) and its ranks (in the worker's) behind
    pids = tmp_path / "pids"
    try:
        outcomes, out = _run(tmp_path, """
            import os
            import subprocess
            import sys
            import threading
            import time

            _CHILD = ("import os, sys, time; "
                      "open(f'up-{os.getpid()}', 'w').close(); "
                      "sys.stderr.write('child up'); sys.stderr.flush(); "
                      "time.sleep(600)")

            def test_hangs_holding_children():
                own = subprocess.Popen([sys.executable, "-c", _CHILD],
                                       start_new_session=True)
                plain = subprocess.Popen([sys.executable, "-c", _CHILD])
                with open("pids", "w") as f:
                    f.write(f"{own.pid} {plain.pid}")
                while not all(os.path.exists(f"up-{p.pid}")
                              for p in (own, plain)):
                    time.sleep(0.01)
                threading.Event().wait()

            def test_after():
                pass
        """)
        assert ("crashed while running "
                "'test_case.py::test_hangs_holding_children'") in out
        assert outcomes["test_after"] == ["passed"]
        left = [int(pid) for pid in pids.read_text().split()]
        assert len(left) == 2
        assert all((tmp_path / f"up-{pid}").exists() for pid in left)
        assert [pid for pid in left if _running(pid)] == []
    finally:
        for pid in pids.read_text().split() if pids.exists() else ():
            with contextlib.suppress(ProcessLookupError):
                os.kill(int(pid), signal.SIGKILL)
