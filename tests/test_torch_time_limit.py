"""The root conftest's two rules, run on throwaway test files in a fresh
pytest: a test past its time limit fails alone (killing the child it waits
on) and the next one runs; a hang the alarm cannot reach ends the process;
each xdist worker's thread pools take its share of the CPUs."""
import os
import subprocess
import sys
import textwrap
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
LIMIT_S = 2


def _pytest(tmp_path, body, *args):
    """Run ``body`` as a test file under the root conftest, its limit cut to
    ``LIMIT_S``; return the finished process and its wall time."""
    with open(os.path.join(ROOT, "conftest.py")) as f:
        src = f.read()
    line = "TEST_TIME_LIMIT_S = 300\n"
    assert line in src
    (tmp_path / "conftest.py").write_text(
        src.replace(line, f"TEST_TIME_LIMIT_S = {LIMIT_S}\n"))
    (tmp_path / "test_rules.py").write_text(textwrap.dedent(body))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PYTEST_XDIST")}
    t0 = time.monotonic()
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-rA", "-p", "no:cacheprovider",
         "-p", "no:randomly", *args, "test_rules.py"],
        capture_output=True, text=True, cwd=tmp_path, env=env, timeout=120)
    return out, time.monotonic() - t0


def test_a_test_past_the_limit_fails_alone_and_its_child_is_killed(tmp_path):
    pid_file = tmp_path / "child.pid"
    out, wall = _pytest(tmp_path, f"""
        import subprocess, sys, time

        def test_sleeps():
            time.sleep(600)

        def test_waits_on_a_child():
            subprocess.run([sys.executable, "-c",
                            "import os, time; "
                            "open({str(pid_file)!r}, 'w').write(str(os.getpid())); "
                            "time.sleep(600)"])

        def test_after():
            pass
    """)
    log = out.stdout + out.stderr
    assert out.returncode == 1, log
    for name in ("test_sleeps", "test_waits_on_a_child"):
        assert f"FAILED test_rules.py::{name} - Failed" in log, log
        assert (f"Failed: test_rules.py::{name} exceeded the {LIMIT_S} s"
                " limit") in log, log
    assert "PASSED test_rules.py::test_after" in log, log
    assert "2 failed, 1 passed" in log, log
    assert wall < 60, wall
    pid = int(pid_file.read_text())
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        pass
    else:
        raise AssertionError(f"child {pid} outlived its test")


def test_a_hang_the_alarm_cannot_reach_ends_the_process(tmp_path):
    out, wall = _pytest(tmp_path, """
        import signal, time

        def test_hangs():
            signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGALRM})
            time.sleep(600)
    """)
    assert out.returncode == 1, out.stdout + out.stderr
    assert "Timeout (0:00:02" in out.stderr, out.stderr
    assert "in test_hangs" in out.stderr, out.stderr
    assert wall < 60, wall


def test_each_xdist_worker_takes_its_share_of_the_cpus(tmp_path):
    share = max(1, len(os.sched_getaffinity(0)) // 2)
    out, _ = _pytest(tmp_path, f"""
        import os, pytest, torch

        @pytest.mark.parametrize("i", range(4))
        def test_share(i):
            assert os.environ["PYTEST_XDIST_WORKER_COUNT"] == "2"
            assert os.environ["OMP_NUM_THREADS"] == "{share}"
            assert os.environ["MKL_NUM_THREADS"] == "{share}"
            assert torch.get_num_threads() == {share}
    """, "-p", "xdist", "-n", "2")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "4 passed" in out.stdout, out.stdout
