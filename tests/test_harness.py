"""The test harness in the repository's root conftest.py: the per-test
time limit and the worker thread share under pytest-xdist."""
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_per_test_limit_fails_a_hanging_test(tmp_path):
    """A test past its limit fails with every thread's stack, and the next
    test in the file still runs and passes."""
    shutil.copy(os.path.join(ROOT, "conftest.py"), tmp_path / "conftest.py")
    (tmp_path / "test_hangs.py").write_text(textwrap.dedent("""
        import time

        import conftest

        conftest.PER_TEST_LIMIT_S = 1


        def test_sleeps_past_the_limit():
            time.sleep(3)

        def test_runs_after():
            pass
    """))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PYTEST_XDIST")}
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-p", "no:xdist",
         "-p", "no:cacheprovider", "-p", "no:randomly", "-q",
         "test_hangs.py"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 1, out
    assert "1 failed, 1 passed" in out, out
    assert "ran past its limit of 1 s" in out, out
    assert "most recent call first" in out, out
    assert "in test_sleeps_past_the_limit" in out, out


def test_xdist_worker_torch_threads_capped():
    """Each xdist worker's torch pool holds at most its share of the
    cores."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        pytest.skip("runs only inside a pytest-xdist worker")
    import torch

    assert torch.get_num_threads() <= max(
        1, (os.cpu_count() or 1) // int(workers))
