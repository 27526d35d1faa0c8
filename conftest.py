"""Test harness settings that pytest loads before tests/conftest.py.

- Under pytest-xdist each worker gets an equal share of the cores for its
  torch thread pool. This runs before tests/conftest.py's `import jax`.
- The JAX package's test of its shard_map paths, the run's longest file,
  starts first under `--dist loadfile`.
- Every test has a time limit (PER_TEST_LIMIT_S).

`pytest --noconftest` (the card's tests) loads none of this.
"""
import faulthandler
import os
import signal
import sys

import pytest

# torch's pool would otherwise start one thread per core in every worker:
# with six workers on eight cores the slowest tests share their cores with
# dozens of threads. (XLA's CPU pool is left as it is: jaxlib 0.9.0 refuses
# --intra_op_parallelism_threads in XLA_FLAGS, and its CPU work stays as
# parallel under --xla_cpu_multi_thread_eigen=false.)
_workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _workers:
    _threads = max(1, (os.cpu_count() or 1) // int(_workers))
    os.environ["OMP_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = str(
        _threads)
    if "torch" in sys.modules:
        sys.modules["torch"].set_num_threads(_threads)

# Queued ahead of every other file under --dist loadfile. xdist queues
# files by their number of items, most first, and hands each worker two
# at the start: this 13-item file, alone the longest, would wait behind
# another file on its worker.
FIRST_FILES = ("tests/test_parallel.py",)
# Seconds a test's set-up, call and tear-down may take together. The
# slowest test takes about 250 s alone and up to twice that in a loaded
# run, and a test that hangs in the run's first minutes still fails
# inside the run's 1470 s.
PER_TEST_LIMIT_S = 900
_stderr_fd = None


def pytest_configure(config):
    # A copy of the process's stderr, taken while output is not captured.
    global _stderr_fd
    _stderr_fd = os.dup(sys.__stderr__.fileno())
    if getattr(config.option, "numprocesses", None) and not os.environ.get(
            "PYTEST_XDIST_WORKER"):
        # Build the JAX package's native graph library here, before xdist
        # starts its workers: its `make` writes the library in place, and a
        # worker that loads it while another worker writes it falls back
        # to the numpy builder for the rest of the run.
        from graph_pde_tpu.graph import native

        native.available()


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    """loadfile, with FIRST_FILES at the head of the queue (order only)."""
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    for scope in FIRST_FILES:
        assert (config.rootpath / scope).is_file(), f"no file {scope}"

    class FirstFilesFirst(LoadFileScheduling):
        def _assign_work_unit(self, node):
            for scope in reversed(FIRST_FILES):
                if scope in self.workqueue:
                    self.workqueue.move_to_end(scope, last=False)
                    continue
                # Not queued: handed out already or not collected, never
                # queued under another name.
                base = scope.rpartition("/")[2]
                assert not any(s == base or s.endswith("/" + base)
                               for s in self.workqueue), (
                    f"{scope} is queued under another name")
            super()._assign_work_unit(node)

    return FirstFilesFirst(config, log)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_protocol(item, nextitem):
    """Fail a test that runs past PER_TEST_LIMIT_S, with every thread's
    stack in its report, and go on with the next test. A test blocked
    outside Python never sees the alarm; the stacks then go to stderr."""
    limit = PER_TEST_LIMIT_S

    def over(signum, frame):
        faulthandler.dump_traceback(all_threads=True)
        pytest.fail(f"{item.nodeid} ran past its limit of {limit} s")

    previous = signal.signal(signal.SIGALRM, over)
    signal.alarm(limit)
    faulthandler.dump_traceback_later(limit + 5, file=_stderr_fd)
    try:
        return (yield)
    finally:
        faulthandler.cancel_dump_traceback_later()
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)
