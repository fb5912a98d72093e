"""Repo-wide test budget.

Run without ``-m``, as tier-1 is (``python -m pytest -q``), the suite
leaves out the two multi-minute conformance fuzz tests; their short
variants (``test_conformance_fuzz``, ``test_conformance_random_sweep``)
run the same oracle.  Given any ``-m``, the marks alone decide: both
are ``slow``, so ``-m slow`` runs them and ``-m "slow or not slow"``
runs everything.

Every other test's setup, call and teardown each fail by name once they
run past ``TEST_TIME_LIMIT_S``, so that a hung test frees its worker
instead of holding the whole run.
"""
import contextlib
import signal
import threading

import pytest

LONG_FUZZ = frozenset({
    "tests/test_conformance.py::test_conformance_fuzz_long",
    "tests/test_conformance.py::test_conformance_random_sweep_long",
})
TEST_TIME_LIMIT_S = 300


def pytest_collection_modifyitems(config, items):
    if config.option.markexpr:
        return
    long_fuzz = [item for item in items if item.nodeid in LONG_FUZZ]
    if long_fuzz:
        config.hook.pytest_deselected(items=long_fuzz)
        items[:] = [item for item in items if item.nodeid not in LONG_FUZZ]


class TimeLimitExceeded(BaseException):
    """Raised in the main thread when a test phase runs past its limit.  A
    BaseException, so that neither ``except Exception`` in the code under
    test nor hypothesis (which catches ``pytest.fail``'s exception to
    shrink and replay) can swallow it."""


@contextlib.contextmanager
def _time_limit(item, phase):
    if (item.nodeid in LONG_FUZZ or not hasattr(signal, "SIGALRM")
            or threading.current_thread() is not threading.main_thread()):
        yield
        return

    def expired(signum, frame):
        raise TimeLimitExceeded(
            f"{item.nodeid} ran past the per-test limit of "
            f"{TEST_TIME_LIMIT_S} s in its {phase}")

    previous = signal.signal(signal.SIGALRM, expired)
    signal.alarm(TEST_TIME_LIMIT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_setup(item):
    with _time_limit(item, "setup"):
        yield


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    with _time_limit(item, "call"):
        yield


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_teardown(item):
    with _time_limit(item, "teardown"):
        yield
