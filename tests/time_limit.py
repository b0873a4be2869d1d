"""A time limit for one test: ``signal.setitimer`` raises
``TimeLimitExceeded`` in the main thread once the limit has passed, so a
test over its limit fails alone, with its own traceback, instead of holding
the whole run until an outer clock cuts it. ``tests/suite_plan.py`` puts
every test call under one (``DEFAULT_TIME_LIMIT``, or the test's row in
``LIMITS``).

A signal handler runs only between Python bytecodes: a test stuck inside a
C call never sees it. The suite plan's backstop for that case is
``faulthandler.dump_traceback_later(..., exit=True)``.
"""

from __future__ import annotations

import contextlib
import signal
import time

DEFAULT_TIME_LIMIT = 600.0


class TimeLimitExceeded(BaseException):
    """Raised in a test that runs past its limit. A BaseException, so that
    an ``except Exception`` in the code under test cannot swallow it."""


@contextlib.contextmanager
def time_limit(seconds: float):
    """Raise TimeLimitExceeded in the body once ``seconds`` have passed.

    Nests: an enclosing limit's timer and handler come back on exit, less
    the time spent inside. Main thread only, as signal handlers are.
    """
    def expire(signum, frame):
        raise TimeLimitExceeded(
            f"the test ran past its time limit of {seconds:g} s")

    start = time.monotonic()
    old_handler = signal.signal(signal.SIGALRM, expire)
    old_delay, _ = signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old_handler)
        if old_delay:
            left = old_delay - (time.monotonic() - start)
            signal.setitimer(signal.ITIMER_REAL, max(left, 1e-3))
