"""The per-test time limit (tests/time_limit.py, tests/suite_plan.py)."""

import signal
import time

import pytest

from tests.time_limit import TimeLimitExceeded, time_limit


def test_time_limit_fails_an_overrunning_call():
    start = time.monotonic()
    with pytest.raises(TimeLimitExceeded, match="time limit of 1 s"):
        with time_limit(1):
            time.sleep(5)
    assert time.monotonic() - start < 2.0
    # the suite plan's limit around this test is armed again
    assert signal.getitimer(signal.ITIMER_REAL)[0] > 0
