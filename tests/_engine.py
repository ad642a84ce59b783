"""A decode engine held until its requests are queued, for the port's tests.

:func:`hold_admissions` makes concurrent requests overlap in the engine for
certain: its loop finds the queue empty until ``n`` requests wait there, so
that the first admission takes as many of them as there are free slots and
the first tick serves them together, however the submitting threads are
scheduled.
"""

import queue
import threading
import time


def hold_admissions(engine, n: int, timeout_s: float = 120.0) -> None:
    """Until ``n`` requests are queued (or ``timeout_s`` has passed, so that
    a request that never comes fails its test instead of hanging it), the
    engine's loop admits nothing; from then on it admits as usual."""
    q, get, opened = engine._queue, engine._queue.get_nowait, threading.Event()
    deadline = time.monotonic() + timeout_s

    def get_nowait():
        if not opened.is_set():
            if q.qsize() < n and time.monotonic() < deadline:
                raise queue.Empty
            opened.set()
        return get()

    q.get_nowait = get_nowait
