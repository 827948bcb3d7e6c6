"""Phase timers with the JAX package's scope names (utils/timer.py there),
so the port's stage times line up with the reference's.

Every closed scope is recorded as (name, ms). Times are host wall clock:
the prover synchronises with the card at every Fiat-Shamir squeeze, so a
scope's time includes its work.
"""

from __future__ import annotations

import contextlib
import functools
import time

_RECORDS: list = []


class timed:
    """Decorator + context-manager factory for phase timing."""

    def __init__(self, name: str):
        self.name = name

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with timed.scope(self.name):
                return fn(*args, **kwargs)

        return wrapper

    @staticmethod
    def records():
        return list(_RECORDS)

    @staticmethod
    def clear():
        _RECORDS.clear()

    @staticmethod
    @contextlib.contextmanager
    def scope(name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            _RECORDS.append((name, (time.perf_counter() - start) * 1e3))
