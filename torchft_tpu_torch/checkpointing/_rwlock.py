"""Readers-writer lock with timeouts.

Same role as the reference's vendored ``torchft/checkpointing/_rwlock.py``
(itself MIT): the Manager holds the write lock while the optimizer mutates
parameters and the read lock while a checkpoint is being serialized to a
recovering peer, so a heal can never observe a half-updated state dict.
Write-preferring two-condition design.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Generator


class RWLock:
    def __init__(self, timeout: float = -1) -> None:
        self._default_timeout = timeout
        self._lock = threading.Lock()
        self._readers_ok = threading.Condition(self._lock)
        self._writers_ok = threading.Condition(self._lock)
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    def acquire_read(self, timeout: float | None = None) -> bool:
        timeout = self._default_timeout if timeout is None else timeout
        deadline = None if timeout < 0 else time.monotonic() + timeout
        with self._lock:
            while self._writer or self._writers_waiting > 0:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._readers_ok.wait(remaining)
            self._readers += 1
            return True

    def release_read(self) -> None:
        with self._lock:
            self._readers -= 1
            if self._readers == 0:
                self._writers_ok.notify()

    def acquire_write(self, timeout: float | None = None) -> bool:
        timeout = self._default_timeout if timeout is None else timeout
        deadline = None if timeout < 0 else time.monotonic() + timeout
        with self._lock:
            self._writers_waiting += 1
            acquired = False
            try:
                while self._writer or self._readers > 0:
                    remaining = (
                        None if deadline is None else deadline - time.monotonic()
                    )
                    if remaining is not None and remaining <= 0:
                        return False
                    self._writers_ok.wait(remaining)
                self._writer = True
                acquired = True
                return True
            finally:
                self._writers_waiting -= 1
                if not acquired and self._writers_waiting == 0:
                    # Wake readers parked on the writer-preference predicate;
                    # otherwise they sleep out their timeouts on a free lock.
                    self._readers_ok.notify_all()

    def release_write(self) -> None:
        with self._lock:
            self._writer = False
            self._writers_ok.notify()
            self._readers_ok.notify_all()

    @contextmanager
    def r_lock(self, timeout: float | None = None) -> Generator[None, None, None]:
        if not self.acquire_read(timeout):
            raise TimeoutError("timed out acquiring read lock")
        try:
            yield
        finally:
            self.release_read()

    @contextmanager
    def w_lock(self, timeout: float | None = None) -> Generator[None, None, None]:
        if not self.acquire_write(timeout):
            raise TimeoutError("timed out acquiring write lock")
        try:
            yield
        finally:
            self.release_write()
