"""Work: the async handle returned by process-group collectives.

Analog of torch.distributed's ``Work`` as used by the reference
(torchft/work.py:9-20, torchft/process_group.py): a future-like object with
``wait``/``done``/``exception`` plus callback chaining. Backed by
``concurrent.futures.Future`` — JAX has no exposed stream objects, so
completion is host-side (the device-side analog is JAX async dispatch; see
manager._ManagedWork for the divide-by-N callback chaining).
"""

from __future__ import annotations

import concurrent.futures
from typing import Any, Callable, Optional


class Work:
    """Base async work handle."""

    def wait(self, timeout: Optional[float] = None) -> Any:
        raise NotImplementedError

    def done(self) -> bool:
        raise NotImplementedError

    def exception(self) -> Optional[BaseException]:
        raise NotImplementedError

    def result(self, timeout: Optional[float] = None) -> Any:
        return self.wait(timeout)

    def add_done_callback(self, fn: Callable[["Work"], None]) -> None:
        raise NotImplementedError


class DummyWork(Work):
    """Already-completed work with a preset result (reference: _DummyWork,
    torchft/work.py:9-20). Returned when a rank doesn't participate or after
    an error has been latched."""

    def __init__(self, result: Any = None) -> None:
        self._result = result

    def wait(self, timeout: Optional[float] = None) -> Any:
        return self._result

    def done(self) -> bool:
        return True

    def exception(self) -> Optional[BaseException]:
        return None

    def add_done_callback(self, fn: Callable[[Work], None]) -> None:
        fn(self)


class FutureWork(Work):
    """Work wrapping a concurrent.futures.Future."""

    def __init__(self, future: concurrent.futures.Future) -> None:
        self._future = future

    @property
    def future(self) -> concurrent.futures.Future:
        return self._future

    def wait(self, timeout: Optional[float] = None) -> Any:
        return self._future.result(timeout)

    def done(self) -> bool:
        return self._future.done()

    def exception(self) -> Optional[BaseException]:
        if not self._future.done():
            return None
        return self._future.exception()

    def add_done_callback(self, fn: Callable[[Work], None]) -> None:
        self._future.add_done_callback(lambda _f: fn(self))


class ErrorWork(Work):
    """Already-failed work carrying an exception."""

    def __init__(self, exc: BaseException) -> None:
        self._exc = exc

    def wait(self, timeout: Optional[float] = None) -> Any:
        raise self._exc

    def done(self) -> bool:
        return True

    def exception(self) -> Optional[BaseException]:
        return self._exc

    def add_done_callback(self, fn: Callable[[Work], None]) -> None:
        fn(self)
