"""Timeout engine for futures, device arrays, and context blocks.

Analog of the reference's ``torchft/futures.py``: a singleton background
asyncio event loop schedules timeouts for pending futures
(``future_timeout``/``future_wait``), for blocks of host code
(``context_timeout``), and for in-flight CUDA work
(``array_timeout`` — the reference's ``stream_timeout``: fires a callback if
the work producing a set of tensors hasn't completed in time). A watchdog thread kills the
process if the event loop itself wedges for more than
``TORCHFT_WATCHDOG_TIMEOUT_SEC`` (default 30s), mirroring futures.py:97-120.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import os
import sys
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Generator, Optional, Sequence

from torchft_tpu_torch import knobs

WATCHDOG_INTERVAL = 0.1


class _TimeoutManager:
    """Singleton scheduling engine (lazy-started)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._watchdog: Optional[threading.Thread] = None
        self._heartbeat = 0.0
        self._watchdog_enabled = False

    def _ensure_started(self) -> asyncio.AbstractEventLoop:
        with self._lock:
            if self._loop is None:
                self._loop = asyncio.new_event_loop()
                self._thread = threading.Thread(
                    target=self._run, name="torchft-timeout-manager", daemon=True
                )
                self._thread.start()
            return self._loop

    def _run(self) -> None:
        assert self._loop is not None
        asyncio.set_event_loop(self._loop)

        async def heartbeat() -> None:
            while True:
                self._heartbeat = time.monotonic()
                await asyncio.sleep(WATCHDOG_INTERVAL)

        self._loop.create_task(heartbeat())
        self._loop.run_forever()

    def start_watchdog(self) -> None:
        """Starts the thread that exits the process if the timeout loop is
        stuck (it is the last line of defense: if it can't run, nothing can
        cancel a wedged collective)."""
        self._ensure_started()  # the loop IS the heartbeat source
        with self._lock:
            if self._watchdog is not None:
                return
            self._watchdog_enabled = True
            self._heartbeat = time.monotonic()
            self._watchdog = threading.Thread(
                target=self._watchdog_loop, name="torchft-watchdog", daemon=True
            )
            self._watchdog.start()

    def _watchdog_loop(self) -> None:
        timeout = knobs.get_float("TORCHFT_WATCHDOG_TIMEOUT_SEC")
        while self._watchdog_enabled:
            time.sleep(timeout / 2)
            age = time.monotonic() - self._heartbeat
            if age > timeout:
                print(
                    f"torchft watchdog: timeout event loop stuck for {age:.1f}s; "
                    "exiting process",
                    file=sys.stderr,
                    flush=True,
                )
                os._exit(1)

    def stop_watchdog(self) -> None:
        self._watchdog_enabled = False
        self._watchdog = None

    def call_later(self, delay: float, fn: Callable[[], None]) -> Callable[[], None]:
        """Schedules fn on the engine loop; returns a cancel function."""
        loop = self._ensure_started()
        handle_box: list = []

        def _schedule() -> None:
            handle_box.append(loop.call_later(delay, fn))

        loop.call_soon_threadsafe(_schedule)

        def cancel() -> None:
            def _cancel() -> None:
                if handle_box:
                    handle_box[0].cancel()

            loop.call_soon_threadsafe(_cancel)

        return cancel


_TIMEOUT_MANAGER = _TimeoutManager()


def future_timeout(
    fut: concurrent.futures.Future, timeout: float
) -> concurrent.futures.Future:
    """Returns a future that mirrors ``fut`` but fails with TimeoutError if
    ``fut`` doesn't complete within ``timeout`` seconds (reference:
    futures.py ``future_timeout``)."""
    out: concurrent.futures.Future = concurrent.futures.Future()

    def on_timeout() -> None:
        if not out.done():
            out.set_exception(
                TimeoutError(f"future timed out after {timeout}s")
            )

    cancel = _TIMEOUT_MANAGER.call_later(timeout, on_timeout)

    def on_done(f: concurrent.futures.Future) -> None:
        cancel()
        if out.done():
            return
        exc = f.exception()
        if exc is not None:
            out.set_exception(exc)
        else:
            out.set_result(f.result())

    fut.add_done_callback(on_done)
    return out


def future_wait(fut: concurrent.futures.Future, timeout: float) -> Any:
    """Waits for ``fut`` up to ``timeout`` seconds; raises TimeoutError."""
    try:
        return fut.result(timeout)
    except concurrent.futures.TimeoutError as e:
        raise TimeoutError(f"future did not complete in {timeout}s") from e


@contextmanager
def context_timeout(
    callback: Callable[[], None], timeout: float
) -> Generator[None, None, None]:
    """Runs ``callback`` if the with-block doesn't finish within ``timeout``
    (reference: futures.py ``context_timeout``; used to abort a process group
    wedged inside a collective)."""
    cancel = _TIMEOUT_MANAGER.call_later(timeout, callback)
    try:
        yield
    finally:
        cancel()


def array_timeout(
    arrays: Sequence[Any], callback: Callable[[], None], timeout: float
) -> None:
    """Fires ``callback`` unless the CUDA work producing ``arrays`` (torch
    tensors) completes within ``timeout`` seconds — the reference's
    ``stream_timeout`` (futures.py:193-212): detect a device computation
    that will never complete, and abort at the transport layer rather than
    wedge the trainer. A CUDA event is recorded on the caller's current
    stream and a waiter thread synchronizes on it; CPU tensors are complete
    at once."""
    done = threading.Event()
    devices = {
        t.device for t in arrays if getattr(t, "is_cuda", False)
    }
    if not devices:
        return
    import torch

    events = []
    for dev in devices:
        with torch.cuda.device(dev):
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            events.append(ev)

    def waiter() -> None:
        try:
            for ev in events:
                ev.synchronize()
        except Exception:  # noqa: BLE001 - readiness probe only
            pass
        finally:
            done.set()

    threading.Thread(target=waiter, daemon=True).start()

    def on_timeout() -> None:
        if not done.is_set():
            callback()

    _TIMEOUT_MANAGER.call_later(timeout, on_timeout)


def start_watchdog() -> None:
    _TIMEOUT_MANAGER.start_watchdog()


def stop_watchdog() -> None:
    _TIMEOUT_MANAGER.stop_watchdog()
