"""Streams: the async dispatch layer.

The analog of the reference's header-only async layer
(``src/include/util.h:45-236``): ``CompressParam``/``DecompressParam``
bundles, ``CompressAsync``/``DecompressAsync`` launching the *synchronous*
device call on the worker that owns a queue pair, a result callback, and a
join.  Semantics preserved:

* One outstanding operation per stream; submitting to a busy stream fails
  immediately (the reference returns -EBUSY when the lcore isn't WAITing,
  ``util.h:218-221``; busy queue pairs are also rejected by EntryGuard,
  ``device.cc:456-459``).
* The callback receives a ``Result`` and its return value is harvested by
  ``wait()`` (the ``rte_eal_wait_lcore`` -> ``kAsyncReturnOK`` convention,
  ``util.h:45``, ``demo_app.cc:258-280``).

Each stream owns one worker thread (the "lcore"); the device work inside
is itself parallel (native codec threads + JAX async dispatch), so streams
overlap host codec CPU, PCIe staging, and device decode time across
devices/engines.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from ..status import Result, Status, StatusError
from .device import CompressedUnit, Engine

ASYNC_RETURN_OK = 2  # reference kAsyncReturnOK (util.h:45)


@dataclass
class CompressParam:
    """Reference ``CompressParam`` (``util.h:49-73``)."""

    engine: Engine
    data: np.ndarray | bytes
    result_callback: Callable[["Stream", Result], int] | None = None


@dataclass
class DecompressParam:
    """Reference ``DecompressParam`` (``util.h:75-101``)."""

    engine: Engine
    unit: CompressedUnit
    out: np.ndarray | None = None
    result_callback: Callable[["Stream", Result], int] | None = None


@dataclass
class Stream:
    """One async execution stream bound to an engine.

    The analog of a (device, queue-pair) pair with its pinned worker lcore
    (``driver.cc:100-158``)."""

    engine: Engine
    stream_id: int = 0
    _executor: ThreadPoolExecutor = field(default=None, repr=False)
    _pending: Future | None = field(default=None, repr=False)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def __post_init__(self):
        if self._executor is None:
            self._executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix=f"bitar-stream-{self.stream_id}")

    # ------------------------------------------------------------------
    def _submit(self, fn) -> Status:
        with self._lock:
            if self._pending is not None and not self._pending.done():
                # -EBUSY analog: the worker lcore is not WAITing.
                return Status.Invalid(
                    f"stream {self.stream_id} busy (outstanding operation)")
            self._pending = self._executor.submit(fn)
            return Status.OK()

    def compress_async(self, param: CompressParam) -> Status:
        """Launch a compress on this stream's worker
        (reference ``CompressAsync``, ``util.h:218-221``)."""

        def work() -> int:
            try:
                unit = param.engine.compress(param.data)
                result: Result = Result.ok(unit)
            except StatusError as e:
                result = Result.error(e.status)
            if param.result_callback is not None:
                return param.result_callback(self, result)
            return ASYNC_RETURN_OK if result.is_ok() else result.status.to_int()

        return self._submit(work)

    def decompress_async(self, param: DecompressParam) -> Status:
        """Reference ``DecompressAsync`` (``util.h:232-236``)."""

        def work() -> int:
            try:
                out = param.engine.decompress(param.unit, param.out)
                result: Result = Result.ok(out)
            except StatusError as e:
                result = Result.error(e.status)
            if param.result_callback is not None:
                return param.result_callback(self, result)
            return ASYNC_RETURN_OK if result.is_ok() else result.status.to_int()

        return self._submit(work)

    def wait(self) -> int:
        """Join the outstanding operation and harvest the callback's return
        (reference ``rte_eal_wait_lcore`` join, ``demo_app.cc:258-280``).
        Returns 0 when the stream is idle."""
        with self._lock:
            fut = self._pending
        if fut is None:
            return 0
        rc = fut.result()
        with self._lock:
            if self._pending is fut:
                self._pending = None
        return rc

    def busy(self) -> bool:
        with self._lock:
            return self._pending is not None and not self._pending.done()

    def close(self) -> None:
        self._executor.shutdown(wait=True)


def make_streams(engines: list[Engine], num_streams: int) -> list[Stream]:
    """N streams round-robined over the engines (the reference's
    per-(device, qp) async fan-out, ``demo_app.cc:577-596``)."""
    from .driver import Driver
    placed = Driver.place_streams(num_streams, engines)
    return [Stream(engine=e, stream_id=i) for i, e in enumerate(placed)]


def wait_all(streams: list[Stream]) -> list[int]:
    """Join every stream (reference ``WaitForAsyncCompletion``,
    ``demo_app.cc:258-280``)."""
    return [s.wait() for s in streams]
