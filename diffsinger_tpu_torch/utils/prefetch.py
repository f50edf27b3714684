"""Bounded background prefetch for the training input pipeline, and the
pinned upload of host arrays (counterpart of diffsinger_tpu/utils/prefetch.py).

A daemon thread runs one pipeline stage ahead of its consumer through a
bounded queue. The trainer chains two such stages: one reads and collates
batches, the other uploads them to the card on a stream of its own, so that
batch k+2 is collated while batch k+1 is copied and batch k trains.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterable, Iterator

import numpy as np
import torch

from diffsinger_tpu_torch.utils import tracing


class PrefetchIterator(Iterator):
    """Iterate ``it`` on a daemon thread, keeping up to ``depth`` items ready.

    - Order-preserving (FIFO).
    - Exceptions raised by the producer re-raise at the consumer.
    - ``close()`` stops the producer and unblocks chained stages; iterating a
      closed prefetcher ends (StopIteration).
    - While tracing is on (``utils.tracing``), the CPU seconds the thread
      spends making items, its waits left out, add up in the counter
      ``pipeline.<name>.cpu_s``.
    """

    _END = object()

    def __init__(self, it: Iterable, depth: int = 2, name: str = "ds-prefetch"):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, int(depth)))
        self._stop = threading.Event()
        self._err: BaseException | None = None

        def _put(item) -> bool:
            """Blocking put that gives up when close() is asked for."""
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        counter = f"pipeline.{name}.cpu_s"

        def _work():
            try:
                items = iter(it)
                while True:
                    if tracing.enabled():  # this thread's CPU time: a blocked wait adds none
                        t0 = time.thread_time()
                        item = next(items, self._END)
                        tracing.add(counter, time.thread_time() - t0)
                    else:
                        item = next(items, self._END)
                    if item is self._END or not _put(item):
                        return
            except BaseException as e:  # noqa: BLE001 - re-raised at the consumer
                self._err = e
            finally:
                _put(self._END)

        self._t = threading.Thread(target=_work, daemon=True, name=name)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._END:
            self._q.put(self._END)  # stay ended on a repeated next()
            if self._err is not None:
                err, self._err = self._err, None
                raise err
            raise StopIteration
        return item

    def is_alive(self) -> bool:
        return self._t.is_alive()

    def close(self):
        """Stop the producer thread and release the queued items.

        Safe against a producer blocked in a put: drain, then put the end
        mark, so that a chained stage downstream ends too.
        """
        self._stop.set()
        for _ in range(200):  # the retries cover a producer's put in flight
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            try:
                self._q.put_nowait(self._END)
                break
            except queue.Full:
                continue
        self._t.join(timeout=5.0)


def upload(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device``. To the card the copy goes
    from pinned memory and does not block the host: from pageable memory it
    would wait for the kernels already queued on the stream."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
