"""Background-thread batch prefetcher.

Port of `hourglass_pose_estimation_tpu/data/prefetch.py`: one daemon
thread prepares the next batches (host canvas assembly and the copy to the
card, see `runner/trainer.py`) while the card runs the current step. numpy
and the copy release the interpreter lock, so the two overlap.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional


class Prefetcher:
    """Wraps a list of work items with a producer thread.

    Args:
      items: iterable of work descriptors (e.g. (idx, valid) tuples).
      produce: callable turning a descriptor into a ready batch.
      depth: max batches staged ahead.

    Iterating yields (batch, item) in the order of `items`; an exception in
    `produce` is raised on the consumer's side, after the batches produced
    before it. `close()` stops the thread (call it when abandoning the
    iteration early)."""

    def __init__(self, items: Iterable, produce: Callable, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._items = list(items)
        self._produce = produce
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _put(self, entry) -> None:
        """Bounded put that stays responsive to close(): an abandoned
        consumer must not leave this thread blocked forever holding
        device memory."""
        while not self._stop.is_set():
            try:
                self._q.put(entry, timeout=0.2)
                return
            except queue.Full:
                continue

    def _run(self):
        try:
            for item in self._items:
                if self._stop.is_set():
                    return
                self._put((self._produce(item), item))
        except BaseException as e:  # surfaced on the consumer side
            self._err = e
        finally:
            # the end-of-items sentinel must be delivered, or the consumer
            # blocks on get() forever once it drains the staged batches
            self._put((None, None))

    def close(self):
        """Stop producing and join the thread. Idempotent."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=10.0)

    def __iter__(self) -> Iterator:
        while True:
            batch, item = self._q.get()
            if batch is None:
                if self._err is not None:
                    raise self._err
                return
            yield batch, item
