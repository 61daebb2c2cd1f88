"""Asynchronous frame pipeline: decode threads -> bounded queue -> consumer.

Counterpart of `jetracer_orbslam2_tpu/runtime/pipeline.py`, which rebuilt the
reference's event bus and GPU-worker free list (src/EventsThread.cpp:57-116,
drop-on-full at :63; src/SlamGpuPipeline/SlamGpuPipeline.cpp:144-165):

  * Worker threads load and decode frames ahead of the consumer.  They stay
    off the card: a source for the card decodes to host tensors (pinned), and
    the consumer, on the main thread, makes every CUDA call.
  * A bounded queue provides backpressure; `drop_when_full` reproduces the
    reference's frame-drop policy for live sources, while dataset replay uses
    blocking mode (drop nothing, throttle the producer).
  * Stats mirror the reference's counters (frames in/out/dropped, per-stage
    wall time, buildStream.cpp:657-665).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

from jetracer_orbslam2_torch.utils.timing import StageTimers


@dataclasses.dataclass
class _Failed:
    error: Exception


@dataclasses.dataclass
class PipelineStats:
    produced: int = 0
    consumed: int = 0
    dropped: int = 0


class FramePipeline:
    """Prefetching producer/consumer bridge.

    source: iterable of frame payloads (anything: frame indices, dataset
    frames, already-decoded arrays).  It is iterated under a lock, one item
    at a time across the workers.
    transform: optional per-frame host work executed in the worker threads
    (PNG decode, dtype conversion, pinning), timed as stage "decode".
    """

    _STOP = object()

    def __init__(
        self,
        source: Iterable,
        transform: Optional[Callable] = None,
        capacity: int = 5,
        drop_when_full: bool = False,
        num_workers: int = 1,
    ):
        self.source = source
        self.transform = transform
        self.capacity = capacity
        self.drop_when_full = drop_when_full
        self.num_workers = max(1, num_workers)
        self.stats = PipelineStats()
        self.timers = StageTimers()
        self._q: queue.Queue = queue.Queue(maxsize=capacity)
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()
        self._count_lock = threading.Lock()   # produced / dropped, per worker

    # -- producer ----------------------------------------------------------
    def _next_item(self):
        with self._it_lock:
            try:
                item = next(self._it)
            except StopIteration:
                return self._STOP, -1
            seq = self._seq
            self._seq += 1
            return item, seq

    def _count(self, name: str) -> None:
        with self._count_lock:
            setattr(self.stats, name, getattr(self.stats, name) + 1)

    def _producer(self):
        try:
            self._produce()
        except Exception as e:              # handed to the consumer, which
            self._put_last(_Failed(e))      # raises it on the main thread
        else:
            self._put_last(self._STOP)

    def _produce(self):
        while not self._stop.is_set():
            item, seq = self._next_item()
            if item is self._STOP:
                break
            if self.transform is not None:
                with self.timers.timer("decode"):
                    item = self.transform(item)
            if self.drop_when_full:
                try:
                    self._q.put_nowait((seq, item))
                    self._count("produced")
                except queue.Full:
                    # the reference's policy: drop and log
                    # (EventsThread.cpp:63-71)
                    self._count("dropped")
            else:
                while not self._stop.is_set():
                    try:
                        self._q.put((seq, item), timeout=0.1)
                        self._count("produced")
                        break
                    except queue.Full:
                        continue

    def _put_last(self, marker) -> None:
        """A worker's last message; given up once the consumer has stopped
        reading, so a worker never blocks on a full queue after close()."""
        while True:
            try:
                self._q.put(marker, timeout=0.1)
                return
            except queue.Full:
                if self._stop.is_set():
                    return

    # -- consumer ----------------------------------------------------------
    def __iter__(self) -> Iterator:
        """Yields frames in source order (a reorder buffer compensates for
        decode-thread races); dropped frames are skipped over."""
        self._it = iter(self.source)
        self._it_lock = threading.Lock()
        self._seq = 0
        for _ in range(self.num_workers):
            th = threading.Thread(target=self._producer, daemon=True)
            th.start()
            self._threads.append(th)
        finished = 0
        pending: dict[int, object] = {}
        next_seq = 0
        try:
            while True:
                item = self._q.get()
                if isinstance(item, _Failed):
                    raise item.error
                if item is self._STOP:
                    finished += 1
                    if finished == self.num_workers:
                        # flush whatever arrived (in order), skipping holes
                        for s in sorted(pending):
                            self.stats.consumed += 1
                            yield pending[s]
                        return
                    continue
                seq, payload = item
                pending[seq] = payload
                while True:
                    if next_seq in pending:
                        self.stats.consumed += 1
                        yield pending.pop(next_seq)
                        next_seq += 1
                    elif (self.drop_when_full
                          and pending
                          and len(pending) > self.capacity):
                        next_seq = min(pending)  # hole was a dropped frame
                    else:
                        break
        finally:
            self.close()

    def close(self):
        self._stop.set()
        for th in self._threads:
            th.join(timeout=1.0)
        self._threads.clear()
