"""Background-thread input prefetching: the tf.data `.prefetch` analogue.

Port of adanet_tpu/utils/prefetch.py. An `input_fn` is a plain Python
iterator, so without prefetch every millisecond of host-side batch
preparation adds to the step. `PrefetchIterator` drains the source on a
daemon thread into a bounded queue while the caller consumes from the
front; numpy slicing and copies release the GIL, so the thread overlaps
the training loop's dispatch work. Order is kept exactly (one worker, a
FIFO queue), so training is the same with prefetch on or off; an
exception and the end of the source reach the consumer at the position
where they happened, and the end is sticky.

`DevicePrefetchIterator` also moves each batch to the device on the
worker: on the card it copies every array into pinned host memory and
from there to the card with a non-blocking copy on its own CUDA stream,
and records an event after the copy. The consumer's stream waits on that
event when it takes the batch (a batch read before its copy is done
would be wrong data with no error), and every tensor of the batch is
`record_stream`ed on the consumer's stream, so that the caching
allocator does not hand its memory to the copy stream again before the
consumer's kernels are done with it. With `buffer_size=2` the copy of
batch i + 1 overlaps the step on batch i. On the CPU (a caller's
choice) the batch is made into tensors there, with no stream.

`close()` stops the worker, wakes a worker parked on a full queue and a
consumer blocked on an empty one, and releases every batch still queued
or in the worker's hands (`_release`): their device tensors are dropped
after their copy has finished, so neither the thread nor device memory
outlives the iterator. A failed copy (the card out of memory) reaches
the consumer at its position, like a source exception.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import torch

from adanet_tpu_torch._device import resolve_device
from adanet_tpu_torch.utils.batches import to_device
from adanet_tpu_torch.utils.trees import tree_leaves, tree_map


class PrefetchIterator:
    """Iterator pulling from `source` on a background thread.

    Args:
      source: the iterable to drain (consumed lazily, FIFO).
      buffer_size: the most batches buffered ahead of the consumer.
    """

    _END = ("end", None)

    def __init__(self, source: Iterable, buffer_size: int = 2):
        if buffer_size < 1:
            raise ValueError("buffer_size must be >= 1")
        self._queue: "queue.Queue" = queue.Queue(maxsize=buffer_size)
        self._stop = threading.Event()
        self._exhausted = False
        self._thread = threading.Thread(target=self._fill, args=(iter(source),), daemon=True)
        self._thread.start()

    def _prepare(self, item):
        """The worker's step before an item is queued (the identity
        here). It runs inside `_fill`'s try, so that a failure reaches
        the consumer at its position."""
        return item

    def _arrive(self, item):
        """The consumer's step when it takes an item (the identity here)."""
        return item

    def _release(self, item) -> None:
        """Disposes of a prepared item that will never reach the consumer
        (drained by close(), or its enqueue cut short by close())."""

    def _put(self, item) -> bool:
        """A blocking put that gives up when close() was called."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _fill(self, source: Iterator) -> None:
        try:
            for item in source:
                prepared = self._prepare(item)
                if not self._put(("item", prepared)):
                    # close() raced the enqueue: nobody else will see it.
                    self._release(prepared)
                    return
        except BaseException as exc:  # handed to the consumer
            self._put(("error", exc))
            return
        self._put(self._END)

    def __iter__(self) -> "PrefetchIterator":
        return self

    def __next__(self):
        if self._exhausted:
            raise StopIteration
        kind, payload = self._queue.get()
        if kind == "item":
            return self._arrive(payload)
        self._exhausted = True
        if kind == "error":
            raise payload
        raise StopIteration

    def _drain(self) -> None:
        """Empties the queue, releasing every unconsumed item."""
        try:
            while True:
                kind, payload = self._queue.get_nowait()
                if kind == "item":
                    self._release(payload)
        except queue.Empty:
            pass

    def close(self) -> None:
        """Stops the worker; safe to call more than once.

        A consumer that abandons the iterator mid-stream without close()
        leaves a daemon thread parked on a full queue; the Estimator
        closes every iterator it replaces or stops using."""
        self._stop.set()
        # Free a worker waiting on a full queue, releasing what it queued.
        self._drain()
        # A worker already inside put() can land its item in the slot the
        # drain freed: wait for it to exit (it sees the stop within one
        # put timeout), then drain again.
        if self._thread is not threading.current_thread():
            self._thread.join(timeout=5.0)
        self._drain()
        self._exhausted = True
        # Wake a consumer blocked in __next__'s get(): nothing else would
        # ever be queued. The queue is empty, so there is room.
        try:
            self._queue.put_nowait(self._END)
        except queue.Full:
            pass


class StagedBatch:
    """A batch the worker moved to the device, with the event recorded on
    the copy stream after its copies (None on the CPU)."""

    def __init__(self, batch, event=None):
        self.batch = batch
        self.event = event

    def take(self, stream):
        """The batch, for use on `stream`: the stream waits for the copy,
        and the batch's memory is kept from reuse until `stream`'s work
        on it is done."""
        if self.event is not None:
            stream.wait_event(self.event)
            for t in tree_leaves(self.batch):
                if torch.is_tensor(t):
                    t.record_stream(stream)
        batch, self.batch = self.batch, None
        return batch

    def release(self) -> None:
        """Drops the batch once its copy has finished (its memory then
        goes back to the allocator); releasing twice is an error."""
        if self.batch is None:
            raise RuntimeError("batch already released")
        if self.event is not None:
            self.event.synchronize()
        self.batch = None


class DevicePrefetchIterator(PrefetchIterator):
    """Prefetch and device copy: hands back batches of tensors on `device`
    (the card unless the caller passes "cpu").

    On the card the worker copies through pinned memory on its own CUDA
    stream (`StagedBatch`); the consumer takes each batch on its current
    stream. `close()` releases every staged batch still queued and the
    worker's in-flight one."""

    def __init__(self, source: Iterable, buffer_size: int = 2, device=None):
        self._device = resolve_device(device)
        self._stream = torch.cuda.Stream(self._device) if self._device.type == "cuda" else None
        super().__init__(source, buffer_size=buffer_size)

    def _prepare(self, item):
        if self._stream is None:
            return StagedBatch(to_device(item, self._device))
        with torch.cuda.stream(self._stream):
            batch = tree_map(
                lambda t: t.pin_memory().to(self._device, non_blocking=True) if torch.is_tensor(t) else t,
                to_device(item, "cpu"),
            )
            event = torch.cuda.Event()
            event.record(self._stream)
        return StagedBatch(batch, event)

    def _arrive(self, item):
        stream = torch.cuda.current_stream(self._device) if self._stream is not None else None
        return item.take(stream)

    def _release(self, item) -> None:
        try:
            item.release()
        except Exception:
            # Already released (a racing close): not worth raising on
            # the shutdown path.
            pass
