"""Device prefetching: overlap the host-to-card copy of the next batches
with the current step (port of data/prefetch.py).

``prefetch_to_device(it, size, device, thread)`` keeps ``size`` items of
``it`` (tuples of numpy arrays or tensors) copied ahead of the consumer.
On the card each array is placed in pinned host memory and copied with
``non_blocking=True`` on a side CUDA stream, after which an event is
recorded; when the consumer takes the item, its current stream waits on
that event and ``record_stream`` ties the card buffers to it, so the
caching allocator does not hand them out while the consumer's work on them
is queued.  The pinned host buffers are the caching host allocator's,
which keeps each until its copy has finished.  ``thread=True`` runs the
producer (the numpy or native augmentation, the pinning and the copy's
issue) on a background thread with a bounded queue, so host batch
preparation overlaps the card's work.  For a CPU device the items are only
converted to tensors.

``sharding=`` takes a data-parallel rule (``parallel.batch_sharding(mesh)``,
``parallel/mesh.py``): each item is cut to this rank's rows on the host
before it is copied, so a rank moves only its slice of the global batch.
``threaded_iterator`` runs any iterator on a background thread with a
bounded queue and yields its items unchanged.  The consumer's wait for the
queue's next item is the span ``data.wait`` (``backend.span``).
"""
from __future__ import annotations

import collections
import itertools
import queue as queue_mod
import threading
from typing import Any, Callable, Iterable, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from ..backend import resolve_device, span

__all__ = ["prefetch_to_device", "threaded_iterator"]

_END = object()


def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))


def _card_put(device: torch.device) -> Tuple[Callable, Callable]:
    """(put, take) for a CUDA device: ``put`` issues the copies of one item
    on the side stream and returns (tensors, event); ``take`` makes the
    consumer's stream wait for them."""
    side = torch.cuda.Stream(device=device)

    def put(item):
        host = [_as_tensor(a).pin_memory() for a in item]
        with torch.cuda.stream(side):
            out = tuple(h.to(device, non_blocking=True) for h in host)
            event = torch.cuda.Event()
            event.record(side)
        return out, event

    def take(staged):
        out, event = staged
        stream = torch.cuda.current_stream(device)
        stream.wait_event(event)
        for t in out:
            t.record_stream(stream)
        return out

    return put, take


def prefetch_to_device(
    iterator: Iterable[Any],
    size: int = 2,
    device: Optional[Union[str, torch.device]] = None,
    thread: bool = False,
    sharding=None,
) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Yield the items of ``iterator`` as tuples of tensors on ``device``
    (default: the card; raises without one, see ``backend.resolve_device``),
    ``size`` items ahead of the consumer; with ``sharding`` (a rule with
    ``local(item)``) each item is first cut to this rank's rows."""
    if size < 1:
        raise ValueError(f"prefetch size must be >= 1, got {size}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        put, take = _card_put(dev)
    else:
        put = lambda item: tuple(_as_tensor(a) for a in item)
        take = lambda staged: staged
    if sharding is not None:
        whole_put = put
        put = lambda item: whole_put(sharding.local(tuple(item)))
    if thread:
        return _threaded_prefetch(iterator, size, put, take)

    it = iter(iterator)
    buf: collections.deque = collections.deque()

    def gen():
        def enqueue(n):
            for item in itertools.islice(it, n):
                buf.append(put(item))

        enqueue(size)
        while buf:
            staged = buf.popleft()
            enqueue(1)
            yield take(staged)

    return gen()


def threaded_iterator(iterator: Iterable[Any], size: int = 2
                      ) -> Iterator[Any]:
    """Run ``iterator`` on a background thread with a ``size``-bounded
    queue, yielding its items unchanged: its host work (augmentation,
    slicing) overlaps the consumer's, as ``prefetch_to_device(thread=True)``
    does without the copy."""
    if size < 1:
        raise ValueError(f"prefetch size must be >= 1, got {size}")
    return _threaded_prefetch(iterator, size, lambda item: item,
                              lambda item: item)


def _threaded_prefetch(iterator, size, put, take) -> Iterator[Any]:
    q: queue_mod.Queue = queue_mod.Queue(maxsize=size)
    stop = threading.Event()

    def offer(item) -> bool:
        """Bounded put that gives up once the consumer abandoned."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                continue
        return False

    def producer():
        try:
            for item in iterator:
                if not offer(put(item)):
                    return
            offer(_END)
        except BaseException as e:  # handed to the consumer
            offer(e)

    t = threading.Thread(target=producer, daemon=True, name="prefetch")

    def gen():
        # start at the first next(): a generator never iterated must not
        # leave a thread holding batches
        t.start()
        try:
            while True:
                with span("data.wait"):
                    item = q.get()
                if item is _END:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield take(item)
        finally:
            stop.set()
            t.join()

    return gen()
