"""Host-side batch prefetching for generator-backed datasets.

Port of ``flowtrain_stochastic_interpolation_tpu/data/prefetch.py``: a
bounded background queue that keeps ``depth`` batches ready while the device
consumes the current one, and a thread pool that generates the items of a
batch in parallel (GeoGen and numpy release the interpreter lock in their hot
loops; so does the native generator).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Sequence, TypeVar

T = TypeVar("T")

_SENTINEL = object()


def prefetch(it: Iterator[T], depth: int = 2) -> Iterator[T]:
    """Iterate ``it`` on a background thread, keeping ``depth`` items queued.

    An exception of the producer is raised again where the items are consumed.
    Closing or abandoning the iterator (``break``, ``close()``, a consumer of
    one batch) stops the producer promptly: every ``put`` is a timed poll
    against a stop flag. The producer is a daemon thread, so an iterator left
    open cannot hang the interpreter's exit.
    """
    q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
    err: list = []
    stop = threading.Event()

    def _put(item) -> bool:
        """Put with stop-polling; False once the consumer has gone away."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for item in it:
                if not _put(item):
                    return
        except BaseException as exc:  # raised again on the consumer's side
            err.append(exc)
        finally:
            _put(_SENTINEL)

    thread = threading.Thread(target=produce, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()  # GeneratorExit or break: unblock and stop the producer


def parallel_map_batches(
    load_item: Callable[[int], T],
    indices_per_batch: Sequence[Sequence[int]],
    stack: Callable[[Sequence[T]], T],
    num_workers: int = 8,
    depth: int = 2,
) -> Iterator[T]:
    """Stacked batches with the items loaded in parallel and the batches prefetched.

    ``load_item(idx)`` runs on a pool of ``num_workers`` threads; whole batches
    are assembled up to ``depth`` ahead of the consumer. Closing the iterator
    cancels the queued work.
    """
    pool = ThreadPoolExecutor(max_workers=num_workers)
    try:
        def batches():
            for idxs in indices_per_batch:
                yield stack(list(pool.map(load_item, idxs)))

        yield from prefetch(batches(), depth=depth)
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
