"""Host->device prefetch: overlap batch assembly/augmentation with device steps.

The reference relies on torch DataLoader workers for this (its configs ship
``workers: 0``, i.e. fully synchronous). Here a background thread prepares
the next batch(es) (HDF5 slicing + C++ augmentation) and issues
``jax.device_put`` with the data-parallel sharding so the transfer overlaps
the current step's compute — the double-buffered device prefetch of
SURVEY.md §7 step 3.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import jax
import numpy as np


class DevicePrefetcher:
    """Wraps a host batch iterator; yields device-resident batches.

    Supports early termination (``close()``, or use as a context manager):
    the worker thread checks a stop flag between puts, so a consumer that
    breaks out of the loop mid-epoch (``max_steps_per_epoch``) does not leak
    a blocked thread per epoch.
    """

    def __init__(self, it: Iterator[Dict[str, np.ndarray]],
                 place: Callable[[Dict[str, np.ndarray]], Dict],
                 depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._place = place
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()

        def worker():
            try:
                for batch in it:
                    item = self._place(batch)
                    while not self._stop.is_set():
                        try:
                            self._q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if self._stop.is_set():
                        return
            except BaseException as e:  # propagate into the consumer
                self._err = e
            finally:
                # The end-of-stream sentinel must not be dropped when the
                # queue is momentarily full (the consumer would block on
                # get() forever) — retry until delivered or closed.
                while not self._stop.is_set():
                    try:
                        self._q.put(None, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def close(self):
        self._stop.set()
        # Drain so a worker blocked on put() can observe the flag and exit.
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def prefetch_to_device(it, mesh=None, exclude=("count",), depth: int = 2):
    """Convenience: prefetch host batches with data-axis sharding."""
    from mvp_benchmark_tpu.parallel.mesh import get_mesh, shard_batch

    m = get_mesh(mesh)

    def place(batch):
        return shard_batch(m, batch, exclude=exclude)

    return DevicePrefetcher(it, place, depth)
