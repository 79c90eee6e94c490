"""Device-transfer prefetching: overlap host-to-device uploads with
compute; the counterpart of ``lsfa_tpu.data.prefetch``.

A background thread pulls items from an iterator (where decoding happens)
and moves their arrays to the device `depth` items ahead. `to_device`
copies through pinned memory without blocking, so the upload of the next
item runs while the current one computes.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from lsfa_tpu_torch.data.loader import to_device


class DevicePrefetcher:
    """Wraps an iterator of dicts of host arrays; yields the dicts with
    every array as a tensor on `device` (other values as they are),
    transferred `depth` items ahead. An exception of the wrapped iterator
    is raised by the `next` that reaches it. `close` stops the thread; a
    consumer that stops early calls it (or uses the prefetcher in a `with`
    statement)."""

    def __init__(self, it, device, depth: int = 2):
        self.it = iter(it)
        self.device = torch.device(device)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._pump, daemon=True)
        self._thread.start()

    def _offer(self, item) -> bool:
        """Queue item unless closed; False once closed."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _pump(self):
        try:
            for item in self.it:
                moved = {k: to_device(v, self.device)
                         if isinstance(v, (np.ndarray, torch.Tensor)) else v
                         for k, v in item.items()}
                if not self._offer(moved):
                    return
        except Exception as e:                  # raised again by __next__
            self._offer(e)
            return
        self._offer(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            self._q.put(item)                   # a later next() stops too
            raise StopIteration
        if isinstance(item, Exception):
            self._q.put(self._done)
            raise item
        return item

    def close(self):
        """Stop the thread and wait for it."""
        self._stop.set()
        self._thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
