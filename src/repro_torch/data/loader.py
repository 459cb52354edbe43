"""Host data loader: prefetching, deterministically resumable (the port's
own copy of the reference's ``data/loader.py``).

A background thread keeps ``prefetch`` batches ready. ``skip(n)``
fast-forwards after a checkpoint restore so the stream is bitwise
identical to an uninterrupted run. Batches are whatever the iterator
yields (numpy arrays from :mod:`repro_torch.data.synthetic`); the trainer
moves them to the device.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional


class PrefetchLoader:
    def __init__(self, make_iter: Callable[[], Iterator[Dict]],
                 prefetch: int = 2):
        self._make_iter = make_iter
        self._prefetch = prefetch
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._iter: Optional[Iterator[Dict]] = None
        self._stop = threading.Event()

    def skip(self, n: int) -> "PrefetchLoader":
        """Fast-forward n batches (resume-after-restore)."""
        it = self._make_iter()
        for _ in range(n):
            next(it)
        self._iter = it
        return self

    def _worker(self):
        it = self._iter if self._iter is not None else self._make_iter()
        try:
            for batch in it:
                if self._stop.is_set():
                    return
                self._queue.put(batch)
        finally:
            self._queue.put(None)

    def __iter__(self):
        self._queue = queue.Queue(maxsize=self._prefetch)
        self._stop.clear()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        while True:
            batch = self._queue.get()
            if batch is None:
                return
            yield batch

    def close(self):
        self._stop.set()
        if self._queue is not None:
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
