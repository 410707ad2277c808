"""Bounded readahead over an indexable dataset.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/data/prefetch.py``, the
same classes and contract. ``Prefetcher`` keeps ``depth`` futures of
``dataset[i]`` in flight on a thread pool, so the next item is read while
the caller works on this one; the native readers release the GIL while
they inflate, so the workers overlap.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Iterator


class Prefetcher:
    """Iterate ``dataset[0..len)`` in order with ``depth`` items in flight.

    ``dataset`` needs ``__len__`` and ``__getitem__``. An exception raised
    by a worker surfaces at the yield of its index, in order."""

    def __init__(self, dataset, depth: int = 4, workers: int = 2):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.dataset = dataset
        self.depth = int(depth)
        self.workers = max(1, int(workers))

    def __len__(self) -> int:
        return len(self.dataset)

    def __iter__(self) -> Iterator:
        n = len(self.dataset)
        if n == 0:
            return
        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            window = {i: pool.submit(self.dataset.__getitem__, i)
                      for i in range(min(self.depth, n))}
            nxt = len(window)
            for i in range(n):
                fut = window.pop(i)
                if nxt < n:
                    window[nxt] = pool.submit(self.dataset.__getitem__, nxt)
                    nxt += 1
                yield fut.result()


def prefetch(dataset, num_workers: int = 0, depth: int | None = None):
    """``dataset`` itself when ``num_workers`` <= 0, else a
    :class:`Prefetcher` with ``depth`` (default twice the workers)."""
    if num_workers <= 0:
        return dataset
    return Prefetcher(dataset, depth=depth or 2 * num_workers,
                      workers=num_workers)
