"""Threaded prefetching batch loader (torch-DataLoader replacement).

The reference feeds GPUs through torch DataLoader worker processes
(data/Objaverse.py:27-66).  Here, as in open_diffusiongs_tpu/data/loader.py
(this module is the port's own copy of it), a small thread pool prefetches
NumPy batches into a bounded queue while the training loop runs device
steps; the loop moves each batch to the device.  Samples are collated by
np.stack; string fields become lists (the reference custom collate,
data/base.py:252-265).

Resume: the index stream is a function of `seed` alone and starts again
from its beginning in every run, so a resumed run sees the batches of a
fresh one, as the JAX package's loader does (the optimizer state, params
and step are what a checkpoint restores).
"""

from __future__ import annotations

import queue
import random
import threading
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np


def collate(samples: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, value in samples[0].items():
        if isinstance(value, str):
            out[key] = [s[key] for s in samples]
        elif isinstance(value, np.ndarray):
            out[key] = np.stack([s[key] for s in samples])
        else:
            out[key] = np.asarray([s[key] for s in samples])
    return out


class PrefetchLoader:
    """Iterate batches from a map-style dataset with background prefetch.

    shuffle=True gives an infinite shuffled stream (training); otherwise one
    epoch in order (eval).
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_threads: int = 2, prefetch: int = 4, seed: int = 0,
                 drop_last: bool = True,
                 process_slice: Optional[slice] = None):
        """process_slice: multi-host mode — the index stream (seeded the
        same on every host) describes the GLOBAL batch; each host only
        loads/collates its `process_slice` of it (mesh.local_batch_slice)."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_threads = max(1, num_threads)
        self.prefetch = prefetch
        self.seed = seed
        self.drop_last = drop_last
        self.process_slice = process_slice

    def _index_stream(self) -> Iterator[List[int]]:
        n = len(self.dataset)
        rng = random.Random(self.seed)
        if self.shuffle:
            while True:
                order = list(range(n))
                rng.shuffle(order)
                # datasets smaller than a batch: repeat (with reshuffle) so
                # the stream always yields full batches
                while len(order) < self.batch_size:
                    extra = list(range(n))
                    rng.shuffle(extra)
                    order.extend(extra)
                for i in range(0, len(order) - self.batch_size + 1,
                               self.batch_size):
                    yield order[i:i + self.batch_size]
        else:
            order = list(range(n))
            end = n if not self.drop_last else n - n % self.batch_size
            for i in range(0, end, self.batch_size):
                yield order[i:i + self.batch_size]

    def first_batch_indices(self) -> List[int]:
        """The dataset indices of the stream's first batch."""
        return next(self._index_stream())

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        idx_iter = self._index_stream()
        lock = threading.Lock()
        SENTINEL = object()

        def worker():
            while not stop.is_set():
                with lock:
                    try:
                        idxs = next(idx_iter)
                    except StopIteration:
                        q.put(SENTINEL)
                        return
                if self.process_slice is not None:
                    idxs = idxs[self.process_slice]
                batch = collate([self.dataset[i] for i in idxs])
                while not stop.is_set():
                    try:
                        q.put(batch, timeout=0.5)
                        break
                    except queue.Full:
                        continue

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_threads)]
        for t in threads:
            t.start()
        done_workers = 0
        try:
            while True:
                item = q.get()
                if item is SENTINEL:
                    done_workers += 1
                    if done_workers == self.num_threads:
                        return
                    continue
                yield item
        finally:
            stop.set()
