"""Batched, prefetching data loader (counterpart of the JAX package's
`data/loader.py`).

Worker processes build the samples while the device trains; a bounded
queue holds `prefetch` batches. The JAX loader's worker threads share the
interpreter lock with the training loop, whose ~38,000 kernel launches a
step (the face train step at batch 15) hold it most of the time: on an
H100 host they took ~11 s to build a clip batch that takes 4 s alone, so
the loop waited. Processes (the `spawn` method) hold no lock of the
loop's. One producer thread runs epoch after epoch, so the next epoch's
first batches are built during the current epoch's last steps (the JAX
loader starts an epoch's work only when it is iterated; with 15 videos at
batch 15, every batch is an epoch).

A dataset with an `rng` (`random.Random`, as `FaceDatasetTrain` has) gets
one seed per sample drawn from it in order, and the worker draws that
sample from `random.Random(seed)`: the batches are the same for the same
seeds however the samples are spread over the workers (the JAX loader's
threads share one rng, in the order they happen to run). `close()` stops
the producer and the workers; a `with` block closes the loader.
"""

from __future__ import annotations

import multiprocessing
import queue
import random as _random
import threading
from concurrent.futures import ProcessPoolExecutor
from typing import Iterator

import numpy as np

_EPOCH_END = "epoch_end"
_DATASET = None   # the dataset, in each worker process


def _init_worker(dataset) -> None:
    global _DATASET
    _DATASET = dataset


def _load(index: int, seed):
    if seed is not None:
        _DATASET.rng = _random.Random(seed)
    return _DATASET[index]


def collate(samples: list[dict]) -> dict:
    """Stack a list of sample dicts along a new leading batch axis."""
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        out[key] = np.stack(vals) if isinstance(vals[0], np.ndarray) else vals
    return out


class Loader:
    """Shuffled batches of `dataset`, built ahead in `num_workers` worker
    processes (the dataset is pickled to each). Each epoch's order comes
    from `random.Random(seed)`, as in the JAX package; an iteration broken
    off mid-epoch is resumed where it stopped by the next one."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 8, seed: int = 0,
                 drop_last: bool = False, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.rng = _random.Random(seed)
        self._queue: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
        self._stop = threading.Event()
        self._thread = None

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def batch_indices(self):
        """The next epoch's batches of dataset indices."""
        order = list(range(len(self.dataset)))
        if self.shuffle:
            self.rng.shuffle(order)
        for i in range(0, len(order), self.batch_size):
            chunk = order[i:i + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            yield chunk

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self):
        rng = getattr(self.dataset, "rng", None)
        try:
            with ProcessPoolExecutor(
                    self.num_workers,
                    mp_context=multiprocessing.get_context("spawn"),
                    initializer=_init_worker,
                    initargs=(self.dataset,)) as pool:
                while not self._stop.is_set():
                    for chunk in self.batch_indices():
                        seeds = [None if rng is None else rng.getrandbits(64)
                                 for _ in chunk]
                        samples = list(pool.map(_load, chunk, seeds))
                        if not self._put(("batch", collate(samples))):
                            return
                    if not self._put((_EPOCH_END, None)):
                        return
        except Exception as exc:  # handed to the consumer, raised there
            self._put(("error", exc))

    def start(self) -> None:
        """Start the workers and the building of batches, if not yet
        started (iterating starts them too): a caller can overlap their
        start (each worker imports the program's main module) with its
        own set-up."""
        if self._thread is None:
            self._thread = threading.Thread(target=self._produce,
                                            daemon=True)
            self._thread.start()

    def __iter__(self) -> Iterator[dict]:
        self.start()
        while True:
            kind, item = self._queue.get()
            if kind == "error":
                raise item
            if kind == _EPOCH_END:
                return
            yield item

    def close(self) -> None:
        """Stop the producer and the workers (samples in flight finish)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=600)
            self._thread = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
