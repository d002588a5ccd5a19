"""Threaded data loader.

The port's own copy of ``esmstereo_tpu/data/loader.py``'s thread path:
worker threads build batches on the host while the previous one is on the
device (the training loop copies each batch to the card one step ahead,
``train.loop.device_batches``). Sample ``i`` of epoch ``e`` is drawn with
``np.random.default_rng((seed, e, i))`` whatever the number of workers, so
an epoch's batches repeat. Batches come in index order, as the reference
trains (``train_sceneflow.py:84``). Not copied: the JAX loader's
fork-process workers (``use_processes``), its opt-in shuffle, which no
recipe turns on, and its per-host shards (``shard_index``,
``num_shards``), which come with multi-device training.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


def _collate(samples: list[dict]) -> dict:
    """Stack a list of sample dicts into one batch dict (lists of arrays,
    such as ``disparity_low``, entry by entry)."""
    out: dict = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], list):
            out[key] = [np.stack([v[i] for v in vals])
                        for i in range(len(vals[0]))]
        elif isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        elif isinstance(vals[0], (int, float)):
            out[key] = np.asarray(vals)
        else:
            out[key] = vals  # strings etc.
    return out


class DataLoader:
    """Batches of ``dataset`` (any object with ``__len__`` and ``get(index,
    rng) -> dict``), in index order; ``set_epoch`` picks the epoch whose
    rngs the next iteration uses."""

    def __init__(self, dataset, batch_size: int, *, num_workers: int = 4,
                 drop_last: bool = True, seed: int = 1) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))

    def __iter__(self) -> Iterator[dict]:
        indices = np.arange(len(self.dataset))
        nb = len(self)
        jobs: "queue.Queue" = queue.Queue()
        for bi in range(nb):
            jobs.put((bi, indices[bi * self.batch_size:
                                  (bi + 1) * self.batch_size]))
        results: dict[int, object] = {}
        cond = threading.Condition()
        epoch = self.epoch
        # at most two batches a worker built ahead of the consumer; on an
        # early stop (the loop's max_batches_per_epoch) the workers end
        ahead = threading.Semaphore(2 * self.num_workers)
        stop = threading.Event()

        def worker():
            while True:
                ahead.acquire()
                if stop.is_set():
                    return
                try:
                    bi, batch_idx = jobs.get_nowait()
                except queue.Empty:
                    return
                try:
                    result = _collate([
                        self.dataset.get(int(i), np.random.default_rng(
                            (self.seed, epoch, int(i))))
                        for i in batch_idx])
                except BaseException as e:  # raised in the consumer
                    result = e
                with cond:
                    results[bi] = result
                    cond.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            for bi in range(nb):
                with cond:
                    while bi not in results:
                        cond.wait()
                    batch = results.pop(bi)
                ahead.release()
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
            for _ in threads:
                ahead.release()
