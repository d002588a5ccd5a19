"""Host-side data loader: worker threads or forked worker processes.

The port's own copy of ``esmstereo_tpu/data/loader.py``: workers build
batches on the host while the previous one is on the device (the training
loop copies each batch to the card one step ahead,
``train.loop.device_batches``). Sample ``i`` of epoch ``e`` is drawn with
``np.random.default_rng((seed, e, i))`` whatever the number or kind of
workers, so threads and processes give the same batches and an epoch's
batches repeat. Batches come in index order (the reference trains with
``shuffle=False``, ``train_sceneflow.py:84``) unless ``shuffle`` draws an
order per epoch; ``shard_index`` / ``num_shards`` keep every
``num_shards``-th index of that order, one host's share.

``use_processes`` forks the workers (the reference's torch loader, and
the JAX CLIs' default): decoding and augmenting in numpy holds the
interpreter lock long enough that threads barely overlap. A child builds
numpy batches only and sends them back through a pipe; it never touches
``torch.cuda``, so it may be forked after the model is on the card. A
worker's exception is raised in the consumer.
"""

from __future__ import annotations

import gc
import multiprocessing as mp
import pickle
import queue
import threading
import traceback
from typing import Iterator

import numpy as np

# seconds between liveness checks of the worker processes while waiting
_POLL_S = 5.0


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
    rng) -> dict``); ``set_epoch`` picks the epoch whose order and rngs
    the next iteration uses."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = False,
                 num_workers: int = 4, drop_last: bool = True, seed: int = 1,
                 shard_index: int = 0, num_shards: int = 1,
                 use_processes: bool = False) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.seed = seed
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.use_processes = use_processes
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, self.epoch)).shuffle(idx)
        return idx[self.shard_index::self.num_shards]

    def __len__(self) -> int:
        n = len(self._indices())
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))

    def _batches(self) -> list[np.ndarray]:
        idx = self._indices()
        return [idx[b * self.batch_size:(b + 1) * self.batch_size]
                for b in range(len(self))]

    def _build(self, batch_idx, epoch: int) -> dict:
        return _collate([
            self.dataset.get(int(i), np.random.default_rng(
                (self.seed, epoch, int(i))))
            for i in batch_idx])

    def __iter__(self) -> Iterator[dict]:
        if self.use_processes:
            return self._iter_processes(self._batches(), self.epoch)
        return self._iter_threads(self._batches(), self.epoch)

    def _iter_threads(self, batches, epoch: int) -> Iterator[dict]:
        nb = len(batches)
        jobs: "queue.Queue" = queue.Queue()
        for bi, b in enumerate(batches):
            jobs.put((bi, b))
        results: dict[int, object] = {}
        cond = threading.Condition()
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
                    result = self._build(batch_idx, epoch)
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

    def _iter_processes(self, batches, epoch: int) -> Iterator[dict]:
        """Forked workers, worker ``w`` building batches ``w``, ``w + n``,
        ... into a queue of its own that holds two, read in order. The
        child inherits the batch list (no job queue to drain) and sends
        each result, or its exception, pickled."""
        ctx = mp.get_context("fork")
        n = min(self.num_workers, max(len(batches), 1))
        queues = [ctx.Queue(maxsize=2) for _ in range(n)]

        def worker(w: int):
            for bi in range(w, len(batches), n):
                try:
                    result = self._build(batches[bi], epoch)
                except BaseException as e:
                    e.add_note(f"in loader worker process {w}, batch {bi}:\n"
                               + traceback.format_exc())
                    try:
                        pickle.dumps(e)
                    except Exception:  # an exception pickle cannot send
                        e = RuntimeError(f"{e!r}\n{traceback.format_exc()}")
                    result = e
                queues[w].put(result)
                if isinstance(result, BaseException):
                    return

        procs = [ctx.Process(target=worker, args=(w,), daemon=True)
                 for w in range(n)]
        # the children inherit the parent's objects, CUDA tensors among
        # them; frozen, the garbage collector of a child never frees one
        # (a free can call into CUDA, which a forked child may not)
        gc.freeze()
        try:
            for p in procs:
                p.start()
        finally:
            gc.unfreeze()
        try:
            for bi in range(len(batches)):
                w = bi % n
                while True:
                    try:
                        got = queues[w].get(timeout=_POLL_S)
                        break
                    except queue.Empty:
                        if procs[w].is_alive():
                            continue
                        try:  # its last put may land just after it exits
                            got = queues[w].get(timeout=1.0)
                            break
                        except queue.Empty:
                            raise RuntimeError(
                                f"loader worker process {w} died (exit code "
                                f"{procs[w].exitcode}) before batch {bi}; "
                                "see its stderr") from None
                if isinstance(got, BaseException):
                    raise got
                yield got
        finally:
            for p in procs:
                p.terminate()
            for p in procs:
                p.join()
            for q in queues:
                q.close()
                q.cancel_join_thread()
