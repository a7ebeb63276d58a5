"""Prefetching batch loaders.

The port's own copy of ``avsep_tpu/data/loader.py``, which stands in for
the reference's ``torch.utils.data.DataLoader`` + ``ConcatDataset``
(reference ``main.py:633-657``): batches of host numpy arrays are built
while the previous step runs on the device; string fields stay lists.
``iter_forever`` restarts the loader at each epoch's end like
``get_av_ao_batch`` (reference ``main.py:585-598``).  ``DevicePrefetcher``
applies a ship function (the host->device copy) a few batches ahead on a
thread.

This module imports numpy and the standard library, never torch: it is the
forkserver's preload for :class:`ProcessBatchLoader`, whose workers stay
light numpy + PIL processes.  ``ShardDataset`` is the disjoint per-rank
view behind ``--dist_data shard`` (``parallel/distributed.py``).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Sequence

import numpy as np


class ConcatDataset:
    """Concatenation of map-style datasets (torch ConcatDataset shape)."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self.offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self.offsets[-1])

    def __getitem__(self, i: int):
        k = int(np.searchsorted(self.offsets, i, side="right") - 1)
        return self.datasets[k][i - int(self.offsets[k])]


class ShardDataset:
    """Disjoint per-process view of a map-style dataset (``dist_data=
    shard``, parallel/distributed.py): process ``index`` of ``count`` owns
    global samples ``index, index+count, ...``, truncated to ``n // count``
    so every process sees the same length: the ranks stay in lockstep on
    the collective train steps, and a global batch never holds a sample
    twice."""

    def __init__(self, dataset, index: int, count: int):
        if not 0 <= index < count:
            raise ValueError(f"shard {index} of {count}")
        self.dataset = dataset
        self.index = index
        self.count = count

    def __len__(self):
        return len(self.dataset) // self.count

    def __getitem__(self, i: int):
        return self.dataset[self.index + i * self.count]


def collate(samples: List[Dict]) -> Dict:
    """Stack array fields; keep str/object fields as lists."""
    out: Dict = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        else:
            out[key] = vals
    return out


class BatchLoader:
    """Shuffling, prefetching batch iterator over a map-style dataset; the
    samples of a batch are built on a thread pool."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 8, seed: int = 0, drop_last: bool = False,
                 prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self._epoch = 0

    def _index_batches(self) -> List[np.ndarray]:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(idx)
        batches = [idx[i:i + self.batch_size]
                   for i in range(0, n, self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def close(self):
        """Nothing outlives an epoch here; the same API as
        :class:`ProcessBatchLoader`, so callers close either."""

    def __iter__(self) -> Iterator[Dict]:
        batches = self._index_batches()
        self._epoch += 1
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        err_holder = [None]

        def _put(item) -> bool:
            # a bounded put that notices a consumer that broke off
            # mid-epoch: a plain q.put would park this thread forever
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for b in batches:
                    if stop.is_set():
                        return
                    futures = [pool.submit(self.dataset.__getitem__, int(i))
                               for i in b]
                    if not _put(collate([f.result() for f in futures])):
                        return
            except Exception as e:  # raised again in the consumer
                err_holder[0] = e
            finally:
                _put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    if err_holder[0] is not None:
                        raise err_holder[0]
                    break
                yield item
        finally:
            stop.set()
            pool.shutdown(wait=False)


def _proc_worker(dataset, task_q, result_q, cur_epoch):
    """Worker loop: build whole collated batches (no per-sample IPC).
    ``cur_epoch`` holds the consumer's live epoch; tasks of an epoch the
    consumer has abandoned are skipped without doing the work."""
    while True:
        task = task_q.get()
        if task is None:
            return
        epoch, seq, idx = task
        if epoch < cur_epoch.value:
            continue
        try:
            batch = collate([dataset[int(i)] for i in idx])
            result_q.put((epoch, seq, batch, None))
        except Exception as e:  # reported to the consumer
            result_q.put((epoch, seq, None, repr(e)))


class ProcessBatchLoader(BatchLoader):
    """Process-pool batch loader (reference torch DataLoader
    ``num_workers``, main.py:633-657).

    Each worker process builds a full collated batch, free of the main
    process's interpreter lock.  Workers come from a forkserver, started
    once on first use and kept across epochs, whose preload is this module
    alone (forking the main process after CUDA has started can deadlock
    the child).  Like a spawned process, each worker also imports the
    parent's main module by name, so a main module that imports torch at
    its top level puts torch in every worker: ``avsep_tpu_torch.main``
    imports it inside its functions.  Results are tagged (epoch, seq) and
    put back in order, so batch order equals :class:`BatchLoader`'s;
    results of an abandoned epoch are dropped by their tag.
    """

    _procs = None

    def _ensure_workers(self, n_batches: int):
        import multiprocessing as mp

        if self._procs:
            return
        ctx = mp.get_context("forkserver")
        # preload only this torch-free module (the default preloads
        # __main__, which under `python -m avsep_tpu_torch.main` is torch)
        ctx.set_forkserver_preload(["avsep_tpu_torch.data.loader"])
        self._task_q = ctx.Queue()
        # bounded, so an abandoned epoch cannot pile batches up in memory
        self._result_q = ctx.Queue(
            maxsize=2 * (self.num_workers + max(2, self.prefetch)))
        self._cur_epoch = ctx.Value("q", 0)
        self._procs = [
            ctx.Process(target=_proc_worker,
                        args=(self.dataset, self._task_q, self._result_q,
                              self._cur_epoch),
                        daemon=True)
            for _ in range(min(self.num_workers, n_batches))]
        for p in self._procs:
            p.start()

    def close(self):
        if self._procs:
            # mark every queued task stale so workers reach the sentinels
            self._cur_epoch.value = self._epoch + 1
            for _ in self._procs:
                self._task_q.put(None)
            # a worker exits only once its queue's feeder has flushed the
            # batches it put into the pipe: drain them while it winds down
            deadline = time.monotonic() + 5
            for p in self._procs:
                while p.is_alive() and time.monotonic() < deadline:
                    try:
                        while True:
                            self._result_q.get_nowait()
                    except queue.Empty:
                        pass
                    p.join(timeout=0.05)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=5)
            self._procs = None

    def __iter__(self) -> Iterator[Dict]:
        batches = self._index_batches()
        self._epoch += 1
        if not batches:
            return
        self._ensure_workers(len(batches))
        epoch = self._epoch
        self._cur_epoch.value = epoch  # workers drop older-epoch tasks
        ahead = len(self._procs) + max(2, self.prefetch)
        next_submit = 0
        for seq in range(min(ahead, len(batches))):
            self._task_q.put((epoch, seq, batches[seq]))
            next_submit += 1
        pending: Dict[int, Dict] = {}
        for want in range(len(batches)):
            while want not in pending:
                try:
                    ep, seq, batch, err = self._result_q.get(timeout=5.0)
                except queue.Empty:
                    # a worker that died before producing would hang this
                    # get forever: fail loudly instead
                    dead = [p.pid for p in self._procs
                            if not p.is_alive()]
                    if dead:
                        raise RuntimeError(
                            f"loader worker process(es) died: {dead} "
                            "(see their stderr above)")
                    continue
                if ep != epoch:
                    continue  # stale result of an abandoned epoch
                if err is not None:
                    raise RuntimeError(
                        f"loader worker failed on batch {seq}: {err}")
                pending[seq] = batch
            if next_submit < len(batches):
                self._task_q.put((epoch, next_submit,
                                  batches[next_submit]))
                next_submit += 1
            yield pending.pop(want)


class DevicePrefetcher:
    """Overlap the host->device copy with the device's work: a daemon
    thread pulls host batches from ``host_iter`` and applies ``put_fn``
    ``depth`` batches ahead, so the copy of batch i+1 is issued while batch
    i runs."""

    def __init__(self, host_iter, put_fn, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err = None
        self._stop = threading.Event()

        def _put(item) -> bool:
            # bounded put honouring close(): a consumer that abandons the
            # iterator would otherwise park this thread on the full queue,
            # pinning `depth` device batches
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def run():
            try:
                for b in host_iter:
                    if self._stop.is_set():
                        return
                    if not _put(put_fn(b)):
                        return
            except Exception as e:  # raised again in the consumer
                self._err = e
            finally:
                _put(None)

        self._t = threading.Thread(target=run, daemon=True)
        self._t.start()

    def close(self):
        """Release the producer thread and its queued batches.  Idempotent."""
        self._stop.set()
        try:  # unblock a producer parked in q.put
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._t.join(timeout=2.0)

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        item = self._q.get()
        if item is None:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def iter_forever(loader: BatchLoader) -> Iterator[Dict]:
    """Endless iterator with epoch restarts (reference main.py:585-598)."""
    while True:
        yield from loader
