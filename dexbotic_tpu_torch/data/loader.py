"""Prefetching data loader: thread or process item fetch + device buffering
(port of dexbotic_tpu/data/loader.py).

Host decode in worker pools, so that it overlaps the device's step:

* ``worker_mode='thread'``: a ThreadPoolExecutor fetching items; enough when
  the per-item work is C code that releases the GIL (PIL, cv2, numpy).
* ``worker_mode='process'``: forked worker processes, each taking
  (batch_id, indices) tasks and returning collated numpy batches, with an
  ordered reassembly buffer in the parent; a worker's error is raised in the
  parent.  Fork start only: the dataset is inherited by memory image, never
  pickled.  The workers run the dataset and the collator, which are numpy
  code: they must not touch CUDA.  Forked workers inherit the parent's global
  ``random`` state, so draws made from it (augmentation, the redrawn last
  frame of an episode) differ from the in-line path's, as in the JAX package.

Both modes yield the batches of the in-line ``exp/base_exp.data_iterator``
on the same seed, in the same order.  ``process_id`` / ``process_count``
slice every global batch into this process's contiguous rows.

:func:`device_prefetch` moves batches onto the device two steps ahead:
on CUDA, pinned host tensors copied on a side stream, the consumer's stream
waiting on each batch's event; on the CPU, a plain copy.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator

import numpy as np
import torch


def _process_worker(dataset, collate_fn, task_q, result_q):
    while True:
        task = task_q.get()
        if task is None:
            return
        batch_id, idxs = task
        try:
            result_q.put((batch_id, collate_fn([dataset[i] for i in idxs]), None))
        except Exception as e:  # noqa: BLE001 (raised in the parent)
            result_q.put((batch_id, None, repr(e)))


PREFETCH_BATCHES = 2  # batches decoded ahead of the consumer, beyond one a worker


class DataLoader:
    """Endless shuffled epoch iterator with parallel item fetch and collation;
    an epoch's last partial batch is dropped, as in line."""

    def __init__(self, dataset, collate_fn: Callable, batch_size: int, shuffle: bool = True,
                 num_workers: int = 8, seed: int = 42, worker_mode: str = "thread",
                 process_id: int = 0, process_count: int = 1):
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"worker_mode {worker_mode!r}: 'thread' or 'process'")
        if batch_size % process_count:
            raise ValueError(f"batch_size {batch_size} not divisible by {process_count} processes")
        self.dataset = dataset
        self.collate_fn = collate_fn
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.worker_mode = worker_mode
        self.process_id = process_id
        self.process_count = process_count

    def __len__(self) -> int:
        """Global batches an epoch."""
        return len(self.dataset) // self.batch_size

    def _index_stream(self) -> Iterator[list[int]]:
        """This process's rows of each global batch."""
        rng = random.Random(self.seed)
        local = self.batch_size // self.process_count
        lo, hi = self.process_id * local, (self.process_id + 1) * local
        n = len(self.dataset)
        while True:
            order = list(range(n))
            if self.shuffle:
                rng.shuffle(order)
            for s in range(0, n - n % self.batch_size, self.batch_size):
                yield order[s + lo: s + hi]

    def __iter__(self):
        if self.worker_mode == "process":
            yield from self._iter_process()
        else:
            yield from self._iter_thread()

    def _iter_thread(self):
        with ThreadPoolExecutor(self.num_workers) as pool:
            pending: queue.Queue = queue.Queue()
            idx_stream = self._index_stream()

            def submit_next():
                idxs = next(idx_stream, None)
                return None if idxs is None else [pool.submit(self.dataset.__getitem__, i)
                                                  for i in idxs]

            for _ in range(PREFETCH_BATCHES):
                futures = submit_next()
                if futures is not None:
                    pending.put(futures)
            while not pending.empty():
                futures = pending.get()
                batch = self.collate_fn([f.result() for f in futures])
                nxt = submit_next()
                if nxt is not None:
                    pending.put(nxt)
                yield batch

    def _iter_process(self):
        ctx = mp.get_context("fork")
        task_q, result_q = ctx.SimpleQueue(), ctx.SimpleQueue()
        workers = [ctx.Process(target=_process_worker,
                               args=(self.dataset, self.collate_fn, task_q, result_q),
                               daemon=True) for _ in range(self.num_workers)]
        for w in workers:
            w.start()
        idx_stream = self._index_stream()
        next_submit = next_yield = 0  # the next batch to dispatch / owed to the consumer
        reorder: dict = {}
        exhausted = False
        in_flight = self.num_workers + PREFETCH_BATCHES  # a task a worker + the margin
        try:
            while True:
                while not exhausted and next_submit - next_yield < in_flight:
                    idxs = next(idx_stream, None)
                    if idxs is None:
                        exhausted = True
                        break
                    task_q.put((next_submit, idxs))
                    next_submit += 1
                if next_yield >= next_submit:
                    return
                while next_yield not in reorder:
                    batch_id, batch, err = result_q.get()
                    reorder[batch_id] = (batch, err)
                # a worker's error is raised in batch order, after every batch before it
                batch, err = reorder.pop(next_yield)
                if err is not None:
                    raise RuntimeError(f"loader worker failed: {err}")
                yield batch
                next_yield += 1
        finally:
            # the batches still in flight are discarded: a worker blocked on
            # putting one (larger than the pipe holds) would never read a stop
            # sentinel, so every worker is stopped at once
            for w in workers:
                w.terminate()
            for w in workers:
                w.join()
            task_q.close()
            result_q.close()


def device_prefetch(iterator, device):
    """Yield each batch's numpy arrays as tensors on ``device``,
    PREFETCH_BATCHES batches ahead of the consumer (a producer thread).  On CUDA the copies
    run from pinned memory on a side stream; the consumer's current stream
    waits on the batch's event before it reads.  An error in the producer is
    raised in the consumer.  Closing this generator stops the producer, which
    then closes ``iterator`` (a process-mode loader stops its workers)."""
    device = torch.device(device)
    q: queue.Queue = queue.Queue(maxsize=PREFETCH_BATCHES)
    stop = threading.Event()
    done = object()
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for batch in iterator:
                arrays = {k: torch.from_numpy(v) for k, v in batch.items()
                          if isinstance(v, np.ndarray)}
                if stream is None:
                    item = ({k: v.to(device) for k, v in arrays.items()}, None)
                else:
                    with torch.cuda.stream(stream):
                        out = {k: v.pin_memory().to(device, non_blocking=True)
                               for k, v in arrays.items()}
                        event = torch.cuda.Event()
                        event.record(stream)
                    item = (out, event)
                if not put(item):
                    break
            else:
                put(done)
        except BaseException as e:  # noqa: BLE001 (raised in the consumer)
            put(e)
        finally:
            close = getattr(iterator, "close", None)
            if close is not None:
                close()

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            out, event = item
            if event is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(event)
                for t in out.values():  # the side stream's memory is now the consumer's
                    t.record_stream(current)
            yield out
    finally:
        stop.set()
        thread.join()
