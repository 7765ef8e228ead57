"""Host-side input pipeline (counterpart of
``speech_enhancement_by_s3prl_tpu/data/loader.py``): a threaded loader with
bucket padding and per-item seeds, and the copy of batches to the device.

Requests and batches are padded to a duration bucket, so a bounded set of
shapes reaches the device. Decoding and mixing run on host threads (numpy
releases the interpreter lock), with a bounded number of finished batches
waiting, so device steps overlap host work.
"""
from __future__ import annotations

import collections
import queue
import random
import threading
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch


def bucket_length(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (falls back to the largest bucket)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def default_buckets(sample_rate: int = 16000, max_time_ms: int = 10000) -> List[int]:
    """Duration buckets in samples: 1s, 2s, 4s, 6s, 8s, max."""
    secs = [1, 2, 4, 6, 8]
    out = [s * sample_rate for s in secs if s * 1000 < max_time_ms]
    out.append(sample_rate * max_time_ms // 1000)
    return out


class DataLoader:
    """Iterable over collated batches with optional shuffling, threaded
    prefetch, and bucket padding.

    Yields whatever ``dataset.collate_fn`` returns: (lengths, wavs) or
    (lengths, wavs, cases) with wavs (B, C, T_bucket), as numpy arrays.
    The data stream is the same for any worker count and thread schedule:
    one base seed per epoch is drawn from the global random module in the
    calling thread, and each item gets its own stream derived from it.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        num_workers: int = 2,
        drop_last: bool = False,
        buckets: Optional[Sequence[int]] = None,
        prefetch: int = 4,
        seed: Optional[int] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.buckets = list(buckets) if buckets is not None else None
        self.prefetch = prefetch
        self.seed = seed
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _batch_indices(self) -> List[List[int]]:
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            # no explicit seed: draw one from the global random module, so
            # reseeding it (as evaluation does) governs batch order too
            seed = (
                random.getrandbits(63) if self.seed is None
                else self.seed + self._epoch
            )
            random.Random(seed).shuffle(idx)
        batches = [
            idx[i : i + self.batch_size] for i in range(0, len(idx), self.batch_size)
        ]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def _collate(self, samples):
        if self.buckets is None:
            return self.dataset.collate_fn(samples)
        wavs = [s[0] if isinstance(s, tuple) else s for s in samples]
        max_len = max(w.shape[0] for w in wavs)
        pad_to = bucket_length(max_len, self.buckets)
        return self.dataset.collate_fn(samples, pad_to=pad_to)

    def __iter__(self) -> Iterator:
        batches = self._batch_indices()
        self._epoch += 1
        from .datasets import set_item_seed

        base = random.getrandbits(63)
        pos = 0
        seeds: List[List[int]] = []
        for b in batches:
            seeds.append([(base + 0x9E3779B97F4A7C15 * (pos + k)) % 2**63
                          for k in range(len(b))])
            pos += len(b)

        def fetch(i, b):
            items = []
            for j, s in zip(b, seeds[i]):
                set_item_seed(s)
                try:
                    items.append(self.dataset[j])
                finally:
                    set_item_seed(None)
            return self._collate(items)

        if self.num_workers <= 1 or len(batches) <= 1:
            for i, b in enumerate(batches):
                yield fetch(i, b)
            return

        results = {}
        results_lock = threading.Condition()
        task_q: "queue.Queue" = queue.Queue()
        for i, b in enumerate(batches):
            task_q.put((i, b))
        stop = threading.Event()
        # finished but unconsumed batches are capped at `prefetch`: a worker
        # that stored a result waits for the consumer before taking another
        # task. The batch the consumer waits on is always already in flight
        # (tasks are taken in order), so this cannot deadlock.
        cap = max(1, self.prefetch)

        def worker():
            while not stop.is_set():
                try:
                    i, b = task_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    batch = fetch(i, b)
                    err = None
                except Exception as e:  # raised again in the consumer
                    batch, err = None, e
                with results_lock:
                    results[i] = (batch, err)
                    results_lock.notify_all()
                    while len(results) >= cap and not stop.is_set():
                        results_lock.wait(timeout=1.0)

        threads = [
            threading.Thread(target=worker, daemon=True)
            for _ in range(self.num_workers)
        ]
        for t in threads:
            t.start()

        try:
            for i in range(len(batches)):
                with results_lock:
                    while i not in results:
                        results_lock.wait(timeout=60.0)
                        if i not in results and not any(t.is_alive() for t in threads):
                            raise RuntimeError("all loader workers died")
                    batch, err = results.pop(i)
                    results_lock.notify_all()  # wake workers gated on `cap`
                if err is not None:
                    raise err
                yield batch
        finally:
            stop.set()
            with results_lock:
                results_lock.notify_all()
            for t in threads:
                t.join(timeout=60.0)


def device_prefetch(iterator, device, size: int = 2):
    """Batches of numpy arrays -> tuples of tensors on ``device``, ``size``
    batches ahead of the consumer. To a CUDA device the arrays go through
    pinned host memory on a copy stream of their own, so the copies overlap
    the device's work on the current batch; before a batch is yielded the
    consumer's current stream is made to wait for that batch's copies, and
    the tensors are recorded on it, so their memory is not reused while the
    consumer's kernels still read them. To the CPU nothing is copied."""
    device = torch.device(device)
    pin = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if pin else None

    def put(batch):
        """(tensors, the event that marks their copies done or None)."""
        if not pin:
            return tuple(torch.from_numpy(x) if isinstance(x, np.ndarray) else x
                         for x in batch), None
        with torch.cuda.stream(copy_stream):
            out = tuple(
                torch.from_numpy(x).pin_memory().to(device, non_blocking=True)
                if isinstance(x, np.ndarray) else x for x in batch)
            done = torch.cuda.Event()
            done.record(copy_stream)
        return out, done

    def take(entry):
        batch, done = entry
        if done is not None:
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(done)
            for x in batch:
                if isinstance(x, torch.Tensor) and x.is_cuda:
                    x.record_stream(consumer)
        return batch

    ahead = collections.deque()
    it = iter(iterator)
    for batch in it:
        ahead.append(put(batch))
        if len(ahead) >= size:
            break
    while ahead:
        batch = take(ahead.popleft())
        nxt = next(it, None)
        if nxt is not None:
            ahead.append(put(nxt))
        yield batch


def infinite_iterator(loader: DataLoader):
    """A loader's batches, restarted at every exhaustion."""
    while True:
        for batch in loader:
            yield batch
