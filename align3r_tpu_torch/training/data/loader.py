"""Batched sampler + data loader.

Behavioural reference: the reference dust3r/datasets/utils/
batched_sampler.py (BatchedRandomSampler:11-74: every batch shares one
aspect-ratio index; epoch+seed-deterministic permutation; rank slicing for
data parallelism) and dust3r/datasets/__init__.py (get_data_loader:20-54).

Port of align3r_tpu/training/data/loader.py: the loader is a lightweight
thread-prefetched iterator yielding numpy-stacked two-view batches, which the
train driver moves to the device. `get_data_loader` takes a dataset object
or a dataset expression (`build_dataset`).
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np


class BatchedRandomSampler:
    """Yields (idx, ar_idx) pairs; consecutive `batch_size` items share
    ar_idx so a batch has one resolution.

    Single-process iteration order is BIT-IDENTICAL to the reference's
    seed-777 contract (batched_sampler.py:39-60). Documented deviation for
    world_size>1: the reference hands each rank a contiguous run of WHOLE
    batches (torch-DDP convention: batch_size is per-GPU); here every rank
    takes a 1/world_size slice of EVERY batch (JAX convention: batch_size
    is the global batch, sharded over the mesh) — the epoch's global sample
    set and per-batch contents are identical, only the rank->item routing
    differs."""

    def __init__(self, dataset, batch_size, num_ar: int, world_size=1, rank=0,
                 drop_last=True):
        if world_size > 1 and not drop_last:
            # a ragged final batch slices unequal per-rank item counts,
            # desynchronizing batch counts across DP ranks (hangs the first
            # collective) — same guard as DataLoader.__init__
            raise ValueError("world_size > 1 requires drop_last=True")
        if world_size > 1 and batch_size % world_size:
            # per = batch_size // world_size would silently drop
            # batch_size % world_size items from EVERY batch on all ranks
            # and desynchronise __len__ from the yielded count (ADVICE r4 #2)
            raise ValueError(
                f"batch_size {batch_size} must be divisible by "
                f"world_size {world_size}")
        self.batch_size = batch_size
        self.num_ar = num_ar
        self.len_dataset = N = len(dataset)
        # round_by(N, batch_size*world_size), matching the reference
        # (batched_sampler.py:26) so the epoch's sample set is identical
        self.total_size = ((N // (batch_size * world_size))
                           * batch_size * world_size if drop_last else N)
        self.world_size = world_size
        self.rank = rank
        self.epoch = None

    def __len__(self):
        return self.total_size // self.world_size

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        if self.epoch is None:
            # reference (batched_sampler.py:41-44): undistributed runs
            # without set_epoch draw a fresh random seed each epoch.
            # A hard raise (not assert, which python -O strips): each rank
            # drawing its own SeedSequence here would silently desynchronise
            # the training data across DP ranks (ADVICE r4 #3)
            if self.world_size != 1 or self.rank != 0:
                raise RuntimeError("use set_epoch() in distributed mode")
            seed = int(np.random.SeedSequence().entropy % (2 ** 63))
        else:
            seed = self.epoch + 777
        rng = np.random.default_rng(seed=seed)
        # shuffle arange(total_size) in place — bit-identical RNG stream to
        # the reference (batched_sampler.py:47-53): items >= total_size are
        # never sampled in a drop_last epoch, and the subsequent
        # aspect-ratio draws consume the same generator state
        idxs = np.arange(self.total_size)
        rng.shuffle(idxs)
        n_batches = (self.total_size + self.batch_size - 1) // self.batch_size
        ar = rng.integers(self.num_ar, size=n_batches)
        per = self.batch_size // self.world_size
        for b in range(n_batches):
            # per-batch chunking (no reshape: the last batch may be ragged
            # when drop_last=False); rank slicing = contiguous per-rank
            # chunk of each batch
            chunk = idxs[b * self.batch_size:(b + 1) * self.batch_size]
            if self.world_size > 1:
                chunk = chunk[self.rank * per:(self.rank + 1) * per]
            for i in chunk:
                yield int(i), int(ar[b])


def collate_views(samples: List[List[Dict]]) -> Dict:
    """List of [view1, view2] -> {'view1': stacked dict, 'view2': ...}."""
    out = {}
    for vi, name in enumerate(("view1", "view2")):
        keys = samples[0][vi].keys()
        view = {}
        for k in keys:
            vals = [s[vi][k] for s in samples]
            if isinstance(vals[0], np.ndarray):
                view[k] = np.stack(vals)
            elif isinstance(vals[0], (int, float, np.integer, np.floating)):
                view[k] = np.asarray(vals)
            else:
                view[k] = vals
        out[name] = view
    return out


class DataLoader:
    """Thread-prefetched loader: iterates sampler indices, fetches dataset
    items in worker threads, collates into numpy batches."""

    def __init__(self, dataset, batch_size: int, *, shuffle=True,
                 num_workers: int = 4, world_size=1, rank=0, drop_last=True,
                 prefetch: int = 4):
        if world_size > 1 and not drop_last:
            # a ragged final batch would slice unequal per-rank chunks,
            # desynchronising batch counts across data-parallel ranks and
            # hanging the first collective of the train step
            raise ValueError("world_size > 1 requires drop_last=True")
        if world_size > 1 and batch_size % world_size:
            # mirror of the sampler guard: per_rank truncation would drop
            # items from every batch silently (ADVICE r4 #2)
            raise ValueError(
                f"batch_size {batch_size} must be divisible by "
                f"world_size {world_size}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.per_rank = batch_size // world_size if world_size > 1 else batch_size
        num_ar = len(getattr(dataset, "resolutions", [0]))
        self.sampler = BatchedRandomSampler(dataset, batch_size, num_ar,
                                            world_size, rank, drop_last) \
            if shuffle else None
        self.num_workers = max(num_workers, 1)
        self.prefetch = prefetch
        self.epoch = 0

    def __len__(self):
        if self.sampler is not None:
            return len(self.sampler) // self.per_rank
        return len(self.dataset) // self.per_rank

    def set_epoch(self, epoch):
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)
        if self.sampler is not None:
            self.sampler.set_epoch(epoch)

    def _index_iter(self):
        if self.sampler is not None:
            yield from self.sampler
        else:
            for i in range(len(self.dataset)):
                yield (i, 0)

    def __iter__(self) -> Iterator[Dict]:
        # items are reassembled in SAMPLER ORDER via sequence numbers: with
        # >=2 workers, arrival order would mix items across batch
        # boundaries, breaking the sampler's one-resolution-per-batch
        # invariant (np.stack of mixed shapes) and desynchronising batch
        # composition across data-parallel ranks
        idx_iter = enumerate(self._index_iter())
        lock = threading.Lock()
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch * self.per_rank)
        stop = object()

        def worker():
            while True:
                with lock:
                    nxt = next(idx_iter, None)
                if nxt is None:
                    out_q.put(stop)
                    return
                seq, idx = nxt
                try:
                    out_q.put((seq, self.dataset[idx]))
                except Exception as e:  # surface in the consumer, don't hang
                    out_q.put(e)
                    out_q.put(stop)
                    return

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()

        done = 0
        buf = []
        pending: Dict[int, object] = {}
        next_seq = 0
        while done < self.num_workers:
            item = out_q.get()
            if item is stop:
                done += 1
                continue
            if isinstance(item, Exception):
                raise item
            pending[item[0]] = item[1]
            while next_seq in pending:
                buf.append(pending.pop(next_seq))
                next_seq += 1
                if len(buf) == self.per_rank:
                    yield collate_views(buf)
                    buf = []
        if buf:  # ragged final batch (drop_last=False)
            yield collate_views(buf)


def get_data_loader(dataset, batch_size, num_workers=4, shuffle=True,
                    drop_last=True, world_size=1, rank=0):
    """Reference-compatible entry (datasets/__init__.py:20-54); `dataset`
    may be a dataset object (len() and [(idx, ar_idx)] -> [view1, view2]
    dicts) or an eval()-style string expression."""
    if isinstance(dataset, str):
        from align3r_tpu_torch.training.data import build_dataset
        dataset = build_dataset(dataset)
    return DataLoader(dataset, batch_size, shuffle=shuffle,
                      num_workers=num_workers, world_size=world_size,
                      rank=rank, drop_last=drop_last)
