"""Dataset algebra: `N @ dataset` resize, `+` concat, `N * dataset` repeat
(port of align3r_tpu/training/data/easy_dataset.py, numpy only).

The JAX package patches these operators onto its image datasets' base
class (easy_dataset.py:26-32); the port's `BaseStereoViewDataset`
subclasses ``EasyDataset`` instead, as any dataset that takes part in the
algebra does.

Behavioural reference: the reference dust3r/datasets/base/easy_dataset.py
(11-157): epoch-seeded permutations for resized datasets; all combinators
preserve the `(idx, ar_idx)` tuple indexing and `resolutions` attribute.
"""
from __future__ import annotations

import numpy as np


class EasyDataset:
    def __add__(self, other):
        return CatDataset([self, other])

    def __rmul__(self, factor):
        return MulDataset(factor, self)

    def __rmatmul__(self, factor):
        return ResizedDataset(factor, self)

    def set_epoch(self, epoch):
        pass


class MulDataset(EasyDataset):
    """len == multiplicator * len(dataset); idx wraps."""

    def __init__(self, multiplicator, dataset):
        assert multiplicator > 0 and isinstance(multiplicator, int)
        self.multiplicator = multiplicator
        self.dataset = dataset

    def __len__(self):
        return self.multiplicator * len(self.dataset)

    def __getitem__(self, idx):
        if isinstance(idx, tuple):
            idx, other = idx
            return self.dataset[idx // self.multiplicator, other]
        return self.dataset[idx // self.multiplicator]

    @property
    def resolutions(self):
        return self.dataset.resolutions

    def set_epoch(self, epoch):
        self.dataset.set_epoch(epoch)


class ResizedDataset(EasyDataset):
    """len == new_size; samples via an epoch-seeded random permutation."""

    def __init__(self, new_size, dataset):
        assert new_size > 0 and isinstance(new_size, int)
        self.new_size = new_size
        self.dataset = dataset
        self._idxs = None

    def __len__(self):
        return self.new_size

    def set_epoch(self, epoch):
        rng = np.random.default_rng(seed=777 + epoch)
        n_repeats = 1 + (self.new_size - 1) // len(self.dataset)
        # ONE permutation tiled (not fresh draws per repeat) — matches the
        # reference's exact data order under the seed-777 contract
        # (easy_dataset.py:89-99)
        perm = rng.permutation(len(self.dataset))
        self._idxs = np.concatenate([perm] * n_repeats)[: self.new_size]
        self.dataset.set_epoch(epoch)

    def __getitem__(self, idx):
        assert self._idxs is not None, "call set_epoch(epoch) first"
        if isinstance(idx, tuple):
            idx, other = idx
            return self.dataset[self._idxs[idx], other]
        return self.dataset[self._idxs[idx]]

    @property
    def resolutions(self):
        return self.dataset.resolutions


class CatDataset(EasyDataset):
    def __init__(self, datasets):
        flat = []
        for d in datasets:
            flat += d.datasets if isinstance(d, CatDataset) else [d]
        self.datasets = flat
        self._cum = np.cumsum([len(d) for d in flat])

    def __len__(self):
        return int(self._cum[-1])

    def set_epoch(self, epoch):
        for d in self.datasets:
            d.set_epoch(epoch)
        self._cum = np.cumsum([len(d) for d in self.datasets])

    def __getitem__(self, idx):
        other = None
        if isinstance(idx, tuple):
            idx, other = idx
        di = int(np.searchsorted(self._cum, idx, side="right"))
        local = idx - (0 if di == 0 else int(self._cum[di - 1]))
        d = self.datasets[di]
        return d[local] if other is None else d[local, other]

    @property
    def resolutions(self):
        r = self.datasets[0].resolutions
        for d in self.datasets[1:]:
            assert d.resolutions == r, "concatenated datasets must share resolutions"
        return r
