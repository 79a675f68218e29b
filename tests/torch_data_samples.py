"""Picklable datasets and batchify functions for the DataLoader tests of
the port (``test_torch_data.py``): numpy only, so a spawned worker that
unpickles them imports nothing else of the test."""

import numpy as np


class FailingDataset:
    """A dataset whose index ``bad`` raises."""

    def __init__(self, n=16, bad=13):
        self._n = n
        self._bad = bad

    def __len__(self):
        return self._n

    def __getitem__(self, i):
        if i == self._bad:
            raise ValueError(f"poisoned sample {i}")
        return np.full(3, i, np.float32)


class PairDataset:
    """(float32 row, uint8 image, int64 label) samples from a seed."""

    def __init__(self, n=37, seed=0):
        rng = np.random.RandomState(seed)
        self._x = rng.rand(n, 4).astype(np.float32)
        self._img = rng.randint(0, 256, (n, 5, 6, 3)).astype(np.uint8)
        self._y = np.arange(n, dtype=np.int64)

    def __len__(self):
        return len(self._y)

    def __getitem__(self, i):
        return self._x[i], self._img[i], self._y[i]


def sum_batchify(samples):
    """A custom batchify: one float32 per sample."""
    return np.asarray([float(np.sum(s[0])) for s in samples], np.float32)
