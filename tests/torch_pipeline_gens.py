"""Generators for the multi-process pipeline tests
(tests/test_torch_train_surface.py).  Worker processes unpickle them, so
this module imports numpy and the standard library only."""

import os
import random

import numpy as np


class CountingGen:
    """Index-stamped batches from one reused buffer: a pipeline that did not
    copy would hand out the last batch's values."""

    def __init__(self, n=7, bs=2):
        self.n, self.batch_size = n, bs
        self.buf = np.zeros((bs, 4, 4, 3), np.float32)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        self.buf[:] = i
        return (self.buf, np.full((self.batch_size, 16, 1), i, np.float32),
                {"pred_mask": np.full((self.batch_size, 16), i, np.float32)})

    def on_epoch_end(self):
        pass


class FailingGen(CountingGen):
    """Batch 1 raises."""

    def __getitem__(self, i):
        if i == 1:
            raise ValueError("corrupt image")
        return super().__getitem__(i)


class DyingGen(CountingGen):
    """The worker serving batch 1 exits without a word."""

    def __getitem__(self, i):
        if i == 1:
            os._exit(3)
        return super().__getitem__(i)


class NoisyGen(CountingGen):
    """Batches drawn from the worker's ``random`` and numpy streams, as an
    augmenting generator draws them."""

    def __getitem__(self, i):
        x = np.random.rand(self.batch_size, 4, 4, 3).astype(np.float32)
        x += random.random()
        return (x, np.full((self.batch_size, 16, 1), i, np.float32),
                {"pred_mask": np.ones((self.batch_size, 16), np.float32)})
