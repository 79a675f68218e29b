"""Language-model datasets over local text.

Counterpart of ``mxnet_tpu/gluon/contrib/data/text.py`` (reference:
gluon/contrib/data/text.py — WikiText2/WikiText103).  The reference
datasets download their corpora at construction time; this one provides
the same Dataset contract over a LOCAL file or string: a vocabulary
built from the data, (seq_len,) int32 windows, the ``seq_len``-strided
layout the reference's batchify produces.  Nothing downloads.
"""

from __future__ import annotations

import numpy as _np

from ...data.dataset import Dataset


class CharTokenDataset(Dataset):
    """Character-tokenized LM dataset: every item is (input_window,
    target_window) of ``seq_len`` int32 codes, windows strided by
    ``seq_len`` (non-overlapping, like the reference's bptt batchify).

    ``source`` is a path to a UTF-8 text file, or the text itself."""

    def __init__(self, source, seq_len=64, vocab=None):
        import os

        if isinstance(source, str) and os.path.exists(source):
            with open(source, encoding="utf-8") as f:
                text = f.read()
        elif isinstance(source, str) and (os.sep in source
                                          or source.endswith(".txt")):
            # looks like a path but doesn't exist: fail loudly (the
            # reference datasets do) instead of training on the path
            # string as a corpus
            raise FileNotFoundError(
                f"CharTokenDataset: no such file {source!r} (to pass "
                f"literal text containing '/', read the file yourself)")
        else:
            text = source
        if vocab is None:
            vocab = {c: i for i, c in enumerate(sorted(set(text)))}
        self.vocab = vocab
        self.inv_vocab = {i: c for c, i in vocab.items()}
        codes = _np.asarray([vocab[c] for c in text if c in vocab],
                            _np.int32)
        self._seq_len = int(seq_len)
        n = (len(codes) - 1) // self._seq_len
        if n <= 0:
            raise ValueError(
                f"text too short ({len(codes)} tokens) for "
                f"seq_len={seq_len}")
        usable = n * self._seq_len
        self._x = codes[:usable].reshape(n, self._seq_len)
        self._y = codes[1:usable + 1].reshape(n, self._seq_len)

    def __len__(self):
        return self._x.shape[0]

    def __getitem__(self, idx):
        return self._x[idx], self._y[idx]
