"""gluon.contrib.data (counterpart of ``mxnet_tpu/gluon/contrib/data/``;
reference: python/mxnet/gluon/contrib/data/).

The reference ships text corpora (WikiText2/103) that download at use
time; `text.CharTokenDataset` covers the same role over local files or
strings.  The sampler utilities are full parity.
"""

from . import sampler
from . import text
from .sampler import IntervalSampler
from .text import CharTokenDataset
