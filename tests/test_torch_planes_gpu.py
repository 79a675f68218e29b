"""The production planes on the card: the integrity fingerprint of card
tensors against its host mirror, and the checkpoint's copy-on-snapshot
against the next captured replay, which rewrites the same buffers in
place.  Marked ``gpu``: each test skips inside itself without a card.
Imports torch and the port only:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_planes_gpu.py -q
"""

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import checkpoint, gluon, integrity
from mxnet_tpu_torch.context import context_of
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.ndarray.ndarray import NDArray

pytestmark = pytest.mark.gpu


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_fingerprint_equals_the_host_mirror(dtype):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(0)
    leaves = [torch.randn(n, device=dev, generator=g).to(dtype)
              for n in (5, 1 << 12, 3 * (1 << 20) + 7)]
    leaves.append(torch.arange(11, device=dev))          # int64 words
    fp = integrity.fingerprint_arrays(leaves, chunk=1 << 20)
    assert fp.device == dev
    host = integrity.fingerprint_host([t.cpu() for t in leaves])
    assert integrity.combine(fp) == host
    integrity._flip_bit(leaves[1])
    assert integrity.combine(integrity.fingerprint_arrays(leaves)) != host


def test_snapshot_survives_the_next_captured_replay(tmp_path):
    dev = _card()
    mx.random.seed(3)
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(256, activation="relu", in_units=64),
                nn.Dense(8, in_units=256))
    net.initialize(init=mx.init.Xavier(), ctx=context_of(dev))
    net.hybridize()
    tr = gluon.Trainer(net.collect_params(), "adam",
                       {"learning_rate": 0.01})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    rs = np.random.RandomState(0)
    x = NDArray(torch.tensor(rs.randn(64, 64).astype(np.float32),
                             device=dev), context_of(dev))
    y = NDArray(torch.tensor(rs.randint(0, 8, 64).astype(np.float32),
                             device=dev), context_of(dev))
    for _ in range(3):                   # records the graph, then replays
        tr.train_step(net, loss_fn, x, y)
    want = checkpoint.trainer_state(tr)                  # host copy
    ck = checkpoint.AsyncCheckpointer(str(tmp_path), rank=0, world_size=1)
    ck.save(3, checkpoint.trainer_state(tr, copy=False))
    tr.train_step(net, loss_fn, x, y)    # rewrites the buffers in place
    ck.wait()
    got = ck.restore(3)
    after = checkpoint.trainer_state(tr)
    for a, b, c in zip(got["params"], want["params"], after["params"]):
        assert np.array_equal(a, b)
        assert not np.array_equal(a, c)
    assert integrity.fingerprint_host(got["opt_state"]) == \
        integrity.fingerprint_host(want["opt_state"])
