"""The production planes on the card: the integrity fingerprint of card
tensors against its host mirror, and the checkpoint's copy-on-snapshot
against the next captured replay, which rewrites the same buffers in
place.  Marked ``gpu``: each test skips inside itself without a card.
Imports torch and the port only:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_planes_gpu.py -q
"""

import gc

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


def _small_trainer(dev):
    mx.random.seed(3)
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(256, activation="relu", in_units=64),
                nn.Dense(8, in_units=256))
    net.initialize(init=mx.init.Xavier(), ctx=context_of(dev))
    net.hybridize()
    tr = gluon.Trainer(net.collect_params(), "adam",
                       {"learning_rate": 0.01})
    rs = np.random.RandomState(0)
    x = NDArray(torch.tensor(rs.randn(64, 64).astype(np.float32),
                             device=dev), context_of(dev))
    y = NDArray(torch.tensor(rs.randint(0, 8, 64).astype(np.float32),
                             device=dev), context_of(dev))
    return net, tr, gluon.loss.SoftmaxCrossEntropyLoss(), x, y


def test_peer_snapshot_of_card_state_through_the_pinned_copy(tmp_path):
    """A gang snapshot of card tensors (f32 and bf16) goes through the
    checkpointer's pinned copy and writer: the held copy is bitwise the
    state at the call, not the next replay's, and comes back with bf16
    leaves as bf16."""
    from mxnet_tpu_torch import distributed

    dev = _card()
    net, tr, loss_fn, x, y = _small_trainer(dev)
    for _ in range(3):
        tr.train_step(net, loss_fn, x, y)
    extra = torch.randn(1000, device=dev).to(torch.bfloat16)
    state = {"trainer": checkpoint.trainer_state(tr, copy=False),
             "bf16": extra}
    want = {"trainer": checkpoint.trainer_state(tr), "bf16": extra.cpu()}
    store = checkpoint.PeerSnapshotStore(
        0, kv=distributed.FileKV(str(tmp_path / "kv"))).start()
    try:
        ck = checkpoint.AsyncCheckpointer(str(tmp_path / "ck"), rank=0,
                                          world_size=1)
        ck.attach_peers(store, every=1)
        ck.push_peers(7, state, buddy=0)
        tr.train_step(net, loss_fn, x, y)    # rewrites the buffers
        extra.mul_(2)
        ck.wait()
        got = store.own_at(7)
        assert got["bf16"].dtype == torch.bfloat16
        assert torch.equal(got["bf16"].view(torch.int16),
                           want["bf16"].view(torch.int16))
        for a, b in zip(got["trainer"]["params"], want["trainer"]["params"]):
            assert np.array_equal(np.asarray(a), np.asarray(b))
        assert integrity.fingerprint_host(got["trainer"]["opt_state"]) == \
            integrity.fingerprint_host(want["trainer"]["opt_state"])
    finally:
        store.close()


def test_out_of_memory_while_recording_leaves_the_card_clean(monkeypatch):
    """An allocator failure inside the graph recording comes out as
    ``torch.cuda.OutOfMemoryError`` (an autotune trial reads it as an
    infeasible candidate), with no stream left capturing, the current
    stream the default one, the failed graph's pool released; the next
    step records and runs."""
    from mxnet_tpu_torch.gluon import captured

    dev = _card()
    net, tr, loss_fn, x, y = _small_trainer(dev)
    real = captured.CapturedStep._run
    hog = []

    def run_oom(self, *args, **kw):
        out = real(self, *args, **kw)
        if torch.cuda.is_current_stream_capturing():
            hog.append(torch.empty(64 << 20, device=dev))   # in the pool
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")
        return out

    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved(dev)
    monkeypatch.setattr(captured.CapturedStep, "_run", run_oom)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        tr.train_step(net, loss_fn, x, y)
    hog.clear()             # the failed recording's tensors die with it
    gc.collect()
    assert not torch.cuda.is_current_stream_capturing()
    assert torch.cuda.current_stream(dev) == torch.cuda.default_stream(dev)
    step = next(iter(tr._captured_cache.values()))
    assert step._graph is None and step._static is None
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    # the failed recording's pool went back to the card: what stays
    # reserved is what the warm-up made (the optimizer state, cuBLAS's
    # workspaces for the two streams it ran on: 64 MiB on the H100), far
    # below the 256 MiB the recording held
    assert torch.cuda.memory_reserved(dev) - before < (128 << 20)
    monkeypatch.setattr(captured.CapturedStep, "_run", real)
    for _ in range(3):
        loss = tr.train_step(net, loss_fn, x, y)
    assert np.isfinite(loss.asnumpy()).all()
