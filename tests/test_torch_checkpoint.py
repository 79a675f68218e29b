"""The port's checkpoints (``mxnet_tpu_torch/checkpoint.py``) against the
JAX package's, on the same numpy inputs.

The on-disk layout is shared: a checkpoint the JAX package writes
restores in the port and one the port writes restores in the JAX
package.  bf16 leaves round-trip bitwise; a torn shard and a missing
manifest fall back to the previous step; ``max_to_keep`` holds; a
``gluon.Trainer`` saved and resumed is bitwise equal to an uninterrupted
run, captured or eager; a ``ShardedTrainer`` round-trips; and the JAX
trainer's state loaded into the port trains on within the trainer
tolerances.
"""

import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.checkpoint as jckpt
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import checkpoint, gluon, resilience, telemetry
from mxnet_tpu_torch.context import cpu
from torch_one_thread import one_torch_thread  # noqa: F401

RTOL, ATOL = 2e-4, 2e-5


def _state(seed=0):
    rs = np.random.RandomState(seed)
    return {"params": [rs.randn(4, 3).astype(np.float32),
                       rs.randn(5).astype(np.float32)],
            "opt": (rs.randint(-9, 9, (6,)).astype(np.int64),
                    rs.randint(0, 255, (3, 2)).astype(np.int32)),
            "num_update": 7, "name": "mlp", "lr": 0.5}


def _assert_same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross_the_packages(tmp_path, writer):
    state = _state()
    w, r = (jckpt, checkpoint) if writer == "jax" else (checkpoint, jckpt)
    ck = w.AsyncCheckpointer(str(tmp_path), rank=0, world_size=1)
    ck.save(10, state, data_state={"epoch": 1, "cursor": 4})
    ck.wait()
    rd = r.AsyncCheckpointer(str(tmp_path), rank=0, world_size=1)
    assert rd.latest_step() == 10
    _assert_same(rd.restore(10), state)
    assert rd.data_state(10) == {"epoch": 1, "cursor": 4}
    assert sorted(os.listdir(tmp_path / "step_0000000010")) == [
        "MANIFEST.json", "rank_00000.json", "shard_00000.mxtckpt"]


def test_bf16_round_trip_is_bitwise(tmp_path):
    g = torch.Generator().manual_seed(3)
    w = torch.randn(7, 9, generator=g).to(torch.bfloat16)
    ck = checkpoint.AsyncCheckpointer(str(tmp_path), rank=0, world_size=1)
    ck.save(1, {"w": w, "m": torch.randn(3, generator=g)})
    ck.wait()
    got = ck.restore(1)
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), w.view(torch.int16))
    # the JAX package reads the bf16 leaf as its uint16 words
    words = jckpt.AsyncCheckpointer(str(tmp_path), rank=0,
                                    world_size=1).restore(1)["w"]
    assert words.dtype == np.uint16 and np.array_equal(
        words, w.view(torch.int16).numpy().view(np.uint16))
    # a tensor template places the leaves and checks shape and dtype
    placed = ck.restore(1, template={"w": w, "m": torch.device("cpu")})
    assert torch.equal(placed["w"], w)
    with pytest.raises(tmx.MXNetError):
        ck.restore(1, template={"w": w.float(), "m": None})


def test_torn_shard_and_missing_manifest_fall_back(tmp_path):
    telemetry.reset()
    ck = checkpoint.AsyncCheckpointer(str(tmp_path), rank=0, world_size=1,
                                      max_to_keep=5)
    for step in (1, 2, 3):
        ck.save(step, {"w": np.full(4, step, np.float32)})
    ck.wait()
    shard = tmp_path / "step_0000000003" / "shard_00000.mxtckpt"
    shard.write_bytes(shard.read_bytes()[:-7])       # torn write
    os.remove(tmp_path / "step_0000000002" / "MANIFEST.json")
    assert ck.all_steps() == [1, 3]
    got = {}
    step = resilience.resume_latest(ck, got.update)
    assert step == 1 and got["w"][0] == 1.0
    assert telemetry.event_counts().get("ckpt_fallback") == 1
    # the next save collects the manifest-less orphan
    ck.save(4, {"w": np.zeros(1, np.float32)})
    ck.wait()
    assert not (tmp_path / "step_0000000002").exists()
    telemetry.reset()


def test_max_to_keep_holds(tmp_path):
    ck = checkpoint.AsyncCheckpointer(str(tmp_path), rank=0, world_size=1,
                                      max_to_keep=2)
    for step in range(1, 6):
        ck.save(step, {"w": np.arange(3) + step})
    ck.wait()
    assert ck.all_steps() == [4, 5]
    assert sorted(n for n in os.listdir(tmp_path)
                  if n.startswith("step_")) == ["step_0000000004",
                                                "step_0000000005"]


def _mlp(pkg):
    nn = pkg.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(16, activation="relu", in_units=6))
        net.add(nn.Dense(3, in_units=16))
    return net


def _batches(n=6, seed=9):
    rng = np.random.RandomState(seed)
    return [(rng.standard_normal((8, 6)).astype(np.float32),
             rng.randint(0, 3, 8).astype(np.float32)) for _ in range(n)]


def _port_trainer(seed=7):
    with cpu():
        tmx.random.seed(seed)
        net = _mlp(tmx)
        net.initialize(init=tmx.init.Xavier())
        net.hybridize()
    tr = gluon.Trainer(net.collect_params(), "adam",
                       {"learning_rate": 0.01})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    return net, tr, loss_fn


def _run(net, tr, loss_fn, batches):
    out = []
    with cpu():
        for x, y in batches:
            out.append(tr.train_step(net, loss_fn, tmx.nd.array(x),
                                     tmx.nd.array(y)).asnumpy())
    return out


@pytest.mark.parametrize("captured_on", ["1", "0"])
def test_trainer_resume_is_bitwise(tmp_path, monkeypatch, captured_on):
    """Saved at step 3 and resumed into a fresh trainer, the run is
    bitwise equal to six uninterrupted steps: losses, weights, Adam's
    states and the update counts."""
    monkeypatch.setenv("MXTPU_CAPTURED_STEP", captured_on)
    data = _batches()
    net, tr, loss_fn = _port_trainer()
    want = _run(net, tr, loss_fn, data)
    net1, tr1, _ = _port_trainer()
    _run(net1, tr1, loss_fn, data[:3])
    ck = checkpoint.AsyncCheckpointer(str(tmp_path), rank=0, world_size=1)
    ck.save(3, checkpoint.trainer_state(tr1, copy=False))
    ck.wait()
    net2, tr2, _ = _port_trainer(seed=11)       # other weights
    checkpoint.load_trainer_state(tr2, ck.restore(3))
    got = _run(net2, tr2, loss_fn, data[3:])
    for a, b in zip(got, want[3:]):
        assert np.array_equal(a, b)
    for a, b in zip(checkpoint.trainer_state(tr2)["params"],
                    checkpoint.trainer_state(tr)["params"]):
        assert np.array_equal(a, b)
    s2, s = (checkpoint.trainer_state(t) for t in (tr2, tr))
    _assert_same(s2["opt_state"], s["opt_state"])
    assert s2["num_update"] == s["num_update"] == 6
    assert s2["update_counts"] == s["update_counts"]


def test_sharded_trainer_state_round_trips(tmp_path):
    from mxnet_tpu_torch import parallel

    def make():
        with cpu():
            tmx.random.seed(5)
            net = _mlp(tmx)
            net.initialize(init=tmx.init.Xavier())
        return parallel.ShardedTrainer(
            net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
            {"learning_rate": 0.01})

    data = _batches(4)
    tr = make()
    want = [float(tr.step(torch.from_numpy(x), torch.from_numpy(y)))
            for x, y in data]
    tr1 = make()
    for x, y in data[:2]:
        tr1.step(torch.from_numpy(x), torch.from_numpy(y))
    ck = checkpoint.AsyncCheckpointer(str(tmp_path), rank=0, world_size=1)
    ck.save(2, tr1.state_dict(copy=False))
    ck.wait()
    tr2 = make()
    tr2.step(torch.from_numpy(data[0][0]), torch.from_numpy(data[0][1]))
    tr2.load_state_dict(ck.restore(2, template=tr2.state_template()))
    got = [float(tr2.step(torch.from_numpy(x), torch.from_numpy(y)))
           for x, y in data[2:]]
    assert got == want[2:]


def test_jax_trainer_state_continues_in_the_port(tmp_path):
    """The JAX trainer's state, written by the JAX package after three
    Adam steps, loaded into the port's trainer: three more steps in each
    package agree within the trainer tolerances."""
    data = _batches()
    jmx.random.seed(7)
    jnet = _mlp(jmx)
    jnet.initialize(init=jmx.init.Xavier())
    jnet.hybridize()
    jtr = jmx.gluon.Trainer(jnet.collect_params(), "adam",
                            {"learning_rate": 0.01})
    jloss = jmx.gluon.loss.SoftmaxCrossEntropyLoss()
    for x, y in data[:3]:
        jtr.train_step(jnet, jloss, jmx.nd.array(x), jmx.nd.array(y))
    jck = jckpt.AsyncCheckpointer(str(tmp_path), rank=0, world_size=1)
    jck.save(3, jckpt.trainer_state(jtr))
    jck.wait()
    net, tr, loss_fn = _port_trainer(seed=13)
    checkpoint.load_trainer_state(
        tr, checkpoint.AsyncCheckpointer(str(tmp_path), rank=0,
                                         world_size=1).restore(3))
    jl = [jtr.train_step(jnet, jloss, jmx.nd.array(x),
                         jmx.nd.array(y)).asnumpy() for x, y in data[3:]]
    tl = _run(net, tr, loss_fn, data[3:])
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    jstate = jckpt.trainer_state(jtr)
    for a, b in zip(checkpoint.trainer_state(tr)["params"],
                    jstate["params"]):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    assert tr._optimizer.num_update == jstate["num_update"] == 6
