"""The port's integrity plane (``mxnet_tpu_torch/integrity.py``) against
the JAX package's, on the same numpy inputs.

The fingerprint of every dtype (f32, bf16, f16, int8, bool, int64, f64)
in a nested tree with a ``None`` equals the reference's
``fingerprint_host`` bitwise, through the port's host mirror and its
tensor path, with a large leaf run in chunks; a single flipped bit
changes it.  The ledger chains as the reference's does, and the
``IntegrityPlane`` vote over a ``FileKV`` with two ranks on threads names
the rank whose state took a bit flip.  The captured step's attestation
reads the same fingerprint as the host mirror of the trainer's state.
"""

import threading

import numpy as np
import pytest
import torch

import mxnet_tpu.integrity as jinteg
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import distributed, gluon, integrity, resilience, \
    telemetry
from mxnet_tpu_torch.context import context_of
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.ndarray.ndarray import NDArray
from torch_one_thread import one_torch_thread  # noqa: F401


@pytest.fixture
def faults(monkeypatch):
    def arm(spec):
        monkeypatch.setenv("MXTPU_FAULT_INJECT", spec)
        resilience.reset_faults()

    yield arm
    monkeypatch.delenv("MXTPU_FAULT_INJECT", raising=False)
    resilience.reset_faults()


def _tree(seed=0):
    """Every dtype the fingerprint maps, nested, with a None; bf16 as a
    tensor (the reference sees its 16-bit words)."""
    rs = np.random.RandomState(seed)
    bf16 = torch.from_numpy(rs.randn(3, 33).astype(np.float32)) \
        .to(torch.bfloat16)
    return {
        "w": [rs.randn(7, 5).astype(np.float32), None,
              rs.randint(-128, 128, (19,)).astype(np.int8)],
        "b": (rs.randn(40).astype(np.float16), rs.rand(13) > 0.5),
        "a": {"i64": rs.randint(-2 ** 40, 2 ** 40, (11,)).astype(np.int64),
              "f64": rs.randn(6).astype(np.float64)},
        "big": rs.randn(1000).astype(np.float32),
        "h": bf16,
    }


def _as_reference(tree):
    """The same leaves for the reference: bf16 as its uint16 words."""
    if isinstance(tree, dict):
        return {k: _as_reference(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_reference(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.view(torch.int16).numpy().view(np.uint16)
    return tree


@pytest.mark.parametrize("chunk", [None, 97])
def test_fingerprint_equals_the_reference_bitwise(chunk):
    tree = _tree()
    want = jinteg.fingerprint_host(_as_reference(tree))
    assert integrity.fingerprint_host(tree, chunk=chunk) == want
    assert integrity.combine(
        integrity.fingerprint_pytree(tree, chunk=chunk)) == want
    # the leaves as tensors (the captured step's path)
    tensors = [torch.from_numpy(np.ascontiguousarray(a))
               if isinstance(a, np.ndarray) else a
               for a in integrity._leaves(tree)]
    assert integrity.combine(integrity.fingerprint_arrays(
        tensors, chunk=chunk)) == want


def test_fingerprint_equals_the_reference_device_reduction():
    """The reference's jitted reduction (``combine(fingerprint_arrays)``)
    on 4-, 2- and 1-byte leaves agrees with the port's."""
    import jax.numpy as jnp

    rs = np.random.RandomState(1)
    leaves = [rs.randn(300).astype(np.float32),
              rs.randn(21).astype(np.float16),
              rs.randint(-5, 5, (9,)).astype(np.int8),
              rs.rand(4) > 0.5]
    want = jinteg.combine(np.asarray(jinteg.fingerprint_arrays(
        [jnp.asarray(a) for a in leaves])))
    assert integrity.combine(integrity.fingerprint_arrays(
        [torch.from_numpy(a) for a in leaves], chunk=64)) == want
    assert integrity.fingerprint_host(leaves) == want


def test_one_flipped_bit_changes_the_fingerprint():
    tree = _tree()
    base = integrity.fingerprint_host(tree)
    flipped = _tree()
    integrity._flip_bit(flipped["h"])
    assert integrity.fingerprint_host(flipped) != base
    flipped = _tree()
    integrity.bit_flip_host(flipped["big"])
    assert integrity.fingerprint_host(flipped) != base
    t = torch.from_numpy(_tree()["big"])
    integrity._flip_bit(t)
    assert np.array_equal(t.numpy(), flipped["big"])


def test_ledger_chains_like_the_reference(tmp_path):
    mine = integrity.IntegrityLedger(str(tmp_path / "p.jsonl"))
    ref = jinteg.IntegrityLedger(str(tmp_path / "j.jsonl"))
    for step in (50, 100):
        mine.append(step, 0xDEADBEEF + step, rank=1, epoch=2, run="r")
        ref.append(step, 0xDEADBEEF + step, rank=1, epoch=2, run="r")
    assert mine.verify_chain() == (True, None)
    assert ref.verify_chain() == (True, None)
    for a, b in zip(mine.entries(), ref.entries()):
        body = {k: v for k, v in a.items() if k not in ("hash", "prev", "t")}
        assert body == {k: v for k, v in b.items()
                        if k not in ("hash", "prev", "t")}
        assert a["hash"] == jinteg.IntegrityLedger._entry_hash(
            a["prev"], {k: v for k, v in a.items() if k != "hash"})
    # the reference verifies the port's ledger
    assert jinteg.IntegrityLedger(mine.path).verify_chain() == (True, None)
    lines = open(mine.path).read().splitlines()
    lines[0] = lines[0].replace('"step":50', '"step":51')
    open(mine.path, "w").write("\n".join(lines) + "\n")
    assert integrity.IntegrityLedger(mine.path).verify_chain()[0] is False


def test_two_rank_vote_over_filekv_catches_a_bit_flip(tmp_path):
    telemetry.reset()
    kv = distributed.FileKV(str(tmp_path / "gang"))
    planes = [integrity.IntegrityPlane(rank=r, world=2, kv=kv, every=1,
                                       timeout=5.0)
              for r in range(2)]
    w = np.arange(64, dtype=np.float32) / 3.0
    verdicts = [None, None]

    def rank(r, state, step):
        verdicts[r] = planes[r].attest(step,
                                       integrity.fingerprint_host(state))

    def vote(states, step=7):
        th = [threading.Thread(target=rank, args=(r, s, step))
              for r, s in enumerate(states)]
        for t in th:
            t.start()
        for t in th:
            t.join(30)

    vote([{"w": w.copy()}, {"w": w.copy()}])
    assert verdicts[0]["ok"] and verdicts[1]["ok"]
    bad = w.copy()
    integrity.bit_flip_host(bad)
    planes[0].epoch = planes[1].epoch = 1
    vote([{"w": w.copy()}, {"w": bad}])
    # two voters, two values: a tie, which names nobody
    assert not verdicts[0]["ok"] and verdicts[0]["tie"]
    assert verdicts[0]["votes"] == verdicts[1]["votes"]
    # with a third, healthy replica's published vote the flipped rank
    # is named
    third = integrity.IntegrityPlane(rank=2, world=3, kv=kv, every=1,
                                     timeout=5.0)
    for p in planes:
        p.peers = [0, 1, 2]
        p.epoch = 2
    third.epoch = 2
    third.publish(9, integrity.fingerprint_host({"w": w.copy()}))
    vote([{"w": bad}, {"w": w.copy()}], step=9)
    assert verdicts[1]["corrupt"] == [0] and verdicts[0]["self_corrupt"]
    recs = [r for r in telemetry._RECENT if r.get("type") == "integrity"]
    assert recs and all(telemetry.validate_record(r) for r in recs)
    assert telemetry.event_counts().get("sdc_detected") == 1
    telemetry.reset()


def _mlp_trainer(seed=3):
    with mx.cpu():
        mx.random.seed(seed)
        net = nn.HybridSequential()
        with net.name_scope():
            net.add(nn.Dense(8, activation="relu"), nn.Dense(3))
        net.initialize(init=mx.init.Xavier(), ctx=context_of(torch.device("cpu")))
        net.hybridize()
        tr = gluon.Trainer(net.collect_params(), "adam",
                           {"learning_rate": 0.01})
    rs = np.random.RandomState(seed)
    x = NDArray(torch.from_numpy(rs.randn(6, 5).astype(np.float32)),
                mx.cpu())
    y = NDArray(torch.from_numpy(rs.randint(0, 3, 6).astype(np.float32)),
                mx.cpu())
    return net, tr, gluon.loss.SoftmaxCrossEntropyLoss(), x, y


def test_captured_attestation_reads_the_host_mirror(monkeypatch, faults):
    """On due steps the captured step's fingerprint (the guard's
    readback) is the host mirror of the trainer's state; a
    ``bit_flip_param`` after a step shows at the next attestation."""
    monkeypatch.setenv("MXTPU_INTEGRITY", "1")
    net, tr, loss_fn, x, y = _mlp_trainer()
    plane = integrity.IntegrityPlane(every=2)
    tr.attach_integrity(plane)
    got = []
    orig = plane.attest

    def attest(step, fp, epoch=None):
        got.append((step, fp, integrity.fingerprint_host(
            integrity.trainer_leaves(tr))))
        return orig(step, fp, epoch)

    plane.attest = attest
    for _ in range(4):
        tr.train_step(net, loss_fn, x, y)
    assert [s for s, _f, _h in got] == [2, 4]
    assert all(f == h for _s, f, h in got)
    faults("bit_flip_param:0")
    tr.train_step(net, loss_fn, x, y)        # step 5 commits, then flips
    got.clear()
    tr.train_step(net, loss_fn, x, y)        # step 6 attests
    (step, fp, host), = got
    assert step == 6 and fp == host
    assert plane.attestations == 3


def test_bit_flip_grad_runs_the_step_eagerly(monkeypatch, faults):
    """An armed ``bit_flip_grad`` routes the step to the eager path,
    where it flips a bit of the first gradient before the update."""
    from mxnet_tpu_torch.gluon import captured

    net, tr, loss_fn, x, y = _mlp_trainer(5)
    tr.train_step(net, loss_fn, x, y)
    d0 = captured.dispatch_count()
    faults("bit_flip_grad:0")
    assert resilience.fault_armed("bit_flip_grad")
    tr.train_step(net, loss_fn, x, y)
    assert captured.dispatch_count() == d0
    assert not resilience.fault_armed("bit_flip_grad")
