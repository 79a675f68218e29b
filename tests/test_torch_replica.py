"""The port's serving replicas (``mxnet_tpu_torch/serving/replica.py``) on
``gpt_tiny`` on the CPU.

A ``ReplicaServer`` polls a checkpoint directory: a good checkpoint with
the right ``expect_fp`` swaps in between groups, after which its tokens
are a fresh engine's on the new weights; a checkpoint whose fingerprint
does not match is refused, and serving goes on with the old weights; a
corrupt shard is refused before the swap.  The ``FrontDoor`` routes
around a closed replica, and ``FleetWatcher`` spawns a replica for an
announced free card.
"""

import numpy as np
import pytest
import torch

from mxnet_tpu_torch import (checkpoint, distributed, integrity,
                             resilience, serving, telemetry)
from mxnet_tpu_torch.context import cpu
from mxnet_tpu_torch.gluon.model_zoo import gpt as tgpt
from mxnet_tpu_torch.serving import FleetWatcher, FrontDoor, ReplicaServer
from mxnet_tpu_torch.serving import ServingEngine
from torch_one_thread import one_torch_thread  # noqa: F401


def _model(seed):
    model = tgpt.gpt_tiny(max_length=16, scan_layers=True, device=cpu())
    model.initialize(generator=torch.Generator().manual_seed(seed))
    return model


def _prompts(n, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 128, rng.randint(2, 6)).tolist()
            for _ in range(n)]


def _serve(target, prompts, n=4):
    futs = [target.submit(p, n) for p in prompts]
    return [f.result(timeout=60)["tokens"] for f in futs]


@pytest.fixture
def old_new():
    old, new = _model(1), _model(2)
    return old, serving.state_for_serving(new), new


def _save(ckpt_dir, step, state):
    ck = checkpoint.AsyncCheckpointer(str(ckpt_dir), rank=0, world_size=1,
                                      max_to_keep=5)
    ck.save(step, state)
    ck.wait()


def test_replica_swaps_a_good_checkpoint_and_refuses_a_bad_fp(
        tmp_path, old_new):
    telemetry.reset()
    old, state, new = old_new
    attested = {1: integrity.fingerprint_host(state), 2: 12345}
    rep = ReplicaServer(ServingEngine(old, batch_buckets=(2,)),
                        ckpt_dir=tmp_path, poll_ms=10 ** 6,
                        max_delay_ms=1.0, expect_fp=attested.get)
    try:
        prompts = _prompts(2, 3)
        before = _serve(rep, prompts)
        _save(tmp_path, 1, state)
        assert rep.poll_once()
        got = _serve(rep, prompts)          # the swap runs between groups
        assert rep.loaded_step == 1 and rep.reloads == 1
        fresh = serving.ContinuousBatcher(
            ServingEngine(new, batch_buckets=(2,)), max_delay_ms=1.0)
        try:
            want = _serve(fresh, prompts)
        finally:
            fresh.close()
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        # step 2 holds other weights, and its attested fingerprint is not
        # theirs: refused, the step-1 weights keep serving
        _save(tmp_path, 2, serving.state_for_serving(old))
        assert rep.poll_once()
        again = _serve(rep, prompts)
        assert rep.loaded_step == 1 and rep.rejected == 1
        for g, w in zip(again, want):
            np.testing.assert_array_equal(g, w)
        assert telemetry.event_counts().get("serving_reload_rejected") == 1
        assert any(not np.array_equal(a, b) for a, b in zip(before, got))
    finally:
        rep.close()


def test_replica_refuses_a_corrupt_shard(tmp_path, old_new):
    old, state, _new = old_new
    rep = ReplicaServer(ServingEngine(old, batch_buckets=(2,)),
                        ckpt_dir=tmp_path, poll_ms=10 ** 6)
    try:
        _save(tmp_path, 4, state)
        shard = tmp_path / "step_0000000004" / "shard_00000.mxtckpt"
        blob = bytearray(shard.read_bytes())
        blob[-3] ^= 0xFF
        shard.write_bytes(bytes(blob))
        assert not rep.poll_once()
        assert rep._staged is None and rep.loaded_step is None
    finally:
        rep.close()


def test_front_door_routes_around_a_closed_replica(tmp_path, old_new):
    old, _state, _new = old_new
    kv = distributed.FileKV(str(tmp_path / "gang"))
    engine = ServingEngine(old, batch_buckets=(2,))
    closed = ReplicaServer(engine, rank=0)
    closed.close()
    live = ReplicaServer(engine, kv=kv, rank=1, max_delay_ms=1.0)
    door = FrontDoor([closed, live], kv=kv, timeout=30.0)
    try:
        outs = _serve(door, _prompts(3, 5))
        assert len(outs) == 3 and all(len(t) == 4 for t in outs)
        assert [r.rank for r in door.alive()] == [1]
        assert kv.get_json("hb/1")["rank"] == 1
    finally:
        door.close()


def test_fleet_watcher_spawns_for_a_freed_card(tmp_path):
    kv = distributed.FileKV(str(tmp_path / "gang"))
    resilience.announce_freed_chips(kv, 3, step=40)
    spawned = []
    w = FleetWatcher(kv, lambda rec: spawned.append(rec["rank"]) or "r")
    assert w.poll_once() == ["r"] and spawned == [3]
    assert kv.get_json("chips/claimed/3")["rank"] == 3
    assert w.poll_once() == []
