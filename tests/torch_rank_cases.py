"""The multi-rank cases the port's gloo gangs run, and the nets, weights
and batches they share with the JAX references.

Every net constructor here takes a package (``mxnet_tpu_torch`` or
``mxnet_tpu``) and draws its weights from a numpy seed, so the test
process builds the JAX twin of what each rank built.  The rank side of every case returns a dict
of arrays (or None on a rank the case's mesh does not hold), which
``torch_rank_worker.py`` writes for the tests to compare.  Nothing here
imports JAX.
"""

import os

import numpy as np

# -- shared data and nets ------------------------------------------------------

MLP_X = np.random.RandomState(1).randn(32, 8).astype(np.float32)
MLP_Y = (np.arange(32) % 4).astype(np.float32)
IMG_X = np.random.RandomState(2).randn(8, 3, 8, 8).astype(np.float32)
IMG_Y = (np.arange(8) % 3).astype(np.float32)
STEPS = 3


def bert_batch():
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 1024, (8, 16)).astype(np.int32)
    mlm = np.where(rs.rand(8, 16) < 0.2, rs.randint(0, 1024, (8, 16)),
                   -1).astype(np.int32)
    nsp = rs.randint(0, 2, (8,)).astype(np.int32)
    return ids, mlm, nsp


def _fill(net, seed):
    """Every parameter of ``net`` from a numpy seed, in name order:
    normal * 0.2 (gammas and variances about 1), set through
    ``set_data``."""
    rs = np.random.RandomState(seed)
    params = net.collect_params()
    for name in sorted(params.keys()):
        p = params[name]
        short = name[len(net.prefix):]
        v = rs.standard_normal(p.shape).astype(np.float32) * 0.2
        if short.endswith(("gamma", "running_var")):
            v = 1.0 + np.abs(v)
        p.set_data(v)
    return net


def mlp(pkg, seed=0):
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix="m_")
    with net.name_scope():
        net.add(nn.Dense(16, activation="relu", in_units=8),
                nn.Dense(4, in_units=16))
    net.initialize()
    return _fill(net, seed)


def tiny_resnet(pkg, seed=0):
    """A conv stem, one residual block (two conv + BatchNorm pairs and
    the skip), global pooling and a classifier."""
    nn = pkg.gluon.nn

    class Residual(pkg.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.c1 = nn.Conv2D(4, 3, padding=1, in_channels=4,
                                    use_bias=False)
                self.b1 = nn.BatchNorm(in_channels=4)
                self.c2 = nn.Conv2D(4, 3, padding=1, in_channels=4,
                                    use_bias=False)
                self.b2 = nn.BatchNorm(in_channels=4)

        def hybrid_forward(self, F, x):
            h = F.relu(self.b1(self.c1(x)))
            return F.relu(x + self.b2(self.c2(h)))

    net = nn.HybridSequential(prefix="r_")
    with net.name_scope():
        net.add(nn.Conv2D(4, 3, padding=1, in_channels=3),
                nn.BatchNorm(in_channels=4), nn.Activation("relu"),
                Residual(prefix="res_"), nn.GlobalAvgPool2D(),
                nn.Dense(3, in_units=4))
    net.initialize()
    return _fill(net, seed)


def bert(pkg, seed=0, dropout=0.0):
    from importlib import import_module

    bz = import_module(pkg.__name__ + ".gluon.model_zoo.bert")
    kw = {} if pkg.__name__ == "mxnet_tpu" else {"device": pkg.cpu()}
    net = bz.bert_tiny(dropout=dropout, scan_layers=True, max_length=16,
                       **kw)
    if pkg.__name__ == "mxnet_tpu":
        net.initialize()
    return _fill(net, seed)


SGD = ("sgd", {"learning_rate": 0.1, "momentum": 0.9})
# BERT's parity runs take SGD: the key bias's gradient is zero in exact
# arithmetic, and Adam turns the rounding noise there (which another
# order of the tp sums moves) into steps of +-lr
BERT_OPT = ("sgd", {"learning_rate": 0.05, "momentum": 0.9, "wd": 0.01})
ADAMW = ("adamw", {"learning_rate": 1e-3, "wd": 0.01})


# -- rank side -----------------------------------------------------------------

def _mx():
    import mxnet_tpu_torch as mx

    return mx


def _train(rank, mesh, net, loss, batch, label, opt, steps=STEPS, **kw):
    """``steps`` ShardedTrainer steps on ``mesh``; returns the losses, the
    full trained parameters, the optimizer states and the aux values, by
    name, from ``state_dict`` (every rank of the mesh calls it)."""
    mx = _mx()
    tr = mx.parallel.ShardedTrainer(net, loss, opt[0], dict(opt[1]),
                                    mesh=mesh, **kw)
    losses = [float(tr.step(batch, label)) for _ in range(steps)]
    return tr, _state_arrays(tr, losses)


def _state_arrays(tr, losses):
    sd = tr.state_dict()
    out = {"losses": np.asarray(losses)}
    for (n, _), p, st in zip(tr._trainable, sd["params"], sd["opt_state"]):
        out["p:" + n] = p
        for j, s in enumerate(st):
            out[f"s{j}:" + n] = s
    for n, v in sd["aux"].items():
        out["a:" + n] = v
    return out


def _mesh(**axes):
    return _mx().parallel.make_mesh(**axes)


def case_mlp_dp2(rank, grad_accum=1):
    mx = _mx()
    mesh = _mesh(dp=2)
    if not mesh.is_member:
        return None
    net = mlp(mx)
    _tr, out = _train(rank, mesh, net,
                      mx.gluon.loss.SoftmaxCrossEntropyLoss(), MLP_X, MLP_Y,
                      ("sgd", {"learning_rate": 0.1}),
                      grad_accum=grad_accum)
    return out


def case_mlp_accum_dp2(rank):
    return case_mlp_dp2(rank, grad_accum=2)


def case_resnet_bn_dp2(rank):
    mx = _mx()
    mesh = _mesh(dp=2)
    if not mesh.is_member:
        return None
    _tr, out = _train(rank, mesh, tiny_resnet(mx),
                      mx.gluon.loss.SoftmaxCrossEntropyLoss(), IMG_X, IMG_Y,
                      SGD)
    return out


def _bert_case(rank, axes, **kw):
    mx = _mx()
    from mxnet_tpu_torch.gluon.model_zoo import bert as bz

    mesh = _mesh(**axes)
    if not mesh.is_member:
        return None
    ids, mlm, nsp = bert_batch()
    _tr, out = _train(rank, mesh, bert(mx), bz.BERTPretrainLoss(), ids,
                      (mlm, nsp), BERT_OPT, **kw)
    return out


def case_bert_tp2(rank):
    from mxnet_tpu_torch.parallel import TRANSFORMER_TP_RULES

    return _bert_case(rank, {"tp": 2}, rules=TRANSFORMER_TP_RULES)


def case_bert_fsdp2(rank):
    return _bert_case(rank, {"dp": 2}, mode="fsdp")


def case_bert_dp2tp2(rank):
    from mxnet_tpu_torch.parallel import TRANSFORMER_TP_RULES

    return _bert_case(rank, {"dp": 2, "tp": 2}, rules=TRANSFORMER_TP_RULES)


def case_bert_dropout_dp2tp2(rank):
    """Dropout on, dp=2 x tp=2: two steps' losses (the dp mean of each tp
    pair's replicated loss) and the replicated final LayerNorm scale."""
    mx = _mx()
    from mxnet_tpu_torch.gluon.model_zoo import bert as bz
    from mxnet_tpu_torch.parallel import TRANSFORMER_TP_RULES

    mesh = _mesh(dp=2, tp=2)
    ids, mlm, nsp = bert_batch()
    net = bert(mx, dropout=0.1)
    tr = mx.parallel.ShardedTrainer(net, bz.BERTPretrainLoss(), *ADAMW,
                                    mesh=mesh, rules=TRANSFORMER_TP_RULES)
    losses = [float(tr.step(ids, (mlm, nsp))) for _ in range(2)]
    gamma = net.encoder.lnf_gamma.data().asnumpy()
    return {"losses": np.asarray(losses), "gamma": gamma}


def case_dropout_streams(rank):
    """What the generator of a sharded step draws on each rank of a
    dp=2 x tp=2 mesh (one step of an MLP with a probe block)."""
    mx = _mx()
    from mxnet_tpu_torch import random as trandom

    draws = []

    class Probe(mx.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            draws.append(torch.rand(4, generator=trandom.current_generator(
                x.device)).numpy())
            return x

    import torch

    net = mlp(mx)
    net.add(Probe())
    mesh = _mesh(dp=2, tp=2)
    tr = mx.parallel.ShardedTrainer(
        net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
        {"learning_rate": 0.1}, mesh=mesh)
    tr.step(MLP_X, MLP_Y)
    tr.step(MLP_X, MLP_Y)
    return {"draws": np.stack(draws), "dp": mesh.coord("dp"),
            "tp": mesh.coord("tp")}


def case_qkv_layout(rank):
    """shard_model(mode="tp") on a tp=2 mesh: the packed qkv stack's
    DTensor placement and this rank's rows; gluon.Trainer's refusal."""
    mx = _mx()
    from mxnet_tpu_torch.parallel import shard_model, sharding

    mesh = _mesh(tp=2)
    if not mesh.is_member:
        return None
    net = bert(mx)
    full = net.encoder.qkv_stack_weight.data().asnumpy().copy()
    bias = net.encoder.qkv_stack_bias.data().asnumpy().copy()
    specs = shard_model(net, mesh, mode="tp")
    d = net.encoder.qkv_stack_weight._tensor
    try:
        mx.gluon.Trainer(net.collect_params(), "sgd").step(1)
        refused = ""
    except NotImplementedError as exc:
        refused = str(exc)
    back = sharding.full_from_shards(
        "enc_qkv_stack_weight", d.to_local().detach(),
        sharding.clean_spec(specs[net.encoder.qkv_stack_weight.name],
                            tuple(full.shape), mesh), mesh).numpy()
    return {"full": full, "bias": bias, "local": d.to_local().detach().numpy(),
            "local_bias": net.encoder.qkv_stack_bias._tensor.to_local()
            .detach().numpy(),
            "placements": np.asarray([repr(p) for p in d.placements]),
            "back": back, "refused": np.asarray(refused),
            "tp": mesh.coord("tp")}


def case_vocab_embed(rank):
    """The Embedding op on a vocab shard inside a tp=2 scope: output and
    the gradient of the rank's rows."""
    import torch

    from mxnet_tpu_torch.ops.indexing import embedding
    from mxnet_tpu_torch.parallel import collectives as coll

    mesh = _mesh(tp=2)
    if not mesh.is_member:
        return None
    rs = np.random.RandomState(5)
    table = rs.randn(10, 3).astype(np.float32)
    ids = rs.randint(0, 10, (4, 6))
    dy = rs.randn(4, 6, 3).astype(np.float32)
    r = mesh.coord("tp")
    local = torch.tensor(table[r * 5:(r + 1) * 5], requires_grad=True)
    scope = coll.ParallelScope(tp_group=mesh.group("tp"),
                               tp_shards={id(local): (0, 5 * r, 10)})
    with coll.parallel_scope(scope):
        out = embedding(torch.as_tensor(ids), local)
    (out * torch.as_tensor(dy)).sum().backward()
    return {"out": out.detach().numpy(), "grad": local.grad.numpy(),
            "table": table, "ids": ids, "dy": dy, "tp": r}


def case_state_reshape(rank):
    """FSDP over dp=2 on the MLP: two steps, the state round trip into a
    fresh trainer, then ``reshape_mesh`` to one device and a third
    step."""
    mx = _mx()
    from mxnet_tpu_torch.parallel import FSDPRules

    mesh = _mesh(dp=2)
    if not mesh.is_member:
        return None
    loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    opt = ("adam", {"learning_rate": 0.01})
    tr = mx.parallel.ShardedTrainer(mlp(mx), loss, *opt, mesh=mesh,
                                    rules=FSDPRules(axis_size=2,
                                                    min_size=16))
    losses = [float(tr.step(MLP_X, MLP_Y)) for _ in range(2)]
    sd = tr.state_dict()
    local = [loc is not None for loc in tr._local]
    twin = mx.parallel.ShardedTrainer(mlp(mx, seed=9), loss, *opt,
                                      mesh=mesh, rules=FSDPRules(
                                          axis_size=2, min_size=16))
    twin._stage(MLP_X)
    twin.load_state_dict(sd)
    sd2 = twin.state_dict()
    same = all(np.array_equal(a, b) for a, b in
               zip(sd["params"], sd2["params"])) and all(
        np.array_equal(a, b) for sa, sb in
        zip(sd["opt_state"], sd2["opt_state"]) for a, b in zip(sa, sb))
    tr.reshape_mesh(mx.parallel.make_mesh(dp=1, devices=[mx.cpu().device]))
    losses.append(float(tr.step(MLP_X, MLP_Y)))
    out = _state_arrays(tr, losses)
    out["roundtrip_equal"] = np.asarray(same)
    out["sharded"] = np.asarray(local)
    return out


def case_kv_invariants(rank):
    mx = _mx()
    kv = mx.kv.create("dist_sync")
    nw = kv.num_workers
    shape = (8, 8)
    kv.init("w0", mx.nd.zeros(shape))
    kv.push("w0", mx.nd.ones(shape) * (rank + 1))
    out = mx.nd.zeros(shape)
    kv.pull("w0", out=out)
    kv.init(["a", "b"], [mx.nd.zeros((4,)), mx.nd.zeros((2, 3))])
    kv.push(["a", "b"], [mx.nd.ones((4,)) * rank, mx.nd.ones((2, 3))])
    oa, ob = mx.nd.zeros((4,)), mx.nd.zeros((2, 3))
    kv.pull(["a", "b"], out=[oa, ob])
    kv.barrier()
    kinds = [mx.kv.create(t).type for t in ("dist_device_sync", "dist_async")]
    return {"w0": out.asnumpy(), "a": oa.asnumpy(), "b": ob.asnumpy(),
            "rank": kv.rank, "nw": nw, "kinds": np.asarray(kinds)}


def _kv_trainer(rank, **kw):
    mx = _mx()
    from mxnet_tpu_torch import autograd, distributed

    net = mx.gluon.nn.Dense(4, in_units=8, prefix="d_")
    net.initialize()
    _fill(net, 42)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1}, kvstore="dist_sync",
                               **kw)
    loss_fn = mx.gluon.loss.L2Loss()
    x = mx.nd.array(KV_X[rank])
    y = mx.nd.array(KV_Y[rank])
    for _ in range(2):
        with autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(4 * distributed.num_workers())
    return {"w": net.weight.data().asnumpy(), "b": net.bias.data().asnumpy(),
            "on_kv": np.asarray(trainer._update_on_kvstore)}


KV_X = [np.random.RandomState(100 + r).randn(4, 8).astype(np.float32)
        for r in range(2)]
KV_Y = [np.random.RandomState(200 + r).randn(4, 4).astype(np.float32)
        for r in range(2)]


def case_kv_trainer(rank):
    return _kv_trainer(rank)


def case_kv_trainer_local_update(rank):
    return _kv_trainer(rank, update_on_kvstore=False)


def case_kv_trainer_compressed(rank):
    return _kv_trainer(rank, compression_params={"type": "2bit",
                                                 "threshold": 0.01})


def grads(rank, rounds=3):
    """The numpy gradients rank ``rank`` pushes in the compression cases:
    (round, 37) values around the 0.5 threshold."""
    rs = np.random.RandomState(300 + rank)
    return rs.randn(rounds, 37).astype(np.float32) * 0.6


def _compressed(rank, params):
    mx = _mx()
    kv = mx.kv.create("dist_sync")
    kv.set_gradient_compression(params)
    kv.init("g", mx.nd.zeros((37,)))
    pulled, residual = [], []
    for g in grads(rank):
        kv.push("g", mx.nd.array(g))
        out = mx.nd.zeros((37,))
        kv.pull("g", out=out)
        pulled.append(out.asnumpy())
        residual.append(kv._compression._residual["g"].numpy())
    return {"pulled": np.stack(pulled), "residual": np.stack(residual)}


def case_compress_2bit(rank):
    return _compressed(rank, {"type": "2bit", "threshold": 0.5})


def case_compress_fp16(rank):
    return _compressed(rank, {"type": "fp16"})


def case_bucketed(rank):
    """bucketed_pushpull at two bucket budgets against per-key pushpull:
    f32 and f64 keys of several sizes."""
    mx = _mx()
    rs = np.random.RandomState(400 + rank)
    vals = [rs.randn(*s).astype(dt) for s, dt in
            [((5, 3), np.float32), ((7,), np.float64), ((300,), np.float32),
             ((2, 2), np.float64), ((64, 5), np.float32)]]
    out = {}
    ref = mx.kv.create("dist_sync")
    ref.init(list(range(5)), [mx.nd.zeros(v.shape, dtype=v.dtype)
                              for v in vals])
    per_key = [mx.nd.zeros(v.shape, dtype=v.dtype) for v in vals]
    for k, v, o in zip(range(5), vals, per_key):
        ref.pushpull(k, mx.nd.array(v, dtype=v.dtype), out=o)
    for tag, mb in (("tiny", "0.0005"), ("big", "4")):
        os.environ["MXTPU_ALLREDUCE_BUCKET_MB"] = mb
        kv = mx.kv.create("dist_sync")
        kv.init(list(range(5)), [mx.nd.zeros(v.shape, dtype=v.dtype)
                                 for v in vals])
        outs = [mx.nd.zeros(v.shape, dtype=v.dtype) for v in vals]
        kv.bucketed_pushpull(list(range(5)),
                             [mx.nd.array(v, dtype=v.dtype) for v in vals],
                             outs=outs)
        out[tag] = np.asarray([np.array_equal(a.asnumpy(), b.asnumpy())
                               for a, b in zip(outs, per_key)])
    os.environ.pop("MXTPU_ALLREDUCE_BUCKET_MB", None)
    out["sum"] = per_key[2].asnumpy()
    return out


def case_collectives(rank):
    """The reference's eager helpers over a dp=2 mesh, and the list
    all_to_all (composed from all_to_all_single for gloo)."""
    import torch

    from mxnet_tpu_torch.parallel import collectives as coll

    mesh = _mesh(dp=2)
    x = torch.arange(6.0) + 10 * rank
    summed = coll.allreduce(x, mesh)
    batch = np.arange(24, dtype=np.float32).reshape(8, 3)
    shard = coll.device_put_sharded_batch(batch, mesh)
    rep = coll.replicated_sum([torch.ones(3), torch.full((3,), 2.0)], mesh)
    outs = [torch.empty(2) for _ in range(2)]
    coll.all_to_all(outs, [torch.full((2,), 10.0 * rank + j)
                           for j in range(2)], mesh.group("dp"))
    bw = coll.measure_allreduce_bandwidth(mesh, size_mb=1, iters=2)
    return {"x": x.numpy(), "summed": summed.numpy(),
            "shard": shard.numpy(), "rep": rep.numpy(),
            "a2a": torch.stack(outs).numpy(), "bw": bw}


def case_data_parallel_dp4(rank):
    """DataParallelTrainer over the four ranks, on the MLP."""
    mx = _mx()
    tr = mx.parallel.DataParallelTrainer(
        mlp(mx), mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
        {"learning_rate": 0.1})
    losses = [float(tr.step(MLP_X, MLP_Y)) for _ in range(STEPS)]
    out = _state_arrays(tr, losses)
    out["dp"] = np.asarray(tr.mesh.shape["dp"])
    return out


SUITES = {
    "dist": [
        ("kv_invariants", case_kv_invariants),
        ("kv_trainer", case_kv_trainer),
        ("kv_trainer_local_update", case_kv_trainer_local_update),
        ("kv_trainer_compressed", case_kv_trainer_compressed),
        ("compress_2bit", case_compress_2bit),
        ("compress_fp16", case_compress_fp16),
        ("bucketed", case_bucketed),
        ("collectives", case_collectives),
    ],
    "sharding": [
        ("mlp_dp2", case_mlp_dp2),
        ("mlp_accum_dp2", case_mlp_accum_dp2),
        ("resnet_bn_dp2", case_resnet_bn_dp2),
        ("bert_tp2", case_bert_tp2),
        ("bert_fsdp2", case_bert_fsdp2),
        ("bert_dp2tp2", case_bert_dp2tp2),
        ("bert_dropout_dp2tp2", case_bert_dropout_dp2tp2),
        ("dropout_streams", case_dropout_streams),
        ("qkv_layout", case_qkv_layout),
        ("vocab_embed", case_vocab_embed),
        ("state_reshape", case_state_reshape),
        ("data_parallel_dp4", case_data_parallel_dp4),
    ],
}
WORLD = {"dist": 2, "sharding": 4}


def run_gang(suite, outdir, timeout=300):
    """Start the gang of ``suite`` (``WORLD[suite]`` rank processes on the
    host over gloo), wait for it, and return ``outdir``.  Raises if a rank
    failed or the gang outlived ``timeout``."""
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.dirname(here)
    world = WORLD[suite]
    procs = []
    for r in range(world):
        env = dict(os.environ, MXTPU_COORDINATOR=f"127.0.0.1:{port}",
                   MXTPU_NUM_WORKERS=str(world), MXTPU_WORKER_RANK=str(r),
                   OMP_NUM_THREADS="1", MXTPU_COLLECTIVE_TIMEOUT="120",
                   PYTHONPATH=repo + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(here, "torch_rank_worker.py"),
             suite, str(outdir)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            logs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError(f"ranks {bad} of the {suite} gang failed:\n"
                           + "\n".join(logs))
    return outdir, logs


def load(outdir, case, rank):
    """Rank ``rank``'s arrays of ``case`` (raises with the rank's error if
    it failed)."""
    base = os.path.join(str(outdir), f"{case}.{rank}")
    if os.path.exists(base + ".err"):
        with open(base + ".err") as f:
            raise AssertionError(f"{case} failed on rank {rank}:\n"
                                 + f.read())
    with np.load(base + ".npz") as z:
        return {k: z[k] for k in z.files}
