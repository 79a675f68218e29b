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
import threading

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


# -- sequence, pipeline and expert parallelism ----------------------------------

QKV = [np.random.RandomState(10 + i).randn(2, 8, 64, 16).astype(np.float32)
       for i in range(3)]
COT = np.random.RandomState(13).randn(2, 8, 64, 16).astype(np.float32)


def _block(a, r, n, dim=2):
    step = a.shape[dim] // n
    return np.take(a, np.arange(r * step, (r + 1) * step), axis=dim)


def _attn_grads(fn, blocks, cot):
    """Output and (dq, dk, dv) of sum(out * cot) through ``fn``."""
    import torch

    q, k, v = (torch.tensor(b, requires_grad=True) for b in blocks)
    out = fn(q, k, v)
    (out * torch.as_tensor(cot)).sum().backward()
    return {"out": out.detach().numpy(), "dq": q.grad.numpy(),
            "dk": k.grad.numpy(), "dv": v.grad.numpy()}


def case_ring_sp4(rank):
    """ring_attention and ulysses_attention over sp=4: each rank's block of
    positions of the outputs and of the gradients, causal and not."""
    import torch

    from mxnet_tpu_torch import parallel

    mesh = _mesh(sp=4)
    r = mesh.coord("sp")
    blocks = [_block(a, r, 4) for a in QKV]
    cot = _block(COT, r, 4)
    out = {}
    for name, fn, causal in (
            ("ring", parallel.ring_attention, False),
            ("ring_causal", parallel.ring_attention, True),
            ("ulysses_causal", parallel.ulysses_attention, True)):
        got = _attn_grads(lambda q, k, v: fn(q, k, v, mesh=mesh,
                                             causal=causal), blocks, cot)
        out.update({f"{name}:{k}": v for k, v in got.items()})
    # the causal ring on rank 0 runs its diagonal block and skips the rest
    from mxnet_tpu_torch.ops import flash_attention as fa

    calls = []
    orig = fa.flash_attention_plain
    fa.flash_attention_plain = lambda *a, **kw: calls.append(1) or orig(*a,
                                                                      **kw)
    try:
        parallel.ring_attention(*(torch.as_tensor(b) for b in blocks),
                                mesh=mesh, causal=True)
    finally:
        fa.flash_attention_plain = orig
    out["causal_blocks"] = np.asarray(len(calls))
    out["sp"] = np.asarray(r)
    # outside a sharded step the arrays hold the whole sequence, whatever
    # the process default mesh is: both impls are flash over it
    from mxnet_tpu_torch.parallel import mesh as pmesh

    prev = pmesh.default_mesh()
    pmesh.set_default_mesh(mesh)
    try:
        for name, fn in (("ring", parallel.ring_attention),
                         ("ulysses", parallel.ulysses_attention)):
            out[f"unscoped_{name}"] = fn(
                *(torch.as_tensor(a) for a in QKV), causal=True).numpy()
    finally:
        pmesh.set_default_mesh(prev)
    return out


def bert_sp(pkg, seed=0, impl="dense"):
    """bert_tiny's trunk (no pooler, no decoder) with scanned layers."""
    from importlib import import_module

    bz = import_module(pkg.__name__ + ".gluon.model_zoo.bert")
    kw = {} if pkg.__name__ == "mxnet_tpu" else {"device": pkg.cpu()}
    net = bz.bert_tiny(dropout=0.0, scan_layers=True, max_length=64,
                       use_pooler=False, use_decoder=False,
                       attention_impl=impl, prefix="bsp_", **kw)
    if pkg.__name__ == "mxnet_tpu":
        net.initialize()
    return _fill(net, seed)


def gpt_sp(pkg, seed=0, impl="dense"):
    from importlib import import_module

    gz = import_module(pkg.__name__ + ".gluon.model_zoo.gpt")
    kw = {} if pkg.__name__ == "mxnet_tpu" else {"device": pkg.cpu()}
    net = gz.gpt_tiny(scan_layers=True, attention_impl=impl, prefix="gsp_",
                      **kw)
    if pkg.__name__ == "mxnet_tpu":
        net.initialize()
    return _fill(net, seed)


SP_IDS = np.random.RandomState(20).randint(0, 100, (4, 64)).astype(np.int32)
SP_TGT = np.random.RandomState(21).randn(4, 64, 64).astype(np.float32) * 0.5
GPT_IDS = np.random.RandomState(22).randint(0, 128, (4, 64)).astype(np.int32)


def case_bert_ring_forward_sp4(rank):
    """bert_tiny(attention_impl="ring") on sp=4: each rank's positions of
    the trunk's output, the ranks' position embeddings at their offsets."""
    import torch

    from mxnet_tpu_torch.parallel import collectives as coll

    mx = _mx()
    mesh = _mesh(sp=4)
    r = mesh.coord("sp")
    net = bert_sp(mx, impl="ring")
    with coll.parallel_scope(coll.ParallelScope(sp_group=mesh.group("sp"))):
        out = net(torch.as_tensor(_block(SP_IDS[:2, :32], r, 4, dim=1)))
    return {"out": out.detach().numpy()}


def _sp_train(rank, axes, make, loss, x, y, opt):
    mesh = _mesh(**axes)
    if not mesh.is_member:
        return None
    _tr, out = _train(rank, mesh, make(), loss, x, y, opt)
    return out


def case_bert_ring_dp2sp2(rank):
    mx = _mx()
    return _sp_train(rank, {"dp": 2, "sp": 2},
                     lambda: bert_sp(mx, impl="ring"),
                     mx.gluon.loss.L2Loss(), SP_IDS, SP_TGT, BERT_OPT)


def case_gpt_ring_sp2(rank):
    mx = _mx()
    from mxnet_tpu_torch.gluon.model_zoo import gpt as gz

    return _sp_train(rank, {"sp": 2}, lambda: gpt_sp(mx, impl="ring"),
                     gz.GPTLMLoss(), GPT_IDS, GPT_IDS, BERT_OPT)


def case_gpt_ulysses_dp2sp2(rank):
    mx = _mx()
    from mxnet_tpu_torch.gluon.model_zoo import gpt as gz

    return _sp_train(rank, {"dp": 2, "sp": 2},
                     lambda: gpt_sp(mx, impl="ulysses"), gz.GPTLMLoss(),
                     GPT_IDS, GPT_IDS, BERT_OPT)


PIPE_X = np.random.RandomState(30).randn(16, 4, 8).astype(np.float32)
PIPE_W = [{"w": np.random.RandomState(31 + s).randn(8, 8).astype(np.float32)
           * 0.3,
           "b": np.random.RandomState(41 + s).randn(8).astype(np.float32)
           * 0.1} for s in range(4)]


def case_pipeline_apply_pp4(rank):
    import torch

    from mxnet_tpu_torch import parallel

    mesh = _mesh(pp=4)
    stacked = parallel.stack_stage_params(
        [{k: torch.as_tensor(v) for k, v in w.items()} for w in PIPE_W])
    out = parallel.pipeline_apply(
        lambda p, x: torch.tanh(x @ p["w"] + p["b"]), stacked,
        torch.as_tensor(PIPE_X), mesh=mesh)
    return {"out": out.numpy()}


MLP8_X = np.random.RandomState(1).standard_normal((8, 8)).astype(np.float32)
MLP8_Y = np.random.RandomState(2).standard_normal((8, 8)).astype(np.float32)
BN_X = np.random.RandomState(3).standard_normal((8, 4, 6, 6)) \
    .astype(np.float32)
BN_Y = np.random.RandomState(4).standard_normal((8, 4, 6, 6)) \
    .astype(np.float32)
PP_IDS = np.random.RandomState(2).randint(0, 64, (8, 16)).astype(np.int32)
PP_LABELS = np.where(np.random.RandomState(5).rand(8, 16) < 0.2, PP_IDS,
                     -1).astype(np.float32)


def tanh_mlp(pkg, seed=0):
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix="m_")
    with net.name_scope():
        for _ in range(2):
            net.add(nn.Dense(8, activation="tanh", in_units=8))
    net.initialize()
    return _fill(net, seed)


def bn_tower(pkg, seed=0):
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix="bn_")
    with net.name_scope():
        for _ in range(2):
            blk = nn.HybridSequential(prefix="")
            blk.add(nn.Conv2D(4, 3, padding=1, in_channels=4,
                              use_bias=False),
                    nn.BatchNorm(in_channels=4), nn.Activation("relu"))
            net.add(blk)
    net.initialize()
    return _fill(net, seed)


def pipeline_parts(pkg, family, seed=0):
    """``bert_pipeline_parts`` / ``gpt_pipeline_parts`` at tiny widths as a
    Sequential (prologue, two layers, epilogue), weights from ``seed``."""
    from importlib import import_module

    z = import_module(f"{pkg.__name__}.gluon.model_zoo.{family}")
    kw = {} if pkg.__name__ == "mxnet_tpu" else {"device": pkg.cpu()}
    embed, layers, head = getattr(z, f"{family}_pipeline_parts")(
        vocab_size=64, units=16, num_layers=2, num_heads=2, max_length=16,
        dropout=0.0, **kw)
    seq = pkg.gluon.nn.HybridSequential(prefix="pp_")
    for b in [embed] + layers + [head]:
        if pkg.__name__ == "mxnet_tpu":
            b.initialize()
        seq.add(b)
    return _fill(seq, seed)


def _pipe_train(rank, make, loss, x, y, opt, schedule, **kw):
    """Three PipelineTrainer steps over pp=2: losses and every trained
    parameter and aux value in structural order."""
    mx = _mx()
    mesh = _mesh(pp=2)
    if not mesh.is_member:
        return None
    net = make()
    children = list(net._children.values())
    if kw.pop("parts", False):
        stages, extra = children[1:-1], {"prologue": children[0],
                                         "epilogue": children[-1]}
    else:
        stages, extra = net, {}
    pt = mx.parallel.PipelineTrainer(stages, loss, opt[0], dict(opt[1]),
                                     mesh=mesh, n_microbatches=4,
                                     schedule=schedule, **extra, **kw)
    losses = [float(pt.step(x, y)) for _ in range(STEPS)]
    sd = pt.state_dict()
    out = {"losses": np.asarray(losses),
           "bubble": np.asarray(pt.bubble_fraction),
           "ticks": np.asarray(pt.schedule_ticks)}
    for i, (n, v) in enumerate(sd["params"].items()):
        out[f"p{i:03d}:{n}"] = v.numpy()
    return out


ADAM01 = ("adam", {"learning_rate": 0.01})
SGD05 = ("sgd", {"learning_rate": 0.05, "momentum": 0.9})


def _schedules(make_case):
    return [(f"{name}_{sched}", lambda rank, s=sched, f=make_case:
             f(rank, s)) for name, sched in
            ((make_case.__name__[5:], "gpipe"),
             (make_case.__name__[5:], "1f1b"))]


def case_mlp_pp2(rank, schedule):
    mx = _mx()
    return _pipe_train(rank, lambda: tanh_mlp(mx, 7), mx.gluon.loss.L2Loss(),
                       MLP8_X, MLP8_Y, ADAM01, schedule)


def case_bn_pp2(rank, schedule):
    mx = _mx()
    return _pipe_train(rank, lambda: bn_tower(mx, 5), mx.gluon.loss.L2Loss(),
                       BN_X, BN_Y, SGD05, schedule)


def case_bert_pp2(rank, schedule):
    mx = _mx()
    from mxnet_tpu_torch.gluon.model_zoo import bert as bz

    return _pipe_train(rank, lambda: pipeline_parts(mx, "bert", 11),
                       bz.BERTMLMLoss(), PP_IDS, PP_LABELS, SGD05, schedule,
                       parts=True)


def case_gpt_pp2(rank, schedule):
    mx = _mx()
    from mxnet_tpu_torch.gluon.model_zoo import gpt as gz

    return _pipe_train(rank, lambda: pipeline_parts(mx, "gpt", 13),
                       gz.GPTLMLoss(), PP_IDS, PP_IDS, SGD05, schedule,
                       parts=True)


def case_tp_stack_pp2(rank):
    """shard_model(mode="pp") places the scanned trunk's stacks over pp=2,
    and ShardedTrainer trains with them (gathered for the step, each rank
    updating its block)."""
    mx = _mx()
    from mxnet_tpu_torch.gluon.model_zoo import bert as bz
    from mxnet_tpu_torch.parallel import shard_model

    mesh = _mesh(pp=2)
    if not mesh.is_member:
        return None
    net = bert(mx)
    specs = shard_model(net, mesh, mode="pp")
    local = net.encoder.qkv_stack_weight._tensor.to_local().shape[0]
    ids, mlm, nsp = bert_batch()
    tr = mx.parallel.ShardedTrainer(net, bz.BERTPretrainLoss(), *BERT_OPT,
                                    mesh=mesh)
    losses = [float(tr.step(ids, (mlm, nsp))) for _ in range(STEPS)]
    out = _state_arrays(tr, losses)
    out["local_layers"] = np.asarray(local)
    out["qkv_spec"] = np.asarray(
        repr(tuple(specs[net.encoder.qkv_stack_weight.name])))
    return out


MOE_X = np.random.RandomState(2).randn(16, 8).astype(np.float32)
MOE_Y = np.random.RandomState(3).randn(16, 8).astype(np.float32)


def moe_net(pkg, k=1, cf=4.0, seed=0):
    """Dense then MoEFFN (the shape of examples/moe_expert_parallel.py)."""
    from importlib import import_module

    contrib = import_module(pkg.__name__ + ".gluon.contrib")
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix="moe_")
    with net.name_scope():
        net.add(nn.Dense(8, activation="relu", in_units=8),
                contrib.MoEFFN(units=8, hidden=16, num_experts=4, k=k,
                               capacity_factor=cf))
    net.initialize()
    return _fill(net, seed)


def _moe_case(rank, axes, k, cf, rules=True):
    mx = _mx()
    mesh = _mesh(**axes)
    if not mesh.is_member:
        return None
    kw = {"rules": mx.parallel.MOE_EP_RULES} if rules else {}
    tr, out = _train(rank, mesh, moe_net(mx, k, cf), mx.gluon.loss.L2Loss(),
                     MOE_X, MOE_Y, ("sgd", {"learning_rate": 0.1}), **kw)
    out["local_experts"] = np.asarray(
        [loc.shape[0] for (n, _), loc in zip(tr._trainable, tr._local)
         if loc is not None and "expert" in n] or [4])
    return out


def case_moe_ep2_k1(rank):
    return _moe_case(rank, {"ep": 2}, 1, 4.0)


def case_moe_ep2_k2_drops(rank):
    return _moe_case(rank, {"ep": 2}, 2, 0.75)


def case_moe_dp2ep2_k2(rank):
    return _moe_case(rank, {"dp": 2, "ep": 2}, 2, 0.75)


def case_moe_dp2_k1_drops(rank):
    return _moe_case(rank, {"dp": 2}, 1, 0.5, rules=False)


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
def case_probe_host(rank):
    """``collectives.probe`` on host tensors over the four ranks: the
    point-to-point entry (``ppermute``) among the collectives."""
    import torch

    from mxnet_tpu_torch.parallel import collectives as coll

    res = coll.probe(torch.device("cpu"))
    return {"names": np.asarray(sorted(res)),
            "results": np.asarray([res[k] for k in sorted(res)])}


SUITES["ring"] = [
    ("probe_host", case_probe_host),
    ("ring_sp4", case_ring_sp4),
    ("bert_ring_forward_sp4", case_bert_ring_forward_sp4),
    ("bert_ring_dp2sp2", case_bert_ring_dp2sp2),
    ("gpt_ring_sp2", case_gpt_ring_sp2),
    ("gpt_ulysses_dp2sp2", case_gpt_ulysses_dp2sp2),
]
SUITES["pipeline"] = [
    ("pipeline_apply_pp4", case_pipeline_apply_pp4),
    *_schedules(case_mlp_pp2), *_schedules(case_bn_pp2),
    *_schedules(case_bert_pp2), *_schedules(case_gpt_pp2),
    ("tp_stack_pp2", case_tp_stack_pp2),
]
SUITES["moe"] = [
    ("moe_ep2_k1", case_moe_ep2_k1),
    ("moe_ep2_k2_drops", case_moe_ep2_k2_drops),
    ("moe_dp2ep2_k2", case_moe_dp2ep2_k2),
    ("moe_dp2_k1_drops", case_moe_dp2_k1_drops),
]
# -- two ranks: the prefetcher over dp, tp decoding and serving, row-sharded
# tables, the compressed row-sparse push, Module over dist_sync, activation
# constraints

PF_BATCHES = [(np.random.RandomState(500 + k).randn(n, 3).astype(np.float32),
               (np.arange(n) % 5).astype(np.float32))
              for k, n in enumerate((8, 8, 7))]
PF_IDS = [np.random.RandomState(510 + k).randint(0, 20, (8, 2))
          .astype(np.float32) for k in range(3)]
PF_TABLE = np.random.RandomState(520).randn(20, 3).astype(np.float32)


def sparse_tower(pkg, vocab=20, dim=3):
    """A ``ShardedEmbedding`` table (``emb_embed_table``) over ids (B, 2),
    flattened into a classifier of 5 classes."""
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix="st_")
    with net.name_scope():
        net.add(pkg.embedding.ShardedEmbedding(vocab, dim, prefix="emb_"),
                nn.Dense(5, in_units=2 * dim))
    net.initialize()
    return _fill(net, 7)


def case_prefetch_dp2(rank):
    """Each rank's rows of every batch through ``DevicePrefetcher`` over a
    dp=2 rank mesh, threaded and synchronous (the 7-row batch whole),
    and the producer's warm ``row_sparse_pull`` from a dist store of the
    rows the rank's block of each id batch touches."""
    mx = _mx()
    from mxnet_tpu_torch.gluon.data import DevicePrefetcher

    mesh = _mesh(dp=2)
    out = {}
    for depth in (2, 0):
        got = list(DevicePrefetcher(PF_BATCHES, depth=depth, mesh=mesh))
        for k, (x, y) in enumerate(got):
            out[f"x{k}.d{depth}"] = x.asnumpy()
            out[f"y{k}.d{depth}"] = y.asnumpy()
    net = sparse_tower(mx)
    kv = mx.kv.create("dist_sync")
    name = net[0].weight.name
    kv.init(name, mx.nd.array(PF_TABLE))
    threads = []
    pull = kv.row_sparse_pull

    def spy(*a, **kw):
        threads.append(threading.current_thread().name)
        return pull(*a, **kw)

    kv.row_sparse_pull = spy
    # synchronous: each batch's pull lands just before it is yielded;
    # threaded: the producer runs ahead, so the rows held after the epoch
    # are the last batch's
    for depth in (0, 2):
        dest = mx.nd.sparse.zeros("row_sparse", PF_TABLE.shape)
        pf = DevicePrefetcher(PF_IDS, depth=depth, mesh=mesh,
                              sparse_tables=net, kvstore=kv,
                              warm_pull={name: dest})
        for k, ids in enumerate(pf):
            out[f"ids{k}.d{depth}"] = ids.asnumpy()
            if depth == 0:
                out[f"pulled_idx{k}"] = dest.indices.asnumpy()
                out[f"pulled{k}"] = dest.data.asnumpy()
        out[f"pulled_last_idx.d{depth}"] = dest.indices.asnumpy()
        out[f"pulled_last.d{depth}"] = dest.data.asnumpy()
    out["pull_threads"] = np.asarray(threads)
    return out


DEC_IDS = np.random.RandomState(530).randint(0, 128, (2, 6))
SERVE_PROMPTS = [np.random.RandomState(531).randint(0, 128, 5),
                 np.random.RandomState(532).randint(0, 128, 3)]


def _gpt_from_state():
    """gpt_tiny (2 layers, window 32) holding the JAX twin's weights the
    test wrote to ``MXTPU_TEST_GPT_STATE``."""
    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch.gluon.model_zoo import gpt

    model = gpt.gpt_tiny(max_length=32, num_layers=2,
                         device=_mx().cpu())
    with np.load(os.environ["MXTPU_TEST_GPT_STATE"]) as z:
        convert.load_state(model, {k: z[k] for k in z.files})
    return model


def case_decode_tp2(rank):
    """``CachedDecoder(mesh=tp2)`` and ``ServingEngine(mesh=tp2)`` on
    gpt_tiny, beside the same model on one rank."""
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.gluon.model_zoo import gpt

    mesh = _mesh(tp=2)
    model = _gpt_from_state()
    out = {}
    for tag, m in (("tp", mesh), ("one", None)):
        dec = gpt.CachedDecoder(model, mesh=m)
        toks, lg = dec.decode(DEC_IDS, max_new_tokens=5, return_logits=True)
        out[f"toks.{tag}"] = toks.asnumpy()
        out[f"logits.{tag}"] = lg
        out[f"cache_heads.{tag}"] = dec._init_cache(1)[0].shape[2]
        eng = serving.ServingEngine(model, batch_buckets=(2,), mesh=m)
        outs, _ = eng.serve_group(SERVE_PROMPTS, 4)
        for i, o in enumerate(outs):
            out[f"serve{i}.{tag}"] = o
        out[f"recordings.{tag}"] = eng.recordings
    return out


def case_embed_rows_dp2(rank, vocab=20):
    """A ``ShardedEmbedding`` table row-sharded over dp=2 by
    ``EmbeddingRules`` through three ``ShardedTrainer`` steps (ids to
    their owner, rows back, gradient rows to their owner), with the
    rank's block of the table's rows and whether the lookup exchanged."""
    mx = _mx()
    from mxnet_tpu_torch.parallel import collectives

    mesh = _mesh(dp=2)
    net = sparse_tower(mx, vocab=vocab)
    rs = np.random.RandomState(540)
    x = rs.randint(0, vocab, (8, 2)).astype(np.float32)
    y = (np.arange(8) % 5).astype(np.float32)
    calls = collectives.stats(reset=True)["calls"]
    tr, out = _train(rank, mesh, net,
                     mx.gluon.loss.SoftmaxCrossEntropyLoss(), x, y, SGD,
                     rules=mx.parallel.EmbeddingRules())
    i = [n for n, _ in tr._trainable].index(net[0].weight.name)
    out["local_rows"] = -1 if tr._local[i] is None \
        else tr._local[i].shape[0]
    out["calls"] = collectives.stats()["calls"] - calls
    # the module's table while the trainer holds the rank's block, then
    # written back whole
    out["module_rows"] = net[0].weight._value().shape[0]
    tr.sync_params()
    out["synced"] = net[0].weight.data().asnumpy()
    return out


def case_embed_rows_uneven_dp2(rank):
    return case_embed_rows_dp2(rank, vocab=21)


RS_ROUNDS = [
    [([[0.7, -0.1], [0.2, 0.9]], [1, 4]), ([[0.4, 0.4]], [4]),
     ([[0.3, -0.8], [0.05, 0.0]], [1, 9])],
    [([[0.6, 0.6]], [4]), ([[-0.9, 0.2], [0.1, 0.55]], [2, 11]),
     ([[0.25, 0.3]], [2])],
]


def _compress_rowsparse(rank, params):
    mx = _mx()
    shape = (12, 2)
    kv = mx.kv.create("dist_sync")
    kv.set_gradient_compression(params)
    kv.init("emb", mx.nd.zeros(shape))
    pulled, residual = [], []
    for vals, ids in RS_ROUNDS[rank]:
        kv.push("emb", mx.nd.sparse.row_sparse_array(
            (np.asarray(vals, np.float32), list(ids)), shape=shape))
        got = mx.nd.zeros(shape)
        kv.pull("emb", out=got)
        pulled.append(got.asnumpy())
        residual.append(kv._compression._residual["emb"].numpy())
    return {"pulled": np.stack(pulled), "residual": np.stack(residual)}


def case_compress_rowsparse_2bit(rank):
    return _compress_rowsparse(rank, {"type": "2bit", "threshold": 0.5})


def case_compress_rowsparse_fp16(rank):
    return _compress_rowsparse(rank, {"type": "fp16", "threshold": 0.5})


MOD_X = np.random.RandomState(550).randn(16, 6).astype(np.float32)
MOD_Y = (np.arange(16) % 3).astype(np.float32)
MOD_B = 4


def module_symbol(pkg):
    sym = pkg.sym
    h = sym.FullyConnected(sym.Variable("data"), sym.Variable("fc1_weight"),
                           sym.Variable("fc1_bias"), num_hidden=8,
                           name="fc1")
    h = sym.Activation(h, act_type="relu", name="relu1")
    out = sym.FullyConnected(h, sym.Variable("fc2_weight"),
                             sym.Variable("fc2_bias"), num_hidden=3,
                             name="fc2")
    return sym.SoftmaxOutput(out, sym.Variable("softmax_label"),
                             name="softmax")


def module_params():
    rs = np.random.RandomState(551)
    return {"fc1_weight": rs.randn(8, 6).astype(np.float32) * 0.3,
            "fc1_bias": rs.randn(8).astype(np.float32) * 0.1,
            "fc2_weight": rs.randn(3, 8).astype(np.float32) * 0.3,
            "fc2_bias": rs.randn(3).astype(np.float32) * 0.1}


def module_rows(rank, world):
    """Rank ``rank``'s rows of ``MOD_X``: its block of each global batch
    of ``world * MOD_B`` rows."""
    g = world * MOD_B
    idx = np.concatenate([np.arange(k, k + g)[rank * MOD_B:
                                              (rank + 1) * MOD_B]
                          for k in range(0, len(MOD_X), g)])
    return MOD_X[idx], MOD_Y[idx]


def module_fit(pkg, x, y, batch, kvstore, global_batch):
    """Two epochs of ``Module.fit`` (SGD, rescaled by the global batch)
    from ``module_params``; returns the trained parameters."""
    mod = pkg.mod.Module(module_symbol(pkg), data_names=["data"],
                         label_names=["softmax_label"])
    it = pkg.io.NDArrayIter(x, y, batch_size=batch, shuffle=False)
    mod.fit(it, num_epoch=2, kvstore=kvstore, optimizer="sgd",
            optimizer_params={"learning_rate": 0.5, "momentum": 0.9,
                              "rescale_grad": 1.0 / global_batch},
            arg_params={k: pkg.nd.array(v)
                        for k, v in module_params().items()},
            eval_metric="acc")
    args, _ = mod.get_params()
    return {k: v.asnumpy() for k, v in args.items()}


def case_module_dist2(rank):
    """``Module.fit`` over a ``dist_sync`` store on two ranks, each on its
    block of every global batch."""
    mx = _mx()
    x, y = module_rows(rank, 2)
    out = module_fit(mx, x, y, MOD_B, "dist_sync", 2 * MOD_B)
    out["workers"] = mx.kv.create("dist_sync").num_workers
    return out


def _spec_of(t):
    """The layout ``constrain`` recorded on ``t``, as a string ("" for
    none)."""
    spec = getattr(t, "partition_spec", None)
    return np.asarray("" if spec is None else repr(tuple(spec)))


def case_shard_activations_tp2(rank):
    """``shard_activations`` on a tp=2 rank mesh outside a sharded step:
    the annotated outputs, their recorded layouts, the whole net with its
    hidden layer annotated, the no-op annotations, and
    ``annotate_activations`` by block name."""
    mx = _mx()
    import torch

    mesh = _mesh(tp=2)
    x = mx.nd.array(MLP_X[:4])
    net = mlp(mx)
    out = {"plain": net(x).asnumpy(), "first": net[0](x).asnumpy()}
    net[0].shard_activations((None, "tp"), mesh)
    h = net[0](x)
    out["sharded"], out["spec.sharded"] = h.asnumpy(), _spec_of(h._data)
    out["whole"] = net(x).asnumpy()
    for tag, spec, m in (("no_axis", (None, "dp"), mesh),
                         ("too_long", (None, None, "tp"), mesh),
                         ("no_mesh", (None, "tp"), None)):
        net[0].shard_activations(spec, m)
        h = net[0](x)
        out[tag], out["spec." + tag] = h.asnumpy(), _spec_of(h._data)
    net2 = mlp(mx)
    mx.parallel.annotate_activations(
        net2, mx.parallel.ShardingRules(rules=[(r"dense0$", (None, "tp"))]),
        mesh)
    h = net2[0](x)
    out["annotated"], out["spec.annotated"] = h.asnumpy(), _spec_of(h._data)
    out["annotated_whole"] = net2(x).asnumpy()
    with torch.no_grad():
        t = net[0].shard_activations((None, "tp"), mesh)(
            torch.as_tensor(MLP_X[:4]))
    out["tensor"], out["spec.tensor"] = t.numpy(), _spec_of(t)
    return out


#: Megatron over the two Dense layers of ``mlp``: the first column-parallel,
#: the second row-parallel
MLP_TP_RULES = [(r"dense0_weight$", ("tp", None)),
                (r"dense1_weight$", (None, "tp"))]


def case_shard_activations_trainer_tp2(rank):
    """``mlp`` with its hidden projection annotated ``(None, 'tp')`` on
    the default mesh (the tp mesh, as ``shard_model`` sets it), trained
    ``STEPS`` ``ShardedTrainer`` steps at tp=2 by ``MLP_TP_RULES``, then
    run whole outside the trainer."""
    mx = _mx()
    mesh = _mesh(tp=2)
    net = mlp(mx)
    net[0].shard_activations((None, "tp"))
    mx.parallel.set_default_mesh(mesh)
    try:
        tr, out = _train(rank, mesh, net,
                         mx.gluon.loss.SoftmaxCrossEntropyLoss(), MLP_X,
                         MLP_Y, SGD,
                         rules=mx.parallel.ShardingRules(rules=MLP_TP_RULES))
        tr.sync_params()
        out["whole"] = net(mx.nd.array(MLP_X[:4])).asnumpy()
    finally:
        mx.parallel.set_default_mesh(None)
    return out


SUITES["ranks2"] = [
    ("prefetch_dp2", case_prefetch_dp2),
    ("decode_tp2", case_decode_tp2),
    ("embed_rows_dp2", case_embed_rows_dp2),
    ("embed_rows_uneven_dp2", case_embed_rows_uneven_dp2),
    ("compress_rowsparse_2bit", case_compress_rowsparse_2bit),
    ("compress_rowsparse_fp16", case_compress_rowsparse_fp16),
    ("module_dist2", case_module_dist2),
    ("shard_activations_tp2", case_shard_activations_tp2),
    ("shard_activations_trainer_tp2", case_shard_activations_trainer_tp2),
]
WORLD = {"dist": 2, "sharding": 4, "ring": 4, "pipeline": 4, "moe": 4,
         "ranks2": 2}


class Gang:
    """A gang of ``suite`` started in the background (``start_gang``):
    ``dir()`` waits for it (once) and returns its output directory, and
    raises as ``run_gang`` does.  The test process computes its JAX
    references while the ranks run."""

    def __init__(self, suite, outdir, procs, timeout):
        self.suite, self.outdir, self.procs = suite, outdir, procs
        self.timeout = timeout
        self._done = None

    def dir(self):
        if self._done is None:
            self._done = _finish(self.suite, self.procs, self.timeout)
        if isinstance(self._done, Exception):
            raise self._done
        return self.outdir

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def start_gang(suite, outdir, timeout=300):
    """Start the gang of ``suite`` and return its ``Gang`` at once."""
    return Gang(suite, outdir, _launch(suite, outdir), timeout)


def _finish(suite, procs, timeout):
    """Wait for the ranks; the error (not raised) if one failed."""
    import subprocess

    logs = []
    try:
        for p in procs:
            p.wait(timeout=timeout)
            with open(p.log, "rb") as f:
                logs.append(f.read().decode(errors="replace"))
    except subprocess.TimeoutExpired as exc:
        return RuntimeError(f"the {suite} gang outlived {timeout} s: {exc}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        return RuntimeError(f"ranks {bad} of the {suite} gang failed:\n"
                            + "\n".join(logs))
    return logs


def run_gang(suite, outdir, timeout=300):
    """Start the gang of ``suite`` (``WORLD[suite]`` rank processes on the
    host over gloo), wait for it, and return ``outdir``.  Raises if a rank
    failed or the gang outlived ``timeout``."""
    done = _finish(suite, _launch(suite, outdir), timeout)
    if isinstance(done, Exception):
        raise done
    return outdir, done


def _launch(suite, outdir):
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
        # a log file, not a pipe: a gang left running while the test
        # process works must never block on a full pipe
        with open(os.path.join(str(outdir), f"rank{r}.log"), "wb") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(here, "torch_rank_worker.py"),
                 suite, str(outdir)], env=env, stdout=log,
                stderr=subprocess.STDOUT))
            procs[-1].log = log.name
    return procs


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
