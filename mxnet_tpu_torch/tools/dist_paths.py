"""The two-rank paths of the input, decode, recommender, symbolic and
activation layers over a gang of ranks, one process a rank: the sibling
of ``tools/dist_bert.py`` and ``tools/dist_sp_pp_ep.py``.

    python3 -m mxnet_tpu_torch.tools.dist_paths --rank R --world 2
        --out DIR [--quick] [--cpu]

with the launch variables ``MXTPU_COORDINATOR`` / ``MXTPU_NUM_WORKERS`` /
``MXTPU_WORKER_RANK`` set (``drive`` sets them).  Each rank joins the
process group (gloo when the ranks share one card) and runs, in order:

- ``prefetch``: ``DevicePrefetcher`` over a dp mesh, threaded and
  synchronous, on ``PF_BATCHES`` batches of ``PF_BATCH`` f32 images of
  ``PF_IMAGE`` x ``PF_IMAGE``: the rank's block of rows of each, bitwise
  against the host's, and ms a batch; then the warm ``row_sparse_pull``
  from a ``dist_sync`` store of a (4096, 64) table through the producer
  thread over zipf ids (the rows pulled before each batch bitwise the
  table's rows of the rank's ids, synchronously; every pull on the
  producer thread, threaded);
- ``decode``: GPT-2 small (12 layers, 768 wide, 12 heads, vocab 50257,
  window 1024) with weights from a seed, ``CachedDecoder`` and
  ``ServingEngine`` over a tp mesh beside the same model on this rank
  alone: the first logits in f32 and in bf16, the tokens, ms a token and
  the engine's counters;
- ``embed``: ``EMB_CONFIGS``' recommender tables (``bench_embedding``'s
  net: a ``ShardedEmbedding`` and a ``Dense(1)``, Xavier, Adam at 1e-3,
  zipf ids) row-sharded over the dp mesh by ``EmbeddingRules`` through
  ``ShardedTrainer``, the objective the mean over the global batch of
  ``out ** 2``: the losses of ``EMB_STEPS`` steps, the rank's rows of
  ``sample_rows``, the Dense's weights, ms a step and ids a second over
  ``EMB_TIMED`` steps, the rank's peak memory;
- ``module``: ``Module.fit`` over a ``dist_sync`` store on ResNet-50 v1
  as a symbol, f32, each rank on its block of ``MOD_GLOBAL`` images of
  every global batch, SGD rescaled by the global batch: a sample of the
  weights before and after ``MOD_STEPS`` steps and ms a step;
- ``shard_act``: ``shard_activations`` over a tp mesh on BERT-base's FFN
  up-projection (768 -> 3072, bf16, 8 x 512 tokens) and
  ``annotate_activations`` by block name: the annotated output, and the
  FFN's whole output after it, bitwise the unannotated ones, with the
  layout recorded where the mesh has the axis.

The rank writes ``DIR/rank<R>.json``.  ``drive`` starts the gang and
returns the results; ``embed_reference`` and ``module_reference`` run
the one-rank counterparts (the table replicated through
``ShardedTrainer`` on one device; a ``Module`` summing the two blocks'
gradients) for the caller to hold the ranks against.  ``--quick`` runs
the paths at tiny sizes (a rehearsal on the host with ``--cpu``).
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time

import numpy as np
import torch

SEED = 0
PF_BATCH, PF_IMAGE, PF_BATCHES = 64, 224, 6
PF_VOCAB, PF_DIM, PF_IDS, PF_ID_BATCHES = 4096, 64, 8192, 4
DEC_BATCH, DEC_PROMPT, DEC_NEW, DEC_F32_NEW = 8, 16, 16, 4
EMB_DIM = 64
EMB_CONFIGS = {"a": (4096, 512), "b": (1 << 24, 8192)}
EMB_STEPS, EMB_TIMED = 3, 5
MOD_GLOBAL, MOD_STEPS, MOD_IMAGE = 32, 1, 224
MOD_SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
#: the weights ``module`` samples, and the sample's size
MOD_SAMPLED = ("dpres_conv0_weight", "dpres_stage1_conv0_weight",
               "dpres_stage2_conv3_weight", "dpres_stage3_conv6_weight",
               "dpres_stage4_conv9_weight", "dpres_dense0_weight",
               "dpres_dense0_bias")
SAMPLE = 1024
#: quick (host rehearsal) sizes of the same paths
QUICK = {"pf": (8, 8, 3, 64, 4, 16, 2), "emb": {"a": (64, 16)},
         "mod": (4, 2, 32), "dec": (2, 4, 4, 2)}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _flash():
    from ..ops import flash_attention as fa

    return {"flash_attention_fwd": fa.flash_attention_fwd,
            "flash_attention_dq": fa.flash_attention_dq,
            "flash_attention_dkv": fa.flash_attention_dkv}


def _zero_flash():
    for fn in _flash().values():
        fn.launches = 0


def _flash_counts():
    return {k: fn.launches for k, fn in _flash().items()}


# -- prefetch --------------------------------------------------------------------

def _emb_net(vocab, dim, device, prefix):
    """``bench_embedding``'s net: a ``ShardedEmbedding`` and a
    ``Dense(1)``, Xavier from seed 0 on ``device``."""
    from .. import context, initializer
    from ..embedding import ShardedEmbedding
    from ..gluon import nn

    net = nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(ShardedEmbedding(vocab, dim),
                nn.Dense(1, in_units=dim, flatten=False))
    net.initialize(init=initializer.Xavier(),
                   ctx=context.context_of(device),
                   generator=torch.Generator(device=device).manual_seed(0))
    return net


def _prefetch(device, world, rank, quick):
    from .. import context, kv, nd
    from ..gluon.data import DevicePrefetcher
    from ..ndarray import sparse
    from ..parallel import make_mesh

    n, img, nb, vocab, dim, nid, nib = QUICK["pf"] if quick else (
        PF_BATCH, PF_IMAGE, PF_BATCHES, PF_VOCAB, PF_DIM, PF_IDS,
        PF_ID_BATCHES)
    mesh = make_mesh(dp=world)
    ctx = context.context_of(device)
    batches = [(np.random.RandomState(SEED + k).standard_normal(
        (n, 3, img, img)).astype(np.float32),
        (np.arange(n) % 10).astype(np.float32)) for k in range(nb)]
    b, lo = n // world, rank * (n // world)
    out = {"rows": b, "batches": nb}
    for depth in (2, 0):
        ok, t0 = True, time.perf_counter()
        for k, (x, y) in enumerate(DevicePrefetcher(batches, depth=depth,
                                                    mesh=mesh)):
            ok &= x._data.device == device and np.array_equal(
                x.asnumpy(), batches[k][0][lo:lo + b]) and np.array_equal(
                y.asnumpy(), batches[k][1][lo:lo + b])
        out[f"bitwise_depth{depth}"] = bool(ok)
        out[f"ms_per_batch_depth{depth}"] = \
            (time.perf_counter() - t0) * 1e3 / nb
    net = _emb_net(vocab, dim, device, "pfemb_")
    name = net[0].weight.name
    table = np.random.RandomState(SEED + 50).standard_normal(
        (vocab, dim)).astype(np.float32)
    store = kv.create("dist_sync")
    store.init(name, nd.array(table, ctx=ctx))
    threads = []
    pull = store.row_sparse_pull

    def spy(*a, **k):
        threads.append(threading.current_thread().name)
        return pull(*a, **k)

    store.row_sparse_pull = spy
    ids = [(np.random.RandomState(SEED + 60 + k).zipf(1.3, size=nid)
            % vocab).astype(np.float32) for k in range(nib)]
    pulled_ok, rows = True, []
    for depth in (0, 2):
        dest = sparse.zeros("row_sparse", (vocab, dim), ctx=ctx)
        pf = DevicePrefetcher(ids, depth=depth, mesh=mesh,
                              sparse_tables=net, kvstore=store,
                              warm_pull={name: dest})
        for k, x in enumerate(pf):
            if depth:
                continue
            mine = np.unique(ids[k][rank * (nid // world):
                                    (rank + 1) * (nid // world)]
                             .astype(np.int64))
            pulled_ok &= np.array_equal(dest.indices.asnumpy(), mine) and \
                np.array_equal(dest.data.asnumpy(), table[mine])
            rows.append(int(len(mine)))
    out.update(warm_pull_bitwise=bool(pulled_ok), warm_pull_rows=rows,
               pull_threads=threads)
    return out


# -- decode ------------------------------------------------------------------------

def gpt_state(model, seed=SEED + 70):
    """A serving checkpoint in the JAX package's naming, N(0, 0.02)
    values (LayerNorm scales about 1) at the model's shapes."""
    rng = np.random.RandomState(seed)
    state = {}
    for name, p in model.named_parameters():
        short = name.split(".")[-1]
        key = ("gptmodel0_trunk_" if name.startswith("encoder.")
               else "gptmodel0_") + short
        a = rng.standard_normal(tuple(p.shape)).astype(np.float32) * 0.02
        if short.endswith("gamma"):
            a += 1.0
        state[key] = a
    return state


def _decode(device, world, quick):
    from .. import convert, serving
    from ..gluon.model_zoo import gpt
    from ..parallel import make_mesh

    B, T0, new, new32 = QUICK["dec"] if quick else (
        DEC_BATCH, DEC_PROMPT, DEC_NEW, DEC_F32_NEW)
    mesh = make_mesh(tp=world)
    model = (gpt.gpt_tiny(scan_layers=True, max_length=64, device=device)
             if quick else gpt.gpt2_small(scan_layers=True,
                                          attention_impl="flash",
                                          device=device))
    convert.load_state(model, gpt_state(model))
    vocab = model.tok_embed_weight.shape[0]
    ids = np.random.RandomState(SEED + 71).randint(0, vocab, (B, T0))
    out = {"batch": B, "prompt": T0, "new_tokens": new}
    logits = {}
    _zero_flash()
    for tag, m in (("tp", mesh), ("one", None)):
        dec32 = gpt.CachedDecoder(model, mesh=m)
        _, lg32 = dec32.decode(ids, max_new_tokens=new32, return_logits=True)
        dec = gpt.CachedDecoder(model, mesh=m, dtype="bfloat16")
        toks, lg = dec.decode(ids, max_new_tokens=new, return_logits=True)
        _sync(device)
        t0 = time.perf_counter()
        dec.decode(ids, max_new_tokens=new)
        _sync(device)
        ms = (time.perf_counter() - t0) * 1e3 / new
        logits[tag] = (lg32[0], lg)
        eng = serving.ServingEngine(model, batch_buckets=(B,), mesh=m,
                                    dtype="bfloat16")
        # the first group builds the two programs it runs
        served, _ = eng.serve_group(list(ids), new)
        _, timings = eng.serve_group(list(ids), new)
        out[tag] = {
            "tokens": toks.asnumpy().astype(np.int64)[:, T0:].tolist(),
            "ms_per_token": ms, "tokens_per_sec": B * 1e3 / ms,
            "cache_heads": int(dec._init_cache(1)[0].shape[2]),
            "engine_tokens": np.stack(served).astype(np.int64).tolist(),
            "engine_decode_us_per_token": timings["decode_us_per_token"],
            "engine_prefill_us": timings["prefill_us"],
            "engine_recordings": eng.recordings,
            "engine_programs": eng.program_count(),
            "engine_eager_reason": eng.eager_reason}
        del dec, dec32, eng
    for j, dt in enumerate(("float32", "bfloat16")):
        want, got = logits["one"][j], logits["tp"][j]
        if j:
            want, got = want[0], got[0]
        scale = float(np.abs(want).max())
        out[f"first_logits_err_{dt}"] = float(np.abs(got - want).max()
                                              / scale)
    lg_one, lg_tp = logits["one"][1], logits["tp"][1]
    out["partings"] = {
        "decoder": token_partings(out["one"]["tokens"], out["tp"]["tokens"],
                                  lg_one, lg_tp),
        "engine": token_partings(out["one"]["engine_tokens"],
                                 out["tp"]["engine_tokens"], lg_one, lg_tp,
                                 (out["one"]["tokens"], out["tp"]["tokens"]))}
    out["flash"] = _flash_counts()
    return out


def token_partings(want, got, lg_want, lg_got, decoded=None):
    """Where two greedy decodes of the same prompts part: for each row, its
    first step whose tokens differ, with ``want``'s logit gap between the
    two tokens there and the largest difference of the two runs' logits at
    that row and step.  A parting is a rounding tie when the gap is at
    most twice that difference: the two runs' rounding alone can swap the
    two tokens' order.  ``lg_want``/``lg_got`` are (steps, rows, vocab);
    when they are another pair of decodes' (``decoded``: their tokens),
    they hold at a row and step only while both pairs' tokens agree before
    it, and a parting elsewhere is no tie.  Rows that never part are left
    out."""
    out = []
    for b, (a, g) in enumerate(zip(want, got)):
        j = next((i for i, (x, y) in enumerate(zip(a, g)) if x != y), None)
        if j is None:
            continue
        same = decoded is None or all(
            list(d[b][:j]) == list(a[:j]) for d in decoded)
        gap = float(abs(lg_want[j, b, a[j]] - lg_want[j, b, g[j]]))
        err = float(np.abs(lg_want[j, b] - lg_got[j, b]).max())
        out.append({"row": b, "step": j, "gap": gap, "err": err,
                    "tie": bool(same and gap <= 2 * err)})
    return out


# -- embed ------------------------------------------------------------------------

def _emb_loss(out, label):
    return (out ** 2).reshape(out.shape[0], -1).sum(1)


def sample_rows(vocab):
    """The table rows the check reads: 64 spread over the vocab and the
    8 zipf ids hit most."""
    return sorted(set(np.linspace(0, vocab - 1, 64).astype(np.int64)
                      .tolist()) | set(range(1, 9)))


def embed_run(vocab, batch, device, mesh=None, rules=None, steps=EMB_STEPS,
              timed=EMB_TIMED):
    """``steps`` then ``timed`` ``ShardedTrainer`` steps of the recommender
    net at (vocab, batch) on ``mesh`` (one device for None): the losses,
    the held rows of ``sample_rows`` (each rank holds its block under
    ``EmbeddingRules``), the Dense's weights, ms a step, ids a second,
    the peak memory over what was allocated before."""
    from .. import parallel

    if device.type == "cuda":
        _sync(device)
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    net = _emb_net(vocab, EMB_DIM, device, "distemb_")
    ids = np.random.RandomState(SEED).zipf(1.3, size=(steps + timed,
                                                      batch)) % vocab
    xs = [torch.as_tensor(b.astype(np.float32), device=device) for b in ids]
    y = torch.zeros(batch, device=device)
    tr = parallel.ShardedTrainer(net, _emb_loss, "adam",
                                 {"learning_rate": 1e-3}, mesh=mesh,
                                 rules=rules)
    losses = [float(tr.step(x, y)) for x in xs[:steps]]
    name = net[0].weight.name
    i = [n for n, _ in tr._trainable].index(name)
    local = tr._local[i]
    table = local if local is not None else net[0].weight.data()._data
    first = 0 if local is None else mesh.coord("dp") * local.shape[0]
    held = {str(r): table[r - first].float().cpu().tolist()
            for r in sample_rows(vocab)
            if first <= r < first + table.shape[0]}
    dense = {k[len(net.prefix):]: p.data()._data.float().cpu().reshape(-1)
             .tolist() for k, p in net.collect_params().items()
             if "dense" in k}
    _sync(device)
    t0 = time.perf_counter()
    for x in xs[steps:]:
        tr.step(x, y)
    _sync(device)
    ms = (time.perf_counter() - t0) * 1e3 / timed
    out = {"losses": losses, "rows": held, "dense": dense,
           "ms_per_step": ms, "ids_per_sec": batch * 1e3 / ms,
           "local_rows": -1 if local is None else int(local.shape[0])}
    out["peak_gib"] = (torch.cuda.max_memory_allocated(device) - base) \
        / 2 ** 30 if device.type == "cuda" else None
    del tr, net, xs
    return out


def embed_reference(vocab, batch, device):
    """``embed_run`` on one device, the table replicated."""
    return embed_run(vocab, batch, device)


def _embed(device, world, quick):
    from ..parallel import EmbeddingRules, make_mesh

    mesh = make_mesh(dp=world)
    out = {}
    for tag, (vocab, batch) in (QUICK["emb"] if quick
                                else EMB_CONFIGS).items():
        out[tag] = embed_run(vocab, batch, device, mesh, EmbeddingRules())
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


# -- module -------------------------------------------------------------------------

def _resnet_symbol(device, quick):
    """ResNet-50 v1 (or, quick, a ResNet of one block a stage) as a
    symbol with ``SoftmaxOutput``, Xavier from seed 0, and its values."""
    from .. import context, initializer, symbol
    from ..gluon.model_zoo import vision

    # one prefix in every process, whatever nets it built before
    net = vision.get_resnet(1, 18, classes=10, prefix="dpres_") if quick \
        else vision.resnet50_v1(classes=1000, prefix="dpres_")
    net.initialize(init=initializer.Xavier(), ctx=context.context_of(device),
                   generator=torch.Generator(device=device).manual_seed(0))
    img = QUICK["mod"][2] if quick else MOD_IMAGE
    net._ensure_initialized(torch.zeros((1, 3, img, img), device=device))
    sym = symbol.SoftmaxOutput(net(symbol.var("data")),
                               symbol.var("softmax_label"), name="softmax")
    params = {k: p.data() for k, p in net.collect_params().items()}
    return sym, params, (10 if quick else 1000)


def module_data(quick):
    """(x, y): ``MOD_STEPS`` global batches of ``MOD_GLOBAL`` images."""
    G, steps, img = QUICK["mod"] if quick else (MOD_GLOBAL, MOD_STEPS,
                                                MOD_IMAGE)
    rs = np.random.RandomState(SEED + 80)
    x = rs.standard_normal((G * steps, 3, img, img)).astype(np.float32)
    y = rs.randint(0, 10 if quick else 1000, G * steps).astype(np.float32)
    return x, y


def _block_rows(n, G, world, rank):
    b = G // world
    return np.concatenate([np.arange(k, k + G)[rank * b:(rank + 1) * b]
                           for k in range(0, n, G)])


def module_sample(args):
    """The first ``SAMPLE`` values of each of ``MOD_SAMPLED`` (or, for
    another net, of its first and last weights), f64 lists."""
    names = [n for n in MOD_SAMPLED if n in args] or \
        [n for n in sorted(args) if n.endswith("weight")][::4]
    return {n: args[n]._data.reshape(-1)[:SAMPLE].double().cpu().tolist()
            for n in names}


def _module(device, world, rank, quick):
    from .. import context, io, module

    G = QUICK["mod"][0] if quick else MOD_GLOBAL
    sym, params, _ = _resnet_symbol(device, quick)
    x, y = module_data(quick)
    idx = _block_rows(len(x), G, world, rank)
    before = module_sample(params)
    mod = module.Module(sym, context=context.context_of(device))
    it = io.NDArrayIter(x[idx], y[idx], batch_size=G // world,
                        label_name="softmax_label")
    args = {k: v for k, v in params.items() if k in sym.list_arguments()}
    aux = {k: v for k, v in params.items()
           if k in sym.list_auxiliary_states()}
    _sync(device)
    t0 = time.perf_counter()
    mod.fit(it, num_epoch=1, kvstore="dist_sync", optimizer="sgd",
            optimizer_params=dict(MOD_SGD, rescale_grad=1.0 / G),
            arg_params=args, aux_params=aux)
    _sync(device)
    ms = (time.perf_counter() - t0) * 1e3 / (len(x) // G)
    got, _ = mod.get_params()
    return {"before": before, "after": module_sample(got),
            "ms_per_step": ms, "workers": mod._kvstore.num_workers,
            "local_batch": G // world}


def module_reference(device, world=2, ranks=None, quick=False):
    """The one-rank counterpart of ``module``: a ``Module`` bound at the
    block size runs each global batch's blocks of ``ranks`` (default
    all) one after another, sums their gradients and updates once, under
    the same rescale; returns the sample after the steps."""
    from .. import context, io, module
    from ..ndarray.ndarray import NDArray

    G = QUICK["mod"][0] if quick else MOD_GLOBAL
    ranks = list(range(world)) if ranks is None else list(ranks)
    sym, params, _ = _resnet_symbol(device, quick)
    x, y = module_data(quick)
    ctx = context.context_of(device)
    b = G // world
    mod = module.Module(sym, context=ctx)
    mod.bind(data_shapes=[("data", (b,) + x.shape[1:])],
             label_shapes=[("softmax_label", (b,))])
    mod.init_params(arg_params={k: v for k, v in params.items()
                                if k in sym.list_arguments()},
                    aux_params={k: v for k, v in params.items()
                                if k in sym.list_auxiliary_states()})
    mod.init_optimizer(kvstore=None, optimizer="sgd",
                       optimizer_params=dict(MOD_SGD, rescale_grad=1.0 / G))
    grads = mod._exec.grad_dict
    for k in range(0, len(x), G):
        total = None
        for r in ranks:
            rows = np.arange(k, k + G)[r * b:(r + 1) * b]
            batch = io.DataBatch(
                data=[NDArray(torch.as_tensor(x[rows], device=device), ctx)],
                label=[NDArray(torch.as_tensor(y[rows], device=device),
                               ctx)])
            mod.forward_backward(batch)
            cur = {n: g._data.detach().clone() for n, g in grads.items()
                   if g is not None}
            total = cur if total is None else {
                n: total[n] + cur[n] for n in cur}
        with torch.no_grad():
            for n, g in grads.items():
                if g is not None:
                    g._data.copy_(total[n])
        mod.update()
    got, _ = mod.get_params()
    return module_sample(got)


# -- activations ----------------------------------------------------------------------

def _shard_act(device, world, quick):
    from .. import context, initializer, parallel
    from ..gluon import nn
    from ..ndarray.ndarray import NDArray

    C, F, B, T = (8, 16, 2, 4) if quick else (768, 3072, 8, 512)
    mesh = parallel.make_mesh(tp=world)
    ctx = context.context_of(device)
    net = nn.HybridSequential(prefix="act_")
    with net.name_scope():
        net.add(nn.Dense(F, in_units=C, flatten=False),
                nn.Dense(C, in_units=F, flatten=False))
    net.initialize(init=initializer.Xavier(), ctx=ctx,
                   generator=torch.Generator(device=device).manual_seed(0))
    net.cast("bfloat16")
    x = NDArray(torch.as_tensor(np.random.RandomState(SEED + 90)
                                .standard_normal((B, T, C)),
                                dtype=torch.bfloat16, device=device), ctx)
    up = net[0]
    full, out_full = up(x)._data, net(x)._data

    def spec(t):
        got = getattr(t, "partition_spec", None)
        return None if got is None else list(got)

    up.shard_activations((None, None, "tp"), mesh)
    sharded = up(x)._data
    _sync(device)
    t0 = time.perf_counter()
    up(x)
    _sync(device)
    ms = (time.perf_counter() - t0) * 1e3
    whole = net(x)._data
    up.shard_activations((None, None, "dp"), mesh)   # no dp axis
    noop = up(x)._data
    up.shard_activations((None, None, "tp"), None)   # no default mesh
    no_mesh = up(x)._data
    up._act_spec = None
    parallel.annotate_activations(net, parallel.ShardingRules(
        rules=[(r"dense0$", (None, None, "tp"))]), mesh)
    annotated = net(x)._data
    return {
        "shape": [B, T, C, F], "ms_annotated": ms,
        "specs": {"sharded": spec(sharded), "noop": spec(noop),
                  "no_mesh": spec(no_mesh)},
        "sharded_bitwise": bool(torch.equal(sharded, full)),
        "whole_bitwise": bool(torch.equal(whole, out_full)),
        "noop_bitwise": bool(torch.equal(noop, full)),
        "no_mesh_bitwise": bool(torch.equal(no_mesh, full)),
        "annotated_bitwise": bool(torch.equal(annotated, out_full))}


# -- the rank ----------------------------------------------------------------------

def rank_main(args):
    from .. import distributed
    from ..parallel.mesh import rank_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert distributed.init_from_env()
    rank, world = distributed.rank(), distributed.num_workers()
    import torch.distributed as dist

    device = rank_device()
    res = {"rank": rank, "world": world, "backend": dist.get_backend(),
           "device": str(device), "seconds": {}}
    for name, fn in (("prefetch", lambda: _prefetch(device, world, rank,
                                                    args.quick)),
                     ("decode", lambda: _decode(device, world, args.quick)),
                     ("embed", lambda: _embed(device, world, args.quick)),
                     ("module", lambda: _module(device, world, rank,
                                                args.quick)),
                     ("shard_act", lambda: _shard_act(device, world,
                                                      args.quick))):
        t0 = time.perf_counter()
        res[name] = fn()
        res["seconds"][name] = time.perf_counter() - t0
        if device.type == "cuda":
            torch.cuda.empty_cache()
        distributed.barrier(f"dist_paths_{name}")
    with open(os.path.join(args.out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    distributed.barrier("dist_paths_end")


def drive(workdir, world=2, quick=False, cpu=False, timeout=900.0,
          collective_timeout=120):
    """Run a gang of ``world`` rank processes of this tool and return
    ``[result of rank r]`` (``dist_bert.drive_ranks``)."""
    from .dist_bert import drive_ranks

    env = {"MXTPU_RENDEZVOUS_TIMEOUT": str(collective_timeout)}
    if cpu:
        env["OMP_NUM_THREADS"] = "1"
    return drive_ranks(
        "mxnet_tpu_torch.tools.dist_paths", workdir, world,
        (["--quick"] if quick else []) + (["--cpu"] if cpu else []),
        env=env, timeout=timeout)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    if args.cpu:
        from .. import context

        torch.set_num_threads(1)
        with context.cpu():
            rank_main(args)
    else:
        rank_main(args)


if __name__ == "__main__":
    main()
