"""Sequence, pipeline and expert parallelism over a gang of ranks, one
process a rank: the sibling of ``tools/dist_bert.py`` for the sp, pp and
ep axes.

    python3 -m mxnet_tpu_torch.tools.dist_sp_pp_ep --rank R --world N
        --out DIR [--steps 3] [--timed 5] [--synced 2] [--quick] [--cpu]

with the launch variables ``MXTPU_COORDINATOR`` / ``MXTPU_NUM_WORKERS`` /
``MXTPU_WORKER_RANK`` set (``drive`` sets them).  Each rank joins the
process group (the backend by ``distributed.backend_rule``: gloo when the
ranks share one card) and runs six paths:

- ``sp_ring`` and ``sp_ulysses``: GPT-2 small (12 layers, 768 wide, 12
  heads, vocab 50257) at B=8, T=1024 with ``attention_impl="ring"`` /
  ``"ulysses"`` through ``ShardedTrainer`` on an sp=N mesh, each rank
  holding T/N positions of every sequence;
- ``pp_gpipe`` and ``pp_1f1b``: BERT-base through ``bert_pipeline_parts``
  (12 encoder layers split over the N stages, T=512, a global batch of 32
  in 4 microbatches, ``attention_impl="flash"``) through
  ``PipelineTrainer``;
- ``ep_k1`` and ``ep_k2``: a Dense layer then ``MoEFFN`` at
  Switch-Base-8's widths (768 wide, expert hidden 3072, 8 experts,
  capacity factor 1.25) over 32 x 512 tokens through ``ShardedTrainer``
  with ``MOE_EP_RULES`` on an ep=N mesh, top-1 and top-2.

In order:

- ``probe``: the collectives the backend accepts on the rank's tensors,
  ``ppermute`` among them (``parallel.collectives.probe``);
- ``check``: every path in f32 with dropout 0, ``--steps`` AdamW steps on
  global batches from a seed: the losses, a fixed sample of the trained
  parameters, a fixed sample of the gradients the first update applies
  (of each parameter this rank updates whose name ends as one of
  ``SAMPLED``'s) and each flash kernel's launches a step on this rank;
- ``timing``: every path in bf16, 2 warm-up and ``--timed`` timed steps:
  ms a step (median, min, max), the bytes the step moved in collectives,
  the peak memory, the pipeline's bubble fraction; then ``--synced`` steps
  under ``collectives.timed_collectives`` for the collectives' own
  seconds.

The rank writes ``DIR/rank<R>.json``.  ``drive`` starts the gang and
returns the results; ``reference`` runs a path's one-rank counterpart on
the same global batches (flash attention on the whole sequence for sp,
``ShardedTrainer`` with ``grad_accum`` at the same microbatches for pp,
all experts on one rank for ep) for the caller to hold the ranks against
with ``excess``.
Every BERT sequence has the same number of masked tokens, so the MLM
loss of a microbatch, of the batch and of a rank's block agree.
``--quick`` runs the paths at tiny widths (a rehearsal on the host with
``--cpu``).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time

import numpy as np
import torch

SEED = 0
ADAMW = {"learning_rate": 1e-4, "wd": 0.01}
PATHS = ("sp_ring", "sp_ulysses", "pp_gpipe", "pp_1f1b", "ep_k1", "ep_k2")
SAMPLE = 512
MICRO = 4
#: ``excess``'s tolerances: rtol and atol on the losses and on the
#: sampled parameters; rtol and atol on the first update's sampled
#: gradients, the atol times the largest |gradient| of the parameter's
#: sample (a gradient's scale is the parameter's own: Adam's first
#: updates move each parameter by about lr times the sign of its
#: gradient, so the losses and parameters alone hold a gradient only to
#: its sign)
LOSS_TOL, PARAM_TOL, GRAD_TOL = (2e-4, 2e-5), (2e-3, 2e-4), (2e-3, 2e-4)
#: the widths of each family, full and ``--quick``
GPT = {"full": dict(vocab_size=50257, units=768, num_layers=12,
                    num_heads=12, max_length=1024, batch=8, seq=1024),
       "quick": dict(vocab_size=128, units=32, num_layers=2, num_heads=2,
                     max_length=64, batch=4, seq=64)}
BERT = {"full": dict(vocab_size=30522, units=768, num_layers=12,
                     num_heads=12, max_length=512, batch=32, seq=512),
        "quick": dict(vocab_size=64, units=16, num_layers=4, num_heads=2,
                      max_length=16, batch=8, seq=16)}
MOE = {"full": dict(units=768, hidden=3072, experts=8, cf=1.25, batch=32,
                    seq=512),
       "quick": dict(units=8, hidden=16, experts=4, cf=1.25, batch=4,
                     seq=8)}


def _size(quick):
    return "quick" if quick else "full"


def _gen(device):
    return torch.Generator(device=device).manual_seed(SEED)


def family(path):
    return path.split("_")[0]


def build(path, device, quick=False, dtype="float32"):
    """The path's model drawn from ``SEED`` on ``device``: a GPT model, the
    (prologue, stages, epilogue) of a BERT, or a Dense + MoEFFN stack."""
    from .. import context
    from ..gluon import nn
    from ..gluon.contrib import MoEFFN
    from ..gluon.model_zoo import bert, gpt
    from ..initializer import Normal, Xavier

    kind, size = family(path), _size(quick)
    dev = torch.device(device)
    if kind == "sp":
        c = GPT[size]
        impl = "flash" if path == "sp_flash" else path.split("_")[1]
        net = gpt.GPTModel(prefix="gpt_", vocab_size=c["vocab_size"],
                           units=c["units"],
                           num_layers=c["num_layers"],
                           num_heads=c["num_heads"],
                           max_length=c["max_length"], dropout=0.0,
                           attention_impl=impl, device=device)
        net.initialize(init=Normal(0.02), generator=_gen(dev))
        parts = [net]
    elif kind == "pp":
        c = BERT[size]
        embed, layers, head = bert.bert_pipeline_parts(
            vocab_size=c["vocab_size"], units=c["units"],
            num_layers=c["num_layers"], num_heads=c["num_heads"],
            max_length=c["max_length"], dropout=0.0,
            attention_impl="flash", device=device)
        parts = [embed] + layers + [head]
        for b in parts:
            b.initialize(init=Xavier(), force_reinit=True,
                         generator=_gen(dev))
        net = (embed, layers, head)
    else:
        c = MOE[size]
        net = nn.HybridSequential(prefix="moe_")
        with net.name_scope():
            net.add(nn.Dense(c["units"], activation="relu",
                             in_units=c["units"], flatten=False),
                    MoEFFN(units=c["units"], hidden=c["hidden"],
                           num_experts=c["experts"],
                           k=int(path.split("_k")[1]),
                           capacity_factor=c["cf"]))
        net.initialize(init=Xavier(), ctx=context.context_of(dev),
                       generator=_gen(dev))
        parts = [net]
    if dtype != "float32":
        for b in parts:
            b.cast(dtype)
    return net


def batches(path, steps, device, quick=False, dtype="float32"):
    """``steps`` global batches (data, label) of the path's family."""
    rng = np.random.RandomState(SEED + 1)
    kind, size = family(path), _size(quick)
    out = []
    for _ in range(steps):
        if kind == "sp":
            c = GPT[size]
            ids = torch.as_tensor(rng.randint(0, min(30000, c["vocab_size"]),
                                              (c["batch"], c["seq"])),
                                  device=device)
            out.append((ids, ids))
        elif kind == "pp":
            c = BERT[size]
            B, T = c["batch"], c["seq"]
            top = min(30000, c["vocab_size"])
            tokens = rng.randint(0, top, (B, T))
            mlm = np.full((B, T), -1, np.int64)
            k = max(1, round(0.15 * T))
            for b in range(B):
                mlm[b, rng.choice(T, k, replace=False)] = \
                    rng.randint(0, top, k)
            out.append((torch.as_tensor(tokens, device=device),
                        torch.as_tensor(mlm, device=device)))
        else:
            c = MOE[size]
            shape = (c["batch"], c["seq"], c["units"])
            x = torch.as_tensor(rng.randn(*shape).astype(np.float32),
                                device=device)
            y = torch.as_tensor(rng.randn(*shape).astype(np.float32) * 0.5,
                                device=device)
            out.append((x.to(getattr(torch, dtype)),
                        y.to(getattr(torch, dtype))))
    return out


def sample_index(numel):
    return np.random.RandomState(SEED + 2).randint(0, numel, SAMPLE)


def _sample(full):
    flat = full.detach().float().reshape(-1).cpu().numpy()
    return flat[sample_index(flat.size)].tolist()


#: the sampled parameters of each family, by name suffix
SAMPLED = {"sp": ("tok_embed_weight", "trunk_layer0_qkv_weight",
                  "ffn2_weight", "trunk_layernorm0_gamma"),
           "pp": ("word_embed_weight", "pplayer0_qkv_weight",
                  "qkv_weight", "decoder_weight"),
           "ep": ("dense0_weight", "gate_weight", "expert_ffn1_weight",
                  "expert_ffn2_weight")}


def _samples(named, kind):
    """{suffix: sample} of the first parameter whose name ends with each
    sampled suffix (the last one's for the pp stages' qkv, which every
    stage has)."""
    out = {}
    for suffix in SAMPLED[kind]:
        hits = [v for n, v in named if n.endswith(suffix)]
        if hits:
            out[suffix] = _sample(hits[-1] if suffix == "qkv_weight"
                                  else hits[0])
    return out


def _grad_samples(named, kind):
    """{name: sample} of every (name, gradient) whose name ends with one of
    the family's sampled suffixes."""
    return {n: _sample(g) for n, g in named
            if any(n.endswith(sfx) for sfx in SAMPLED[kind])}


def _record_first_grads(trainer, named):
    """Spy on ``trainer``'s optimizer: the first update's gradients go to
    the returned dict as ``named(grads)``'s {name: sample} (``named`` pairs
    the update's gradients with their names, in its order)."""
    out = {}
    apply = trainer.optimizer.apply

    def spy(params, grads, *args):
        if not out:
            out.update(named(grads))
        return apply(params, grads, *args)

    trainer.optimizer.apply = spy
    return out


def _excess(got, want, rtol, atol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) - rtol * np.abs(want)).max() / atol)


def excess(got, ref):
    """How far one rank's ``check`` of a path lies from its one-rank
    ``reference``: {"loss", "params", "grads"}, each the largest
    (|got - want| - rtol |want|) / atol over its values, <= 1 within
    ``LOSS_TOL``, ``PARAM_TOL`` and ``GRAD_TOL``; the gradients over the
    parameters this rank updates."""
    grads = [_excess(g, ref["grads"][n], GRAD_TOL[0],
                     GRAD_TOL[1] * max(np.abs(ref["grads"][n]).max(), 1e-30))
             for n, g in got["grads"].items()]
    return {"loss": _excess(got["losses"], ref["losses"], *LOSS_TOL),
            "params": max(_excess(got["samples"][k], v, *PARAM_TOL)
                          for k, v in ref["samples"].items()),
            "grads": max(grads) if grads else float("inf")}


def _flash():
    from ..ops import flash_attention as fa

    return (fa.flash_attention_fwd, fa.flash_attention_dq,
            fa.flash_attention_dkv)


def _zero_flash():
    for fn in _flash():
        fn.launches = 0


def _flash_counts():
    return {fn.__name__: fn.launches for fn in _flash()}


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _loss_fn(path):
    from ..gluon.loss import L2Loss
    from ..gluon.model_zoo import bert, gpt

    return {"sp": gpt.GPTLMLoss, "pp": bert.BERTMLMLoss,
            "ep": L2Loss}[family(path)]()


def reference(path, steps, device, quick=False):
    """The one-rank counterpart of ``path`` on the same global batches:
    losses and the samples."""
    from .. import parallel
    from ..gluon import nn

    kind = family(path)
    net = build("sp_flash" if kind == "sp" else path, device, quick)
    kw = {}
    if kind == "pp":
        embed, layers, head = net
        seq = nn.HybridSequential(prefix="ppref_")
        for b in [embed] + layers + [head]:
            seq.add(b)
        net, kw = seq, {"grad_accum": MICRO}
    tr = parallel.ShardedTrainer(net, _loss_fn(path), "adamw", dict(ADAMW),
                                 **kw)
    grads = _record_first_grads(tr, lambda gs: _grad_samples(
        zip([n for n, _ in tr._trainable], gs), kind))
    losses = [float(tr.step(x, y))
              for x, y in batches(path, steps, device, quick)]
    out = {"losses": losses, "grads": grads,
           "samples": _samples([(n, p._value()) for n, p in
                                net.collect_params().items()], kind)}
    del tr, net
    return out


def _path_trainer(path, world, device, quick, dtype="float32"):
    """(step(x, y) -> loss, samples(), extra numbers, the first update's
    gradient samples (filled by the first step)) for one path."""
    from .. import parallel

    kind = family(path)
    net = build(path, device, quick, dtype)
    loss_fn = _loss_fn(path)
    if kind == "pp":
        from ..gluon import nn

        embed, layers, head = net
        trunk = nn.HybridSequential(prefix="pptrunk_")
        for layer in layers:
            trunk.add(layer)
        mesh = parallel.make_mesh(pp=world)
        # the trunk's layers split evenly into the world's stages
        pt = parallel.PipelineTrainer(
            trunk, loss_fn, "adamw", dict(ADAMW), mesh=mesh,
            n_microbatches=MICRO, prologue=embed, epilogue=head,
            schedule=path.split("_")[1])

        def samples():
            sd = pt.state_dict()["params"]
            return _samples(list(sd.items()), kind)

        # the update's order: this rank's stage, the prologue, the epilogue
        names = [n for b in (pt.stages[pt._pipe.s], embed, head)
                 for n, p in b.collect_params().items()
                 if p.grad_req != "null"]
        grads = _record_first_grads(
            pt, lambda gs: _grad_samples(zip(names, gs), kind))
        return pt.step, samples, lambda: {
            "bubble_fraction": pt.bubble_fraction,
            "schedule_ticks": pt.schedule_ticks}, grads
    if kind == "sp":
        mesh, kw = parallel.make_mesh(sp=world), {}
    else:
        mesh = parallel.make_mesh(ep=world)
        kw = {"rules": parallel.MOE_EP_RULES}
    tr = parallel.ShardedTrainer(net, loss_fn, "adamw", dict(ADAMW),
                                 mesh=mesh, **kw)

    def samples():
        named = [(n, t if tr._local[i] is None else tr._full(i, tr._local[i]))
                 for i, (n, t) in enumerate(tr._trainable)]
        return _samples(named, kind)

    def named(gs):
        # an ep shard's gradient gathered like its parameter (a collective
        # every rank joins)
        return _grad_samples([(n, tr._full(i, g)) for i, ((n, _), g) in
                              enumerate(zip(tr._trainable, gs))], kind)

    return tr.step, samples, lambda: {}, _record_first_grads(tr, named)


def _free(device):
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def _check(args, device, world):
    out = {}
    for path in PATHS:
        step, samples, extra, grads = _path_trainer(path, world, device,
                                                    args.quick)
        data = batches(path, args.steps, device, args.quick)
        _zero_flash()
        losses = [float(step(x, y)) for x, y in data]
        _sync(device)
        per_step = {k: v / args.steps for k, v in _flash_counts().items()}
        out[path] = {"losses": losses, "launches": per_step,
                     "samples": samples(), "grads": grads, **extra()}
        del step, samples, extra, grads
        _free(device)
    return out


def _timing(args, device, world):
    from ..parallel import collectives

    out = {}
    for path in PATHS:
        step, _, extra, _ = _path_trainer(path, world, device, args.quick,
                                          dtype="bfloat16")
        x, y = batches(path, 1, device, args.quick, dtype="bfloat16")[0]
        for _ in range(2):
            step(x, y)
        _sync(device)
        ms, coll_b, coll_s = [], [], []
        for _ in range(args.timed):
            collectives.stats(reset=True)
            t0 = time.perf_counter()
            float(step(x, y))
            _sync(device)
            ms.append((time.perf_counter() - t0) * 1e3)
            coll_b.append(collectives.stats()["bytes"])
        # the collectives' own time, in steps of their own: the card waits
        # before and after each collective, which the steps above do not
        with collectives.timed_collectives():
            for _ in range(args.synced):
                collectives.stats(reset=True)
                float(step(x, y))
                coll_s.append(collectives.stats()["seconds"])
        dev = torch.device(device)
        out[path] = {"ms_median": statistics.median(ms), "ms_min": min(ms),
                     "ms_max": max(ms), "ms": ms,
                     "collective_bytes": coll_b[-1],
                     "collective_s_median": statistics.median(coll_s),
                     "peak_mem_gib": (torch.cuda.max_memory_allocated(dev)
                                      / 2 ** 30 if dev.type == "cuda"
                                      else None), **extra()}
        del step, extra
        _free(device)
    return out


def rank_main(args):
    from .. import distributed
    from ..parallel import collectives
    from ..parallel.mesh import rank_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert distributed.init_from_env()
    rank, world = distributed.rank(), distributed.num_workers()
    import torch.distributed as dist

    device = rank_device()
    res = {"rank": rank, "world": world, "backend": dist.get_backend(),
           "device": str(device)}
    t0 = time.perf_counter()
    res["probe"] = collectives.probe(device)
    res["check"] = _check(args, device, world)
    res["check_s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    res["timing"] = _timing(args, device, world)
    res["timing_s"] = time.perf_counter() - t1
    with open(os.path.join(args.out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    distributed.barrier("dist_sp_pp_ep_end")


def drive(workdir, world=2, steps=3, timed=5, synced=2, quick=False,
          cpu=False, timeout=900.0, collective_timeout=90):
    """Run a gang of ``world`` rank processes of this tool and return
    ``[result of rank r]`` (``dist_bert.drive_ranks``).  The ranks'
    process groups time out after ``collective_timeout`` seconds
    (``MXTPU_RENDEZVOUS_TIMEOUT``), so a mismatched exchange fails the
    gang instead of hanging it."""
    from .dist_bert import drive_ranks

    env = {"MXTPU_RENDEZVOUS_TIMEOUT": str(collective_timeout)}
    if cpu:
        env["OMP_NUM_THREADS"] = "1"
    return drive_ranks(
        "mxnet_tpu_torch.tools.dist_sp_pp_ep", workdir, world,
        ["--steps", str(steps), "--timed", str(timed), "--synced",
         str(synced)] + (["--quick"] if quick else [])
        + (["--cpu"] if cpu else []), env=env, timeout=timeout)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--timed", type=int, default=5)
    ap.add_argument("--synced", type=int, default=2)
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
