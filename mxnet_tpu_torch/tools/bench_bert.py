"""BERT-base pretraining throughput on one card: the port's counterpart of
the JAX package's ``bench_bert`` (``bench.py``), same configuration and
timing.

    python3 -m mxnet_tpu_torch.tools.bench_bert [--batch 32] [--seq 512]
        [--steps 10] [--attn flash] [--dtype bfloat16] [--f32-reductions]
        [--path sharded|gluon|captured]

prints one JSON line: ``metric``
``bert_base_pretrain_tokens_per_sec_per_chip``, ``impl`` ``torch``, the
``path``,
``value`` (tokens/s), the final ``loss`` and the whole trajectory,
``ms_per_step``, ``peak_mem_gib``, the card's name and power
limit as ``nvidia-smi`` reads them, and ``mfu``.  ``--f32-reductions``
sets ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
to False for the process (cuBLAS then reduces split-K bf16 GEMMs in f32;
the library itself leaves the flag at torch's default); the line says
which way it ran.

The model: ``bert_base(dropout=0.0, max_length=seq, scan_layers=True,
attention_impl=attn)`` (a Gluon block), ``initialize(init=Xavier())``,
``cast(dtype)``.  ``--path`` picks how it trains, AdamW with lr 1e-4 and
wd 0.01 on ``BERTPretrainLoss`` over ``(tokens, (mlm_labels,
nsp_labels))`` every time:

- ``sharded`` (default): ``ShardedTrainer(..., mesh=data_parallel_mesh(1))``,
  its update in f32 on the bf16 weights;
- ``gluon``: the eager Gluon loop, ``autograd.record()``, ``backward()``,
  ``gluon.Trainer(net.collect_params(), "adamw", {..., "multi_precision":
  True}).step(batch)`` (f32 master weights and states, the grouped update);
- ``captured``: the same trainer's ``train_step`` on the hybridized block,
  one CUDA graph a step.
  The data is ``bench_bert``'s:
``RandomState(0)`` tokens in [0, 30000), 15% MLM labels (the rest -1) and
NSP labels in {0, 1}, one batch repeated; the weights are drawn from
seed 0 too, so two runs start from the same step.  The timing is ``_measure``'s:
two warm-up steps each ended by a readback, then ``steps`` steps closed by
``torch.cuda.synchronize()`` and one readback.  An MFU above ``MFU_GATE``
means the clock stopped before the card finished: ``run`` then raises.

MFU counts ``bench_bert``'s matmul FLOPs, 3 (2 * 110e6 + 12 * 2 * 2 * T *
768) per token, against the H100's dense bf16 tensor-core peak; it is
null on another card and on the host.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from .. import context
from ..gluon.model_zoo import bert
from ..initializer import Xavier
from ..parallel import ShardedTrainer, data_parallel_mesh

METRIC = "bert_base_pretrain_tokens_per_sec_per_chip"
H100_BF16_PEAK = 989e12            # dense bf16 tensor-core FLOP/s, H100 SXM
MFU_GATE = 0.7


def flops_per_step(batch, seq):
    """``bench_bert``'s FLOP count of one BERT-base training step."""
    n_params = 110e6
    attn_flops = 12 * 2 * 2 * seq * 768      # per token: QK^T + PV
    return 3.0 * (2 * n_params + attn_flops) * batch * seq


def make_data(batch, seq, vocab, device, seed=0):
    """``bench_bert``'s batch: (tokens, (mlm_labels, nsp_labels)) as int64
    tensors on ``device``; token ids below min(30000, vocab)."""
    rng = np.random.RandomState(seed)
    top = min(30000, vocab)
    tokens = rng.randint(0, top, (batch, seq))
    mlm = np.full((batch, seq), -1, np.int64)
    mask = rng.rand(batch, seq) < 0.15
    mlm[mask] = rng.randint(0, top, int(mask.sum()))
    nsp = rng.randint(0, 2, (batch,))
    return tuple(torch.as_tensor(a, dtype=torch.int64, device=device)
                 for a in (tokens, mlm, nsp))


def mfu(flops, seconds, device_name):
    """Model FLOP utilisation of ``flops`` done in ``seconds`` on the card
    named ``device_name``: None off an H100.  Raises above ``MFU_GATE``,
    where the clock stopped before the card finished."""
    if not (device_name and "H100" in device_name):
        return None
    got = flops / seconds / H100_BF16_PEAK
    if got > MFU_GATE:
        raise RuntimeError(f"MFU {got:.3f} above {MFU_GATE}: the timing "
                           f"ended before the card finished the steps")
    return got


def _net(seq, attn, dtype, device, seed, dropout=0.0):
    net = bert.bert_base(dropout=dropout, max_length=seq, scan_layers=True,
                         attention_impl=attn, device=device)
    dev = net.word_embed_weight.data()._data.device
    net.initialize(init=Xavier(),
                   generator=torch.Generator(device=dev).manual_seed(seed))
    net.cast(dtype)
    return net, dev


def build(batch=32, seq=512, attn="flash", dtype="bfloat16", device=None,
          seed=0):
    """The bench's trainer and batch: returns (trainer, tokens, (mlm_labels,
    nsp_labels)).  The weights are drawn from ``seed``, the data from
    ``RandomState(seed)``."""
    net, dev = _net(seq, attn, dtype, device, seed)
    with context.context_of(dev):
        mesh = data_parallel_mesh(1)
    trainer = ShardedTrainer(net, bert.BERTPretrainLoss(), "adamw",
                             {"learning_rate": 1e-4, "wd": 0.01}, mesh=mesh)
    tokens, mlm, nsp = make_data(batch, seq, net._vocab, dev, seed)
    return trainer, tokens, (mlm, nsp)


PATHS = ("sharded", "gluon", "captured")
#: gluon.Trainer's optimizer: bench_bert's AdamW, with f32 master weights
GLUON_ADAMW = {"learning_rate": 1e-4, "wd": 0.01, "multi_precision": True}


def build_gluon(batch=32, seq=512, attn="flash", dtype="bfloat16",
                device=None, seed=0, dropout=0.0):
    """The bench's model on ``gluon.Trainer``: returns (net, trainer,
    loss_fn, tokens, (mlm_labels, nsp_labels)), the data as NDArrays; the
    net is hybridized (``train_step`` captures it)."""
    from .. import gluon
    from ..ndarray.ndarray import NDArray

    net, dev = _net(seq, attn, dtype, device, seed, dropout)
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "adamw", dict(GLUON_ADAMW))
    ctx = context.context_of(dev)
    tokens, mlm, nsp = make_data(batch, seq, net._vocab, dev, seed)
    return (net, trainer, bert.BERTPretrainLoss(), NDArray(tokens, ctx),
            (NDArray(mlm, ctx), NDArray(nsp, ctx)))


def step_fn(path, batch=32, seq=512, attn="flash", dtype="bfloat16",
            device=None):
    """One training step of ``path`` as a closure returning the loss (a
    0-dim tensor or NDArray)."""
    if path == "sharded":
        trainer, tokens, labels = build(batch, seq, attn, dtype, device)
        return lambda: trainer.step(tokens, labels)
    from .. import autograd

    net, trainer, loss_fn, tokens, labels = build_gluon(
        batch, seq, attn, dtype, device)
    if path == "captured":
        return lambda: trainer.train_step(net, loss_fn, tokens, labels)

    def eager():
        with autograd.record():
            loss = loss_fn(net(tokens), labels)
        loss.backward()
        trainer.step(batch)
        return loss

    return eager


def card_line():
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def measure(build, steps, device, work, flops, **fields):
    """Time ``steps`` training steps as ``bench.py``'s ``_measure`` does and
    return the result line as a dict.  ``build()`` makes the step function
    (after the peak-memory counter is reset, so the peak counts the build);
    two warm-up steps each end in a readback, then ``steps`` steps are
    closed by ``torch.cuda.synchronize()`` and one readback.  ``value`` is
    ``work`` units a step over the timed seconds; ``mfu`` counts ``flops``
    a step.  ``fields`` (the metric, the unit, the configuration) open the
    line."""
    dev = context.resolve(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)   # the context the reset needs
        torch.cuda.reset_peak_memory_stats(dev)
    step = build()
    warm = [float(step()) for _ in range(2)]    # each ends in a readback
    t0 = time.perf_counter()
    outs = [step() for _ in range(steps)]
    if cuda:
        torch.cuda.synchronize(dev)
    float(outs[-1])
    dt = time.perf_counter() - t0
    losses = [float(x) for x in outs]
    name = torch.cuda.get_device_name(dev) if cuda else None
    return dict(
        fields,
        impl="torch",
        value=work * steps / dt,
        loss=losses[-1],
        losses=warm + losses,
        ms_per_step=dt / steps * 1e3,
        steps=steps,
        flops_per_step=flops,
        mfu=mfu(flops * steps, dt, name),
        peak_mem_gib=(torch.cuda.max_memory_allocated(dev) / 2 ** 30
                      if cuda else None),
        device=str(dev),
        device_name=name,
        nvidia_smi=card_line() if cuda else None,
    )


def run(batch=32, seq=512, steps=10, attn="flash", dtype="bfloat16",
        device=None, path="sharded"):
    """Build the bench's ``path``, time ``steps`` training steps after two
    warm-up steps, and return the result line as a dict."""
    if path not in PATHS:
        raise ValueError(f"bench_bert: path must be one of {PATHS}")
    dev = context.resolve(device)

    def build_step():
        return step_fn(path, batch, seq, attn, dtype, dev)

    return measure(
        build_step, steps, dev, batch * seq, flops_per_step(batch, seq),
        metric=METRIC, unit="tokens/sec/chip", batch=batch, seq=seq,
        attn=attn, dtype=dtype, path=path,
        bf16_reduced_precision_reduction=(
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--attn", default="flash")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--path", default="sharded", choices=PATHS)
    ap.add_argument("--f32-reductions", action="store_true",
                    help="hold cuBLAS's bf16 GEMM reductions in f32")
    args = ap.parse_args(argv)
    if args.f32_reductions:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    print(json.dumps(run(args.batch, args.seq, args.steps, args.attn,
                         args.dtype, path=args.path)), flush=True)


if __name__ == "__main__":
    main()
