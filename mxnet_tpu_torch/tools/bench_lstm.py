"""The word-level LSTM language model on one card.

    python3 -m mxnet_tpu_torch.tools.bench_lstm [--vocab 10000]
        [--embed 650] [--hidden 650] [--layers 2] [--bptt 35]
        [--batch 20] [--dropout 0.5] [--steps 20] [--warmup 2]

trains ``RNNModel`` (``examples/lstm_language_model.py``'s model:
``Embedding`` -> ``Dropout`` -> ``gluon.rnn.LSTM`` -> ``Dropout`` ->
``Dense(vocab, flatten=False)``) with ``SoftmaxCrossEntropyLoss`` and
``gluon.Trainer`` (Adam, lr 0.01, ``clip_gradient`` 0.25), Xavier from a
seed, by truncated BPTT: the hidden state is carried across windows and
detached.  The defaults are the "medium" PTB LM of Zaremba, Sutskever and
Vinyals (arXiv:1409.2329, section 4.1; MXNet's example/rnn/word_lm at
``--emsize 650 --nhid 650``) in f32.  The corpus is synthetic and seeded
(``corpus``): each token has four successors drawn once by Zipf's law, so
the model has structure to learn, the skewed frequencies first.

Prints one JSON line: ``ms_per_step`` (the median of the timed steps,
each closed by a synchronize and a readback of its loss) with
``ms_min``/``ms_max``, ``tokens_per_sec`` at the median, the first and
last windows' losses, ``peak_mem_gib`` (the run's peak allocation over
what was allocated when it began), and from one torch.profiler trace of
three steps held whole by ``trace_edges``' fences: ``busy_share`` (the
time some kernel runs on the device over host wall time),
``kernel_ms_per_step`` (the kernels' summed time), ``kernels_per_step`` and
``device_records_per_step`` (``record_function`` annotations left out);
then the card's name and power limit as
``nvidia-smi`` reads them.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import autograd, context, initializer
from ..gluon import Block, Trainer, loss, nn, rnn
from ..ndarray.ndarray import NDArray

#: the medium PTB LM (Zaremba et al. 2014, section 4.1)
MEDIUM = dict(vocab=10000, embed=650, hidden=650, layers=2, bptt=35,
              batch=20, dropout=0.5)
PROFILE_STEPS = 3


class RNNModel(Block):
    """Embedding -> Dropout -> LSTM -> Dropout -> Dense(vocab), the
    reference's word-level LM (``examples/lstm_language_model.py``)."""

    def __init__(self, vocab_size, embed_dim, hidden, layers, dropout,
                 **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.drop = nn.Dropout(dropout)
            self.encoder = nn.Embedding(vocab_size, embed_dim)
            self.rnn = rnn.LSTM(hidden, num_layers=layers,
                                dropout=dropout, input_size=embed_dim)
            self.decoder = nn.Dense(vocab_size, in_units=hidden,
                                    flatten=False)

    def forward(self, inputs, hidden):
        emb = self.drop(self.encoder(inputs))
        output, hidden = self.rnn(emb, hidden)
        output = self.drop(output)
        return self.decoder(output), hidden

    def begin_state(self, *args, **kwargs):
        return self.rnn.begin_state(*args, **kwargs)


def corpus(vocab, n_tokens, seed=0, successors=4):
    """``n_tokens`` int32 token ids: each token's next is one of its
    ``successors`` successors, chosen uniformly; the successors are drawn
    once, by Zipf's law over the ids (p(id) ~ 1 / (id + 1)), so the
    tokens' frequencies are skewed as a text's are."""
    rs = np.random.RandomState(seed)
    zipf = 1.0 / np.arange(1, vocab + 1)
    succ = rs.choice(vocab, size=(vocab, successors), p=zipf / zipf.sum())
    picks = rs.randint(0, successors, size=n_tokens)
    toks = np.empty(n_tokens, np.int32)
    tok = 0
    for i in range(n_tokens):
        toks[i] = tok
        tok = succ[tok, picks[i]]
    return toks


def batchify(data, batch_size):
    """(T, B): column b is the b-th contiguous stretch of ``data``."""
    n = len(data) // batch_size
    return data[:n * batch_size].reshape(batch_size, n).T


def build(vocab, embed, hidden, layers, dropout, device=None, seed=0):
    """The model (Xavier from ``seed``), its Adam trainer and the loss."""
    dev = context.resolve(device)
    model = RNNModel(vocab, embed, hidden, layers, dropout)
    model.initialize(init=initializer.Xavier(), ctx=context.context_of(dev),
                     generator=torch.Generator(device=dev).manual_seed(seed))
    trainer = Trainer(model.collect_params(), "adam",
                      {"learning_rate": 0.01, "clip_gradient": 0.25})
    return model, trainer, loss.SoftmaxCrossEntropyLoss()


def windows(vocab, bptt, batch, n, device=None, seed=0):
    """``n`` (input, label) BPTT windows of the seeded corpus, each
    (bptt, batch) float32 on the device."""
    dev = context.resolve(device)
    ctx = context.context_of(dev)
    data = torch.as_tensor(batchify(corpus(vocab, (n * bptt + 1) * batch,
                                           seed), batch).astype("float32"),
                           device=dev)
    return [(NDArray(data[i:i + bptt], ctx),
             NDArray(data[i + 1:i + 1 + bptt], ctx))
            for i in range(0, n * bptt, bptt)]


def train_window(model, trainer, loss_fn, hidden, x, y):
    """One truncated-BPTT step: detach the carried state, forward and
    backward under ``autograd.record()``, ``trainer.step(T * B)``.
    Returns (the per-token losses, the new hidden state)."""
    T, B = x.shape
    hidden = [h.detach() for h in hidden]
    with autograd.record():
        out, hidden = model(x, hidden)
        ls = loss_fn(out.reshape((-1, out.shape[-1])), y.reshape((-1,)))
    ls.backward()
    trainer.step(T * B)
    return ls, hidden


def run(vocab=MEDIUM["vocab"], embed=MEDIUM["embed"],
        hidden=MEDIUM["hidden"], layers=MEDIUM["layers"],
        bptt=MEDIUM["bptt"], batch=MEDIUM["batch"],
        dropout=MEDIUM["dropout"], steps=20, warmup=2, device=None, seed=0):
    """Train ``warmup + steps`` windows (and ``PROFILE_STEPS`` more under
    the profiler on a card); returns the result line as a dict."""
    dev = context.resolve(device)
    cuda = dev.type == "cuda"
    base = 0
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    model, trainer, loss_fn = build(vocab, embed, hidden, layers, dropout,
                                    dev, seed)
    extra = PROFILE_STEPS if cuda else 0
    data = windows(vocab, bptt, batch, warmup + steps + extra, dev, seed)
    state = [model.begin_state(batch_size=batch,
                               ctx=context.context_of(dev))]
    losses, times = [], []

    def step(i):
        ls, state[0] = train_window(model, trainer, loss_fn, state[0],
                                    *data[i])
        return float(ls.mean().asscalar())

    for i in range(warmup + steps):
        t0 = time.perf_counter()
        losses.append(step(i))
        if cuda:
            torch.cuda.synchronize(dev)
        if i >= warmup:
            times.append(time.perf_counter() - t0)
    ms = sorted(t * 1e3 for t in times)
    med = ms[len(ms) // 2]
    out = {
        "metric": "lstm_lm_ms_per_step",
        "impl": "torch",
        "value": med,
        "unit": "ms",
        "ms_per_step": med, "ms_min": ms[0], "ms_max": ms[-1],
        "tokens_per_sec": bptt * batch / (med / 1e3),
        "loss_first": losses[0], "loss_last": losses[-1],
        "steps_timed": steps, "warmup": warmup,
        "vocab": vocab, "embed": embed, "hidden": hidden, "layers": layers,
        "bptt": bptt, "batch": batch, "dropout": dropout, "dtype": "float32",
        "params": sum(p.data().size
                      for p in model.collect_params().values()),
        "backend": "gpu" if cuda else "cpu",
    }
    if extra:
        out.update(_profile(step, warmup + steps, extra))
    if cuda:
        from .bench_bert import card_line

        out.update(peak_mem_gib=(torch.cuda.max_memory_allocated(dev)
                                 - base) / 2 ** 30,
                   device_name=torch.cuda.get_device_name(dev),
                   nvidia_smi=card_line())
    return out


def _profile(step, first, n):
    """Busy share and launches a step over ``n`` steps, from a trace that
    ``trace_edges.kernel_records`` shows held them whole."""
    from .trace_edges import kernel_records

    wall = []

    def steps():
        t0 = time.perf_counter()
        for i in range(first, first + n):
            step(i)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)

    records = kernel_records(steps)
    # a record_function range (the trainer's "optimizer_update") shows on
    # the device timeline as an annotation spanning its kernels
    events = [e for e in records if not getattr(e, "is_user_annotation",
                                                False)]
    kernels = [e for e in events
               if not e.name.startswith(("Memcpy", "Memset"))]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    kernel_us = sum(end - start for start, end in spans)
    # the device is busy while any kernel runs: kernels that overlap
    # (cuDNN's, on streams of their own) count once
    busy_us, reach = 0, None
    for start, end in spans:
        if reach is None or start > reach:
            busy_us += end - start
            reach = end
        elif end > reach:
            busy_us += end - reach
            reach = end
    return {"busy_share": busy_us / 1e6 / wall[0],
            "kernel_ms_per_step": kernel_us / 1e3 / n,
            "kernels_per_step": len(kernels) / n,
            "device_records_per_step": len(events) / n,
            "annotations_per_step": (len(records) - len(events)) / n,
            "profiled_steps": n}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    for k, v in MEDIUM.items():
        ap.add_argument("--" + k, type=type(v), default=v)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=2)
    a = vars(ap.parse_args(argv))
    if not torch.cuda.is_available():
        raise SystemExit("bench_lstm: measures the card; no CUDA device")
    print(json.dumps(run(**a)), flush=True)


if __name__ == "__main__":
    main()
