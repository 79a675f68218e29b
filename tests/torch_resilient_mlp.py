"""``examples/train_resilient.py``'s MLP, for either package.

``build(pkg, weights=...)`` returns the example's ``(step_fn, get_state,
set_state, trainer)``: four Gaussian blobs in 16 dimensions, a
Dense(32, relu) -> Dense(4) MLP trained by SGD at lr 0.1, 64 samples a
batch.  The layers declare their input widths so the weights exist at
once: ``weights`` (a list of arrays in parameter order) sets them, so both
packages start from the same point.  Run as a script it trains under
``run_resilient`` and, with ``--crash-after N``, arms
``crash_during_save`` once N steps have run, so the process dies in the
next save's shard write (exit code 57).
"""

import argparse
import importlib
import os
import sys

import numpy as np


def build(pkg, weights=None, batch_size=64, seed=7, nan_step=None):
    mx = importlib.import_module(pkg)
    from contextlib import nullcontext

    ctx = mx.cpu() if pkg.endswith("_torch") else nullcontext()
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-2, 2, (4, 16)).astype(np.float32)
    y = rng.randint(0, 4, 1024)
    x = centers[y] + rng.normal(0, 0.5, (1024, 16)).astype(np.float32)
    with ctx:
        batches = [(mx.nd.array(x[i:i + batch_size]),
                    mx.nd.array(y[i:i + batch_size].astype(np.float32)))
                   for i in range(0, 1024, batch_size)]
        nn = mx.gluon.nn
        net = nn.HybridSequential()
        with net.name_scope():
            net.add(nn.Dense(32, activation="relu", in_units=16),
                    nn.Dense(4, in_units=32))
        mx.random.seed(seed)
        net.initialize(init=mx.init.Xavier())
    params = list(net.collect_params().values())
    if weights is not None:
        with ctx:
            for p, w in zip(params, weights):
                p.set_data(mx.nd.array(w))
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def step_fn(step):
        if nan_step is not None and step == nan_step:
            os.environ["MXTPU_FAULT_INJECT"] = "nan_grad:1"
            mx.resilience.reset_faults()
        data, label = batches[step % len(batches)]
        with ctx:
            with mx.autograd.record():
                loss = loss_fn(net(data), label)
            loss.backward()
            trainer.step(data.shape[0])
            return float(loss.asnumpy().mean())

    def get_state():
        return [p.data().asnumpy() for p in params]

    def set_state(state):
        with ctx:
            for p, v in zip(params, state):
                p.set_data(mx.nd.array(v))

    return step_fn, get_state, set_state, trainer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("pkg")
    ap.add_argument("ckpt_dir")
    ap.add_argument("weights")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--crash-after", type=int, default=10)
    args = ap.parse_args()
    mx = importlib.import_module(args.pkg)
    weights = list(np.load(args.weights).values())
    step_fn, get_state, set_state, _tr = build(args.pkg, weights)

    def armed_step(step):
        if step == args.crash_after:
            os.environ["MXTPU_FAULT_INJECT"] = "crash_during_save"
            mx.resilience.reset_faults()
        return step_fn(step)

    ck = mx.checkpoint.make_checkpointer(args.ckpt_dir, max_to_keep=3)
    mx.resilience.run_resilient(armed_step, ck, args.steps,
                                get_state=get_state, set_state=set_state,
                                checkpoint_every=10)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.exit(main())
