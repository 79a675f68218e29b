"""Monitor: per-node output statistics during training (reference:
python/mxnet/monitor.py; installed by ``Module.fit(monitor=...)``).

Counterpart of ``mxnet_tpu/monitor.py``.  The reference hooks a callback
into every op's execution; the JAX package re-evaluates the matching
nodes at ``toc()`` because its graph is one compiled program.  Here the
graph runs op by op, so an executor with a monitor installed keeps each
node's output of its last forward, and ``toc()`` takes the statistics
from those: the very values (dropout masks included) that forward
computed, from the weights it used, whatever ran since.
"""

from __future__ import annotations

import logging
import re

import torch

from .ndarray.ndarray import NDArray


def _default_stat(x):
    return x.abs().mean()


def nonfinite_fraction(x):
    """The share of non-finite values in a node's output: with
    ``Monitor(1, stat_func=nonfinite_fraction)`` the first layer that
    produces NaN or Inf shows."""
    return 1.0 - torch.isfinite(x.float()).float().mean()


class Monitor:
    """Statistics of the outputs of the nodes whose names match
    ``pattern``, every ``interval`` batches: ``stat_func`` (tensor ->
    scalar, default mean |x|); ``sort`` orders them by name."""

    def __init__(self, interval, stat_func=None, pattern=".*",
                 sort=False):
        self.interval = int(interval)
        self.stat_func = stat_func or _default_stat
        self.re_pattern = re.compile(pattern)
        self.sort = sort
        self.queue = []
        self.step = 0
        self.activated = False
        self._exes = []

    def install(self, exe):
        """Watch ``exe``.  An executor of the same symbol (a rebind)
        replaces the one watched before."""
        for e in self._exes:
            if e is exe or e._symbol is exe._symbol:
                e._monitors = [m for m in e._monitors if m is not self]
        self._exes = [e for e in self._exes
                      if e is not exe and e._symbol is not exe._symbol]
        self._exes.append(exe)
        if self not in exe._monitors:
            exe._monitors.append(self)

    def tic(self):
        """Start collecting for this batch if the interval hits."""
        if self.step % self.interval == 0:
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self):
        """The statistics of the watched executors' last forwards:
        (step, node output name, NDArray scalar) triples."""
        if not self.activated:
            return []
        res = []
        for exe in self._exes:
            values = exe._node_values or {}
            for node in exe._symbol._topo():
                if node.op is None or node.name not in values \
                        or not self.re_pattern.match(node.name):
                    continue
                out = values[node.name]
                outs = list(out) if isinstance(out, (tuple, list)) \
                    else [out]
                for i, o in enumerate(outs):
                    if not isinstance(o, torch.Tensor):
                        continue
                    name = node.name + (f"_output{i}" if len(outs) > 1
                                        else "_output")
                    with torch.no_grad():
                        stat = self.stat_func(o.detach())
                    res.append((self.step, name,
                                NDArray(torch.as_tensor(stat), exe._ctx)))
        self.activated = False
        if self.sort:
            res.sort(key=lambda t: t[1])
        self.queue = res
        return res

    def toc_print(self):
        """Collect and log."""
        for step, name, stat in self.toc():
            val = stat.asnumpy() if isinstance(stat, NDArray) else stat
            logging.info("Batch: %7d %30s %s", step, name, str(val))
