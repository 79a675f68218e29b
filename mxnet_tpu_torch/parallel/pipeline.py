"""Pipeline parallelism: forward and training over the ranks of a pp axis.

Counterpart of ``mxnet_tpu/parallel/pipeline.py``.  The JAX package
writes the schedule as one ``lax.scan`` over the mesh's ``pp`` axis and
lets AD derive the backward; here each rank of the pp group holds its
stage and runs the schedule's ticks eagerly, the activations and their
gradients crossing stages through ``collectives.ppermute``:

- ``_schedule_1f1b`` and ``gpipe_bubble_fraction``, the JAX package's
  host-side tables and bubble, as they are;
- ``pipeline_apply``: a forward over M microbatches in M + S - 1 ticks
  (stage s runs microbatch t - s at tick t), the last stage's outputs
  broadcast to every rank; ``stack_stage_params`` stacks stage trees;
- ``PipelineTrainer`` with ``schedule="gpipe"`` (every forward, then
  every backward in reverse microbatch order, the loss over the whole
  batch as the JAX step's) or ``"1f1b"`` (the tick tables: a ready
  backward first, else a forward while fewer than S - s microbatches
  are in flight; the loss the mean of the microbatches' means).  A rank
  keeps each in-flight microbatch's graph from its forward tick to its
  backward tick, where the JAX 1F1B recomputes the stage (the same
  arithmetic; BatchNorm statistics move once, on the forward tick).

The JAX trainer replicates ``prologue`` and ``epilogue`` on every pp
device and computes them redundantly.  Here the prologue runs on the
first stage and the epilogue on the last; their gradients are broadcast
from those stages over the pp group, so every rank applies the same
update and holds the same copy.  A stage's own parameters are updated on
its rank only; ``sync_params`` broadcasts each stage's values (trainable
and aux) to every rank, and ``state_dict`` gives the full values.
``_compat`` (``shard_map``, ``pvary``) is JAX plumbing with no
counterpart here.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .. import autograd as _ag
from .. import random as _random
from ..base import MXNetError
from . import collectives as _coll
from .mesh import PP, default_mesh


def _schedule_1f1b(n_stages, n_micro):
    """Host-side greedy 1F1B schedule.

    Returns (table_f, table_b, n_ticks, bubble): (n_ticks, n_stages)
    int lists -- table_f[t][s] is the microbatch whose FORWARD stage s
    runs at tick t (-1: none), table_b likewise for backward; bubble is
    the measured idle fraction of device-ticks.  The greedy rule (do a
    ready backward, else a forward while in-flight < n_stages - s) is
    the classic non-interleaved 1F1B: in-flight activations per stage
    are bounded by n_stages (not n_micro, GPipe's bound).
    """
    S, M = n_stages, n_micro
    fwd_ready = [list(range(M))] + [[] for _ in range(S - 1)]
    bwd_ready = [[] for _ in range(S)]
    # (arrival_tick, mb) events scheduled into the future
    fwd_arrivals = [[] for _ in range(S)]
    bwd_arrivals = [[] for _ in range(S)]
    inflight = [0] * S
    done_bwd = [0] * S
    rows_f, rows_b = [], []
    t = 0
    while any(d < M for d in done_bwd):
        for s in range(S):
            fwd_ready[s] += [m for at, m in fwd_arrivals[s] if at <= t]
            fwd_arrivals[s] = [(at, m) for at, m in fwd_arrivals[s]
                               if at > t]
            bwd_ready[s] += [m for at, m in bwd_arrivals[s] if at <= t]
            bwd_arrivals[s] = [(at, m) for at, m in bwd_arrivals[s]
                               if at > t]
        row_f, row_b = [-1] * S, [-1] * S
        for s in range(S):
            if bwd_ready[s]:
                b = min(bwd_ready[s])
                bwd_ready[s].remove(b)
                row_b[s] = b
                inflight[s] -= 1
                done_bwd[s] += 1
                if s > 0:
                    bwd_arrivals[s - 1].append((t + 1, b))
            elif fwd_ready[s] and inflight[s] < S - s:
                f = min(fwd_ready[s])
                fwd_ready[s].remove(f)
                row_f[s] = f
                inflight[s] += 1
                if s < S - 1:
                    fwd_arrivals[s + 1].append((t + 1, f))
                else:
                    bwd_arrivals[s].append((t + 1, f))
            # else: bubble
        rows_f.append(row_f)
        rows_b.append(row_b)
        t += 1
        if t > 4 * (M + S) + 8:  # safety against a schedule bug
            raise MXNetError("1F1B schedule did not converge")
    n_ticks = len(rows_f)
    busy = sum(1 for row in rows_f for v in row if v >= 0) + \
        sum(1 for row in rows_b for v in row if v >= 0)
    bubble = 1.0 - busy / float(S * n_ticks)
    return rows_f, rows_b, n_ticks, bubble


def gpipe_bubble_fraction(n_stages, n_micro):
    """Analytic GPipe bubble: (S-1)/(M+S-1) per fwd/bwd pass."""
    return (n_stages - 1) / float(n_micro + n_stages - 1)


def _tree_map(fn, *trees):
    t = trees[0]
    if isinstance(t, (list, tuple)):
        return type(t)(_tree_map(fn, *xs) for xs in zip(*trees))
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    return fn(*trees)


def stack_stage_params(per_stage_params):
    """[stage0_tree, stage1_tree, ...] -> one tree with stacked leaves
    (leading dim = n_stages); rank s of the pp axis reads index s."""
    return _tree_map(lambda *leaves: torch.stack(leaves), *per_stage_params)


class _Pipe:
    """The pp group of a mesh: this rank's stage s of S and the
    exchanges between neighbouring stages."""

    def __init__(self, mesh, axis):
        self.group = mesh.group(axis) if mesh is not None else None
        self.S = mesh.shape.get(axis, 1) if mesh is not None else 1
        self.s = mesh.coord(axis) if mesh is not None else 0
        if self.S > 1 and self.group is None:
            raise NotImplementedError(
                f"pipeline: a {self.S}-stage pp axis needs one process a "
                "stage (a rank mesh under a process group)")

    def send(self, pairs, t, like, name):
        """Exchange over the (source, destination) stage ``pairs``: ``t``
        (None when this stage sends nothing) goes to its destination;
        returns what arrived (None when nothing came).  Skipped when no
        stage sends."""
        if not pairs:
            return None
        out = _coll.ppermute(t if t is not None else torch.zeros_like(like),
                             pairs, self.group, name)
        return out if any(d == self.s for _, d in pairs) else None

    def broadcast(self, tensors, src_stage):
        """Every rank takes stage ``src_stage``'s ``tensors`` (one flat
        buffer per dtype)."""
        if self.group is None or not tensors:
            return tensors
        src = dist.get_global_rank(self.group, src_stage)
        out = list(tensors)
        by_dtype = {}
        for i, t in enumerate(tensors):
            by_dtype.setdefault(t.dtype, []).append(i)
        for idx in by_dtype.values():
            flat = torch.cat([tensors[i].reshape(-1) for i in idx])
            _coll.broadcast_(flat, src, self.group)
            off = 0
            for i in idx:
                n = tensors[i].numel()
                out[i] = flat[off:off + n].view_as(tensors[i])
                off += n
        return out


def pipeline_apply(stage_fn, params_stacked, x_micro, mesh=None, axis=PP):
    """A pipelined forward.

    ``stage_fn(stage_params, x) -> y``: every stage's computation (one
    signature and shape: the homogeneous-trunk assumption).
    ``params_stacked``: a tree whose leaves have leading dim n_stages;
    rank s of the pp axis uses index s.  ``x_micro``: (n_micro, mb, ...),
    every rank the same.  Returns (n_micro, mb, ...), the last stage's
    outputs, on every rank.  Forward only: the result holds no graph (a
    backward through it raises); ``PipelineTrainer`` is the training
    path."""
    mesh = mesh or default_mesh()
    if mesh is None:
        raise MXNetError("pipeline_apply needs a mesh")
    pipe = _Pipe(mesh, axis)
    if x_micro.shape[0] < pipe.S:
        raise MXNetError(f"pipeline needs n_micro ({x_micro.shape[0]}) >= "
                         f"n_stages ({pipe.S}) to fill the pipe")
    with torch.no_grad():
        return _apply(stage_fn, params_stacked, x_micro, pipe)


def _apply(stage_fn, params_stacked, x_micro, pipe):
    S, s, M = pipe.S, pipe.s, x_micro.shape[0]
    if pipe.group is None:
        h = x_micro
        for j in range(S):
            mine = _tree_map(lambda p: p[j], params_stacked)
            h = torch.stack([stage_fn(mine, h[m]) for m in range(M)])
        return h
    mine = _tree_map(lambda p: p[s], params_stacked)
    outs = torch.zeros_like(x_micro)
    recv = None
    for t in range(M + S - 1):
        m = t - s
        y = None
        if 0 <= m < M:
            y = stage_fn(mine, x_micro[m] if s == 0 else recv)
            if s == S - 1:
                outs[m] = y
        pairs = [(j, j + 1) for j in range(S - 1) if 0 <= t - j < M]
        recv = pipe.send(pairs, y, x_micro[0], "pp_act")
    return pipe.broadcast([outs], S - 1)[0]


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [leaf for a in x for leaf in _leaves(a)]
    return [x]


class PipelineTrainer:
    """GPipe or 1F1B training of a homogeneous stage list, one rank a stage.

    ``stages``: a list of structurally identical Gluon blocks, or a
    (Hybrid)Sequential whose children divide evenly into the stages.
    Every rank builds the whole model; rank s of the mesh's ``axis``
    trains stage s.  ``prologue`` (e.g. the embedding) runs before the
    pipe on the first stage, ``epilogue`` (e.g. the MLM head) after it on
    the last, and the loss attaches to the epilogue's (or last stage's)
    output.  Stages may hold aux state (BatchNorm statistics: each
    microbatch's, moved on the ticks that run real data).  ``step``
    returns the loss on every rank."""

    def __init__(self, stages, loss_fn, optimizer="sgd",
                 optimizer_params=None, mesh=None, n_microbatches=None,
                 axis=PP, prologue=None, epilogue=None, schedule="gpipe"):
        from .trainer import _PureOptimizer

        mesh = mesh or default_mesh()
        if mesh is None:
            raise MXNetError("PipelineTrainer needs a mesh")
        if schedule not in ("gpipe", "1f1b"):
            raise MXNetError(
                f"PipelineTrainer: unknown schedule {schedule!r} "
                "('gpipe' or '1f1b')")
        others = [a for a, n in mesh.shape.items() if a != axis and n > 1]
        if others:
            raise NotImplementedError(
                f"PipelineTrainer: mesh axes {others} beside {axis!r}; the "
                "pipeline trains over a pp-only mesh")
        self.mesh = mesh
        self.axis = axis
        self._pipe = _Pipe(mesh, axis)
        self.n_stages = self._pipe.S
        self.loss_fn = loss_fn
        self.stages = self._as_stages(stages)
        self.prologue = prologue
        self.epilogue = epilogue
        self.schedule = schedule
        self.n_micro = int(n_microbatches or self.n_stages)
        if self.n_micro < self.n_stages:
            raise MXNetError("n_microbatches must be >= n_stages")
        if schedule == "1f1b":
            self._1f1b_tables = _schedule_1f1b(self.n_stages, self.n_micro)
            self.bubble_fraction = self._1f1b_tables[3]
            self.schedule_ticks = self._1f1b_tables[2]
        else:
            self.bubble_fraction = gpipe_bubble_fraction(self.n_stages,
                                                         self.n_micro)
            # the forward ticks and the backward's
            self.schedule_ticks = 2 * (self.n_micro + self.n_stages - 1)
        opt_kwargs = dict(optimizer_params or {})
        lr = opt_kwargs.pop("learning_rate", opt_kwargs.pop("lr", 0.01))
        self.optimizer = _PureOptimizer(optimizer, lr=lr, **opt_kwargs)
        self._num_update = 0
        self._initialized = False

    def _as_stages(self, stages):
        if isinstance(stages, (list, tuple)):
            stage_list = list(stages)
        else:
            children = list(stages._children.values())
            if not children or len(children) % self.n_stages:
                raise MXNetError(
                    f"cannot split {len(children)} layers into "
                    f"{self.n_stages} equal pipeline stages")
            per = len(children) // self.n_stages
            if per == 1:
                stage_list = children
            else:
                from ..gluon.nn import HybridSequential

                stage_list = []
                for s in range(self.n_stages):
                    seq = HybridSequential(prefix=f"ppstage{s}_")
                    for c in children[s * per:(s + 1) * per]:
                        seq.add(c)
                    stage_list.append(seq)
        if len(stage_list) != self.n_stages:
            raise MXNetError(f"got {len(stage_list)} stages for a "
                             f"{self.n_stages}-way pp mesh")
        return stage_list

    # -- staging ---------------------------------------------------------------
    @staticmethod
    def _split_params(block):
        """(trainable tensors, aux tensors) of ``block`` in structural
        order."""
        if block is None:
            return [], []
        items = list(block.collect_params().values())
        return ([p._value() for p in items if p.grad_req != "null"],
                [p._value() for p in items if p.grad_req == "null"])

    def _stage_params(self, example):
        """The activation's shape from the prologue on one microbatch (in
        predict mode, on every rank); deferred shapes materialised by one
        forward of the whole chain when a block has any; the stages
        checked alike; every rank started from rank 0's values and the
        optimizer state zeroed."""
        pipe = self._pipe
        blocks = [b for b in self.stages + [self.epilogue] if b is not None]
        deferred = any(p._deferred_init or p._tensor is None
                       for b in blocks for p in b.collect_params().values())
        with torch.no_grad(), _ag.pause():
            h = self.prologue(example) if self.prologue is not None \
                else example
            self._act = torch.zeros_like(h)
            for st in self.stages if deferred else ():
                h = st(h)
                if h.shape != self._act.shape:
                    raise MXNetError(
                        f"pipeline stages must keep the activation's shape "
                        f"{tuple(self._act.shape)}, got {tuple(h.shape)}")
            if deferred and self.epilogue is not None:
                self.epilogue(h)
        split = [self._split_params(st) for st in self.stages]
        shapes = [[tuple(t.shape) for t in tr + ax] for tr, ax in split]
        if any(sh != shapes[0] for sh in shapes[1:]):
            raise MXNetError(f"pipeline stages are not structurally "
                             f"identical: {shapes}")
        if self.schedule == "1f1b" and self._split_params(self.epilogue)[1]:
            raise MXNetError(
                "schedule='1f1b' does not support aux params in the "
                "epilogue (each microbatch's loss would move them); use "
                "schedule='gpipe'")
        self._device = self._act.device
        if pipe.group is not None:
            every = [t for tr, ax in split for t in tr + ax]
            for b in (self.prologue, self.epilogue):
                tr, ax = self._split_params(b)
                every += tr + ax
            with torch.no_grad():
                for t, v in zip(every, pipe.broadcast(
                        [t.detach() for t in every], 0)):
                    t.copy_(v)
                seed = torch.tensor([_random.next_seed()], dtype=torch.int64,
                                    device=self._device)
                self._seed = int(pipe.broadcast([seed], 0)[0].item())
        else:
            self._seed = _random.next_seed()
        self._mine = split[pipe.s][0]
        self._pro = self._split_params(self.prologue)[0]
        self._epi = self._split_params(self.epilogue)[0]
        params = self._mine + self._pro + self._epi
        owners = [p for b in (self.stages[pipe.s], self.prologue,
                              self.epilogue) if b is not None
                  for p in b.collect_params().values()
                  if p.grad_req != "null"]
        self._wd_mults = [p.wd_mult for p in owners]
        self._lr_mults = [p.lr_mult for p in owners]
        self._opt_state = self.optimizer.init_state(
            [p.detach() for p in params])
        self._initialized = True

    # -- the schedules ---------------------------------------------------------
    def _run_stage(self, src):
        inp = src.detach().requires_grad_(True)
        return inp, self.stages[self._pipe.s](inp)

    def _stage_grads(self, inp, out, dy, acc):
        """Backward of one microbatch through this rank's stage: adds the
        parameters' gradients to ``acc`` and returns d(input)."""
        gs = torch.autograd.grad(out, self._mine + [inp], grad_outputs=dy,
                                 allow_unused=True)
        for i, g in enumerate(gs[:-1]):
            if g is not None:
                acc[i] = g if acc[i] is None else acc[i] + g
        return gs[-1]

    def _head_loss(self, out, y):
        """The epilogue and the mean loss on ``out``."""
        if self.epilogue is not None:
            out = self.epilogue(out)
        loss = self.loss_fn(out, y) if self.loss_fn is not None else out
        return loss.mean()

    def _prologue(self, x):
        """(h, h's microbatches) on the first stage (None elsewhere)."""
        if self._pipe.s != 0:
            return None, None
        h = self.prologue(x) if self.prologue is not None else x
        return h, h.reshape((self.n_micro, -1) + tuple(h.shape[1:]))

    def _gpipe(self, x, y):
        pipe, M = self._pipe, self.n_micro
        S, s = pipe.S, pipe.s
        act = self._act
        h, hs = self._prologue(x)
        held, recv = {}, None
        for t in range(M + S - 1):
            m = t - s
            y_out = None
            if 0 <= m < M:
                held[m] = self._run_stage(hs[m] if s == 0 else recv)
                y_out = held[m][1].detach()
            pairs = [(j, j + 1) for j in range(S - 1) if 0 <= t - j < M]
            recv = pipe.send(pairs, y_out, act, "pp_act")
        acc = [None] * len(self._mine)
        epi_g, loss, dys = [None] * len(self._epi), None, None
        if s == S - 1:
            leaves = [held[m][1].detach().requires_grad_(True)
                      for m in range(M)]
            loss = self._head_loss(torch.cat(leaves), y)
            gs = torch.autograd.grad(loss, self._epi + leaves,
                                     allow_unused=True)
            epi_g = list(gs[:len(self._epi)])
            dys = gs[len(self._epi):]
        dH = [None] * M
        recv = None
        for t in range(M + S - 1):
            m = M - 1 - (t - (S - 1 - s))
            dx = None
            if 0 <= m < M:
                inp, out = held.pop(m)
                dy = dys[m] if s == S - 1 else recv
                dx = self._stage_grads(inp, out, dy, acc)
                if s == 0:
                    dH[m] = dx
            pairs = [(j, j - 1) for j in range(1, S)
                     if 0 <= M - 1 - (t - (S - 1 - j)) < M]
            recv = pipe.send(pairs, dx, act, "pp_grad")
        return loss, acc, self._prologue_grads(h, dH), epi_g

    def _1f1b(self, x, y):
        pipe, M = self._pipe, self.n_micro
        S, s = pipe.S, pipe.s
        rows_f, rows_b, n_ticks, _ = self._1f1b_tables
        act = self._act
        h, hs = self._prologue(x)
        ys = _tree_map(lambda a: a.reshape((M, -1) + tuple(a.shape[1:])), y)
        acc = [None] * len(self._mine)
        epi_g = [None] * len(self._epi)
        loss = torch.zeros((), dtype=torch.float32, device=self._device)
        held, fwd_in, bwd_in, dH = {}, {}, {}, [None] * M
        for t in range(n_ticks):
            f, b = rows_f[t][s], rows_b[t][s]
            y_out = dx = None
            if b >= 0:
                inp, out = held.pop(b)
                if s == S - 1:
                    leaf = out.detach().requires_grad_(True)
                    lval = self._head_loss(leaf, _tree_map(lambda a: a[b],
                                                           ys))
                    gs = torch.autograd.grad(lval / M, self._epi + [leaf],
                                             allow_unused=True)
                    for i, g in enumerate(gs[:-1]):
                        if g is not None:
                            epi_g[i] = g if epi_g[i] is None \
                                else epi_g[i] + g
                    loss = loss + lval.detach().float() / M
                    dy = gs[-1]
                else:
                    dy = bwd_in.pop(b)
                dx = self._stage_grads(inp, out, dy, acc)
                if s == 0:
                    dH[b] = dx
            elif f >= 0:
                held[f] = self._run_stage(hs[f] if s == 0 else fwd_in.pop(f))
                y_out = held[f][1].detach()
            pairs = [(j, j + 1) for j in range(S - 1) if rows_f[t][j] >= 0]
            got = pipe.send(pairs, y_out if s < S - 1 else None, act,
                            "pp_act")
            if got is not None:
                fwd_in[rows_f[t][s - 1]] = got
            pairs = [(j, j - 1) for j in range(1, S) if rows_b[t][j] >= 0]
            got = pipe.send(pairs, dx if s > 0 else None, act, "pp_grad")
            if got is not None:
                bwd_in[rows_b[t][s + 1]] = got
        return (loss if s == S - 1 else None), acc, \
            self._prologue_grads(h, dH), epi_g

    def _prologue_grads(self, h, dH):
        if self._pipe.s != 0 or self.prologue is None:
            return [None] * len(self._pro)
        return list(torch.autograd.grad(h, self._pro,
                                        grad_outputs=torch.cat(dH)
                                        .reshape(h.shape),
                                        allow_unused=True))

    # -- public API ------------------------------------------------------------
    def step(self, data, label):
        """One pipelined training step on the global batch (every rank
        passes the same one); batch dim 0 must divide into
        n_microbatches.  Returns the loss (0-dim f32) on every rank."""
        pipe = self._pipe
        x = torch.as_tensor(data)
        if x.shape[0] % self.n_micro:
            raise MXNetError(f"batch {x.shape[0]} not divisible by "
                             f"n_microbatches {self.n_micro}")
        if not self._initialized:
            dev = next(iter(self.stages[0].collect_params().values())) \
                ._value().device
            mb = x.shape[0] // self.n_micro
            self._stage_params(x[:mb].to(dev))
        x = x.to(self._device)
        y = _tree_map(lambda a: torch.as_tensor(a, device=self._device),
                      label)
        self._num_update += 1
        t = self._num_update
        lr = self.optimizer.lr_at(t)
        gen = _random.generator((self._seed * 1000003 + t * 7919
                                 + pipe.s * 104729) % (1 << 62),
                                self._device)
        run = self._gpipe if self.schedule == "gpipe" else self._1f1b
        with _random.generator_scope(gen), _ag.train_mode():
            loss, g_mine, g_pro, g_epi = run(x, y)

        def filled(gs, params):
            return [torch.zeros_like(p) if g is None else g
                    for g, p in zip(gs, params)]

        g_pro = pipe.broadcast(filled(g_pro, self._pro), 0)
        loss = torch.zeros((), dtype=torch.float32, device=self._device) \
            if loss is None else loss.detach().float()
        *g_epi, loss = pipe.broadcast(filled(g_epi, self._epi)
                                      + [loss.reshape(1)], pipe.S - 1)
        params = self._mine + self._pro + self._epi
        grads = filled(g_mine, self._mine) + list(g_pro) + list(g_epi)
        with torch.no_grad():
            new_p, self._opt_state = self.optimizer.apply(
                [p.detach() for p in params], grads, self._opt_state, lr, t,
                self._wd_mults, self._lr_mults, 1.0)
            for p, w in zip(params, new_p):
                p.copy_(w)
        return loss.reshape(())

    def sync_params(self):
        """Broadcast each stage's values (trainable and aux) from its rank
        to every rank, and the prologue's and epilogue's aux from the
        stages that move them: afterwards every rank's blocks hold the
        trained model (a collective: every rank of the pp group calls
        it)."""
        pipe = self._pipe
        if pipe.group is None or not self._initialized:
            return
        with torch.no_grad():
            for j, st in enumerate(self.stages):
                tr, ax = self._split_params(st)
                for t, v in zip(tr + ax, pipe.broadcast(
                        [t.detach() for t in tr + ax], j)):
                    t.copy_(v)
            for block, src in ((self.prologue, 0),
                               (self.epilogue, pipe.S - 1)):
                ax = self._split_params(block)[1]
                for t, v in zip(ax, pipe.broadcast(
                        [t.detach() for t in ax], src)):
                    t.copy_(v)

    def state_dict(self):
        """{"params": {name: host tensor}, "num_update": n}: every
        parameter of the prologue, the stages and the epilogue at its
        trained value (``sync_params`` first: a collective)."""
        self.sync_params()
        out = {}
        for block in [self.prologue] + self.stages + [self.epilogue]:
            if block is not None:
                for n, p in block.collect_params().items():
                    out[n] = p._value().detach().cpu().clone()
        return {"params": out, "num_update": int(self._num_update)}
