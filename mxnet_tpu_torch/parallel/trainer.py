"""The training step: ``ShardedTrainer`` and its pure optimizer.

Counterpart of ``mxnet_tpu/parallel/trainer.py``.  The JAX package
compiles forward, backward and the optimizer update into one program over
a device mesh; here each rank runs them eagerly, in the same order and
with the same arithmetic:

- forward in training mode (``Module.train()`` for the zoo's
  ``nn.Module``s, ``autograd.train_mode()`` for Gluon blocks), dropout
  drawing from one generator per step; a Gluon block's BatchNorm moves
  its running statistics in place, once per microbatch, as the JAX
  step's scan carry does;
- the mean loss and its gradients (``torch.autograd.grad``); with
  ``grad_accum=k`` dim 0 is split into k microbatches whose losses and
  gradients are averaged;
- one pure update (``_PureOptimizer.apply``, one grouped pass) with
  ``rescale=1``, since the gradients are of the mean loss;
- the module's previous train/eval mode restored;
- with ``remat`` (or ``MXTPU_REMAT``/``MXNET_BACKWARD_DO_MIRROR``) the
  forward and loss run as one rematerialised region (``remat.wrap``).

``mesh`` is None or a one-device ``Mesh`` (the step above, on one
device, the generator the package chain's next), or a rank mesh
(``make_mesh`` under a process group, one process per rank), where the
JAX package's GSPMD program becomes explicit collectives:

- every rank calls ``step`` with the same GLOBAL batch; a rank keeps the
  rows of its dp coordinate of each microbatch (microbatch j is rows
  [j B/k, (j+1) B/k) of the global batch, as the reference's reshape),
  split further over an ep axis, and over an sp axis its block of T/sp
  positions of every (B, T, ...) leaf (the positions' embeddings at its
  offset, ``_parallel_scope.seq_offset``);
- ``rules`` (or ``mode="fsdp"``'s ``fsdp_rules`` over ``batch_axis``)
  give each parameter a spec; a rank keeps its shard
  (``sharding.local_shard``; the packed qkv by heads), and so do its
  optimizer states;
- the forward runs under ``collectives.parallel_scope``: a tp shard is
  consumed by the tp-aware ops (the trunk's heads and FFN columns, the
  vocab-parallel embedding, the column/row-parallel ``FullyConnected``);
  a dim sharded over the batch axis (FSDP) is all-gathered for the step
  and its gradient reduce-scattered back, except a ``ShardedEmbedding``
  table whose vocab rows ``EmbeddingRules`` split over it
  (``rules.row_sharded(name)``): the rank keeps its block of rows and
  the module's full table is dropped until ``sync_params`` writes it
  back, the lookup exchanges ids and rows with their owners
  (``embedding.sharded.row_sharded_lookup``) and the block's gradient
  already holds every rank's ids; an ep shard (``MOE_EP_RULES``)
  is consumed by ``moe_ffn``; BatchNorm and the masked-token mean take
  the global batch's statistics over the ranks that split its tokens;
- the step's objective is the mean over the R ranks that split the
  batch's tokens (dp, sp and ep) of their losses (the global batch's
  mean loss), so every gradient is summed over them (flat buckets per
  dtype of ``MXTPU_ALLREDUCE_BUCKET_MB``, or a reduce-scatter for an FSDP
  shard; an ep shard's, the rank's experts, over the ranks holding the
  same experts, its tokens having come through ``moe_ffn``'s all-to-all)
  and divided by R; a dim over pp (``PPRules``) is gathered for the step
  and keeps this rank's block of the gradient;
- ranks holding other tokens draw distinct dropout streams and tp and
  pp ranks the same one (their dropped activations are replicated), from
  a seed rank 0 draws at the first step;
- replicated parameters are written back into the module each step,
  sharded ones only by ``sync_params`` (a collective; a row-sharded
  table's full value is dropped again at the next step);
- every parameter and aux value is broadcast from rank 0 at the first
  step, so the ranks start alike.

Before its first step the trainer replays a stored autotune winner for
its signature (``autotune.replay_for_sharded``).  Feeding a block that
``shard_model`` placed to the captured ``train_step`` over a rank mesh
waits for the next slice (a CUDA graph cannot hold a gloo collective).
"""

from __future__ import annotations

import math

import torch

from .. import autograd as _ag
from .. import random as _random
from .. import remat as _remat
from ..base import MXNetError
from ..ops import optimizer_op as _op
from ..optimizer import grouped as _grouped
from . import collectives as _coll
from . import sharding as _sh
from .mesh import DP, EP, PP, SP, TP, Mesh, data_parallel_mesh


class _PureOptimizer:
    """Pure-functional optimizer over a list of parameter tensors, with the
    JAX package's seven update rules, run as ONE grouped pass over the
    list (``optimizer.grouped``'s ``LISTS`` arithmetic, the
    ``torch._foreach_*`` form of the single-tensor rules, op for op).
    State tensors take the parameter's dtype; the update runs in f32 and
    is cast back to the parameter's dtype, as the JAX update's f32
    learning rate promotes it.  The per-parameter lr and wd enter as
    columns, so lr_mult / wd_mult cost no extra pass."""

    def __init__(self, name, lr=0.01, momentum=0.0, wd=0.0, beta1=0.9,
                 beta2=0.999, epsilon=1e-8, clip_gradient=None,
                 lr_scheduler=None, gamma1=None, rho=None, gamma2=0.9,
                 centered=False, lower_bound=None, upper_bound=None,
                 clip_weights=None, lazy_update=True, **unknown):
        self.name = name.lower()
        self.lr = lr
        self.momentum = momentum
        self.wd = wd
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.clip_gradient = clip_gradient
        self.lr_scheduler = lr_scheduler
        # rmsprop decay: reference calls it gamma1, torch-style calls rho
        self.gamma1 = gamma1 if gamma1 is not None else \
            (rho if rho is not None else 0.9)
        self.gamma2 = gamma2
        self.centered = bool(centered)
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound
        self.clip_weights = clip_weights
        if unknown:
            import warnings

            warnings.warn(
                f"ShardedTrainer: ignoring optimizer hyperparameters "
                f"{sorted(unknown)} for {name}", stacklevel=3)
        if self.name not in ("sgd", "nag", "adam", "adamw", "lamb",
                             "rmsprop", "adagrad"):
            raise MXNetError(f"ShardedTrainer: unsupported optimizer "
                             f"{name}")

    def lr_at(self, num_update):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(num_update)
        return self.lr

    def n_states(self):
        if self.name == "rmsprop":
            return 3 if self.centered else 1
        return {"sgd": 1, "nag": 1, "adagrad": 1,
                "adam": 2, "adamw": 2, "lamb": 2}[self.name]

    def init_state(self, param_vals):
        n = self.n_states()
        return [tuple(torch.zeros_like(p) for _ in range(n))
                for p in param_vals]

    def _rule(self):
        """(rule, static hyper-parameters, whether it reads the states)."""
        cg = -1.0 if self.clip_gradient is None else \
            float(self.clip_gradient)
        cw = -1.0 if self.clip_weights is None else float(self.clip_weights)
        n = self.name
        if n == "sgd" and not self.momentum:
            return _op.sgd_rule, {"clip_gradient": cg}, False
        if n == "sgd":
            return _op.sgd_mom_rule, {"momentum": self.momentum,
                                      "clip_gradient": cg}, True
        if n == "nag":
            return _op.nag_mom_rule, {"momentum": self.momentum,
                                      "clip_gradient": cg}, True
        if n in ("adam", "adamw"):
            rule = _op.adam_rule if n == "adam" else _op.adamw_rule
            return rule, {"beta1": self.beta1, "beta2": self.beta2,
                          "epsilon": self.epsilon, "clip_gradient": cg}, True
        if n == "lamb":
            return _op.lamb_fused_rule, {
                "beta1": self.beta1, "beta2": self.beta2,
                "epsilon": self.epsilon, "clip_gradient": cg,
                "lower_bound": -1.0 if self.lower_bound is None
                else float(self.lower_bound),
                "upper_bound": -1.0 if self.upper_bound is None
                else float(self.upper_bound)}, True
        if n == "rmsprop" and self.centered:
            return _op.rmspropalex_rule, {
                "gamma1": self.gamma1, "gamma2": self.gamma2,
                "epsilon": self.epsilon, "clip_gradient": cg,
                "clip_weights": cw}, True
        if n == "rmsprop":
            return _op.rmsprop_rule, {
                "gamma1": self.gamma1, "epsilon": self.epsilon,
                "clip_gradient": cg, "clip_weights": cw}, True
        return _op.adagrad_rule, {"epsilon": self.epsilon,
                                  "clip_gradient": cg}, True

    def _dyn(self, lr, t, wd_mults, lr_mults, rescale):
        """The per-parameter step scalars, {name: [float per param]}."""
        k = len(wd_mults)
        row = {"lr": [lr * lm for lm in lr_mults],
               "wd": [self.wd * wm for wm in wd_mults],
               "rescale_grad": [rescale] * k}
        if self.name in ("adam", "adamw"):
            f = math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t)
            row["lr"] = [v * f for v in row["lr"]]
        elif self.name == "lamb":
            row["denom1"] = [1.0 - self.beta1 ** t] * k
            row["denom2"] = [1.0 - self.beta2 ** t] * k
        return row

    def apply(self, param_vals, grads, states, lr, t, wd_mults, lr_mults,
              rescale):
        """One update over all params as one grouped pass; returns
        (new_params, new_states) as new tensors."""
        if not param_vals:
            return [], []
        rule, static, stateful = self._rule()
        f32 = torch.float32
        ws = [p.to(f32) for p in param_vals]
        gs = [g.to(f32) for g in grads]
        cols = [[s[j].to(f32) for s in states]
                for j in range(len(states[0]))] if stateful else []
        dyn = _grouped.as_columns(
            self._dyn(lr, t, wd_mults, lr_mults, rescale), f32,
            ws[0].device)
        res = rule(_grouped.LISTS, ws, gs, *cols, **static, **dyn)
        new_p = [w.to(p.dtype) for w, p in zip(res[0], param_vals)]
        if not stateful:
            return new_p, [tuple(s) for s in states]
        new_s = [tuple(c[i].to(old.dtype) for c, old in zip(res[1:], s0))
                 for i, s0 in enumerate(states)]
        return new_p, new_s


def _tree_map(fn, x):
    if isinstance(x, (tuple, list)):
        return type(x)(_tree_map(fn, a) for a in x)
    if isinstance(x, dict):
        return {k: _tree_map(fn, a) for k, a in x.items()}
    return fn(x)


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [leaf for a in x for leaf in _leaves(a)]
    if isinstance(x, dict):
        return [leaf for a in x.values() for leaf in _leaves(a)]
    return [x]


class ShardedTrainer:
    """Train an ``nn.Module`` or a Gluon ``Block`` with one optimizer step
    per ``step`` call.

    Usage, as in the JAX package::

        mesh = parallel.make_mesh(dp=2, tp=2)   # under a process group
        trainer = parallel.ShardedTrainer(net, loss_fn, 'adamw',
                                          {'learning_rate': 3e-4},
                                          mesh=mesh,
                                          rules=parallel.TRANSFORMER_TP_RULES)
        loss = trainer.step(x, y)     # forward, backward, update

    ``mesh`` None is one device, or every rank of the process group when
    one of more than one rank is up.  ``mode`` is None, ``"tp"`` (with
    ``rules``) or ``"fsdp"`` (``fsdp_rules`` over ``batch_axis`` unless
    ``rules`` is given).  Outputs and labels may be tuples (BERT's four
    outputs, its two label arrays): they reach ``loss_fn`` as they
    came."""

    def __init__(self, block, loss_fn, optimizer="sgd",
                 optimizer_params=None, mesh=None, rules=None,
                 batch_axis=DP, grad_accum=1, remat=None, mode=None):
        if mode not in (None, "tp", "fsdp"):
            raise MXNetError(f"ShardedTrainer: unknown mode {mode!r} "
                             "(expected 'tp' or 'fsdp')")
        if mesh is None and _world() > 1:
            mesh = data_parallel_mesh()
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"ShardedTrainer: mesh must be a parallel.Mesh, "
                            f"got {type(mesh).__name__}")
        if mesh is not None and mesh.size > 1 and not mesh.is_rank_mesh:
            raise NotImplementedError(
                f"ShardedTrainer: mesh {mesh.shape} holds several devices "
                "of one process; the port runs one process a rank (start "
                "the ranks under a process group: MXTPU_COORDINATOR, "
                "MXTPU_NUM_WORKERS, MXTPU_WORKER_RANK)")
        self.block = block
        self.remat = remat
        self.loss_fn = loss_fn
        self.mesh = mesh
        self.batch_axis = batch_axis
        self.mode = mode
        opt_kwargs = dict(optimizer_params or {})
        lr = opt_kwargs.pop("learning_rate", opt_kwargs.pop("lr", 0.01))
        self.optimizer = _PureOptimizer(optimizer, lr=lr, **opt_kwargs)
        if mode == "fsdp" and rules is None:
            rules = _sh.fsdp_rules(mesh=mesh, axis=batch_axis)
        self._rules = rules
        self._grad_accum = int(grad_accum)
        if self._grad_accum < 1:
            raise ValueError(f"ShardedTrainer: grad_accum must be >= 1, got "
                             f"{grad_accum}")
        self._num_update = 0
        self._initialized = False

    @property
    def _ranked(self):
        return self.mesh is not None and self.mesh.is_rank_mesh

    # -- staging ---------------------------------------------------------------
    def _stage(self, example):
        """Collect the trainable parameters, lay them out on the mesh and
        zero the optimizer state.  A Gluon block's deferred parameters
        first materialise from one forward of ``example`` in predict mode,
        outside the tape, which leaves BatchNorm's running statistics as
        they were; its trainable parameters are those with ``grad_req !=
        "null"``, each with its own ``wd_mult``/``lr_mult``; the rest
        (running statistics) are its aux state, which the forward updates
        in place."""
        self._gluon = hasattr(self.block, "collect_params")
        if self._gluon:
            if self._ranked:
                _sh.unplace(self.block, self.mesh)
            allp = list(self.block.collect_params().items())
            ctx = next((c for _, p in allp for c in p.list_ctx()), None)
            if ctx is not None:
                self.block._ensure_initialized(_tree_map(
                    lambda a: torch.as_tensor(a, device=ctx.device),
                    example))
            if self._rules is not None:
                _sh.annotate_block(self.block, self._rules)
            owned = [(n, p) for n, p in allp if p.grad_req != "null"]
            self._trainable = [(n, p._value()) for n, p in owned]
            self._owners = [p for _, p in owned]
            specs = [getattr(p, "partition_spec", None) for _, p in owned]
            mults = [(p.wd_mult, p.lr_mult) for _, p in owned]
            self._aux = [p._value() for _, p in allp
                         if p.grad_req == "null"]
        else:
            self._trainable = [(n, p) for n, p in
                               self.block.named_parameters()
                               if p.requires_grad]
            self._owners = [n for n, _ in self._trainable]
            specs = [None if self._rules is None else
                     self._rules.spec_for(n, tuple(p.shape))
                     for n, p in self._trainable]
            mults = [(getattr(p, "wd_mult", 1.0), getattr(p, "lr_mult", 1.0))
                     for _, p in self._trainable]
            self._aux = list(self.block.buffers())
        if not self._trainable:
            raise MXNetError("ShardedTrainer: the block has no trainable "
                             "parameters")
        self._device = self._trainable[0][1].device
        if self.mesh is not None:
            want = self.mesh.device
            if torch.device(want) != self._device:
                raise MXNetError(f"ShardedTrainer: the mesh holds {want} "
                                 f"here, the block's parameters are on "
                                 f"{self._device}")
        self._wd_mults = [w for w, _ in mults]
        self._lr_mults = [lm for _, lm in mults]
        self._raw_specs = specs
        self._layout()
        self._opt_state = self.optimizer.init_state(self._update_vals())
        self._initialized = True

    def _layout(self):
        """Each parameter's cleaned spec on the mesh and, on a rank mesh,
        this rank's shard of the sharded ones (``_local``; None for a
        replicated parameter, which the module's own tensor holds)."""
        mesh = self.mesh
        self._sp = mesh.shape.get(SP, 1) if self._ranked else 1
        self._ep = mesh.shape.get(EP, 1) if self._ranked else 1
        # the ranks that split the global batch's tokens: rows over the
        # batch axis and ep (in the mesh's order), positions over sp
        self._row_axes = (self.batch_axis, EP)
        self._stat_axes = (self.batch_axis, SP, EP)
        if self._ranked:
            with torch.no_grad():
                g = mesh.all_group
                for t in [t for _, t in self._trainable] + self._aux:
                    _coll.broadcast_(t.data if t.requires_grad else t, 0, g)
                base = torch.tensor([_random.next_seed()],
                                    dtype=torch.int64, device=self._device)
                self._seed = int(_coll.broadcast_(base, 0, g).item())
        self._specs, self._local, self._row_tables = [], [], []
        for (n, t), spec in zip(self._trainable, self._raw_specs):
            if not self._ranked:
                self._specs.append(_sh.PartitionSpec())
                self._local.append(None)
                continue
            spec = _sh.clean_spec(spec, tuple(t.shape), mesh)
            bad = [a for a in spec
                   if a not in (None, TP, PP, EP, self.batch_axis)]
            if bad:
                raise NotImplementedError(
                    f"ShardedTrainer: {n!r} is sharded over {bad[0]!r}; a "
                    "parameter shards over the batch, tp, pp and ep axes "
                    "(the sp axis splits the sequence, not the weights)")
            if self.batch_axis in spec and (self._sp > 1 or self._ep > 1):
                raise NotImplementedError(
                    f"ShardedTrainer: {n!r} is sharded over the batch axis "
                    "(FSDP) on a mesh with an sp or ep axis; FSDP runs "
                    "with dp, tp and pp")
            self._specs.append(spec)
            loc = _sh.local_shard(n, t.detach(), spec, mesh) \
                if any(a is not None for a in spec) else None
            if self._row_sharded(n, spec):
                # its own storage, so dropping the full table frees it
                self._row_tables.append(len(self._local))
                loc = loc.clone()
            self._local.append(loc)
        self._drop_full_tables()

    def _drop_full_tables(self):
        """The row-sharded tables' full values leave the module: a rank
        holds its block of rows alone (``sync_params`` writes the full
        table back)."""
        for i in self._row_tables:
            t = self._trainable[i][1]
            if t.numel():
                t.data = t.data.new_empty((0,) + tuple(t.shape[1:]))

    def _update_vals(self):
        return [loc if loc is not None else t.detach()
                for loc, (_, t) in zip(self._local, self._trainable)]

    def _to_device(self, x):
        return _tree_map(lambda a: torch.as_tensor(a, device=self._device), x)

    # -- the step ----------------------------------------------------------------
    def _loss_of(self, x, y):
        if getattr(self, "_module_override", None):
            out = torch.func.functional_call(self.block,
                                             self._module_override, (x,))
        else:
            out = self.block(x)
        loss = self.loss_fn(out, y) if self.loss_fn is not None else out
        return loss.mean()

    def _loss_and_grads(self, x, y, leaves):
        loss = _remat.wrap(self._loss_of, self.remat)(x, y)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a table's row-sparse gradient (``sparse_embedding``) joins the
        # dense update
        return loss.detach(), [
            torch.zeros_like(p) if g is None
            else g.to_dense() if g.is_sparse else g
            for p, g in zip(leaves, grads)]

    def _microbatches(self, x, y):
        """This rank's rows of each microbatch: microbatch j is rows
        [j B/k, (j+1) B/k) of the global batch, and the rank keeps the
        block of its batch shard (its dp coordinate, then its ep one);
        over sp it keeps its block of positions of every (B, T, ...)
        leaf."""
        k = self._grad_accum
        mesh = self.mesh
        dp = mesh.size_over(self._row_axes) if self._ranked else 1
        r = mesh.coord_over(self._row_axes) if self._ranked else 0
        for leaf in _leaves(x) + _leaves(y):
            if leaf.shape[0] % (k * dp):
                raise ValueError(
                    f"ShardedTrainer: batch dim {leaf.shape[0]} not "
                    f"divisible by grad_accum={k} x {dp} batch shards")
        sp = self._sp if self._ranked else 1
        T = _leaves(x)[0].shape[1] if sp > 1 else None
        if sp > 1 and T % sp:
            raise ValueError(f"ShardedTrainer: sequence length {T} not "
                             f"divisible by sp={sp}")
        s = mesh.coord(SP) if sp > 1 else 0

        def rows(a, j):
            m = a.shape[0] // k
            b = m // dp
            a = a[j * m + r * b:j * m + (r + 1) * b]
            # sp: every (B, T, ...) leaf keeps this rank's positions
            if sp > 1 and a.dim() >= 2 and a.shape[1] == T:
                a = a[:, s * (T // sp):(s + 1) * (T // sp)]
            return a

        for j in range(k):
            yield (_tree_map(lambda a: rows(a, j), x),
                   _tree_map(lambda a: rows(a, j), y))

    def _stand_ins(self):
        """The tensors the forward reads for each trainable parameter, as
        leaves: the module's own tensor for a replicated one; for a
        sharded one, its shard with every dim over the batch or pp axis
        all-gathered (FSDP, ``PPRules``), and the scope's record of its tp
        dim or of the experts it holds (ep, read by ``moe_ffn``)."""
        leaves, tp_shards, ep_shards, override = [], {}, {}, {}
        self._row_shards = {}
        mesh = self.mesh
        for (n, t), spec, loc, owner in zip(self._trainable, self._specs,
                                            self._local, self._owners):
            if loc is None:
                leaves.append(t)
                continue
            if self._row_sharded(n, spec):
                leaf = loc.detach().requires_grad_(True)
                rows = leaf.shape[0]
                self._row_shards[id(leaf)] = (
                    mesh.coord(self.batch_axis) * rows,
                    mesh.shape[self.batch_axis] * rows)
                leaves.append(leaf)
                override[owner] = leaf
                continue
            s = loc
            with torch.no_grad():
                for dim, axis in enumerate(spec):
                    if axis is not None and axis not in (TP, EP):
                        s = _coll.all_gather_dim(s, mesh.group(axis), dim)
            leaf = s.detach().requires_grad_(True)
            if TP in spec:
                dim = spec.index(TP)
                tp_shards[id(leaf)] = (dim, mesh.coord(TP) * leaf.shape[dim],
                                       t.shape[dim])
            if EP in spec:
                if spec.index(EP) != 0:
                    raise NotImplementedError(
                        f"ShardedTrainer: {n!r} is sharded over ep on dim "
                        f"{spec.index(EP)}; experts shard on dim 0")
                ep_shards[id(leaf)] = (mesh.coord(EP) * leaf.shape[0],
                                       leaf.shape[0])
            leaves.append(leaf)
            override[owner] = leaf
        return leaves, tp_shards, ep_shards, override

    def _row_sharded(self, name, spec):
        """Whether the rules row-shard parameter ``name`` (an
        ``EmbeddingRules`` table) and its cleaned spec splits its vocab
        rows alone over the batch axis."""
        return self._rules is not None and self._rules.row_sharded(name) \
            and len(spec) > 0 and spec[0] == self.batch_axis \
            and all(a is None for a in spec[1:])

    def _forward_scope(self, override):
        """Gluon parameters read their stand-ins through
        ``param_override_scope``; an ``nn.Module``'s forward runs as a
        ``torch.func.functional_call`` over them (``_loss_of``)."""
        self._module_override = None if self._gluon else override
        if self._gluon:
            from ..gluon.parameter import param_override_scope

            return param_override_scope(override)
        import contextlib

        return contextlib.nullcontext()

    def step(self, data, label):
        """One training step; returns the mean loss as a 0-dim tensor.
        ``data``/``label`` may be tensors, arrays, or tuples/lists/dicts
        of them, batch-major on dim 0; on a rank mesh every rank passes
        the same global batch.  With ``grad_accum=k`` the batch is split
        into k microbatches and one update applies their averaged
        gradients."""
        if not self._initialized:
            self._stage(data)
            # autotune consult (replay only): a stored winner's knobs
            # (remat, ...) are in the environment before the first step
            from .. import autotune as _autotune

            _autotune.replay_for_sharded(
                _autotune.sharded_signature(self, data), self.mesh)
        x, y = self._to_device(data), self._to_device(label)
        self._num_update += 1
        t = self._num_update
        lr = self.optimizer.lr_at(t)
        if self._ranked:
            self._drop_full_tables()
            leaves, tp_shards, ep_shards, override = self._stand_ins()
            mesh = self.mesh
            scope = _coll.ParallelScope(
                dp_group=mesh.group_over(self._stat_axes),
                tp_group=mesh.group(TP), tp_shards=tp_shards,
                sp_group=mesh.group(SP), ep_group=mesh.group(EP),
                ep_shards=ep_shards, row_shards=self._row_shards)
            # ranks holding other tokens draw distinct streams, tp and pp
            # ranks the same one
            seed = (self._seed * 1000003 + t * 7919
                    + mesh.coord_over(self._stat_axes) * 104729) % (1 << 62)
            gen = _random.generator(seed, self._device)
        else:
            leaves = [p for _, p in self._trainable]
            scope, override = None, {}
            gen = _random.step_generator(self._device)
        was_training = self.block.training
        self.block.train()
        try:
            with _random.generator_scope(gen), _ag.train_mode(), \
                    _parallel(scope), self._forward_scope(override):
                loss, grads = 0.0, None
                for xb, yb in self._microbatches(x, y):
                    lb, gb = self._loss_and_grads(xb, yb, leaves)
                    loss = loss + lb
                    grads = gb if grads is None else [
                        a + b for a, b in zip(grads, gb)]
                if self._grad_accum > 1:
                    loss = loss / self._grad_accum
                    grads = [g / self._grad_accum for g in grads]
        finally:
            self.block.train(was_training)
        if scope is not None:
            self._check_consumed(scope, leaves)
            loss, grads = self._reduce(loss, grads)
        with torch.no_grad():
            # the loss is the MEAN over the batch, so its gradients are
            # already batch-normalised: rescale stays 1
            new_p, self._opt_state = self.optimizer.apply(
                self._update_vals(), grads, self._opt_state, lr, t,
                self._wd_mults, self._lr_mults, 1.0)
            for i, ((_, p), w) in enumerate(zip(self._trainable, new_p)):
                if self._local[i] is not None:
                    self._local[i] = w
                else:
                    p.copy_(w)
        return loss

    def _check_consumed(self, scope, leaves):
        missed = [n for (n, _), leaf in zip(self._trainable, leaves)
                  if (id(leaf) in scope.tp_shards
                      or id(leaf) in scope.ep_shards
                      or id(leaf) in scope.row_shards)
                  and id(leaf) not in scope.consumed]
        if missed:
            raise MXNetError(
                f"ShardedTrainer: tp, ep or row shards {missed} were read by "
                "no op that runs on a shard (the scanned transformer trunk, "
                "multi_head_attention's packed qkv, Embedding, "
                "FullyConnected, moe_ffn, ShardedEmbedding); a rule shards "
                "a parameter whose layer cannot run on its shard")

    def _reduce(self, loss, grads):
        """Sum the gradients over the ranks that split the batch's tokens
        (dp, sp and ep) and divide by their number R: a reduce-scatter
        for an FSDP shard, the store's flat buckets
        (``collectives.bucketed_all_reduce``) for the rest; an ep shard's
        over the ranks that hold the same experts (its gradient already
        holds every ep rank's tokens: they reached the experts through
        the all-to-all).  A dim over pp keeps this rank's block of the
        gradient every pp rank computed alike.  The loss is the R ranks'
        mean."""
        mesh = self.mesh
        group = mesh.group_over(self._stat_axes)
        R = mesh.size_over(self._stat_axes)
        out = list(grads)
        for i, spec in enumerate(self._specs):
            if PP in spec:
                dim = spec.index(PP)
                out[i] = out[i].chunk(mesh.shape[PP], dim)[mesh.coord(PP)]
        if group is None:
            return loss, out
        dense, experts = [], []
        for i, spec in enumerate(self._specs):
            if self._local[i] is not None and \
                    self._row_sharded(self._trainable[i][0], spec):
                # the owner summed every rank's rows in the exchange
                out[i] = out[i] / R
            elif self.batch_axis in spec:
                out[i] = _coll.reduce_scatter_dim(
                    out[i], group, spec.index(self.batch_axis)) / R
            elif EP in spec:
                experts.append(i)
            else:
                dense.append(i)
        loss_t = torch.as_tensor(loss, dtype=torch.float32,
                                 device=self._device).reshape(1)
        others = mesh.group_over(tuple(a for a in self._stat_axes
                                       if a != EP))
        for idx, g, name in ((dense, group, "dp_grad_bucket"),
                             (experts, others, "ep_grad_bucket")):
            if not idx:
                continue
            reduced, flats = _coll.bucketed_all_reduce(
                [out[i] for i in idx], g, name)
            for flat, _ in flats:
                flat /= R
            for i, gr in zip(idx, reduced):
                out[i] = gr
        _coll.all_reduce_(loss_t, group, "dp_loss")
        return (loss_t / R).reshape(()), out

    # -- state -------------------------------------------------------------------
    def _full(self, i, t):
        """The full value, in the canonical layout, of tensor ``t`` laid out
        as parameter ``i`` (a collective for a sharded one)."""
        if self._local[i] is None:
            return t
        return _sh.full_from_shards(self._trainable[i][0], t,
                                    self._specs[i], self.mesh)

    def sync_params(self):
        """Write the sharded parameters' full values back into the module
        (a collective on a rank mesh: every rank calls it); replicated
        ones are written back by every step.  A row-sharded table comes
        back whole until the next step drops it."""
        if not self._initialized or not self._ranked:
            return
        with torch.no_grad():
            for i, (_, p) in enumerate(self._trainable):
                if self._local[i] is None:
                    continue
                full = self._full(i, self._local[i])
                if i in self._row_tables:
                    p.data = full.to(p.dtype)
                else:
                    p.copy_(full)

    def _full_state(self, copy=True):
        """``state_dict`` on a rank mesh: every sharded parameter and state
        gathered to its full value in the canonical layout (a
        collective)."""
        from .. import checkpoint

        aux = {}
        if self._gluon:
            trained = {n for n, _ in self._trainable}
            aux = {n: p._value() for n, p in
                   self.block.collect_params().items() if n not in trained}
        state = {
            "params": [self._full(i, v)
                       for i, v in enumerate(self._update_vals())],
            "opt_state": [[self._full(i, s) for s in st]
                          for i, st in enumerate(self._opt_state)],
            "aux": aux,
            "num_update": int(self._num_update),
        }
        return checkpoint.snapshot_to_host(state) if copy else state

    def state_dict(self, copy=True):
        """The full train state (parameters, optimizer states, aux state,
        step) as a pytree, valid after the first step: a host snapshot,
        or with ``copy=False`` the live tensors for
        ``AsyncCheckpointer.save`` (``checkpoint.trainer_state``).  On a
        rank mesh the sharded values are gathered to their full values in
        the canonical layout, so the state loads into any mesh.  The
        ``resilience.run_resilient`` ``get_state`` hook."""
        from .. import checkpoint

        if self._ranked:
            return self._full_state(copy)
        return checkpoint.trainer_state(self, copy=copy)

    def load_state_dict(self, state):
        """Load a ``state_dict()`` or checkpoint pytree back into this
        trainer's tensors, bitwise; on a rank mesh each rank takes its
        shards of the full values (the ``set_state`` hook)."""
        from .. import checkpoint

        if not self._ranked:
            checkpoint.load_trainer_state(self, state)
            return
        if not self._initialized:
            raise MXNetError("load_state_dict: stage the ShardedTrainer "
                             "with one step (or _stage) first")
        mesh = self.mesh

        def mine(i, v):
            v = torch.as_tensor(v, device=self._device)
            if self._local[i] is None:
                return v
            return _sh.local_shard(self._trainable[i][0], v,
                                   self._specs[i], mesh)

        with torch.no_grad():
            for i, ((_, p), v) in enumerate(zip(self._trainable,
                                                state["params"])):
                if self._local[i] is None:
                    p.copy_(mine(i, v).to(p.dtype))
                else:
                    self._local[i] = mine(i, v).to(self._local[i].dtype)
            self._opt_state = [
                tuple(mine(i, v).to(old.dtype) for v, old in zip(vs, olds))
                for i, (vs, olds) in enumerate(zip(state["opt_state"],
                                                   self._opt_state))]
            if self._gluon:
                params = self.block.collect_params()
                for n, v in state.get("aux", {}).items():
                    params[n]._value().copy_(torch.as_tensor(
                        v, device=self._device))
        self._num_update = int(state["num_update"])

    def state_template(self):
        """The restore template: ``state_dict()``'s structure with this
        trainer's device at every tensor position."""
        from .. import checkpoint

        if not self._ranked:
            return checkpoint.trainer_state_template(self)
        dev = self._device
        return {
            "params": [dev for _ in self._trainable],
            "opt_state": [[dev for _ in s] for s in self._opt_state],
            "aux": ({n: dev for n, p in self.block.collect_params().items()
                     if p.grad_req == "null"} if self._gluon else {}),
            "num_update": None,
        }

    def reshape_mesh(self, mesh=None):
        """Re-lay this trainer onto a new mesh (the elastic N -> M
        reshape, ``resilience.ElasticGang``): the full train state is
        gathered on the old mesh (a collective), the layout is recomputed
        on ``mesh`` (default a data-parallel mesh over the ranks or
        devices there are now) and the state loaded into it, so the
        trajectory goes on as a fresh trainer restored from the same
        state would."""
        new = mesh if mesh is not None else data_parallel_mesh()
        if not self._initialized:
            self.mesh = new
            return self
        state = self.state_dict(copy=True)
        self.mesh = new
        self._layout()
        self._opt_state = self.optimizer.init_state(self._update_vals())
        if self._ranked:
            self.load_state_dict(state)
        else:
            from .. import checkpoint

            checkpoint.load_trainer_state(self, state)
        return self

    @property
    def learning_rate(self):
        return self.optimizer.lr_at(self._num_update)

    def set_learning_rate(self, lr):
        self.optimizer.lr = lr
        self.optimizer.lr_scheduler = None


def _parallel(scope):
    import contextlib

    return _coll.parallel_scope(scope) if scope is not None \
        else contextlib.nullcontext()


def _world():
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() \
        and dist.is_initialized() else 1


class DataParallelTrainer(ShardedTrainer):
    """The common case, pure data parallelism: over ``n_devices`` ranks of
    the process group (default all of them), or one device."""

    def __init__(self, block, loss_fn, optimizer="sgd",
                 optimizer_params=None, n_devices=None):
        mesh = data_parallel_mesh(n_devices) \
            if _world() > 1 or n_devices not in (None, 1) else None
        super().__init__(block, loss_fn, optimizer, optimizer_params,
                         mesh=mesh)
