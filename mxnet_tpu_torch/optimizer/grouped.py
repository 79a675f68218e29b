"""Grouped (multi-tensor) optimizer stepping for the imperative Trainer.

Counterpart of ``mxnet_tpu/optimizer/grouped.py`` (reference: the
``multi_sgd_update`` / ``multi_lamb`` family and Gluon's
``MXNET_OPTIMIZER_AGGREGATION_SIZE``): instead of one op chain per
parameter, whole groups of parameters step together.

``GroupedUpdater`` partitions a Trainer's parameters into groups keyed by
(update rule, static hyper-params, dtype) and runs each group's rule once
over ``LISTS``, the ``torch._foreach_*`` form of the arithmetic the
single-tensor rules run over (``ops.optimizer_op``): the same ops in the
same order, so the grouped update equals the per-parameter ``Updater``
bit for bit wherever ``_foreach_*`` computes as its single-tensor op does
(everywhere on the host; on the card ``_foreach_norm`` sums in its own
order).  Per-step scalars (lr, wd, rescale_grad and the host-folded
step-count coefficients) enter as ``Col`` columns: one device tensor per
name, one entry per item, cast to the group's dtype as the reference
casts them, so an LR schedule changes data, not the ops; a column whose
entries are all equal hands ``_foreach_*`` one 0-dim tensor for the whole
list.  New values are written into the parameters' and states' own
tensors in place, so a captured CUDA graph (``gluon.captured``) keeps
reading and writing the same memory.

``multi_precision`` items (float16 and bfloat16 weights with an f32
master copy) group by their model dtype: the rule runs on the masters
with the gradients widened to f32, and the model weights are rounded from
the masters.  A row-sparse gradient of an SGD or Adam item with
``lazy_update`` runs ``sparse_row_kernel``'s variant of its rule: the
touched rows of the weight and the states are gathered, the same rule
runs over those rows, and the rows go back in place (``index_copy_``), so
untouched rows never move (``step_group``).  What the rules cannot
express falls back to the legacy per-parameter ``Updater``: the
optimizers without a plan (Adamax, Nadam, SGLD, DCASGD, Test, user
subclasses), non-float or mixed-dtype items, and the row-sparse items of
other optimizers, of ``lazy_update=False`` or of multi-precision
weights.
"""

from __future__ import annotations

import math
import os

import torch

from ..ops import optimizer_op as _op
from . import optimizer as _optmod


def fused_step_enabled() -> bool:
    """MXTPU_FUSED_STEP gate (default on); 0/false/off restores the
    legacy per-parameter loop."""
    return os.environ.get("MXTPU_FUSED_STEP", "1").lower() \
        not in ("0", "false", "off", "")


def group_max_items() -> int:
    """MXTPU_GROUP_MAX_ITEMS: the most parameters one group holds (0, the
    default, for no cap).  An autotune knob, read on every ``plan_items``:
    a changed value re-plans the next step, and since the plan is part of
    the capture key, re-captures it.  Splitting leaves the numbers as
    they are: a group's multi-tensor ops work tensor by tensor, so chunk
    boundaries change the launches, never the arithmetic."""
    try:
        return max(0, int(os.environ.get("MXTPU_GROUP_MAX_ITEMS", "0")))
    except ValueError:
        return 0


# -- dispatch accounting -------------------------------------------------------

_DISPATCH_COUNT = 0


def dispatch_count() -> int:
    """Grouped update dispatches since the last reset: one per (rule,
    static hyper-params, dtype) group per step."""
    return _DISPATCH_COUNT


def reset_dispatch_count() -> None:
    global _DISPATCH_COUNT
    _DISPATCH_COUNT = 0


# -- the arithmetic over tensor lists ------------------------------------------

class Col:
    """One per-step scalar of a group: a 1-D tensor with one entry an item.
    ``uniform`` when every entry is equal: a ``_foreach_*`` op then takes
    entry 0 as one 0-dim tensor for the whole list.  Arithmetic with
    numbers and other columns is elementwise, as the single-tensor rule's
    0-dim arithmetic is."""

    __slots__ = ("t", "uniform")

    def __init__(self, t, uniform=False):
        self.t = t
        self.uniform = bool(uniform)

    def arg(self):
        return self.t[0] if self.uniform else list(self.t.unbind())

    def _bin(self, other, fn, reflected=False):
        if isinstance(other, Col):
            a, b, uni = self.t, other.t, self.uniform and other.uniform
        else:
            a, b, uni = self.t, other, self.uniform
        return Col(fn(b, a) if reflected else fn(a, b), uni)

    def __mul__(self, o):
        return self._bin(o, torch.mul)

    def __rmul__(self, o):
        return self._bin(o, torch.mul, True)

    def __add__(self, o):
        return self._bin(o, torch.add)

    def __rsub__(self, o):
        return self._bin(o, lambda a, b: a - b, True)

    def __truediv__(self, o):
        return self._bin(o, torch.div)


def _s(x):
    return x.arg() if isinstance(x, Col) else x


class _ListOps:
    """The rules' arithmetic over lists of tensors (``torch._foreach_*``);
    scalars are numbers or ``Col`` columns, norms come back as columns."""

    @staticmethod
    def mul(x, s):
        return torch._foreach_mul(x, _s(s))

    @staticmethod
    def add(x, y):
        return torch._foreach_add(x, _s(y))

    @staticmethod
    def sub(x, y):
        return torch._foreach_sub(x, y)

    @staticmethod
    def div(x, y):
        return torch._foreach_div(x, _s(y))

    sqrt = staticmethod(torch._foreach_sqrt)
    sign = staticmethod(torch._foreach_sign)
    abs = staticmethod(torch._foreach_abs)
    neg = staticmethod(torch._foreach_neg)

    @staticmethod
    def square(x):
        return torch._foreach_mul(x, x)

    @staticmethod
    def clamp_min(x, lo):
        return torch._foreach_clamp_min(x, lo)

    @staticmethod
    def clip(x, lo, hi):
        return torch._foreach_clamp_max(torch._foreach_clamp_min(x, lo), hi)

    @staticmethod
    def norm(x):
        return Col(torch.stack(torch._foreach_norm(x)))

    @staticmethod
    def scalar_max(r, c):
        return Col(torch.clamp_min(r.t, c), r.uniform)

    @staticmethod
    def scalar_min(r, c):
        return Col(torch.clamp_max(r.t, c), r.uniform)

    @staticmethod
    def trust(r1, r2, ratio):
        return Col(torch.where((r1.t > 0) & (r2.t > 0), ratio.t,
                               torch.ones_like(ratio.t)))


LISTS = _ListOps()


# -- per-optimizer grouping plans ----------------------------------------------
#
# A plan maps one (optimizer, index, weight, state) item to
# (pure update, static_kwargs, state NDArrays, dyn_fn).  ``static_kwargs``
# are Python constants; ``dyn_fn(opt, indices)`` runs AFTER the update
# count is bumped and returns the per-step host scalars of a group's items,
# ``{name: [value per item]}``: the float64 expressions the per-parameter
# optimizers compute before their update.

def _cg(opt):
    return -1.0 if opt.clip_gradient is None else float(opt.clip_gradient)


def _lrs(opt, idx):
    if type(opt)._get_lr is _optmod.Optimizer._get_lr:
        return opt._get_lrs(idx)
    return [opt._get_lr(i) for i in idx]     # a per-index lr (LBSGD)


def _dyn_lrwd(opt, idx):
    return {"lr": _lrs(opt, idx), "wd": opt._get_wds(idx),
            "rescale_grad": [opt.rescale_grad] * len(idx)}


def _dyn_wd(opt, idx):
    return {"wd": opt._get_wds(idx),
            "rescale_grad": [opt.rescale_grad] * len(idx)}


def _steps(opt, idx):
    return [opt._index_update_count[i] for i in idx]


def _dyn_adam(opt, idx):
    d = _dyn_lrwd(opt, idx)
    d["lr"] = [lr * (math.sqrt(1.0 - opt.beta2 ** t) / (1.0 - opt.beta1 ** t))
               for lr, t in zip(d["lr"], _steps(opt, idx))]
    return d


def _dyn_lamb(opt, idx):
    d = _dyn_lrwd(opt, idx)
    ts = _steps(opt, idx)
    if opt.bias_correction:
        d["denom1"] = [1.0 - opt.beta1 ** t for t in ts]
        d["denom2"] = [1.0 - opt.beta2 ** t for t in ts]
    else:
        d["denom1"] = d["denom2"] = [1.0] * len(idx)   # x / 1.0 is exact
    return d


def _dyn_ftml(opt, idx):
    ts = _steps(opt, idx)
    return {"c_over_lr": [(1.0 - opt.beta1 ** t) / lr
                          for t, lr in zip(ts, _lrs(opt, idx))],
            "coef2": [1.0 - opt.beta2 ** t for t in ts],
            "wd": opt._get_wds(idx),
            "rescale_grad": [opt.rescale_grad] * len(idx)}


def _plan_sgd(o, i, w, state):
    if state is not None:
        return (_op.sgd_mom_update_pure,
                {"momentum": o.momentum, "clip_gradient": _cg(o)},
                [state], _dyn_lrwd)
    return (_op.sgd_update_pure, {"clip_gradient": _cg(o)}, [], _dyn_lrwd)


def _plan_nag(o, i, w, state):
    if state is not None:
        return (_op.nag_mom_update_pure,
                {"momentum": o.momentum, "clip_gradient": _cg(o)},
                [state], _dyn_lrwd)
    return (_op.sgd_update_pure, {"clip_gradient": _cg(o)}, [], _dyn_lrwd)


def _plan_adam(o, i, w, state):
    return (_op.adam_update_pure,
            {"beta1": o.beta1, "beta2": o.beta2, "epsilon": o.epsilon,
             "clip_gradient": _cg(o)}, list(state), _dyn_adam)


def _plan_adamw(o, i, w, state):
    return (_op.adamw_update_pure,
            {"beta1": o.beta1, "beta2": o.beta2, "epsilon": o.epsilon,
             "clip_gradient": _cg(o)}, list(state), _dyn_adam)


def _plan_rmsprop(o, i, w, state):
    cw = float(o.clip_weights) if o.clip_weights else -1.0
    if o.centered:
        return (_op.rmspropalex_update_pure,
                {"gamma1": o.gamma1, "gamma2": o.gamma2,
                 "epsilon": o.epsilon, "clip_gradient": _cg(o),
                 "clip_weights": cw}, list(state), _dyn_lrwd)
    return (_op.rmsprop_update_pure,
            {"gamma1": o.gamma1, "epsilon": o.epsilon,
             "clip_gradient": _cg(o), "clip_weights": cw},
            list(state), _dyn_lrwd)


def _plan_adagrad(o, i, w, state):
    return (_op.adagrad_update_pure,
            {"epsilon": o.float_stable_eps, "clip_gradient": _cg(o)},
            [state], _dyn_lrwd)


def _plan_adadelta(o, i, w, state):
    return (_op.adadelta_update_pure,
            {"rho": o.rho, "epsilon": o.epsilon, "clip_gradient": _cg(o)},
            list(state), _dyn_wd)


def _plan_ftrl(o, i, w, state):
    return (_op.ftrl_update_pure,
            {"lamda1": o.lamda1, "beta": o.beta, "clip_gradient": _cg(o)},
            list(state), _dyn_lrwd)


def _plan_signum(o, i, w, state):
    if state is not None:
        return (_op.signum_update_pure,
                {"momentum": o.momentum, "wd_lh": o.wd_lh,
                 "clip_gradient": _cg(o)}, [state], _dyn_lrwd)
    return (_op.signsgd_update_pure, {"clip_gradient": _cg(o)}, [],
            _dyn_lrwd)


def _plan_lamb(o, i, w, state):
    lb = -1.0 if o.lower_bound is None else float(o.lower_bound)
    ub = -1.0 if o.upper_bound is None else float(o.upper_bound)
    return (_op.lamb_fused_update_pure,
            {"beta1": o.beta1, "beta2": o.beta2, "epsilon": o.epsilon,
             "clip_gradient": _cg(o), "lower_bound": lb, "upper_bound": ub},
            list(state), _dyn_lamb)


def _plan_lars(o, i, w, state):
    # 1-D params (biases, norm scales) take the plain momentum step: the
    # optimizer's own skip list
    if len(w.shape) <= 1:
        return (_op.sgd_mom_update_pure,
                {"momentum": o.momentum, "clip_gradient": _cg(o)},
                [state], _dyn_lrwd)
    return (_op.lars_update_pure,
            {"momentum": o.momentum, "eta": o.eta, "epsilon": o.epsilon,
             "clip_gradient": _cg(o)}, [state], _dyn_lrwd)


def _plan_ftml(o, i, w, state):
    return (_op.ftml_fused_update_pure,
            {"beta1": o.beta1, "beta2": o.beta2, "epsilon": o.epsilon,
             "clip_grad": _cg(o)}, list(state), _dyn_ftml)


# exact-type dispatch: a user SUBCLASS of a registered optimizer may
# override update() arbitrarily, so it takes the legacy loop
_PLANS = {
    _optmod.SGD: _plan_sgd,
    _optmod.NAG: _plan_nag,
    _optmod.Adam: _plan_adam,
    _optmod.AdamW: _plan_adamw,
    _optmod.RMSProp: _plan_rmsprop,
    _optmod.AdaGrad: _plan_adagrad,
    _optmod.AdaDelta: _plan_adadelta,
    _optmod.Ftrl: _plan_ftrl,
    _optmod.Signum: _plan_signum,
    _optmod.LAMB: _plan_lamb,
    _optmod.LARS: _plan_lars,
    # LBSGD overrides only the host-side lr warmup (_get_lr), which the dyn
    # scalars already route through: the device math is LARS's
    _optmod.LBSGD: _plan_lars,
    _optmod.FTML: _plan_ftml,
}


def has_plan(optimizer) -> bool:
    return type(optimizer) in _PLANS


def _groupable(opt, weight, grad):
    """Items the grouped rules reproduce bit for bit; everything else falls
    back to the per-parameter Updater."""
    if getattr(grad, "stype", "default") != "default" \
            or getattr(weight, "stype", "default") != "default":
        return False
    w, g = weight._data, grad._data
    return w.is_floating_point() and w.dtype == g.dtype


# -- row-sparse (lazy-update) rules ----------------------------------------------

class _SparseRows:
    """The row-sparse lazy-update variant of a dense rule: its group
    gathers the touched rows of every weight and state, runs ``rule`` on
    them and writes them back (``step_group``).  One per dense rule, so
    the group key stays stable across plans and capture signatures."""

    def __init__(self, kernel):
        self.dense = kernel
        self.rule = kernel.rule
        self.__name__ = "row_sparse_" + getattr(kernel, "__name__", "kernel")

    def __repr__(self):
        return self.__name__


_SPARSE_KERNELS = {}


def sparse_row_kernel(kernel):
    """The cached row-sparse variant of ``kernel`` (a ``*_update_pure``)."""
    fn = _SPARSE_KERNELS.get(kernel)
    if fn is None:
        fn = _SPARSE_KERNELS[kernel] = _SparseRows(kernel)
    return fn


def is_sparse_kernel(kernel) -> bool:
    return isinstance(kernel, _SparseRows)


def _sparse_groupable(opt, weight, grad):
    """Row-sparse items the row rule reproduces against the per-parameter
    lazy update: SGD or Adam with ``lazy_update`` on a dense float weight
    without a multi-precision master."""
    if getattr(grad, "stype", "default") != "row_sparse" \
            or getattr(weight, "stype", "default") != "default":
        return False
    if type(opt) not in (_optmod.SGD, _optmod.Adam) \
            or not getattr(opt, "lazy_update", True):
        return False
    return weight._data.is_floating_point() and not opt._mp_weight(weight)


# -- the group step ------------------------------------------------------------

def clip_coef(health, clip):
    """``min(1, clip / (norm + 1e-8))`` from the health array, the
    ``gluon.utils.clip_global_norm`` formula."""
    norm = torch.sqrt(health[1])
    return torch.clamp_max(torch.full_like(norm, clip) / (norm + 1e-8), 1.0)


def healthy_of(health):
    """The skip predicate as a device bool: every gradient finite and the
    global squared norm finite."""
    return (health[0] > 0) & torch.isfinite(health[1])


_INT_VIEW = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def select(ok, new, old):
    """``new`` where the device bool ``ok`` holds, else ``old``, over lists
    of tensors of one dtype, exactly: on the values' integer views,
    ``new * ok + old * (1 - ok)`` with ``ok`` in {0, 1}, where no product
    or sum can overflow, so NaN and Inf pass as bit patterns.  Three
    ``_foreach_*`` ops for the list, where ``torch.where`` takes one launch
    a tensor.  ``new`` (a rule's fresh outputs) is overwritten."""
    if not new:
        return []
    it = _INT_VIEW[new[0].element_size()]
    m = ok.to(it)
    kept = [t.view(it) for t in new]
    torch._foreach_mul_(kept, m)
    torch._foreach_add_(kept, torch._foreach_mul([t.view(it) for t in old],
                                                 1 - m))
    return new


def build_group_step(kernel, static_items, guarded=False, clip=None):
    """The group-step function, the single home of the grouped update's
    arithmetic: the eager ``GroupedUpdater`` and the captured step
    (``gluon.captured``) both call it.  ``(weights, grads, states, dyn,
    health)`` in, ``(new_weights, new_states)`` out, with ``states`` a
    list per item and ``dyn`` a dict of ``Col``.  With ``clip`` the
    gradients are first scaled by ``clip_coef``; with ``guarded`` an
    unhealthy step returns the inputs' values (``select`` on the device,
    no host sync)."""
    rule = kernel.rule
    static = dict(static_items)

    def group_step(weights, grads, states, dyn, health=None):
        if clip is not None:
            coef = clip_coef(health, clip)
            grads = torch._foreach_mul(grads, coef.to(grads[0].dtype))
        n_states = len(states[0]) if states else 0
        cols = [[st[j] for st in states] for j in range(n_states)]
        res = rule(LISTS, weights, grads, *cols, **static, **dyn)
        new_w, new_cols = list(res[0]), [list(c) for c in res[1:]]
        if guarded:
            ok = healthy_of(health)
            new_w = select(ok, new_w, weights)
            new_cols = [select(ok, nc, oc) for nc, oc in zip(new_cols, cols)]
        new_s = [[c[j] for c in new_cols] for j in range(len(weights))]
        return new_w, new_s

    return group_step


def plan_items(updater, index, grad, weight):
    """Partition ``(index, grad, weight)`` triples into groups, creating
    optimizer states on demand through the same
    ``create_state_multi_precision`` call as the legacy loop.

    Returns ``(groups, fallback)``: ``groups`` maps ``(pure update,
    static_items, dtype)`` (``dtype`` the model weight's, ``"mp:"`` before
    it for multi-precision items) to item lists of ``(i, w, g, state_nds,
    dyn_fn, w32)``, ``w32`` the f32 master NDArray or None; ``fallback``
    holds the triples the rules cannot express.  Shared by
    ``GroupedUpdater`` and ``gluon.captured``, so both agree on what is
    grouped and how."""
    upd = updater
    o = upd.optimizer
    plan = _PLANS.get(type(o))
    groups, fallback = {}, []
    for i, g, w in zip(index, grad, weight):
        upd.ensure_state(i, w)
        sparse = plan is not None and _sparse_groupable(o, w, g)
        if plan is None or not (sparse or _groupable(o, w, g)):
            fallback.append((i, g, w))
            continue
        state, w32 = upd.states[i], None
        if o._mp_weight(w):
            w32, state = state
        kernel, static, state_nds, dyn_fn = plan(
            o, i, w32 if w32 is not None else w, state)
        if sparse:
            kernel = sparse_row_kernel(kernel)
        dtype = str(w._data.dtype).split(".")[-1]
        gkey = (kernel, tuple(sorted(static.items())),
                ("mp:" if w32 is not None else "") + dtype)
        groups.setdefault(gkey, []).append((i, w, g, state_nds, dyn_fn,
                                            w32))
    cap = group_max_items()
    if cap > 0:
        # oversize groups split into chunks of <= cap items; the chunk's
        # first position extends the key, which consumers read as
        # gkey[0..2] only
        split = {}
        for gkey, items in groups.items():
            if len(items) <= cap:
                split[gkey] = items
            else:
                for ci in range(0, len(items), cap):
                    split[gkey + (ci,)] = items[ci:ci + cap]
        groups = split
    return groups, fallback


def compute_dtype(gkey):
    """The dtype a group's rule runs in: f32 for multi-precision groups,
    else the weights'."""
    name = gkey[2]
    return torch.float32 if name.startswith("mp:") else getattr(torch, name)


def dyn_rows(optimizer, items):
    """One step's per-item host scalars of a group, ``{name: [float per
    item]}``; run AFTER the update-count bump."""
    return items[0][4](optimizer, [it[0] for it in items])


def is_uniform(values):
    return all(v == values[0] for v in values)


def as_columns(row, dtype, device):
    """A group's ``dyn_rows`` as ``Col`` columns of ``dtype`` on
    ``device``."""
    return {name: Col(torch.tensor(vals, dtype=dtype, device=device),
                      is_uniform(vals))
            for name, vals in row.items()}


def dyn_columns(optimizer, items, dtype, device):
    """One step's per-item scalars of a group as ``Col`` columns, cast to
    the group's compute dtype as the reference casts them; run AFTER the
    update-count bump."""
    return as_columns(dyn_rows(optimizer, items), dtype, device)


def group_operands(gkey, items, grads=None):
    """The raw tensors a group step reads: (weights, grads, states), the
    f32 masters and the widened gradients for multi-precision items.
    ``grads`` (raw tensors, one an item) stands in for the items' gradient
    NDArrays (the captured step's gradients never reach them)."""
    mp = gkey[2].startswith("mp:")
    ws = [(m if mp else w)._data for _i, w, _g, _s, _d, m in items]
    if grads is None:
        grads = [g._data for _i, _w, g, _s, _d, _m in items]
    if mp:      # widened by one multi-tensor copy
        gs = [torch.empty_like(g, dtype=torch.float32) for g in grads]
        torch._foreach_copy_(gs, list(grads))
    else:
        gs = list(grads)
    ss = [[s._data for s in st] for _i, _w, _g, st, _d, _m in items]
    return ws, gs, ss


@torch.no_grad()
def commit(gkey, items, new_w, new_s):
    """Write a group's new values into its tensors in place (and round the
    model weights from the masters of a multi-precision group)."""
    mp = gkey[2].startswith("mp:")
    torch._foreach_copy_([(m if mp else w)._data
                          for _i, w, _g, _s, _d, m in items], new_w)
    old = [s._data for _i, _w, _g, st, _d, _m in items for s in st]
    if old:
        torch._foreach_copy_(old, [s for ns in new_s for s in ns])
    if mp:
        torch._foreach_copy_([w._data for _i, w, _g, _s, _d, _m in items],
                             new_w)
    for _i, w, _g, st, _d, m in items:
        for nd in (w, m, *st):
            if nd is not None:
                nd._version += 1


def step_group(gkey, items, dyn, grads=None, health=None, guarded=False,
               clip=None, rows=None):
    """One group's update, written into its tensors in place: the single
    entry the ``GroupedUpdater`` and the captured step share.  ``grads``
    (raw tensors, one an item) stands in for the items' gradient NDArrays.

    A row-sparse group's gradients are row values, and ``rows`` gives
    each item's ``(ids, src)``: the table rows they belong to and, for
    the captured step's padded buckets, the slot whose new row each slot
    writes (None: every slot its own).  The weights' and states' rows at
    ``ids`` are gathered, the rule runs on them (clip, guard and all, as
    in ``build_group_step``), and they go back with ``index_copy_``.  A
    padded slot repeats a real id; taking the real slot's new row and
    states makes every write to that row the same bits, whatever order
    the writes land in, and no padded slot applies an update of its
    own."""
    fn = build_group_step(gkey[0], gkey[1], guarded=guarded, clip=clip)
    if not is_sparse_kernel(gkey[0]):
        ws, gs, ss = group_operands(gkey, items, grads)
        new_w, new_s = fn(ws, gs, ss, dyn, health)
        commit(gkey, items, new_w, new_s)
        return
    if rows is None:
        rows = [(g._rs_indices, None) for _i, _w, g, _s, _d, _m in items]
        grads = [g._rs_values for _i, _w, g, _s, _d, _m in items]
    tables = [[w._data] + [s._data for s in st]
              for _i, w, _g, st, _d, _m in items]
    gathered = [[t.index_select(0, ids) for t in ts]
                for ts, (ids, _src) in zip(tables, rows)]
    gs = [g.to(ts[0].dtype) for g, ts in zip(grads, tables)]
    new_w, new_s = fn([r[0] for r in gathered], gs,
                      [r[1:] for r in gathered], dyn, health)
    with torch.no_grad():
        for ts, (ids, src), nw, ns in zip(tables, rows, new_w, new_s):
            for t, new in zip(ts, [nw, *ns]):
                if src is not None:
                    new = new.index_select(0, src)
                t.index_copy_(0, ids, new)
    for _i, w, _g, st, _d, _m in items:
        for nd in (w, *st):
            nd._version += 1


class GroupedUpdater:
    """Multi-tensor drop-in for ``Updater`` on the Trainer's local path.

    Shares the wrapped Updater's ``states`` dict (and creates states through
    the same ``create_state_multi_precision`` call), so ``save_states`` /
    ``load_states`` and ``set_states`` round-trip identically whichever path
    ran the steps."""

    def __init__(self, updater):
        self._updater = updater

    @property
    def optimizer(self):
        return self._updater.optimizer

    @property
    def states(self):
        return self._updater.states

    def __call__(self, index, grad, weight, guard=None):
        global _DISPATCH_COUNT
        upd = self._updater
        o = upd.optimizer
        if guard is not None and not guard.skip and guard.clip is None:
            guard = None
        if not isinstance(index, (list, tuple)):
            index, grad, weight = [index], [grad], [weight]
        groups, fallback = plan_items(upd, index, grad, weight)
        # the legacy loop for what the rules cannot express; a guarded step
        # skips these on the host (the guard's one readback, shared with
        # the Trainer's finalize through the StepGuard cache)
        if fallback and guard is not None and guard.skip \
                and not guard.healthy:
            fallback = []
        for i, g, w in fallback:
            upd(i, g, w)
        if not groups:
            return
        # bump every grouped index first (num_update is a running max, so
        # the per-item lr/wd read below sees the value the loop would)
        for items in groups.values():
            for i, *_ in items:
                o._update_count(i)
        for gkey, items in groups.items():
            dyn = dyn_columns(o, items, compute_dtype(gkey),
                              items[0][1]._data.device)
            with torch.no_grad(), \
                    torch.profiler.record_function("optimizer_update"):
                step_group(gkey, items, dyn,
                           health=None if guard is None else guard.health,
                           guarded=guard is not None and guard.skip,
                           clip=None if guard is None else guard.clip)
            _DISPATCH_COUNT += 1

    # -- Updater API passthroughs (save/load states) ---------------------------
    def sync_state_context(self, state, context):
        return self._updater.sync_state_context(state, context)

    def set_states(self, states):
        self._updater.set_states(states)

    def get_states(self, dump_optimizer=False):
        return self._updater.get_states(dump_optimizer)
