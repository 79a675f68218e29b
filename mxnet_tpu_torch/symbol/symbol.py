"""Symbolic graphs: ``mx.sym.Variable``, the generated op wrappers'
nodes, ``list_*``, ``infer_shape``, ``tojson``/``load``, ``bind``/
``simple_bind``, ``eval`` and ``Group``.

Counterpart of ``mxnet_tpu/symbol/symbol.py:32-440,543-763`` (reference:
python/mxnet/symbol/ and nnvm's Symbol/Graph).  A Symbol is a small
Python DAG over the port's op registry (``ops/registry.py``), the same
registry ``mx.nd`` runs, under the JAX package's op names.

- The JSON layout is the JAX package's (``{'nodes', 'arg_nodes',
  'node_row_ptr', 'heads', 'attrs'}``, op kwargs JSON-encoded in a node's
  ``attrs``, ``__scalar__``/``__null__``/``__aux__`` markers, a
  variable's user attributes merged into its ``attrs`` and an op node's
  under ``node_attrs``), so a ``-symbol.json`` either package writes
  loads in the other.
- Evaluation walks the graph once, keyed by node name (a multi-output
  node runs once for all its output views), on tensors, with the
  injection the eager wrappers do (``ndarray/register.py``):
  ``_is_training`` from ``autograd.is_training()`` for mode-dependent
  ops and a ``torch.Generator`` from ``random.current_generator`` for
  random ones.  A BatchNorm in training mode whose moving statistics are
  auxiliary states updates them in place with its momentum, as the
  reference's BatchNorm does in its forward (the Gluon layer's update).
- ``infer_shape`` runs each op on ``device="meta"`` tensors, after the
  per-op parameter rules (the FInferShape bidirectionality) solve weight
  shapes from data shapes; what a meta tensor cannot give stays None.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .. import autograd as _ag
from .. import random as _random
from ..attribute import _LOCAL as _attr_local
from ..attribute import current_attrs as _current_attrs
from ..base import MXNetError, np_dtype, torch_dtype
from ..ops import registry as _registry

_SYM_COUNTER = [0]


def _auto_name(hint):
    _SYM_COUNTER[0] += 1
    return f"{hint.lower()}{_SYM_COUNTER[0] - 1}"


class Symbol:
    """One output of a graph node (reference: nnvm NodeEntry + Symbol)."""

    __slots__ = ("op", "name", "inputs", "attrs", "out_index", "_n_outputs",
                 "_attr_dict")

    def __init__(self, op, name, inputs, attrs, out_index=0, n_outputs=1):
        self.op = op                  # None for variables
        self.name = name
        self.inputs = inputs          # list[Symbol]
        self.attrs = attrs            # op kwargs (JSON-serialisable)
        self.out_index = out_index
        self._n_outputs = n_outputs
        self._attr_dict = {}

    def __repr__(self):
        return f"<Symbol {self.name}>"

    def __copy__(self):
        return Symbol(self.op, self.name, list(self.inputs),
                      dict(self.attrs), self.out_index, self._n_outputs)

    def attr(self, key):
        return self._attr_dict.get(key)

    @property
    def shape(self):
        """The static shape of a Variable made with ``shape=`` (a Gluon
        parameter's, or an export trace input's): ``hybrid_forward``
        bodies read ``ids.shape[1]``."""
        s = self._attr_dict.get("shape")
        if s is None:
            raise AttributeError(
                f"Symbol {self.name!r} has no static shape (create the "
                "Variable with shape=, or export after a forward pass so "
                "the trace inputs carry the seen shapes)")
        return tuple(s)

    def _set_attr(self, **kwargs):
        # Nones are absent var() kwargs: they must not clobber AttrScope's
        self._attr_dict.update(
            {k: v for k, v in kwargs.items() if v is not None})

    def __getitem__(self, index):
        if not isinstance(index, int):
            # array indexing (pos_table[:T], seq[:, 0, :]) is a node with a
            # JSON index spec; an int picks an output of a multi-output node
            return apply_op("_sym_index", self,
                            index_spec=_encode_index(index))
        if self._n_outputs == 1 and index == 0:
            return self
        view = Symbol(self.op, self.name, self.inputs, self.attrs,
                      out_index=index, n_outputs=self._n_outputs)
        view._attr_dict = self._attr_dict     # attributes are the node's
        return view

    def _binop(self, other, opname, reverse=False):
        if not isinstance(other, Symbol):
            other = _scalar_sym(other)
        a, b = (other, self) if reverse else (self, other)
        return apply_op(opname, a, b)

    def __add__(self, o):
        return self._binop(o, "broadcast_add")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binop(o, "broadcast_sub")

    def __rsub__(self, o):
        return self._binop(o, "broadcast_sub", reverse=True)

    def __mul__(self, o):
        return self._binop(o, "broadcast_mul")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binop(o, "broadcast_div")

    def __rtruediv__(self, o):
        return self._binop(o, "broadcast_div", reverse=True)

    def __pow__(self, o):
        return self._binop(o, "broadcast_power")

    def __neg__(self):
        return apply_op("negative", self)

    # -- graph introspection --------------------------------------------------

    def _topo(self):
        order, seen = [], set()
        stack = [self]
        while stack:
            node = stack.pop()
            if id(node) in seen:
                continue
            pending = [i for i in node.inputs if id(i) not in seen]
            if pending:
                stack.append(node)
                # leftmost input first: data before weights before labels
                stack.extend(reversed(pending))
            else:
                seen.add(id(node))
                order.append(node)
        return order

    def _variables(self):
        """The graph's variables in topological order, one per name."""
        out, names = [], set()
        for n in self._topo():
            if n.op is None and n.name not in names:
                names.add(n.name)
                out.append(n)
        return out

    def list_arguments(self):
        """Free variables in topological order, auxiliary states, scalar
        constants and absent-tensor slots excluded."""
        return [n.name for n in self._variables()
                if not n._attr_dict.get("__aux__")
                and "__scalar__" not in n.attrs
                and "__null__" not in n.attrs]

    def list_auxiliary_states(self):
        return [n.name for n in self._variables()
                if n._attr_dict.get("__aux__")]

    def list_inputs(self):
        return [n.name for n in self._variables()
                if "__scalar__" not in n.attrs
                and "__null__" not in n.attrs]

    def list_outputs(self):
        if self._n_outputs == 1:
            return [f"{self.name}_output"]
        return [f"{self.name}_output{i}" for i in range(self._n_outputs)]

    def attr_dict(self):
        """{node name: {attribute: str(value)}} over the whole graph, the
        user attributes only (what the optimizer reads for
        ``lr_mult``/``wd_mult``)."""
        out = {}
        for n in self._topo():
            attrs = {k: str(v)
                     for k, v in _json_safe_attrs(n._attr_dict).items()}
            if attrs:
                out[n.name] = attrs
        return out

    def optimize_for(self, backend="XLA", **kwargs):
        """This graph partitioned for a subgraph backend (reference:
        Symbol.optimize_for)."""
        from ..subgraph import partition

        return partition(self, backend)

    def get_internals(self):
        """Every op node's output, as a Group."""
        return Group([n for n in self._topo() if n.op is not None])

    def list_nodes(self):
        """The JSON node dicts (``visualization`` reads them)."""
        return json.loads(self.tojson())["nodes"]

    # -- evaluation -----------------------------------------------------------

    def _heads(self):
        return [self]

    def _eval_inputs(self, node, env, cache):
        return [_pick(i, self._eval_node(i, env, cache))
                for i in node.inputs]

    def _eval_node(self, node, env, cache):
        # keyed by node NAME: s and s[1] view one node and share its run
        key = node.name
        if key in cache:
            return cache[key]
        if node.op is None:
            if "__scalar__" in node.attrs:
                val = node.attrs["__scalar__"]
            elif node.attrs.get("__null__"):
                val = None              # an absent optional tensor slot
            elif node.name in env:
                val = env[node.name]
            else:
                raise MXNetError(f"unbound variable {node.name}")
        elif node.op == "_subgraph_exec":
            from ..subgraph import subgraph_exec

            val = subgraph_exec(node, self._eval_inputs(node, env, cache))
        elif node.op == "_group":
            val = tuple(self._eval_inputs(node, env, cache))
        else:
            val = run_node(node, self._eval_inputs(node, env, cache))
        cache[key] = val
        return val

    def _eval_heads(self, env, cache=None):
        """The graph's outputs as a list of tensors, one walk of the graph
        for all of them."""
        cache = {} if cache is None else cache
        return [_pick(h, self._eval_node(h, env, cache))
                for h in self._heads()]

    def eval_raw(self, **env):
        """Evaluate on raw tensors: one output, or a tuple for a Group."""
        outs = self._eval_heads(env)
        return outs[0] if len(outs) == 1 and not isinstance(self, Group) \
            else tuple(outs)

    def eval(self, ctx=None, **kwargs):
        """Bind the variables to NDArrays (or tensors) and evaluate
        (reference: Symbol.eval): an NDArray, or a list of them for a
        Group.  Recorded on the tape while ``autograd.record()`` is
        open."""
        from ..context import current_context
        from ..ndarray.ndarray import NDArray
        from ..ndarray.register import _wrap

        env = {k: (v._data if isinstance(v, NDArray) else v)
               for k, v in kwargs.items()}
        if ctx is None:
            ctx = next((v._ctx for v in kwargs.values()
                        if isinstance(v, NDArray)), None) or \
                current_context()
        inputs = [t for t in env.values() if isinstance(t, torch.Tensor)]
        with torch.set_grad_enabled(_ag.is_recording()):
            outs = self._eval_heads(env)
        outs = [_wrap(o, ctx, inputs) for o in outs]
        return outs if isinstance(self, Group) else outs[0]

    # -- inference ------------------------------------------------------------

    def infer_shape(self, **kwargs):
        """(arg_shapes, out_shapes, aux_shapes) from the given
        ``name=shape`` pairs, in ``list_arguments`` /
        ``list_auxiliary_states`` order; what cannot be solved is None."""
        known = {k: tuple(v) for k, v in kwargs.items()}
        shapes = self._infer_all(known)
        outs = [shapes.get(h.name) for h in self._heads()]
        outs = [o[h.out_index] if isinstance(o, list) else o
                for h, o in zip(self._heads(), outs)]
        if any(o is None for o in outs):
            outs = None
        return ([known.get(a) for a in self.list_arguments()],
                [tuple(o) for o in outs] if outs is not None else None,
                [known.get(a) for a in self.list_auxiliary_states()])

    infer_shape_partial = infer_shape

    def infer_type(self, **kwargs):
        """(arg_types, out_types, aux_types): the given ``name=dtype``
        pairs, float32 for the rest, as the JAX package's."""
        def one(n):
            return np_dtype(kwargs[n]) if n in kwargs else np.float32

        return ([one(a) for a in self.list_arguments()],
                [np.float32] * len(self._heads()),
                [one(a) for a in self.list_auxiliary_states()])

    def _infer_all(self, known):
        """Walk the graph in topological order: solve unknown variable
        shapes through ``_PARAM_SHAPE_RULES``, then run each op on meta
        tensors for its output shapes."""
        shapes = {}

        def shape_of(sym):
            if sym.op is None and ("__scalar__" in sym.attrs
                                   or sym.attrs.get("__null__")):
                return ()
            s = shapes.get(sym.name)
            return s[sym.out_index] if isinstance(s, list) else s

        for node in self._topo():
            if node.op is None:
                shapes[node.name] = known.get(node.name)
                continue
            if node.op in ("_group", "_subgraph_exec"):
                shapes[node.name] = None
                continue
            in_shapes = [shape_of(i) for i in node.inputs]
            if any(s is None for s in in_shapes):
                rule = _PARAM_SHAPE_RULES.get(node.op)
                if rule is not None:
                    for i, s in zip(node.inputs, rule(in_shapes, node.attrs)):
                        if s is not None and shapes.get(i.name) is None \
                                and i.op is None:
                            shapes[i.name] = known[i.name] = tuple(s)
                    in_shapes = [shape_of(i) for i in node.inputs]
            if any(s is None for s in in_shapes):
                shapes[node.name] = None
                continue
            args = [_meta_arg(i, s) for i, s in zip(node.inputs, in_shapes)]
            try:
                out = run_node(node, args, training=False, meta=True)
            except Exception:
                shapes[node.name] = None
                continue
            if isinstance(out, (tuple, list)):
                shapes[node.name] = [tuple(o.shape) for o in out]
            else:
                shapes[node.name] = tuple(out.shape)
        return shapes

    # -- serialisation --------------------------------------------------------

    def tojson(self):
        """The graph in the JAX package's JSON layout."""
        order = self._topo()
        index = {id(n): i for i, n in enumerate(order)}
        nodes, arg_nodes = [], []
        for i, n in enumerate(order):
            if n.op is None:
                arg_nodes.append(i)
            entry = {
                "op": "null" if n.op is None else n.op,
                "name": n.name,
                "attrs": {k: json.dumps(v) if not isinstance(v, str) else v
                          for k, v in n.attrs.items()},
                "inputs": [[index[id(s)], s.out_index, 0]
                           for s in n.inputs],
            }
            # user attributes: a variable's merge into its "attrs" (it has
            # no op kwargs to collide with), an op node's go under
            # "node_attrs" (merging would corrupt its kwargs on reload)
            user = _json_safe_attrs(n._attr_dict)
            if user:
                if n.op is None:
                    entry["attrs"] = {**{k: str(v)
                                         for k, v in user.items()},
                                      **entry["attrs"]}
                else:
                    entry["node_attrs"] = user
            nodes.append(entry)
        heads = [[index[id(self)], self.out_index, 0]]
        return json.dumps({"nodes": nodes, "arg_nodes": arg_nodes,
                           "node_row_ptr": list(range(len(nodes) + 1)),
                           "heads": heads,
                           "attrs": {"mxnet_version": ["str", "2.0-tpu"]}},
                          indent=2)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())

    # -- binding --------------------------------------------------------------

    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    shared_exec=None, **kwargs):
        """An Executor with zero-filled arrays of the inferred shapes on
        ``ctx`` (default ``current_context()``), in ``type_dict``'s dtypes
        (float32 by default).  With ``shared_exec``, an argument or
        auxiliary state of the same name and shape is that executor's
        array itself: the two share its storage (BucketingModule)."""
        from ..context import current_context
        from ..ndarray import zeros
        from .executor import Executor

        ctx = ctx or current_context()
        type_dict = dict(type_dict or {})
        arg_shapes, _, aux_shapes = self.infer_shape(**kwargs)
        names = self.list_arguments()
        aux_names = self.list_auxiliary_states()
        for name, shape in zip(names + aux_names, arg_shapes + aux_shapes):
            if shape is None:
                raise MXNetError(
                    f"simple_bind could not infer the shape of '{name}'; "
                    f"pass it explicitly (simple_bind({name}=(...), ...))")

        def alloc(name, shape, pool):
            got = pool.get(name) if pool else None
            if got is not None and tuple(got.shape) == tuple(shape):
                return got
            return zeros(shape, ctx, dtype=type_dict.get(name, "float32"))

        shared_args = shared_exec.arg_dict if shared_exec else None
        shared_aux = shared_exec.aux_dict if shared_exec else None
        args = {n: alloc(n, s, shared_args)
                for n, s in zip(names, arg_shapes)}
        aux = {n: alloc(n, s, shared_aux)
               for n, s in zip(aux_names, aux_shapes)}
        return Executor(self, args, grad_req=grad_req, aux_states=aux,
                        ctx=ctx)

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None):
        """An Executor over the given arrays (a list in
        ``list_arguments`` order, or a dict)."""
        from .executor import Executor

        if isinstance(args, (list, tuple)):
            args = dict(zip(self.list_arguments(), args))
        return Executor(self, args, args_grad=args_grad, grad_req=grad_req,
                        aux_states=aux_states, ctx=ctx)


class Group(Symbol):
    """Several outputs grouped (reference: mx.sym.Group)."""

    def __init__(self, symbols):
        super().__init__("_group", _auto_name("group"), list(symbols), {},
                         n_outputs=len(symbols))

    def _heads(self):
        return list(self.inputs)

    def list_outputs(self):
        return [o for s in self.inputs for o in s.list_outputs()]


def _pick(sym, val):
    return val[sym.out_index] if isinstance(val, (tuple, list)) else val


def _device_of(values):
    for v in values:
        if isinstance(v, torch.Tensor):
            return v.device
    from ..context import current_context

    return current_context().device


def _meta_arg(sym, shape):
    if sym.op is None and "__scalar__" in sym.attrs:
        return sym.attrs["__scalar__"]
    if sym.op is None and sym.attrs.get("__null__"):
        return None
    return torch.empty(shape, device="meta")


#: BatchNorm's moving statistics are inputs 3 and 4
_BN_OPS = ("BatchNorm", "batch_norm")


def _is_aux(sym):
    return sym.op is None and bool(sym._attr_dict.get("__aux__"))


def run_node(node, args, training=None, meta=False):
    """Run one op node on its evaluated inputs with the eager wrappers'
    injection: ``_is_training`` (``training``, default
    ``autograd.is_training()``) for a mode-dependent op, a generator from
    ``random.current_generator`` for a random one (none on meta tensors).
    A BatchNorm in training mode over auxiliary moving statistics updates
    them in place: ``m * moving + (1 - m) * batch``."""
    opdef = _registry.get(node.op)
    pos, kw_bound, attrs = _split_kw_inputs(args, node.attrs)
    kwargs = {k: v for k, v in attrs.items() if not k.startswith("__")}
    if opdef.mode_dependent and kwargs.get("_is_training") is None:
        kwargs["_is_training"] = _ag.is_training() if training is None \
            else training
    if opdef.random and kwargs.get("_key") is None and not meta:
        kwargs["_key"] = _random.current_generator(
            _device_of(list(pos) + list(kw_bound.values())))
    if node.op in _BN_OPS and kwargs.get("_is_training") and not meta \
            and not kwargs.get("use_global_stats") \
            and len(node.inputs) >= 5 \
            and _is_aux(node.inputs[3]) and _is_aux(node.inputs[4]):
        want = kwargs.get("output_mean_var", False)
        kwargs["output_mean_var"] = True
        out, mean, var = opdef.fn(*pos, **kw_bound, **kwargs)
        m = float(kwargs.get("momentum", 0.9))
        with torch.no_grad():
            for moving, batch in ((pos[3], mean), (pos[4], var)):
                moving.copy_(m * moving + (1.0 - m) * batch)
        return (out, mean, var) if want else out
    return opdef.fn(*pos, **kw_bound, **kwargs)


# -- parameter shape rules (the reference's per-op FInferShape) ---------------

def _prod(xs):
    p = 1
    for x in xs:
        p *= x
    return p


def _fc_rule(in_shapes, attrs):
    data = in_shapes[0]
    nh = attrs.get("num_hidden")
    if data is None or nh is None:
        return [None] * len(in_shapes)
    in_units = _prod(data[1:]) if attrs.get("flatten", True) else data[-1]
    out = [data, (nh, in_units)]
    if len(in_shapes) > 2:
        out.append((nh,))
    return out


def _conv_rule(in_shapes, attrs, transposed=False):
    data = in_shapes[0]
    nf = attrs.get("num_filter")
    kernel = attrs.get("kernel")
    if data is None or nf is None or kernel is None:
        return [None] * len(in_shapes)
    groups = attrs.get("num_group", 1)
    k = (kernel,) * (len(data) - 2) if isinstance(kernel, int) \
        else tuple(kernel)
    layout = attrs.get("layout")
    c = data[layout.index("C")] if layout and len(layout) == len(data) \
        else data[1]
    w = (c, nf // groups) + k if transposed else (nf, c // groups) + k
    out = [data, w]
    if len(in_shapes) > 2:
        out.append((nf,))
    return out


def _channel_rule(axis_default):
    def rule(in_shapes, attrs):
        data = in_shapes[0]
        if data is None:
            return [None] * len(in_shapes)
        c = data[attrs.get("axis", axis_default)]
        return [data] + [(c,)] * (len(in_shapes) - 1)
    return rule


def _embedding_rule(in_shapes, attrs):
    din, dout = attrs.get("input_dim"), attrs.get("output_dim")
    if din is None or dout is None:
        return [None] * len(in_shapes)
    return [in_shapes[0], (din, dout)]


def _label_like_batch_rule(in_shapes, attrs):
    data = in_shapes[0]
    if data is None:
        return [None] * len(in_shapes)
    return [data, (data[0],)]


_PARAM_SHAPE_RULES = {
    "FullyConnected": _fc_rule,
    "fully_connected": _fc_rule,
    "Convolution": _conv_rule,
    "convolution": _conv_rule,
    "Deconvolution": lambda s, a: _conv_rule(s, a, transposed=True),
    "BatchNorm": _channel_rule(1),
    "batch_norm": _channel_rule(1),
    "LayerNorm": _channel_rule(-1),
    "layer_norm": _channel_rule(-1),
    "InstanceNorm": _channel_rule(1),
    "GroupNorm": _channel_rule(1),
    "Embedding": _embedding_rule,
    "SoftmaxOutput": _label_like_batch_rule,
    "softmax_output": _label_like_batch_rule,
}


def var(name, attr=None, shape=None, lr_mult=None, wd_mult=None,
        dtype=None, init=None, stype=None, **kwargs):
    """mx.sym.Variable: extra kwargs must be ``__dunder__`` attributes,
    as the reference's ``variable()`` requires."""
    for k in kwargs:
        if not (k.startswith("__") and k.endswith("__")):
            raise ValueError(
                f"Variable attribute {k!r} must start and end with "
                f"double underscores (__{k}__)")
    s = Symbol(None, name, [], {})
    scope = _current_attrs()
    if scope:
        s._set_attr(**scope)
    if dtype is not None and not isinstance(dtype, str):
        dtype = str(torch_dtype(dtype)).replace("torch.", "")
    s._set_attr(shape=shape, lr_mult=lr_mult, wd_mult=wd_mult,
                dtype=dtype, init=init, **(attr or {}), **kwargs)
    return s


Variable = var


def _scalar_sym(value):
    value = value if isinstance(value, (int, bool)) else float(value)
    s = var(_auto_name("scalar"))
    s._set_attr(__scalar__=value)
    s.attrs["__scalar__"] = value
    return s


def _null_sym():
    s = var(_auto_name("null"))
    s._set_attr(__null__=True)
    s.attrs["__null__"] = True
    return s


def _encode_index(index):
    """An NDArray-style index as a JSON-able spec (``ops._sym_index``
    decodes it)."""
    items = index if isinstance(index, tuple) else (index,)
    spec = []
    for it in items:
        if isinstance(it, int):
            spec.append(["i", it])
        elif isinstance(it, slice):
            parts = []
            for b in (it.start, it.stop, it.step):
                if b is None:
                    parts.append(None)
                elif isinstance(b, int) or (hasattr(b, "__index__")
                                            and not isinstance(b, Symbol)):
                    parts.append(int(b))
                else:
                    raise MXNetError(
                        "Symbol slice bounds must be static ints (got "
                        f"{type(b).__name__}); dynamic bounds need "
                        "slice_axis with a concrete end")
            spec.append(["s"] + parts)
        elif it is Ellipsis:
            spec.append(["e"])
        elif it is None:
            spec.append(["n"])
        else:
            raise MXNetError("Symbol indexing takes ints, slices, "
                             f"Ellipsis and None, got {type(it).__name__}")
    return spec


def _split_kw_inputs(args, attrs):
    """Undo ``apply_op``'s lifting of Symbol-valued kwargs: (positional
    inputs, kwarg inputs, the other attributes)."""
    attrs = dict(attrs)
    kw_names = attrs.pop("__kw_inputs__", None)
    if kw_names:
        n = len(kw_names)
        return list(args[:-n]), dict(zip(kw_names, args[-n:])), attrs
    return list(args), {}, attrs


def apply_op(opname, *sym_inputs, name=None, **kwargs):
    """A graph node applying the registered op ``opname``."""
    _registry.get(opname)  # an unknown op fails here, not at eval
    nm = name or _auto_name(opname.lower().replace("_", ""))
    inputs = list(sym_inputs)
    # trailing Nones (an absent bias) are dropped: the op's defaults apply;
    # interior ones become null slots that evaluate to None
    while inputs and inputs[-1] is None:
        inputs.pop()
    inputs = [_null_sym() if i is None else i for i in inputs]
    # positional Python scalars (clip(x, 0, 6)) become scalar constants
    inputs = [i if isinstance(i, Symbol) else _scalar_sym(i)
              for i in inputs]
    # Symbol-valued kwargs (qkv_weight=w) are tensor inputs: appended, and
    # their names recorded (a plain string list, JSON round-trips)
    kw_syms = [(k, v) for k, v in kwargs.items() if isinstance(v, Symbol)]
    if kw_syms:
        for k, _ in kw_syms:
            kwargs.pop(k)
        kwargs["__kw_inputs__"] = [k for k, _ in kw_syms]
        inputs += [v for _, v in kw_syms]
    out = Symbol(opname, nm, inputs, kwargs)
    scope = _current_attrs()
    if scope:
        out._set_attr(**scope)
    return out


def load(fname):
    """Load a ``-symbol.json`` (reference: mx.sym.load)."""
    with open(fname) as f:
        return fromjson(json.load(f))


_INTERNAL_ATTRS = {"__aux__", "__null__", "__scalar__", "__kw_inputs__"}


def _json_safe_attrs(attr_dict):
    """The user attributes: plain scalars, less the internal markers and
    the runtime bookkeeping (Symbol lists, initializer objects)."""
    return {k: v for k, v in attr_dict.items()
            if k not in _INTERNAL_ATTRS
            and isinstance(v, (str, int, float, bool))}


def fromjson(data):
    """A Symbol from its JSON (a string or the parsed dict).  An open
    AttrScope is not applied to the loaded nodes."""
    if isinstance(data, str):
        data = json.loads(data)
    built = []
    saved_scope, _attr_local.stack = _attr_local.stack, []
    try:
        for nd in data["nodes"]:
            attrs = {}
            for k, v in nd.get("attrs", {}).items():
                try:
                    attrs[k] = json.loads(v)
                except (json.JSONDecodeError, TypeError):
                    attrs[k] = v
            if nd["op"] == "null":
                v = var(nd["name"])
                v.attrs.update(attrs)
                if attrs.get("__aux__"):
                    v._set_attr(__aux__=True)
                # the reference format keeps a variable's user attributes
                # (lr_mult, __lr_mult__, ctx_group) in its "attrs"
                user = _json_safe_attrs(attrs)
                if user:
                    v._set_attr(**user)
                built.append(v)
            elif nd["op"] == "_group":
                built.append(Group([built[i][oi] if oi else built[i]
                                    for i, oi, _ in nd["inputs"]]))
            else:
                inputs = [built[i][oi] for i, oi, _ in nd["inputs"]]
                built.append(apply_op(nd["op"], *inputs, name=nd["name"],
                                      **attrs))
            if nd.get("node_attrs"):
                built[-1]._set_attr(**nd["node_attrs"])
    finally:
        _attr_local.stack = saved_scope
    head, oi, _ = data["heads"][0]
    return built[head][oi] if oi else built[head]


def trace_block(block, inputs=None):
    """The Symbol graph of a Gluon block: its ``hybrid_forward`` run with
    ``F`` = this package's ``symbol`` and Variable inputs (the reference's
    export path).  The trace runs in predict mode; the inputs carry the
    shapes of the block's last hybridized forward."""
    shapes = getattr(block, "_last_input_shapes", None) or []
    if inputs is None:
        names = ["data"] if len(shapes) <= 1 else [
            f"data{i}" for i in range(len(shapes))]
        inputs = [var(n, shape=s)
                  for n, s in zip(names, shapes)] or [var("data")]
    elif isinstance(inputs, str):
        inputs = [var(inputs, shape=shapes[0] if shapes else None)]
    elif all(isinstance(i, str) for i in inputs):
        inputs = [var(n, shape=s) for n, s in zip(
            inputs, list(shapes) + [None] * len(inputs))]
    with _ag.predict_mode(), _ag.pause():
        out = block(*inputs)
    if isinstance(out, (list, tuple)):
        return Group(list(out))
    if not isinstance(out, Symbol):
        raise MXNetError(
            f"trace_block: block {type(block).__name__} returned "
            f"{type(out).__name__}, not a Symbol: its forward bypasses "
            "hybrid_forward; export needs a HybridBlock")
    return out
