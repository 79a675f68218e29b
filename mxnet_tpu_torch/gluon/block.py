"""Gluon ``Block`` and ``HybridBlock`` as ``torch.nn.Module``s.

Counterpart of ``mxnet_tpu/gluon/block.py`` (reference:
python/mxnet/gluon/block.py): name scopes and prefixes, child
registration, ``collect_params``, ``initialize``, ``cast``,
``save_parameters``/``load_parameters``, and ``HybridBlock.forward``
calling ``hybrid_forward(F, x, **params)``.

A Block is a ``torch.nn.Module``: its children are torch submodules and
its Gluon parameters' tensors are torch parameters or buffers under their
attribute names (``parameter.py``), so ``named_parameters()``,
``state_dict()`` and ``train()`` work on it as on any module.  The Gluon
state stays the reference: ``collect_params()`` names parameters as the
JAX package does (``resnetv10_stage1_conv0_weight``), and the mode a
layer runs in (BatchNorm, Dropout) is ``autograd.is_training()``, not
``Module.training``.

``F`` is ``mxnet_tpu_torch.ndarray``: its generated op wrappers pass raw
tensors straight to the ops, so a JAX ``hybrid_forward`` body carries over
line by line and runs on tensors.  Called with tensors, a block runs under
torch's own grad mode (the trainer's path).  Called with NDArrays, it
unwraps them, runs with gradients only inside ``autograd.record()``, and
wraps the outputs back: the imperative path, on the same tape as ``nd``.
``hybridize`` records its flag, which ``gluon.captured`` reads (a
Trainer's ``train_step`` captures a hybridized block's whole step), and
makes the forward draw one generator a call; the block still runs op by
op.  ``hybridize(remat=...)`` (or ``MXTPU_REMAT``/
``MXNET_BACKWARD_DO_MIRROR``) runs a hybridized block's forward as one
rematerialised region (``remat.checkpoint``): its backward recomputes the
forward, with the dropout masks the forward drew.

Called with ``Symbol``s, a HybridBlock builds a graph instead
(reference ``gluon/block.py:463-480``): ``hybrid_forward`` runs with
``F`` = the port's ``symbol`` and each parameter as its Variable
(``Parameter.var``; a ``grad_req="null"`` one marked auxiliary).
``export`` writes that graph, traced in predict mode, as
``-symbol.json`` with ``-%04d.params`` (``arg:``/``aux:`` keys);
``SymbolBlock.imports`` runs such a pair as a block, and
``optimize_for`` runs the partitioned graph (``subgraph.partition``).
``shard_activations(spec, mesh=None)`` pins a block's forward output to
a spec through ``parallel.sharding.constrain`` (the default mesh at call
time when ``mesh`` is None).  As the reference's constraint, it changes
the layout and never the value: on a rank mesh outside a sharded step
the output carries the cleaned spec as ``partition_spec``; inside one
(``parallel.ShardedTrainer``), with no mesh, a one-device mesh or a spec
longer than the output, it is the output as it is.  ``_cache_version`` counts the
changes a captured step keys on (``_clear_cached_op`` bumps it, as the
reference's does: LoRA attach, freeze and merge).
"""

from __future__ import annotations

import re
import threading
import warnings
from collections import OrderedDict

import torch

from .. import autograd as _ag
from .. import name as _name
from .. import random as _random
from .. import remat as _remat
from ..ndarray.ndarray import NDArray
from ..ndarray.register import _wrap
from ..symbol.symbol import Symbol
from .parameter import Parameter, ParameterDict


class _BlockScope:
    """Name and parameter scoping for child blocks (reference:
    _BlockScope); the counters are this package's own."""

    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None
        self._name_scope = None

    @staticmethod
    def create(prefix, params, hint):
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                prefix = _name.current().get(None, hint) + "_"
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            prefix = f"{hint}{count}_"
            current._counter[hint] = count + 1
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        self._name_scope = _name.Prefix(self._block.prefix)
        self._name_scope.__enter__()
        return self

    def __exit__(self, ptype, value, trace):
        if self._block._empty_prefix:
            return
        self._name_scope.__exit__(ptype, value, trace)
        self._name_scope = None
        _BlockScope._current.value = self._old_scope


class Block(torch.nn.Module):
    """Base of all layers and models (reference: gluon.Block)."""

    def __init__(self, prefix=None, params=None):
        torch.nn.Module.__init__(self)
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(
            prefix, params, self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._children = OrderedDict()
        self._reg_params = {}
        # bumped by whatever changes what a captured step recorded: a
        # parameter or child registered, a parameter's tensor replaced
        # (cast, deferred init, load), hybridize (gluon.captured keys on it)
        self._cache_version = 0

    def __repr__(self):
        modstr = "\n".join(
            [f"  ({key}): " + repr(block).replace("\n", "\n  ")
             for key, block in self._children.items()])
        return f"{self.__class__.__name__}(\n{modstr}\n)"

    def __setattr__(self, name, value):
        existing = self.__dict__.get(name, self.__dict__.get(
            "_modules", {}).get(name))
        if isinstance(existing, (Parameter, Block)) and \
                not isinstance(value, type(existing)):
            raise TypeError(
                f"Changing attribute type for {self.name} from "
                f"{type(existing)} to {type(value)} is not allowed.")
        if isinstance(value, Parameter):
            assert name not in self._reg_params or \
                self._reg_params[name] is value, \
                "Overriding Parameter attribute %s is not allowed. " \
                "If you want to share parameters between blocks, please " \
                "set 'params' at Block construction instead." % name
            self._reg_params[name] = value
            object.__setattr__(self, name, value)
            value._attach(self, name)
            self._cache_version += 1
            return
        if isinstance(value, Block):
            self.register_child(value, name)
        super().__setattr__(name, value)

    def _alias(self):
        return self.__class__.__name__.lower()

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        return self._scope

    @property
    def params(self):
        return self._params

    def collect_params(self, select=None):
        """This block's and its children's Parameters, optionally those
        whose name matches the regex ``select`` (reference:
        Block.collect_params)."""
        self._check_container_with_block()
        ret = ParameterDict(self._params.prefix)
        if not select:
            ret.update(self.params)
        else:
            pattern = re.compile(select)
            ret.update({name: value for name, value in self.params.items()
                        if pattern.match(name)})
        for cld in self._children.values():
            ret.update(cld.collect_params(select=select))
        return ret

    def _check_container_with_block(self):
        children = set(self._children.values())
        for k, v in self.__dict__.items():
            if isinstance(v, (list, tuple, dict)) and not k.startswith("_"):
                flat = v.values() if isinstance(v, dict) else v
                for item in flat:
                    if isinstance(item, Block) and item not in children:
                        warnings.warn(
                            f'"{item}" is an unregistered container with '
                            "Blocks. Note that Blocks inside the list, tuple "
                            "or dict will not be registered automatically. "
                            "Make sure to register them using "
                            "register_child() or switching to "
                            "nn.Sequential/nn.HybridSequential instead.")

    def _collect_params_with_prefix(self, prefix=""):
        if prefix:
            prefix += "."
        ret = {prefix + key: val for key, val in self._reg_params.items()}
        for name, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def save_parameters(self, filename, deduplicate=False):
        """Save the parameters under their structural names
        (``features.0.weight``), the reference's ``.params`` format."""
        from ..ndarray import save as nd_save

        params = self._collect_params_with_prefix()
        if deduplicate:
            unique = {}
            for k, v in params.items():
                if not any(v is u for u in unique.values()):
                    unique[k] = v
            params = unique
        nd_save(filename, {key: val.data() for key, val in params.items()})

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        """Load a ``save_parameters`` file; a file of full names
        (``ParameterDict.save``) loads too."""
        from ..context import cpu
        from ..ndarray import load as nd_load

        loaded = nd_load(filename, ctx=cpu())     # staged on the host
        params = self._collect_params_with_prefix()
        if not loaded and not params:
            return
        if not any("." in i for i in loaded.keys()):
            del loaded
            self.collect_params().load(
                filename, ctx, allow_missing, ignore_extra, self.prefix,
                cast_dtype=cast_dtype, dtype_source=dtype_source)
            return
        if not allow_missing:
            for name in params.keys():
                assert name in loaded, \
                    f"Parameter '{name}' is missing in file '{filename}', " \
                    f"which contains parameters: " \
                    f"{_brief_print_list(loaded.keys())}. Set " \
                    "allow_missing=True to ignore missing parameters."
        for name in loaded:
            if not ignore_extra and name not in params:
                raise ValueError(
                    f"Parameter '{name}' loaded from file '{filename}' is "
                    "not present in ParameterDict, which contains parameters "
                    f"{_brief_print_list(params.keys())}. Set "
                    "ignore_extra=True to ignore.")
            if name in params:
                params[name]._load_init(loaded[name], ctx,
                                        cast_dtype=cast_dtype,
                                        dtype_source=dtype_source)

    save_params = save_parameters
    load_params = load_parameters

    def register_child(self, block, name=None):
        if name is None:
            name = str(len(self._children))
        self._children[name] = block
        self._modules[name] = block
        self._cache_version += 1

    def apply(self, fn):
        """Apply ``fn`` to every child, recursively, then to this block
        (reference: Block.apply)."""
        for cld in self._children.values():
            cld.apply(fn)
        fn(self)
        return self

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False, generator=None):
        """Initialise every parameter of this block and its children with
        ``init`` (default ``Uniform()``) on ``ctx`` (default
        ``current_context()``), drawing from ``generator`` (default the
        next generator of the package chain); deferred parameters draw
        when their shapes are known."""
        from .. import initializer as _init

        self.collect_params().initialize(
            init if init is not None else _init.Uniform(), ctx, verbose,
            force_reinit, generator=generator)

    def hybridize(self, active=True, **kwargs):
        for cld in self._children.values():
            cld.hybridize(active, **kwargs)

    def _clear_cached_op(self):
        """Mark what a captured step recorded as stale."""
        self._cache_version += 1

    def cast(self, dtype):
        """Cast every parameter to ``dtype``; returns the block."""
        for child in self._children.values():
            child.cast(dtype)
        for _, param in self.params.items():
            param.cast(dtype)
        self._cache_version += 1
        return self

    def forward(self, *args):
        raise NotImplementedError


def _brief_print_list(lst, limit=7):
    lst = list(lst)
    if len(lst) > limit:
        return _brief_print_list(lst[:limit // 2], limit) + ", ..., " + \
            _brief_print_list(lst[-limit // 2:], limit)
    return ", ".join([f"'{str(i)}'" for i in lst])


def _wrap_out(out, ctx, inputs):
    if isinstance(out, (tuple, list)):
        return type(out)(_wrap_out(o, ctx, inputs) for o in out)
    return _wrap(out, ctx, inputs)


class HybridBlock(Block):
    """A Block whose computation is ``hybrid_forward(F, x, **params)``
    (reference: gluon.HybridBlock)."""

    #: (spec, mesh) from ``shard_activations``; a class attribute, so
    #: blocks built before the call carry None
    _act_spec = None

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._flags = {}

    def register_child(self, block, name=None):
        if not isinstance(block, HybridBlock):
            raise ValueError(
                f"Children of HybridBlock must also be HybridBlock, but "
                f"{str(block)} has type {str(type(block))}. If you are using "
                "Sequential, please try HybridSequential instead.")
        super().register_child(block, name)

    def hybridize(self, active=True, **kwargs):
        """Record the flag; the block still runs op by op.  A hybridized
        block's forward draws one generator from the package chain for
        all its random ops (unless a ``generator_scope`` is open), as the
        reference's CachedOp draws one key a call: the captured step
        (``gluon.captured``) draws the same generators, in the same
        order."""
        self._active = active
        self._flags = dict(kwargs)
        self._cache_version += 1
        super().hybridize(active, **kwargs)

    def infer_shape(self, *args):
        """Complete deferred parameter shapes from the inputs' shapes.  The
        built-in layers override it; composite blocks resolve child by
        child during their first forward."""
        raise ValueError(
            f"Deferred initialization failed because shape cannot be "
            f"inferred for block {self.name}. Override infer_shape, or "
            "construct the layer with explicit input dims.")

    def _param_values(self, *args):
        """This block's own parameters as tensors, materialising deferred
        ones from the inputs' shapes first."""
        params = self._reg_params
        if any(p._tensor is None and p._deferred_init
               for p in params.values()):
            self.infer_shape(*args)
            for p in params.values():
                p._finish_deferred_init()
        return {k: p._value() for k, p in params.items()}

    def forward(self, x, *args, **kwargs):
        if isinstance(x, Symbol) or any(isinstance(a, Symbol)
                                        for a in _leaves(args)):
            return self._forward_sym(x, *args, **kwargs)
        if self._active:
            # the export trace gives its input Variables these shapes
            self._last_input_shapes = [tuple(a.shape) if hasattr(
                a, "shape") else None for a in (x, *args)]
        if self._active and not _random.scoped():
            with _random.generator_scope(_random.step_generator(
                    _device_of(_leaves((x, *args))))):
                return self._constrain_out(
                    self._remat_forward(x, *args, **kwargs))
        return self._constrain_out(self._remat_forward(x, *args, **kwargs))

    def shard_activations(self, spec, mesh=None):
        """Pin this block's forward output to a PartitionSpec (Megatron
        activation annotation, e.g. ``('dp', None, 'tp')`` after a
        column-parallel projection).  ``mesh=None`` resolves the process
        default mesh at call time.  The output's value never changes: on a
        rank mesh it carries the cleaned spec as ``partition_spec``
        (``parallel.sharding.constrain``); inside a sharded step, with no
        mesh or a one-device one, it is left as it is.  Returns the
        block."""
        self._act_spec = (tuple(spec), mesh)
        self._clear_cached_op()
        return self

    def _constrain_out(self, out):
        if self._act_spec is None:
            return out
        from ..parallel.mesh import default_mesh
        from ..parallel.sharding import constrain

        spec, mesh = self._act_spec
        if mesh is None:
            mesh = default_mesh()
        if mesh is None:
            return out

        for v in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(v, NDArray):
                constrain(v._data, mesh, spec)
            elif isinstance(v, torch.Tensor):
                constrain(v, mesh, spec)
        return out

    def _remat_forward(self, *args, **kwargs):
        policy = _remat.env_default(self._flags.get("remat")) \
            if self._active else None
        if policy and _remat.parse_save_every(policy) is None:
            nd_in = any(isinstance(a, NDArray) for a in _leaves(args))
            if _ag.is_recording() if nd_in else torch.is_grad_enabled():
                with torch.enable_grad():
                    return _remat.checkpoint(
                        lambda *a: self._forward(*a, **kwargs), policy,
                        *args)
        return self._forward(*args, **kwargs)

    def _forward(self, x, *args, **kwargs):
        if any(isinstance(a, NDArray)
               for a in _leaves((x, *args, *kwargs.values()))):
            return self._forward_nd(x, *args, **kwargs)
        return self.hybrid_forward(_F(), x, *args, **kwargs,
                                   **self._param_values(x, *args))

    def _forward_nd(self, *args, **kwargs):
        """NDArrays in (nested in tuples or lists too), NDArrays out: the
        tensors run through ``hybrid_forward``, recorded while
        ``autograd.record()`` is open."""
        ctx = next(a for a in _leaves((*args, *kwargs.values()))
                   if isinstance(a, NDArray))._ctx
        raw = [_unwrap(a) for a in args]
        kw = {k: _unwrap(v) for k, v in kwargs.items()}
        with torch.set_grad_enabled(_ag.is_recording()):
            params = self._param_values(*raw)
            out = self.hybrid_forward(_F(), *raw, **kw, **params)
        inputs = [t for t in _leaves((*raw, *kw.values(), *params.values()))
                  if isinstance(t, torch.Tensor)]
        return _wrap_out(out, ctx, inputs)

    def _forward_sym(self, *args, **kwargs):
        """The symbolic dispatch: ``hybrid_forward`` over the ``symbol``
        module with each parameter as its Variable."""
        from .. import symbol as _sym

        params = {}
        for k, p in self._reg_params.items():
            v = p.var()
            if p.grad_req == "null":
                v._set_attr(__aux__=True)
                v.attrs["__aux__"] = True
            params[k] = v
        return self.hybrid_forward(_sym, *args, **kwargs, **params)

    def export(self, path, epoch=0, remove_amp_cast=True):
        """Write ``path-symbol.json`` (the graph traced in predict mode,
        inputs ``data`` or ``data0``...) and ``path-%04d.params``, each
        parameter under ``arg:`` or, with ``grad_req="null"``, ``aux:``
        and its global name (reference: HybridBlock.export); returns the
        Symbol.  Needs ``hybridize()`` and one forward first, whose input
        shapes the trace carries."""
        from .. import symbol as _sym
        from ..ndarray import save as nd_save

        if not self._active:
            raise RuntimeError(
                "Please first call block.hybridize() and then run forward "
                "with this block at least once before calling export.")
        sym = _sym.trace_block(self)
        sym.save(f"{path}-symbol.json")
        arg_dict = {}
        for name, param in self.collect_params().items():
            tag = "aux" if param.grad_req == "null" else "arg"
            arg_dict[f"{tag}:{name}"] = param.data()
        nd_save(f"{path}-{epoch:04d}.params", arg_dict)
        return sym

    def optimize_for(self, x, *extra, backend="XLA", **kwargs):
        """A SymbolBlock running this block's graph partitioned for
        ``backend`` with copies of the current parameters (reference:
        HybridBlock.optimize_for); ``x`` (and ``extra`` inputs) are run
        first, as the reference's sample input, and name the inputs
        ``data`` or ``data0``...  A string second argument is the
        backend."""
        from .. import symbol as _sym

        if extra and isinstance(extra[0], str):
            backend, extra = extra[0], extra[1:]
        if not self._active:
            self.hybridize()
        with _ag.pause(), torch.no_grad():
            self(x, *extra)
        n_in = 1 + len(extra)
        in_names = ["data"] if n_in == 1 else \
            [f"data{i}" for i in range(n_in)]
        psym = _sym.trace_block(self, inputs=in_names).optimize_for(
            backend, **kwargs)
        sb = SymbolBlock(psym, [_sym.var(n) for n in in_names])
        params = self.collect_params()
        for name, p in sb.params.items():
            if name in params:
                src = params[name].data()
                p._load_init(src, src.context, cast_dtype=True,
                             dtype_source="saved")
        return sb

    def _ensure_initialized(self, *args):
        """Materialise every deferred parameter with one forward in
        predict mode, outside the tape (the reference's InferShape
        pass)."""
        if any(p._deferred_init for p in self.collect_params().values()):
            # a generator of its own: this pass draws nothing of the chain
            with _ag.pause(), torch.no_grad(), _random.generator_scope(
                    torch.Generator(device=_device_of(args))):
                self(*args)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [leaf for a in x for leaf in _leaves(a)]
    return [x]


def _unwrap(x):
    if isinstance(x, (tuple, list)):
        return type(x)(_unwrap(a) for a in x)
    return x._data if isinstance(x, NDArray) else x


def _device_of(args):
    for a in args:
        if isinstance(a, NDArray):
            return a._data.device
        if isinstance(a, torch.Tensor):
            return a.device
    from ..context import current_context

    return current_context().device


def _F():
    from .. import ndarray

    return ndarray


class SymbolBlock(HybridBlock):
    """A Symbol graph run as a block (reference: gluon.SymbolBlock): every
    free variable that is not an input is a parameter of the block under
    its own name (the ``.params`` file's keys), auxiliary when the graph
    marks it so.  The forward evaluates the graph on the inputs and the
    parameters' tensors, under the same NDArray/tensor and tape rules as
    any HybridBlock; a Group's outputs come back as a list."""

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """A SymbolBlock over a ``-symbol.json``, its parameters loaded
        from ``param_file`` onto ``ctx`` (default ``current_context()``)
        in their saved dtypes."""
        from .. import symbol as _sym

        sym = _sym.load(symbol_file)
        if isinstance(input_names, str):
            input_names = [input_names]
        ret = SymbolBlock(sym, [_sym.var(i) for i in input_names])
        if param_file is not None:
            ret.collect_params().load(param_file, ctx=ctx, cast_dtype=True,
                                      dtype_source="saved",
                                      allow_missing=False, ignore_extra=True)
        return ret

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix=None, params=params)
        if isinstance(outputs, (list, tuple)):
            from .. import symbol as _sym

            outputs = outputs[0] if len(outputs) == 1 else \
                _sym.Group(list(outputs))
        if isinstance(inputs, Symbol):
            inputs = [inputs]
        self._outputs_sym = outputs
        self._input_names = [i.name for i in inputs]
        inputs_set = set(self._input_names)
        aux = set(outputs.list_auxiliary_states())
        for name in outputs.list_inputs():
            if name not in inputs_set and name not in self.params._params:
                self.params._params[name] = Parameter(
                    name, allow_deferred_init=True,
                    grad_req="null" if name in aux else "write")

    def _param_values(self, *args):
        return {k: p._value() for k, p in self.params.items()}

    def hybrid_forward(self, F, *args, **params):
        from .. import symbol as _sym

        if F is _sym:
            raise NotImplementedError(
                "SymbolBlock inside a symbolic trace is not supported")
        feed = dict(zip(self._input_names, args))
        feed.update(params)
        outs = self._outputs_sym._eval_heads(feed)
        return outs if isinstance(self._outputs_sym, _sym.Group) \
            else outs[0]
