"""Gluon ``Parameter``, ``Constant`` and ``ParameterDict``.

Counterpart of ``mxnet_tpu/gluon/parameter.py`` (reference:
python/mxnet/gluon/parameter.py): shapes with 0 for a dimension that is
solved at the first forward (deferred initialisation), ``grad_req``,
``lr_mult``/``wd_mult``, ``Constant``, and a ``ParameterDict`` with prefix
namespacing and shared parameters.

A materialised parameter holds one tensor.  With ``grad_req`` "write" or
"add" it is a ``torch.nn.Parameter``; with "null" (BatchNorm's running
statistics, a ``Constant``) a plain tensor.  Every ``Block`` that holds
the parameter as an attribute registers that tensor under the attribute's
name, as a torch parameter or as a buffer, so ``named_parameters()``,
``state_dict()`` and ``train()`` see it; a deferred parameter is
registered as ``None`` until it materialises.  ``data()`` is a port
``NDArray`` over that same tensor, and its gradient buffer is ``grad()``:
the imperative path (``autograd.record()`` + ``backward()``) writes there.
A write through ``data()`` (``set_data``, ``x[:] = v``, ``copyto``) goes
into the tensor in place, so the block and the NDArray never part.
``cast`` and ``reset_ctx`` replace the tensor and register the new one.

Initialisation draws from a ``torch.Generator`` on the parameter's
device: the one passed to ``initialize``, else the next of the package
chain (``random.seed``).  A deferred parameter keeps the initializer, the
context and the generator, and draws when its shape is known; a ``cast``
made while it is deferred gives it its dtype when it materialises.
"""

from __future__ import annotations

import copy
import weakref

import numpy as _np
import torch

from .. import initializer
from .. import random as _random
from ..base import MXNetError, np_dtype, torch_dtype
from ..context import cpu, current_context
from ..ndarray.ndarray import NDArray


#: stand-in tensors by ``id(Parameter)``, innermost scope last
_OVERRIDES = []


class param_override_scope:
    """Make each Parameter of ``mapping`` ({Parameter: tensor}) read its
    tensor in a block's forward (the JAX package's
    ``param_override_scope``): the sharded trainer runs the forward on a
    rank's shards and gathered weights this way."""

    def __init__(self, mapping):
        self._map = {id(p): t for p, t in mapping.items()}

    def __enter__(self):
        _OVERRIDES.append(self._map)
        return self

    def __exit__(self, *exc):
        _OVERRIDES.pop()


class DeferredInitializationError(MXNetError):
    """Parameter accessed before its deferred shape was known."""


class _ParamArray(NDArray):
    """The NDArray ``Parameter.data()`` returns: its tensor is the
    parameter's own, and a write lands in that tensor in place."""

    __slots__ = ()

    def _set_data(self, t):
        with torch.no_grad():
            self._data.copy_(t)
        self._version += 1


def _dtype_name(dtype):
    return torch_dtype(dtype).__repr__().split(".")[-1]


class Parameter:
    """A Block parameter (reference: gluon.Parameter)."""

    def __init__(self, name, grad_req="write", shape=None, dtype=_np.float32,
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        self._tensor = None
        self._nd = None
        self._ctx = None
        self._deferred_init = ()
        self._owners = []
        self._differentiable = differentiable
        self._allow_deferred_init = allow_deferred_init
        self._grad_req = None
        if isinstance(shape, int):
            shape = (shape,)
        self._shape = tuple(shape) if shape is not None else None
        self.name = name
        self._dtype = np_dtype(dtype)
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        for st in (stype, grad_stype):
            if st not in ("default", "row_sparse", "csr"):
                raise MXNetError(f"Parameter {name!r}: unknown storage "
                                 f"type {st!r}")
        self._stype = stype
        self._grad_stype = grad_stype
        self.grad_req = grad_req
        self.init = init
        self._var = None

    def __repr__(self):
        return f"Parameter {self.name} (shape={self.shape}, " \
               f"dtype={self.dtype})"

    def __deepcopy__(self, memo):
        """A copy with its own tensor, registered on the copies of its
        owners (a block copied with ``copy.deepcopy`` gets parameters of
        its own)."""
        new = self.__class__.__new__(self.__class__)
        memo[id(self)] = new
        for k, v in self.__dict__.items():
            if k not in ("_tensor", "_nd", "_owners", "_deferred_init",
                         "_var"):
                new.__dict__[k] = copy.deepcopy(v, memo)
        new._tensor = new._nd = new._var = None
        new._deferred_init = self._deferred_init
        new._owners = [(weakref.ref(memo[id(b)]), attr)
                       for b, attr in ((r(), a) for r, a in self._owners)
                       if b is not None and id(b) in memo]
        if self._tensor is not None:
            # the memo hands the copied block's _parameters/_buffers entry
            # the same tensor; the copy's owners are not built yet, so the
            # tensor is not registered again here
            new._bind(copy.deepcopy(self._tensor, memo), self._ctx,
                      register=False)
        return new

    # -- attributes ------------------------------------------------------------
    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        assert req in ("write", "add", "null"), \
            f"grad_req must be one of 'write', 'add', or 'null', but got {req}"
        if not self._differentiable:
            req = "null"
        if self._grad_req == req:
            return
        self._grad_req = req
        if self._tensor is not None:
            self._bind(self._tensor.detach(), self._ctx)

    @property
    def dtype(self):
        return self._dtype

    @dtype.setter
    def dtype(self, dtype):
        self.cast(dtype)

    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        new_shape = tuple(new_shape)
        if self._shape is None:
            self._shape = new_shape
            return
        assert len(self._shape) == len(new_shape) and \
            all(j in (0, i) for i, j in zip(new_shape, self._shape)), \
            f"Expected shape {new_shape} is incompatible with given shape " \
            f"{self._shape}."
        self._shape = new_shape

    @property
    def stype(self):
        return self._stype

    @property
    def grad_stype(self):
        return self._grad_stype

    # -- the tensor and its owners ----------------------------------------------
    def _attach(self, block, attr):
        """Register this parameter's tensor on ``block`` as attribute
        ``attr`` (now and whenever the tensor is replaced)."""
        self._owners.append((weakref.ref(block), attr))
        self._register(block, attr)

    def _register(self, block, attr):
        if self._tensor is None or isinstance(self._tensor,
                                              torch.nn.Parameter):
            home, other = block._parameters, block._buffers
        else:
            home, other = block._buffers, block._parameters
        other.pop(attr, None)
        home[attr] = self._tensor         # an existing entry keeps its place

    def _bind(self, t, ctx, register=True):
        """Make ``t`` (a tensor on ``ctx``'s device) the value: a
        ``torch.nn.Parameter`` unless ``grad_req`` is "null", wrapped by the
        ``data()`` NDArray, registered on every owner."""
        trainable = self._grad_req != "null" and t.is_floating_point()
        if trainable and not isinstance(t, torch.nn.Parameter):
            t = torch.nn.Parameter(t.detach(), requires_grad=True)
        elif not trainable and t.requires_grad:
            t = t.detach()
        self._tensor, self._ctx = t, ctx
        nd = self._nd if self._nd is not None else _ParamArray(t, ctx)
        nd._data, nd._ctx, nd._version = t, ctx, nd._version + 1
        if trainable:
            if self._grad_stype == "row_sparse":
                from ..ndarray import sparse

                nd._grad = sparse.zeros("row_sparse", t.shape, ctx, t.dtype)
            else:
                nd._grad = NDArray(torch.zeros_like(t.detach()), ctx)
            nd._grad_req = self._grad_req
            nd._leaf = t
            t._mx_var = weakref.ref(nd)
        else:
            nd._grad, nd._grad_req, nd._leaf = None, "null", None
        self._nd = nd
        if not register:
            return
        alive = []
        for ref, attr in self._owners:
            block = ref()
            if block is not None:
                self._register(block, attr)
                block._cache_version += 1
                alive.append((ref, attr))
        self._owners = alive

    def _check_and_get(self):
        if self._nd is not None:
            return self._nd
        if self._deferred_init:
            raise DeferredInitializationError(
                f"Parameter '{self.name}' has not been initialized yet "
                "because initialization was deferred. Actual initialization "
                "happens during the first forward pass. Please pass one "
                "batch of data through the network before accessing "
                "Parameters.")
        raise RuntimeError(
            f"Parameter '{self.name}' has not been initialized. Note that "
            "you should initialize parameters and create Trainer with "
            "Block.collect_params() instead of Block.params because the "
            "later does not include Parameters of nested child Blocks")

    def _value(self):
        """The tensor, for a block's forward: raises as ``data()`` does
        while the parameter is deferred or uninitialised.  Inside
        ``param_override_scope`` a parameter it maps reads its
        stand-in."""
        if _OVERRIDES:
            t = _OVERRIDES[-1].get(id(self))
            if t is not None:
                return t
        return self._check_and_get()._data

    # -- initialisation ----------------------------------------------------------
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False, generator=None):
        """Materialise the parameter (reference: Parameter.initialize) on
        ``ctx`` (default ``current_context()``, read now); deferred while
        the shape has unknown (0) dims and ``allow_deferred_init`` is set.
        ``init`` or the parameter's own ``init`` wins over
        ``default_init``'s name-suffix dispatch (default ``Uniform()``).
        Draws come from ``generator``, default the next generator of the
        package chain on the parameter's device."""
        if self._tensor is not None and not force_reinit:
            return
        if default_init is None:
            default_init = initializer.Uniform()
        if isinstance(ctx, (list, tuple)):
            ctx = ctx[0] if ctx else None
        ctx = ctx or current_context()
        if self.shape is None or any(s <= 0 for s in self.shape):
            if self._allow_deferred_init:
                self._deferred_init = (init, default_init, ctx, generator)
                return
            raise ValueError(
                f"Cannot initialize Parameter '{self.name}' because it has "
                f"invalid shape: {self.shape}.")
        self._deferred_init = ()
        self._init_from(init, default_init, ctx, generator)

    def _finish_deferred_init(self):
        if not self._deferred_init:
            return
        init, default_init, ctx, generator = self._deferred_init
        self._deferred_init = ()
        assert self.shape is not None and all(s > 0 for s in self.shape), \
            f"Cannot initialize Parameter '{self.name}' because it has " \
            f"invalid shape: {self.shape}."
        self._init_from(init, default_init, ctx, generator)

    def _init_from(self, init, default_init, ctx, generator):
        t = torch.zeros(self.shape, dtype=torch_dtype(self.dtype),
                        device=ctx.device)
        if generator is None:
            generator = _random.step_generator(ctx.device)
        specific = init if init is not None else self.init
        initializer.create(default_init)(self.name, t, generator, specific)
        self._bind(t, ctx)

    def _init_impl(self, data, ctx=None):
        """Take a copy of ``data`` (an NDArray, tensor or numpy array) as
        the value, in this parameter's dtype, on ``ctx`` (default: where it
        lives now, else where it was to be initialised, else
        ``current_context()``)."""
        if ctx is None:
            ctx = self._ctx or (self._deferred_init[2] if self._deferred_init
                                else None) or current_context()
        if isinstance(data, NDArray):
            data = data._data
        t = torch.as_tensor(data).detach().to(
            device=ctx.device, dtype=torch_dtype(self.dtype), copy=True)
        self._bind(t, ctx)
        self._deferred_init = ()

    def _load_init(self, data, ctx=None, cast_dtype=False,
                   dtype_source="current"):
        """Load from a saved array (reference: Parameter._load_init)."""
        if isinstance(ctx, (list, tuple)):
            ctx = ctx[0] if ctx else None
        if self.shape:
            for self_dim, data_dim in zip(self.shape, data.shape):
                assert self_dim in (0, data_dim), \
                    f"Failed loading Parameter '{self.name}' from saved " \
                    f"params: shape incompatibility, expected {self.shape} " \
                    f"vs saved {tuple(data.shape)}"
        self._shape = tuple(data.shape)
        if not cast_dtype:
            if _dtype_name(self.dtype) != _dtype_name(data.dtype):
                raise AssertionError(
                    f"Failed loading Parameter '{self.name}' from saved "
                    f"params: dtype incompatibility, expected "
                    f"{self.dtype} vs saved {data.dtype}. Set cast_dtype=True "
                    "to cast the dtype of saved params.")
        elif dtype_source == "saved":
            self._dtype = np_dtype(data.dtype)
        self._init_impl(data, ctx)

    # -- values ----------------------------------------------------------------
    def set_data(self, data):
        """Write ``data`` into the parameter (reference:
        Parameter.set_data); a deferred parameter takes it as its value."""
        self.shape = data.shape
        if self._tensor is None:
            assert self._deferred_init, \
                f"Parameter '{self.name}' has not been initialized"
            self._init_impl(data)
            return
        raw = data._data if isinstance(data, NDArray) else \
            torch.as_tensor(data)
        self._nd._set_data(raw.to(device=self._tensor.device,
                                  dtype=self._tensor.dtype))

    def data(self, ctx=None):
        return self._check_and_get()

    def row_sparse_data(self, row_id):
        """The value for the rows ``row_id`` will touch (reference:
        Parameter.row_sparse_data): one worker holds the whole table, so
        this is ``data()``."""
        return self.data()

    def list_row_sparse_data(self, row_id):
        return [self.row_sparse_data(row_id)]

    def list_data(self):
        return [self._check_and_get()]

    def grad(self, ctx=None):
        nd = self._check_and_get()
        if nd._grad is None:
            raise RuntimeError(
                f"Cannot get gradient array for Parameter '{self.name}' "
                "because grad_req='null'")
        return nd._grad

    def list_grad(self):
        return [self.grad()]

    def list_ctx(self):
        if self._tensor is None:
            if self._deferred_init:
                return [self._deferred_init[2]]
            raise RuntimeError(f"Parameter '{self.name}' has not been "
                               "initialized")
        return [self._ctx]

    def zero_grad(self):
        if self._nd is None or self._nd._grad is None:
            return
        g = self._nd._grad
        if g.stype == "row_sparse":
            g._set_sparse(g._rs_indices[:0], g._rs_values[:0])
            return
        g._set_data(torch.zeros_like(g._data))

    def reset_ctx(self, ctx):
        """Move the value to ``ctx`` (gradients restart at zero)."""
        if isinstance(ctx, (list, tuple)):
            ctx = ctx[0]
        if self._tensor is not None:
            self._bind(self._tensor.detach().to(ctx.device), ctx)
        elif self._deferred_init:
            init, default_init, _, generator = self._deferred_init
            self._deferred_init = (init, default_init, ctx, generator)

    def var(self):
        """This parameter as a symbol Variable of its name (reference:
        Parameter.var), made once."""
        if self._var is None:
            from .. import symbol

            self._var = symbol.var(self.name, shape=self.shape,
                                   dtype=self.dtype, lr_mult=self.lr_mult,
                                   wd_mult=self.wd_mult, init=self.init)
        return self._var

    def cast(self, dtype):
        """Cast to ``dtype``; a deferred parameter materialises in it."""
        self._dtype = np_dtype(dtype)
        self._var = None
        if self._tensor is not None:
            self._bind(self._tensor.detach().to(torch_dtype(dtype)),
                       self._ctx)


class _Value(initializer.Initializer):
    """Initializer that copies a fixed tensor (``Constant``'s)."""

    def __init__(self, value):
        super().__init__()
        self.value = value

    def _init_weight(self, name, arr, generator):
        with torch.no_grad():
            arr.copy_(self.value.to(device=arr.device, dtype=arr.dtype))


class Constant(Parameter):
    """A parameter that is never trained (reference: gluon.Constant)."""

    def __init__(self, name, value):
        if isinstance(value, NDArray):
            value = value._data
        value = torch.as_tensor(_np.asarray(value) if not isinstance(
            value, torch.Tensor) else value).detach()
        self.value = value
        super().__init__(name, grad_req="null", shape=tuple(value.shape),
                         dtype=value.dtype, init=_Value(value))


class ParameterDict:
    """Ordered dict of Parameters with a prefix (reference:
    gluon.ParameterDict)."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = {}
        self._shared = shared

    def __repr__(self):
        name = self._prefix + " " if self._prefix else ""
        return "{name}(\n{content}\n)".format(name=name, content="\n".join(
            [repr(v).replace("\n", "\n  ") for v in self.values()]))

    def __getitem__(self, key):
        return self._params[key]

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    @property
    def prefix(self):
        return self._prefix

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._shared._params[name]
        return None

    def get(self, name, **kwargs):
        """Get or create ``self.prefix + name``; a found parameter must
        agree with ``kwargs`` (a 0 dim agrees with any)."""
        name = self.prefix + name
        param = self._get_impl(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
            return param
        for k, v in kwargs.items():
            existing = getattr(param, k, None)
            if existing is None:
                setattr(param, k, v)
                continue
            if k == "shape" and len(v) == len(existing):
                dims = []
                for d1, d2 in zip(v, existing):
                    if d1 != d2 and d1 * d2 != 0:
                        break
                    dims.append(max(d1, d2))
                else:
                    param._shape = tuple(dims)
                    continue
            elif k == "dtype" and _dtype_name(v) == _dtype_name(existing):
                continue
            assert v is None or v == existing, \
                f"Cannot retrieve Parameter '{name}' because desired " \
                f"attribute does not match with stored for attribute " \
                f"'{k}': desired '{v}' vs stored '{existing}'"
        return param

    def get_constant(self, name, value=None):
        name = self.prefix + name
        param = self._get_impl(name)
        if param is None:
            if value is None:
                raise KeyError(
                    f"No constant named '{name}'. Please specify value if "
                    "you want to create a new constant.")
            param = Constant(name, value)
            self._params[name] = param
        elif value is not None:
            assert isinstance(param, Constant), \
                f"Parameter '{name}' already exists but it is not a constant."
        return param

    def update(self, other):
        for k, v in other.items():
            if k in self._params:
                assert self._params[k] is v, \
                    f"Cannot update self with other because they have " \
                    f"different Parameters with the same name '{k}'"
            else:
                self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False, generator=None):
        """Initialise every parameter with ``init`` as the default
        initializer (``Uniform()`` when None), from one generator (default:
        the next of the package chain on ``ctx``'s device)."""
        if isinstance(ctx, (list, tuple)):
            ctx = ctx[0] if ctx else None
        ctx = ctx or current_context()
        if generator is None:
            generator = _random.step_generator(ctx.device)
        for v in self.values():
            v.initialize(None, ctx, init, force_reinit=force_reinit,
                         generator=generator)

    def zero_grad(self):
        for v in self.values():
            v.zero_grad()

    def reset_ctx(self, ctx):
        for v in self.values():
            v.reset_ctx(ctx)

    def list_ctx(self):
        s = []
        for v in self.values():
            for c in v.list_ctx():
                if c not in s:
                    s.append(c)
        return s

    def setattr(self, name, value):
        for v in self.values():
            setattr(v, name, value)

    def save(self, filename, strip_prefix=""):
        from ..ndarray import save as nd_save

        arg_dict = {}
        for param in self.values():
            if not param.name.startswith(strip_prefix):
                raise ValueError(
                    f"Prefix '{strip_prefix}' is to be striped before "
                    f"saving, but Parameter's name '{param.name}' does not "
                    "start with it")
            arg_dict[param.name[len(strip_prefix):]] = param.data()
        nd_save(filename, arg_dict)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix="", cast_dtype=False,
             dtype_source="current"):
        from ..ndarray import load as nd_load

        if restore_prefix:
            for name in self.keys():
                assert name.startswith(restore_prefix), \
                    f"restore_prefix is '{restore_prefix}' but Parameter " \
                    f"name '{name}' does not start with it"
        lprefix = len(restore_prefix)
        loaded = nd_load(filename, ctx=cpu())     # staged on the host
        arg_dict = {(restore_prefix + k[4:] if k.startswith(("arg:", "aux:"))
                     else restore_prefix + k): v for k, v in loaded.items()}
        if not allow_missing:
            for name in self.keys():
                assert name in arg_dict, \
                    f"Parameter '{name[lprefix:]}' is missing in file " \
                    f"'{filename}'"
        for name in arg_dict:
            if name not in self._params:
                assert ignore_extra, \
                    f"Parameter '{name[lprefix:]}' loaded from file " \
                    f"'{filename}' is not present in ParameterDict"
                continue
            self[name]._load_init(arg_dict[name], ctx,
                                  cast_dtype=cast_dtype,
                                  dtype_source=dtype_source)
