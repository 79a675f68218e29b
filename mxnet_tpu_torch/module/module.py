"""Module and BucketingModule: symbolic training on a bound executor.

Counterpart of ``mxnet_tpu/module/module.py`` (reference:
python/mxnet/module/module.py and bucketing_module.py).

- ``Module`` (``:25-194``): ``bind`` over ``simple_bind`` on the
  module's context (default ``current_context()``, the card), the
  parameters in the data's floating type,
  ``init_params`` (the parameters and the auxiliary states, each from its
  variable's ``init`` attribute or by name), ``get_params``/
  ``set_params``, ``init_optimizer`` (``rescale_grad = 1 / batch`` unless
  given, over ``optimizer.get_updater``; a dist kvstore reduces each
  gradient before the update, as at ``:131-140``), ``update``,
  ``update_metric``, ``save_checkpoint``/``load``.  One executor: the
  reference's DataParallelExecutorGroup over several devices is not kept.
- ``BucketingModule`` (``:196-299``): one Module per bucket key, each
  bound with the default bucket's module as ``shared_module``, so every
  bucket's parameters (and auxiliary states) are the default bucket's
  arrays and its updater is shared too.
"""

from __future__ import annotations

import logging

from .. import initializer as init_mod
from .. import optimizer as opt_mod
from .. import random as _random
from ..base import MXNetError, torch_dtype
from ..model import load_checkpoint, save_checkpoint
from ..symbol.executor import _assign
from .base_module import BaseModule


def _init_desc(name, attrs):
    """An InitDesc carrying the variable's own initializer (its ``init``
    or ``__init__`` attribute)."""
    own = attrs.get("__init__") or attrs.get("init")
    return init_mod.InitDesc(name, {"__init__": own} if own else {})


def _init_aux(initializer, desc, arr):
    """Auxiliary states without an initializer of their own start as the
    reference's: variances at one, means and the rest at zero."""
    if desc.attrs.get("__init__"):
        initializer(desc, arr)
    elif desc.endswith(("var", "variance")):
        arr.fill_(1.0)
    else:
        arr.zero_()


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None,
                 compression_params=None):
        from ..context import current_context

        super().__init__(logger=logger)
        if isinstance(context, (list, tuple)):
            if len(context) > 1:
                raise MXNetError("Module: one context (the executor group "
                                 "over several devices is not kept)")
            context = context[0]
        self._context = context or current_context()
        self._symbol = symbol
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        self._fixed_param_names = list(fixed_param_names or [])
        self._param_names = [n for n in symbol.list_arguments()
                             if n not in self._data_names
                             and n not in self._label_names]
        self._aux_names = symbol.list_auxiliary_states()
        self._param_index = {n: i for i, n in enumerate(self._param_names)}
        self._exec = None
        self._optimizer = None
        self._updater = None
        self._kvstore = None
        self._preloaded = None
        self._preloaded_states = None

    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._symbol.list_outputs()

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        """Bind an executor for these input shapes (reference:
        Module.bind).  With ``shared_module``, parameters and auxiliary
        states of the same names and shapes are that module's arrays."""
        if self.binded and not force_rebind:
            return
        shapes, types = {}, {}
        for desc in list(data_shapes) + list(label_shapes or []):
            shapes[desc[0]] = tuple(desc[1])
            dtype = getattr(desc, "dtype", None)
            if dtype is not None:
                types[desc[0]] = dtype
        # the parameters and auxiliary states take the data's floating
        # type, as the reference's type inference gives them
        floating = [t for n, t in types.items() if n in self._data_names
                    and torch_dtype(t).is_floating_point]
        if floating:
            for n in self._param_names + self._aux_names:
                types.setdefault(n, floating[0])
        self._batch_size = tuple(data_shapes[0][1])[0]
        req = {}
        for n in self._symbol.list_arguments():
            if n in self._data_names:
                req[n] = grad_req if inputs_need_grad else "null"
            elif n in self._label_names or n in self._fixed_param_names:
                req[n] = "null"
            else:
                req[n] = grad_req if for_training else "null"
        shared = shared_module._exec if shared_module is not None else None
        self._exec = self._symbol.simple_bind(
            ctx=self._context, grad_req=req, type_dict=types,
            shared_exec=shared, **shapes)
        self.binded = True
        self.for_training = for_training
        if shared_module is not None and shared_module.params_initialized:
            self.params_initialized = True

    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        """Initialise the parameters and auxiliary states: from
        ``arg_params``/``aux_params`` (or what ``Module.load`` read) where
        they hold a name, else with ``initializer`` (default
        ``Uniform(0.01)``)."""
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before init_params"
        if arg_params is None and aux_params is None and self._preloaded:
            arg_params, aux_params = self._preloaded
        if initializer is None:
            initializer = init_mod.Uniform(0.01)
        attrs = self._symbol.attr_dict()
        for given, names, table in (
                (arg_params, self._param_names, self._exec.arg_dict),
                (aux_params, self._aux_names, self._exec.aux_dict)):
            for name in names:
                arr = table[name]
                if given and name in given:
                    _assign(arr, given[name])
                    continue
                if given and not allow_missing:
                    raise MXNetError(f"{name} is not presented")
                desc = _init_desc(name, attrs.get(name, {}))
                t = arr._data
                if table is self._exec.aux_dict:
                    _init_aux(initializer, desc, t)
                else:
                    initializer(desc, t,
                                _random.step_generator(t.device))
                arr._version += 1
        self.params_initialized = True

    def get_params(self):
        """(arg_params, aux_params): copies of the current values."""
        arg_params = {n: self._exec.arg_dict[n].copy()
                      for n in self._param_names}
        aux_params = {n: self._exec.aux_dict[n].copy()
                      for n in self._aux_names}
        return arg_params, aux_params

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """The optimizer (a name with ``optimizer_params``, or an
        instance), its updater, and a dist kvstore's wiring."""
        if self.optimizer_initialized and not force_init:
            return
        if isinstance(optimizer, str):
            optimizer_params = dict(optimizer_params)
            if "rescale_grad" not in optimizer_params:
                # the reference's default: summed gradients over the batch
                optimizer_params["rescale_grad"] = \
                    1.0 / getattr(self, "_batch_size", 1)
            optimizer = opt_mod.create(
                optimizer, param_idx2name=dict(enumerate(self._param_names)),
                sym=self._symbol, **optimizer_params)
        self._optimizer = optimizer
        self._updater = opt_mod.get_updater(optimizer)
        if self._preloaded_states:
            with open(self._preloaded_states, "rb") as f:
                self._updater.set_states(f.read())
        if kvstore:
            from .. import kvstore as kv_mod

            kv = kv_mod.create(kvstore) if isinstance(kvstore, str) \
                else kvstore
            if kv.num_workers > 1 or kv.type.startswith("dist"):
                self._kvstore = kv
                for name in self._param_names:
                    kv.init(self._param_index[name],
                            self._exec.arg_dict[name])
        self.optimizer_initialized = True

    def borrow_optimizer(self, shared_module):
        """Use ``shared_module``'s optimizer, updater and kvstore (its
        states are keyed by its parameter indices)."""
        self._optimizer = shared_module._optimizer
        self._updater = shared_module._updater
        self._kvstore = shared_module._kvstore
        self._param_index = shared_module._param_index
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        if is_train is None:
            is_train = self.for_training
        feed = dict(zip(self._data_names, data_batch.data))
        if data_batch.label is not None and self._label_names:
            feed.update(zip(self._label_names, data_batch.label))
        self._exec.forward(is_train=is_train, **feed)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._exec.backward(out_grads=out_grads)

    def update(self):
        """Each parameter's gradient (reduced over the kvstore's workers
        when there is one) through the updater."""
        assert self.optimizer_initialized
        for name in self._param_names:
            grad = self._exec.grad_dict.get(name)
            if grad is None:
                continue
            i = self._param_index[name]
            if self._kvstore is not None:
                self._kvstore.pushpull(i, grad, out=grad)
            self._updater(i, grad, self._exec.arg_dict[name])

    def get_outputs(self, merge_multi_context=True):
        return self._exec.outputs

    def get_input_grads(self, merge_multi_context=True):
        return [self._exec.grad_dict.get(n) for n in self._data_names]

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        eval_metric.update(labels, self._exec.outputs)

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False,
                        remove_amp_cast=True):
        """``prefix-symbol.json``, ``prefix-%04d.params`` and, when asked,
        ``prefix-%04d.states`` (the updater's states)."""
        arg_params, aux_params = self.get_params()
        save_checkpoint(prefix, epoch, self._symbol, arg_params,
                        aux_params)
        if save_optimizer_states and self._updater is not None:
            with open(f"{prefix}-{epoch:04d}.states", "wb") as f:
                f.write(self._updater.get_states())

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module over a checkpoint's symbol; ``init_params`` without
        arguments takes its parameters, ``init_optimizer`` its optimizer
        states when asked."""
        symbol, arg_params, aux_params = load_checkpoint(
            prefix, epoch, ctx=kwargs.get("context"))
        mod = Module(symbol, **kwargs)
        mod._preloaded = (arg_params, aux_params)
        if load_optimizer_states:
            mod._preloaded_states = f"{prefix}-{epoch:04d}.states"
        return mod


class BucketingModule(BaseModule):
    """One Module per bucket key from ``sym_gen(key) -> (symbol,
    data_names, label_names)``, sharing the default bucket's parameters
    (reference: bucketing_module.py: variable-length batching)."""

    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, **kwargs):
        super().__init__(logger=logger)
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._context = context
        self._kwargs = kwargs
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._monitor = None

    @property
    def default_bucket_key(self):
        return self._default_bucket_key

    def _module(self, bucket_key):
        if bucket_key not in self._buckets:
            sym, data_names, label_names = self._sym_gen(bucket_key)
            self._buckets[bucket_key] = Module(
                sym, data_names=data_names, label_names=label_names,
                logger=self.logger, context=self._context, **self._kwargs)
        return self._buckets[bucket_key]

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Make ``bucket_key``'s module current, binding it over the
        default bucket's arrays at its first use."""
        mod = self._module(bucket_key)
        if not mod.binded:
            default = self._buckets[self._default_bucket_key]
            mod.bind(data_shapes, label_shapes,
                     for_training=self.for_training,
                     shared_module=None if mod is default else default)
            if mod is not default and default.optimizer_initialized:
                mod.borrow_optimizer(default)
            if self._monitor is not None:
                mod.install_monitor(self._monitor)
        self._curr_module = mod
        self._curr_bucket_key = bucket_key

    def install_monitor(self, mon):
        """Watch every bound bucket, and the buckets bound later."""
        self._monitor = mon
        for mod in self._buckets.values():
            if mod.binded:
                mod.install_monitor(mon)

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        if self.binded and not force_rebind:
            return
        self.for_training = for_training
        self.switch_bucket(self._default_bucket_key, data_shapes,
                           label_shapes)
        self.binded = True

    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        self._buckets[self._default_bucket_key].init_params(
            initializer=initializer, arg_params=arg_params,
            aux_params=aux_params, allow_missing=allow_missing,
            force_init=force_init, allow_extra=allow_extra)
        for mod in self._buckets.values():
            mod.params_initialized = True
        self.params_initialized = True

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(arg_params=arg_params, aux_params=aux_params,
                         allow_missing=allow_missing, force_init=force_init)

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        default = self._buckets[self._default_bucket_key]
        default.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                               optimizer_params=optimizer_params,
                               force_init=force_init)
        for mod in self._buckets.values():
            if mod is not default:
                mod.borrow_optimizer(default)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        key = data_batch.bucket_key if data_batch.bucket_key is not None \
            else self._default_bucket_key
        if key != self._curr_bucket_key:
            self.switch_bucket(key, data_batch.provide_data,
                               data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads)

    def update(self):
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs(merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._curr_module.update_metric(eval_metric, labels, pre_sliced)

    def get_params(self):
        return self._curr_module.get_params()

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False,
                        remove_amp_cast=True):
        self._buckets[self._default_bucket_key].save_checkpoint(
            prefix, epoch, save_optimizer_states)

    @property
    def symbol(self):
        return self._curr_module.symbol if self._curr_module else None
