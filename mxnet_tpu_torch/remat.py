"""Memory-saving recompute (rematerialisation): the named-policy registry.

Counterpart of ``mxnet_tpu/remat.py`` (reference: the gradient-mirroring
pass ``MXNET_BACKWARD_DO_MIRROR`` enables).  The JAX package's
``jax.checkpoint`` is ``torch.utils.checkpoint.checkpoint`` here, always
non-reentrant (``use_reentrant=False``), so ``torch.autograd.grad`` over
parameters the wrapped function only closes over works:

- ``"full"`` (aliases ``"all"``, ``True``): save nothing inside the region,
  recompute the whole forward in the backward;
- ``"dots"``: save the matrix products' outputs (``mm``, ``addmm``,
  ``bmm``, ``baddbmm``) and recompute the rest, through
  ``torch.utils.checkpoint.create_selective_checkpoint_contexts``;
- ``"dots_no_batch"``: the same, batched products (``bmm``, ``baddbmm``:
  the attention products) recomputed too;
- ``"save_every_k:N"``: the transformer trunk's chunked policy
  (``ops/attention.py::scan_transformer_encoder``): L/N checkpointed
  chunks of N layers; ``wrap`` leaves a function unchanged under it.

Precedence as in the JAX package: the explicit argument (an explicit
``"none"`` included), then ``MXTPU_REMAT``, then
``MXNET_BACKWARD_DO_MIRROR=1`` meaning ``"full"``.

Random draws replay: the recompute must see the dropout masks the forward
drew, or the gradients are silently wrong.  ``torch.utils.checkpoint``'s
``preserve_rng_state`` restores only torch's default generators, and the
port draws from explicit ones (``random.current_generator``), so every
region records the masks its forward draws (``random.keep_mask``) and its
recompute takes them back in the same order, under the forward's
generator scope and autograd recording and training modes (a CUDA
backward recomputes on autograd's device thread, where none is set).
The masks are ordinary tensors, so this holds inside a CUDA graph capture
too; the default generators are never read (``preserve_rng_state=False``).
"""

from __future__ import annotations

import contextlib
import os
import threading

import torch

from .base import MXNetError

_SAVE_EVERY_PREFIX = "save_every_k:"

#: canonical policy name -> zero-arg factory of the ops whose outputs a
#: region saves (None: save nothing, recompute all)
_REGISTRY = {}


def register_policy(name, saved_ops):
    """Register a checkpoint-style policy: ``saved_ops`` is a zero-arg
    factory returning the aten ops whose outputs are saved (None = save
    nothing)."""
    _REGISTRY[name] = saved_ops


def _dots():
    aten = torch.ops.aten
    return (aten.mm.default, aten.addmm.default, aten.bmm.default,
            aten.baddbmm.default)


def _dots_no_batch():
    aten = torch.ops.aten
    return (aten.mm.default, aten.addmm.default)


register_policy("full", lambda: None)
register_policy("dots", _dots)
register_policy("dots_no_batch", _dots_no_batch)


def names():
    """All selectable policy names (the save_every_k family once, with
    its N placeholder)."""
    return ("none",) + tuple(_REGISTRY) + ("all", "save_every_k:N")


def parse_save_every(policy):
    """N for 'save_every_k:N', else None."""
    if isinstance(policy, str) and policy.startswith(_SAVE_EVERY_PREFIX):
        try:
            n = int(policy[len(_SAVE_EVERY_PREFIX):])
        except ValueError:
            raise MXNetError(f"bad remat policy {policy!r}: N must be "
                             "an int >= 1")
        if n < 1:
            raise MXNetError(f"bad remat policy {policy!r}: N must be "
                             ">= 1")
        return n
    return None


def canonical(remat):
    """A remat spec as a canonical policy name, or None (no remat).
    Unknown names raise MXNetError."""
    if remat is None or remat is False:
        return None
    if remat is True:
        return "full"
    name = str(remat)
    if name in ("none", ""):
        return None
    if name == "all":
        return "full"
    if name in _REGISTRY or parse_save_every(name) is not None:
        return name
    raise MXNetError(
        f"unknown remat policy {name!r}: use one of {names()}")


def env_policy():
    """The ``MXTPU_REMAT`` policy (canonical), or None when it is unset or
    'none'."""
    return canonical(os.environ.get("MXTPU_REMAT") or None)


def env_default(remat):
    """The effective policy: the explicit argument first (an explicit
    'none' included), then MXTPU_REMAT, then MXNET_BACKWARD_DO_MIRROR ->
    'full'."""
    if remat is not None:
        return canonical(remat)
    raw = os.environ.get("MXTPU_REMAT")
    if raw:
        return canonical(raw)
    if os.environ.get("MXNET_BACKWARD_DO_MIRROR", "0") not in ("0", ""):
        return "full"
    return None


# -- the recorded draws --------------------------------------------------------

class _Local(threading.local):
    def __init__(self):
        self.depth = 0


_LOCAL = _Local()


def active():
    """Whether a remat region's forward is running on this thread (an
    inner ``wrap`` then runs its function as it is: one checkpoint)."""
    return _LOCAL.depth > 0


class _Draws:
    """The masks one region's forward drew, and what its recompute needs
    to run as the forward did: the generator scope and the autograd
    recording and training modes."""

    def __init__(self):
        from . import autograd as _ag
        from . import random as _random

        self.masks = []
        self.pos = None                      # None: recording
        self.gen = _random.scoped_generator()
        self.recording = _ag.is_recording()
        self.training = _ag.is_training()


@contextlib.contextmanager
def _recording(draws):
    from . import random as _random

    _LOCAL.depth += 1
    _random.push_tape(draws)
    try:
        yield
    finally:
        _random.pop_tape()
        _LOCAL.depth -= 1


@contextlib.contextmanager
def _replaying(draws):
    from . import autograd as _ag
    from . import random as _random

    draws.pos = 0
    _LOCAL.depth += 1
    _random.push_tape(draws)
    mode = _ag._RecordingScope(draws.recording, draws.training)
    scope = _random.generator_scope(draws.gen) if draws.gen is not None \
        else contextlib.nullcontext()
    try:
        with mode, scope:
            yield
        if draws.pos != len(draws.masks):
            raise MXNetError(f"remat: the recompute drew {draws.pos} masks, "
                             f"the forward {len(draws.masks)}")
    finally:
        draws.pos = None
        _random.pop_tape()
        _LOCAL.depth -= 1


def _contexts(policy):
    """``context_fn`` for ``torch.utils.checkpoint``: the recorded draws,
    and for the 'dots' policies the selective checkpoint's own pair."""
    saved = _REGISTRY[policy]()

    def context_fn():
        draws = _Draws()
        fwd, rec = _recording(draws), _replaying(draws)
        if saved is None:
            return fwd, rec
        from torch.utils.checkpoint import (
            CheckpointPolicy, create_selective_checkpoint_contexts)

        def choose(ctx, op, *args, **kwargs):
            return CheckpointPolicy.MUST_SAVE if op in saved \
                else CheckpointPolicy.PREFER_RECOMPUTE

        sac_fwd, sac_rec = create_selective_checkpoint_contexts(choose)
        return _joined(fwd, sac_fwd), _joined(rec, sac_rec)

    return context_fn


@contextlib.contextmanager
def _joined(first, second):
    with first, second:
        yield


def checkpoint(fn, policy, *args):
    """``fn(*args)`` as one checkpointed region under ``policy`` (a
    canonical checkpoint-style name).  Outside autograd (no grad mode, or
    inside another region) it is a plain call."""
    if not torch.is_grad_enabled() or active():
        return fn(*args)
    from torch.utils.checkpoint import checkpoint as _ckpt

    return _ckpt(fn, *args, use_reentrant=False, preserve_rng_state=False,
                 context_fn=_contexts(policy))


def wrap(fn, remat):
    """``fn`` run as one checkpointed region per the policy (after
    ``env_default``); unchanged for None/'none' and for 'save_every_k:N',
    which applies inside the trunk (``trunk_policy``)."""
    remat = env_default(remat)
    if not remat or parse_save_every(remat) is not None:
        return fn
    if remat not in _REGISTRY:
        raise MXNetError(
            f"unknown remat policy {remat!r}: use one of {names()}")

    def wrapped(*args):
        return checkpoint(fn, remat, *args)

    return wrapped


def trunk_policy(remat):
    """The remat policy of the transformer trunk: ('layer', name) for a
    checkpoint per layer, ('every', N) for save_every_k chunks, or None.
    An explicit truthy ``remat`` on the op wins (True: per layer, 'full');
    otherwise only the env *save_every_k* policy applies here: whole-step
    policies ('full', 'dots', ...) are applied once at the step or block
    boundary by ``wrap``, and per layer too would checkpoint twice."""
    if remat:
        name = canonical(remat)
        if name is None:
            return None
        n = parse_save_every(name)
        if n is not None:
            return ("every", n)
        return ("layer", name)
    n = parse_save_every(env_default(None))
    if n is not None:
        return ("every", n)
    return None
