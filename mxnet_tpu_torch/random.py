"""Random state: seeds become explicit ``torch.Generator`` objects.

Counterpart of ``mxnet_tpu/random.py``.  JAX threads PRNG keys through
traced code; eager PyTorch passes a ``torch.Generator`` to the call that
draws (sampling at a temperature in ``gpt._sample``, dropout in the
trunk).  The two packages give different numbers from the same seed, so
parity tests make their inputs with numpy and compare greedy decodes and
dropout-free training only.

The package seed (``seed``) plays the part of the JAX package's global key
chain: ``step_generator`` draws a fresh generator from it for each
training step (the trainer's ``next_key()``), and ``generator_scope`` makes
that generator the one ``current_generator`` returns while the step's
forward runs (the counterpart of ``key_scope``).  Nothing here touches
torch's global RNG.  The module-level samplers (``uniform``, ``normal``
...) delegate to ``mx.nd.random``, as the JAX package's do.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch


class _State(threading.local):
    def __init__(self):
        self.seed = None
        self.count = 0
        self.scope: list = []
        self.tapes: list = []


_STATE = _State()


def generator(seed_state: int, device=None) -> torch.Generator:
    """A fresh generator on ``device`` (default: the host) seeded with
    ``seed_state``."""
    g = torch.Generator(device=torch.device(device or "cpu"))
    g.manual_seed(int(seed_state))
    return g


def seed(seed_state: int, ctx="all") -> None:
    """Reseed the package's generator chain (``mx.random.seed``): the
    generators ``step_generator`` draws afterwards, and so every
    ``mx.nd.random`` draw, are a function of ``seed_state`` and their
    order.  ``ctx`` is kept for API parity: one chain serves every
    device."""
    _STATE.seed = int(seed_state)
    _STATE.count = 0


def next_seed() -> int:
    """The seed of the next generator of the package chain.  Unseeded, the
    chain starts from the operating system's entropy, as the JAX
    package's does."""
    if _STATE.seed is None:
        _STATE.seed = int.from_bytes(os.urandom(8), "little") >> 1
    _STATE.count += 1
    ss = np.random.SeedSequence([_STATE.seed, _STATE.count])
    return int(ss.generate_state(1, np.uint64)[0] >> 1)


def step_generator(device=None) -> torch.Generator:
    """The next generator of the package chain, on ``device``."""
    return generator(next_seed(), device)


def scoped() -> bool:
    """Whether a ``generator_scope`` is open."""
    return bool(_STATE.scope)


class generator_scope:
    """Context manager making ``gen`` the generator ``current_generator``
    returns, as ``key_scope`` routes ``next_key()`` in the JAX package."""

    def __init__(self, gen: torch.Generator):
        self.gen = gen

    def __enter__(self):
        _STATE.scope.append(self.gen)
        return self.gen

    def __exit__(self, *exc):
        _STATE.scope.pop()


def scoped_generator():
    """The generator of the innermost ``generator_scope``, or None."""
    return _STATE.scope[-1] if _STATE.scope else None


def push_tape(tape) -> None:
    """Route ``keep_mask`` through ``tape`` (``remat``'s recorded draws)
    until the matching ``pop_tape``."""
    _STATE.tapes.append(tape)


def pop_tape() -> None:
    _STATE.tapes.pop()


def keep_mask(shape, keep, generator, device) -> torch.Tensor:
    """A boolean mask, True with probability ``keep``: ``rand < keep``
    drawn from ``generator``, the dropout ops' one draw.  Inside a remat
    region's forward the mask is recorded; in its recompute the recorded
    mask comes back instead of a new draw."""
    tape = _STATE.tapes[-1] if _STATE.tapes else None
    if tape is not None and tape.pos is not None:
        mask = tape.masks[tape.pos]
        tape.pos += 1
        return mask
    mask = torch.rand(shape, generator=generator, device=device) < keep
    if tape is not None:
        tape.masks.append(mask)
    return mask


def current_generator(device=None) -> torch.Generator:
    """The generator of the innermost ``generator_scope``, else the next
    one of the package chain.  Raises if the scope's generator lives on
    another device type than ``device``."""
    if not _STATE.scope:
        return step_generator(device)
    gen = _STATE.scope[-1]
    if device is not None and gen.device.type != torch.device(device).type:
        raise ValueError(f"generator_scope holds a generator on "
                         f"{gen.device}, the draw is on {device}")
    return gen


# -- module-level samplers (reference: python/mxnet/random.py delegates
# to the ndarray.random generated wrappers) --------------------------------

def _delegate(name):
    def fn(*args, **kwargs):
        from .ndarray import random as _ndr

        return getattr(_ndr, name)(*args, **kwargs)

    fn.__name__ = name
    fn.__doc__ = f"mx.random.{name} (delegates to mx.nd.random.{name})"
    return fn


uniform = _delegate("uniform")
normal = _delegate("normal")
randn = _delegate("randn")
randint = _delegate("randint")
poisson = _delegate("poisson")
exponential = _delegate("exponential")
gamma = _delegate("gamma")
multinomial = _delegate("multinomial")
negative_binomial = _delegate("negative_binomial")
generalized_negative_binomial = _delegate("generalized_negative_binomial")
shuffle = _delegate("shuffle")
