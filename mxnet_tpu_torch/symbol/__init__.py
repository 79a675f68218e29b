"""``mx.sym``: the symbolic API.

Counterpart of ``mxnet_tpu/symbol/`` (reference: python/mxnet/symbol/):
``Symbol``, ``Variable``/``var``, ``Group``, ``load``/``fromjson``,
``trace_block``, the ``Executor``, ``contrib`` and a wrapper for every
registered op.
"""

from .. import ops as _ops  # noqa: F401  (registers the op families)
from .symbol import (Group, Symbol, Variable, apply_op, fromjson, load,
                     trace_block, var)
from .executor import Executor
from . import register as _register
from . import contrib

_register.populate(globals())
