"""``mx.nd.linalg``: the linear-algebra ops under their names less the
``linalg_`` prefix (counterpart of ``mxnet_tpu/ndarray/linalg.py``)."""

from __future__ import annotations

from ..ops import registry as _registry
from . import register as _register

_NAMES = ("gemm", "gemm2", "potrf", "potri", "trsm", "trmm", "syrk",
          "gelqf", "syevd", "sumlogdiag", "extractdiag", "makediag",
          "extracttrian", "maketrian", "inverse", "det", "slogdet", "svd")


def _alias(public):
    opdef = _registry.get("linalg_" + public)

    def f(*args, **kwargs):
        return _register.invoke(opdef, args, kwargs)

    f.__name__ = public
    f.__doc__ = opdef.fn.__doc__
    return f


globals().update({name: _alias(name) for name in _NAMES})
