"""Device meshes.

Counterpart of ``mxnet_tpu/parallel/mesh.py``: ``make_mesh`` with the
canonical axis order (pp, dp, sp, ep, tp), ``data_parallel_mesh`` and
``mesh_axis_size``.  The JAX package builds a ``jax.sharding.Mesh``; here
a ``Mesh`` is a small record of the axes and the ``torch.device``s laid
out along them, for ``ShardedTrainer(mesh=...)`` to read.  The port
trains on one device, so the trainer takes a mesh of one device only;
the sharded meshes wait for the multi-GPU slice.

The devices default to the visible CUDA cards, or to the host inside a
``with cpu():`` scope (the port's entry points run on the card unless the
caller scopes or passes the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import context

DP, TP, PP, SP, EP = "dp", "tp", "pp", "sp", "ep"
_ORDER = (PP, DP, SP, EP, TP)


class Mesh:
    """Named axes over an array of devices: ``shape`` maps each axis name
    to its size, in order; ``devices`` is the numpy object array of
    ``torch.device``s of that shape."""

    def __init__(self, devices, axis_names):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"Mesh: {self.devices.ndim}-d devices for axes "
                             f"{self.axis_names}")

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return int(self.devices.size)

    def __repr__(self):
        return f"Mesh({self.shape}, devices={list(self.devices.flat)})"


def _visible_devices():
    scope = context.scoped_context()
    if scope is not None and scope.device_type == "cpu":
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(context.num_gpus())]


def make_mesh(dp=1, tp=1, pp=1, sp=1, ep=1, devices=None):
    """A ``Mesh`` with the axes of size > 1 in the canonical order
    (``("dp",)`` of size 1 when every size is 1).  Raises ValueError for a
    size that is not a positive int, or an axis product past the devices
    available."""
    override = devices is not None
    devices = list(devices) if override else _visible_devices()
    sizes = {"pp": pp, "dp": dp, "sp": sp, "ep": ep, "tp": tp}
    for name, size in sizes.items():
        if not isinstance(size, int) or size < 1:
            raise ValueError(
                f"make_mesh: axis {name}={size!r} must be a positive int")
    axes = [(n, sizes[n]) for n in _ORDER if sizes[n] > 1] or [(DP, 1)]
    total = int(np.prod(list(sizes.values())))
    if total > len(devices):
        product = " * ".join(f"{n}={s}" for n, s in sizes.items()
                             if s > 1) or "dp=1"
        source = ("devices= override" if override
                  else "the visible devices")
        raise ValueError(
            f"make_mesh: axis product {product} = {total} devices, but "
            f"only {len(devices)} available from {source}")
    arr = np.empty(total, dtype=object)
    arr[:] = devices[:total]
    return Mesh(arr.reshape([s for _, s in axes]), [n for n, _ in axes])


def data_parallel_mesh(n=None):
    """A pure data-parallel mesh over ``n`` devices (default: every
    visible CUDA card)."""
    return make_mesh(dp=n or len(_visible_devices()))


def mesh_axis_size(mesh, name):
    return mesh.shape.get(name, 1)
