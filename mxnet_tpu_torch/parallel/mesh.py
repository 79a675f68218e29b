"""Device meshes.

Counterpart of ``mxnet_tpu/parallel/mesh.py``: ``make_mesh`` with the
canonical axis order (pp, dp, sp, ep, tp) and its ``axes=`` dict form,
``data_parallel_mesh``, ``mesh_axis_size``, the process default mesh
(``set_default_mesh`` / ``default_mesh``) and the placement helpers
``replicated`` / ``sharded``.

The JAX package is single-controller: one process holds every device and
GSPMD inserts the collectives.  The port runs one process per rank over
``torch.distributed``.  So a ``Mesh`` is one of two things:

- **one device** (no process group, or ``devices=`` given): a record of
  the axes and the ``torch.device``s laid out along them, as before;
- **a rank mesh** (a process group of more than one rank is up): the
  axes laid over the first ranks of the group (all of them, or as many as
  the axis product, as the JAX package takes the first devices) in
  canonical order, tp innermost.  It holds
  this rank's coordinates, one process group per axis (``group(axis)``,
  the ranks that differ only along that axis) and, on demand, the
  ``torch.distributed.device_mesh.DeviceMesh`` over the same layout that
  DTensor placements refer to (``device_mesh``).  Every rank builds the
  same mesh in the same order: the per-axis groups are collective to
  create.

The devices default to the visible CUDA cards (a rank's own card under a
process group), or to the host inside a ``with cpu():`` scope.
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
    ``torch.device``s of that shape (on a rank mesh, rank r's device at
    rank r's position)."""

    def __init__(self, devices, axis_names, ranks=None):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"Mesh: {self.devices.ndim}-d devices for axes "
                             f"{self.axis_names}")
        self.ranks = None if ranks is None else np.asarray(ranks)
        self._groups = {}
        self._device_mesh = None
        if self.ranks is not None:
            self._make_groups()

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return int(self.devices.size)

    @property
    def is_rank_mesh(self):
        """Whether the axes run over the ranks of a process group."""
        return self.ranks is not None and self.ranks.size > 1

    # -- the rank mesh ---------------------------------------------------------
    def _make_groups(self):
        import torch.distributed as dist

        me = dist.get_rank()
        members = [int(r) for r in self.ranks.flat]
        self._all_group = dist.group.WORLD \
            if len(members) == dist.get_world_size() \
            else dist.new_group(members)
        for ax, name in enumerate(self.axis_names):
            moved = np.moveaxis(self.ranks, ax, -1).reshape(
                -1, self.ranks.shape[ax])
            for row in moved:
                members = [int(r) for r in row]
                # every rank creates every group, in the same order
                g = dist.new_group(members) if len(members) > 1 else None
                if me in members:
                    self._groups[name] = g

    @property
    def is_member(self):
        """Whether this rank lies on the mesh (always, on a one-device
        mesh)."""
        return self.ranks is None or bool((self.ranks == self.rank).any())

    @property
    def rank(self):
        """This process's rank (0 on a one-device mesh)."""
        if self.ranks is None:
            return 0
        import torch.distributed as dist

        return dist.get_rank()

    def coord(self, axis):
        """This rank's index along ``axis`` (0 for an axis the mesh does
        not have, or on a one-device mesh)."""
        if not self.is_rank_mesh or axis not in self.axis_names:
            return 0
        pos = np.argwhere(self.ranks == self.rank)[0]
        return int(pos[self.axis_names.index(axis)])

    def group(self, axis):
        """The process group of the ranks that differ from this one only
        along ``axis``; None when that axis has size 1 or is absent."""
        return self._groups.get(axis)

    @property
    def all_group(self):
        """The process group of every rank on the mesh."""
        return self._all_group

    @property
    def device(self):
        """This rank's device (the one device of a one-device mesh)."""
        if self.ranks is None:
            return torch.device(self.devices.flat[0])
        return torch.device(
            self.devices[tuple(np.argwhere(self.ranks == self.rank)[0])])

    @property
    def device_mesh(self):
        """The ``DeviceMesh`` over this layout (built once, on first use),
        the mesh DTensor placements refer to."""
        if self._device_mesh is None:
            if not self.is_rank_mesh or not self.is_member:
                raise ValueError("Mesh.device_mesh: a one-device mesh has "
                                 "no process group")
            from torch.distributed.device_mesh import DeviceMesh

            # over the axis groups this mesh already made: building a
            # DeviceMesh's own groups is a collective of the whole world,
            # which the ranks off a smaller mesh never join
            groups = [self.group(name) for name in self.axis_names]
            self._device_mesh = DeviceMesh.from_group(
                groups if len(groups) > 1 else groups[0], self.device.type,
                mesh=torch.as_tensor(self.ranks),
                mesh_dim_names=self.axis_names)
        return self._device_mesh

    def __repr__(self):
        if self.is_rank_mesh:
            return f"Mesh({self.shape}, ranks={self.ranks.tolist()})"
        return f"Mesh({self.shape}, devices={list(self.devices.flat)})"


def _world():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _visible_devices():
    scope = context.scoped_context()
    if scope is not None and scope.device_type == "cpu":
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(context.num_gpus())]


def rank_device():
    """This rank's device: the host inside a ``with cpu():`` scope, else
    its card (rank modulo the visible cards).  Raises when no card is
    visible: a rank never goes on without the card it was asked for."""
    scope = context.scoped_context()
    if scope is not None and scope.device_type == "cpu":
        return torch.device("cpu")
    n = context.num_gpus()
    if n == 0:
        from ..base import MXNetError

        raise MXNetError("parallel: this rank has no CUDA card (open "
                         "`with cpu():` to run the rank on the host)")
    import torch.distributed as dist

    return torch.device("cuda", dist.get_rank() % n)


def _axis_sizes(dp, tp, pp, sp, ep, axes):
    sizes = {"pp": pp, "dp": dp, "sp": sp, "ep": ep, "tp": tp}
    if axes is not None:
        clash = [n for n, s in sizes.items() if s != 1]
        if clash:
            raise ValueError(
                "make_mesh: pass axis sizes either as keywords or via "
                f"axes=, not both (keyword {clash[0]}={sizes[clash[0]]!r} "
                f"alongside axes={axes!r})")
        unknown = [n for n in axes if n not in sizes]
        if unknown:
            raise ValueError(
                f"make_mesh: unknown axis {unknown[0]!r} in axes= "
                f"(expected a subset of {sorted(sizes)})")
        sizes = {n: axes.get(n, 1) for n in sizes}
    for name, size in sizes.items():
        if not isinstance(size, int) or size < 1:
            raise ValueError(
                f"make_mesh: axis {name}={size!r} must be a positive int")
    return sizes


def make_mesh(dp=1, tp=1, pp=1, sp=1, ep=1, devices=None, axes=None):
    """A ``Mesh`` with the axes of size > 1 in the canonical order
    (``("dp",)`` of size 1 when every size is 1).  ``axes={"dp": 2,
    "tp": 2}`` is the dict form (mixing it with a keyword size raises).

    Under a process group of W > 1 ranks (and no ``devices=``) the mesh is
    over the first ranks (the axis product, at most W), each rank's
    device ``rank_device()``; every rank of the group calls it (the
    per-axis groups are collective to create), and a rank past the mesh
    is not ``is_member``.  Otherwise it is over ``devices`` (default the
    visible cards).  Raises ValueError for a size that is not a positive
    int, or an axis product past the ranks or devices available."""
    sizes = _axis_sizes(dp, tp, pp, sp, ep, axes)
    layout = [(n, sizes[n]) for n in _ORDER if sizes[n] > 1] or [(DP, 1)]
    total = int(np.prod(list(sizes.values())))
    product = " * ".join(f"{n}={s}" for n, s in sizes.items()
                         if s > 1) or "dp=1"
    world = _world() if devices is None else 1
    if world > 1 and total > 1:
        if total > world:
            raise ValueError(
                f"make_mesh: axis product {product} = {total} ranks, but "
                f"the process group has only {world}")
        import torch.distributed as dist

        ranks = np.arange(total).reshape([s for _, s in layout])
        devs = np.empty(total, dtype=object)
        devs[:] = [None] * total
        if dist.get_rank() < total:
            devs[dist.get_rank()] = rank_device()
        return Mesh(devs.reshape(ranks.shape), [n for n, _ in layout],
                    ranks=ranks)
    override = devices is not None
    devices = list(devices) if override else _visible_devices()
    if total > len(devices):
        source = ("devices= override" if override
                  else "the visible devices")
        raise ValueError(
            f"make_mesh: axis product {product} = {total} devices, but "
            f"only {len(devices)} available from {source}")
    arr = np.empty(total, dtype=object)
    arr[:] = devices[:total]
    return Mesh(arr.reshape([s for _, s in layout]), [n for n, _ in layout])


def data_parallel_mesh(n=None):
    """A pure data-parallel mesh over ``n`` ranks or devices (default:
    every rank of the process group, else every visible CUDA card)."""
    world = _world()
    return make_mesh(dp=n or (world if world > 1
                              else len(_visible_devices())))


def mesh_axis_size(mesh, name):
    return mesh.shape.get(name, 1)


_DEFAULT_MESH = None


def set_default_mesh(mesh):
    """Set the process-wide default mesh (read by mesh-aware code when
    no mesh is passed)."""
    global _DEFAULT_MESH
    _DEFAULT_MESH = mesh
    return mesh


def default_mesh():
    return _DEFAULT_MESH


def replicated(mesh):
    """The placements of a tensor replicated over every axis of
    ``mesh`` (the JAX package's ``NamedSharding(mesh, P())``)."""
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() for _ in mesh.axis_names)


def sharded(mesh, *spec):
    """The placements of a tensor whose dim i is sharded over the axis
    ``spec[i]`` (None: not sharded), the JAX package's
    ``NamedSharding(mesh, P(*spec))``."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in mesh.axis_names:
        dims = [i for i, e in enumerate(spec) if e == name]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)
