"""KVStore: parameter and gradient synchronisation on one device.

Counterpart of ``mxnet_tpu/kvstore.py`` (reference: src/kvstore/ and
python/mxnet/kvstore.py): ``create('local'|'device'|'nccl')`` with
``init``/``push``/``pull``/``pushpull``, ``set_optimizer`` (updates run in
the store) and the optimizer-state save/load, for one worker.  Push sums
the values of a key's list (the reference's intra-node reduce) and pull
copies the stored value out; ``row_sparse_pull`` gathers just the
requested rows.  The ``dist_*`` types and gradient
compression belong to the multi-GPU slice and raise
``NotImplementedError``.
"""

from __future__ import annotations

import torch

from . import optimizer as opt
from .base import MXNetError
from .ndarray.ndarray import NDArray

_LOCAL_TYPES = ("local", "device", "nccl", "local_allreduce_device",
                "local_allreduce_cpu")
_DIST_TYPES = ("dist_sync", "dist_device_sync", "dist_async",
               "dist_sync_device", "horovod")


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


def device_fingerprint():
    """Part of every captured-step key: the visible CUDA devices (the
    device set a captured graph was recorded against)."""
    if not torch.cuda.is_available():
        return ()
    return tuple(torch.cuda.get_device_name(i)
                 for i in range(torch.cuda.device_count()))


def captured_step_compatible(kv):
    """Whether ``gluon.captured`` may fold this trainer's gradient
    reduction into the captured step: only the local path (no store: one
    worker, in-process tensors) qualifies."""
    return kv is None


class KVStore:
    """In-process KVStore on one worker (reference: include/mxnet/
    kvstore.h)."""

    def __init__(self, kv_type="local"):
        self._type = kv_type
        self._store = {}
        self._updater = None
        self._optimizer = None

    @property
    def type(self):
        return self._type

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    # -- data plane ------------------------------------------------------------
    def _normalize(self, key, value):
        if isinstance(key, (list, tuple)):
            return list(key), list(value)
        return [key], [value]

    def init(self, key, value):
        keys, values = self._normalize(key, value)
        for k, v in zip(keys, values):
            if k in self._store:
                raise MXNetError(f"key {k} already initialized")
            v0 = _as_list(v)[0]
            self._store[k] = v0.copy() if v0.stype != "default" \
                else NDArray(v0._data.detach().clone(), v0._ctx)

    def _reduce(self, values):
        vals = _as_list(values)
        merged = vals[0]._data.detach()
        for v in vals[1:]:
            merged = merged + v._data.detach().to(merged.device)
        return NDArray(merged, vals[0]._ctx)

    def push(self, key, value, priority=0):
        keys, values = self._normalize(key, value)
        for k, v in zip(keys, values):
            if k not in self._store:
                raise MXNetError(f"key {k} not initialized")
            merged = self._reduce(v)
            stored = self._store[k]
            if self._updater is not None:
                self._updater(k, merged, stored)
            else:
                with torch.no_grad():
                    stored._data.copy_(merged._data)
                stored._version += 1

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        if out is None:
            raise MXNetError("pull requires out=")
        keys, outs = self._normalize(key, out)
        for k, o in zip(keys, outs):
            if k not in self._store:
                raise MXNetError(f"key {k} not initialized")
            stored = self._store[k]
            for dst in _as_list(o):
                dst._set_data(stored._data.detach().to(
                    device=dst._data.device, dtype=dst._data.dtype,
                    copy=True))

    def pushpull(self, key, value, out=None, priority=0):
        """Push then pull: an all-reduce."""
        self.push(key, value, priority)
        if out is not None:
            self.pull(key, out, priority)

    def broadcast(self, key, value, out=None, priority=0):
        self.init(key, value)
        if out is not None:
            self.pull(key, out, priority)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Pull only the requested rows, as compact row-sparse arrays
        (reference: the row_sparse path of src/kvstore/kvstore_local.h).
        Duplicate ids are coalesced on the host (numpy ids are taken as
        they are), so the device does one gather.  From a row-sparse store
        the rows come from its compact parts (absent rows pull zeros),
        never from its dense view.  Without ``row_ids`` this is
        ``pull``."""
        if row_ids is None:
            self.pull(key, out, priority)
            return
        import numpy as _np

        from .ndarray.sparse import RowSparseNDArray, coalesce

        if out is None:
            raise MXNetError("row_sparse_pull requires out=")
        keys, outs = self._normalize(key, out)
        rids = row_ids if isinstance(row_ids, (list, tuple)) \
            else [row_ids] * len(keys)
        for k, o, rid in zip(keys, outs, rids):
            if k not in self._store:
                raise MXNetError(f"key {k} not initialized")
            stored = self._store[k]
            host = rid.asnumpy() if isinstance(rid, NDArray) \
                else _np.asarray(rid)
            uniq = _np.unique(host.astype(_np.int64).reshape(-1))
            if isinstance(stored, RowSparseNDArray):
                si, sv = coalesce(stored._rs_indices, stored._rs_values)
                idx = torch.as_tensor(uniq, device=sv.device)
                vals = torch.zeros((idx.numel(),) + tuple(sv.shape[1:]),
                                   dtype=sv.dtype, device=sv.device)
                if si.numel():
                    pos = torch.searchsorted(si, idx).clamp_max(
                        si.numel() - 1)
                    hit = si[pos] == idx
                    vals[hit] = sv[pos[hit]]
            else:
                table = stored._data.detach()
                idx = torch.as_tensor(uniq, device=table.device)
                vals = table.index_select(0, idx)
            for dst in _as_list(o):
                if isinstance(dst, RowSparseNDArray):
                    dst._set_sparse(idx.to(dst._rs_values.device),
                                    vals.to(dst._rs_values.device))
                else:
                    dense = torch.zeros(stored.shape, dtype=vals.dtype,
                                        device=dst._data.device)
                    dense[idx.to(dense.device)] = vals.to(dense.device)
                    dst._set_data(dense)

    # -- optimizer plane -------------------------------------------------------
    def set_optimizer(self, optimizer):
        """Run parameter updates in the store (reference: the server-side
        optimizer)."""
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)

    def _set_updater(self, updater):
        self._updater = updater

    set_updater = _set_updater

    def save_optimizer_states(self, fname, dump_optimizer=False):
        if self._updater is None:
            raise MXNetError("Cannot save states: the store has no "
                             "optimizer")
        with open(fname, "wb") as fout:
            fout.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("Cannot load states: the store has no "
                             "optimizer")
        with open(fname, "rb") as fin:
            self._updater.set_states(fin.read())

    def set_gradient_compression(self, compression_params):
        raise NotImplementedError("gradient compression comes with the "
                                  "multi-GPU slice")

    def barrier(self):
        """No-op: one worker has no one to wait for."""


def create(name="local"):
    """mx.kv.create (reference: KVStore::Create): 'local', 'device' and
    'nccl' on one worker; the dist types raise NotImplementedError."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if name in _DIST_TYPES:
        raise NotImplementedError(
            f"kvstore {name!r}: distributed stores come with the multi-GPU "
            f"slice (torch.distributed over NCCL), not ported yet")
    if name not in _LOCAL_TYPES:
        raise MXNetError(f"unknown KVStore type {name}")
    return KVStore(name)
