"""KVStore: parameter and gradient synchronisation.

Counterpart of ``mxnet_tpu/kvstore.py`` (reference: src/kvstore/ and
python/mxnet/kvstore.py): ``create('local'|'device'|'nccl'|'dist_sync'|
'dist_device_sync'|'dist_async')`` with ``init``/``push``/``pull``/
``pushpull``, ``set_optimizer`` (updates run in the store), the
optimizer-state save/load, ``rank``/``num_workers``/``barrier`` and
gradient compression.  Push sums the values of a key's list (the
reference's intra-node reduce) and, for a dist type over more than one
worker, all-reduces the sum across the process group
(``distributed.init_from_env``: one process per rank); pull copies the
stored value out; ``row_sparse_pull`` gathers just the requested rows.
With compression on, each worker's contribution is quantised with error
feedback first: the 2-bit wire is an all-gather of the packed codes, the
fp16 wire an all-gather of f16 values summed in f32.
``bucketed_pushpull`` packs dense keys into flat per-dtype buckets of
``MXTPU_ALLREDUCE_BUCKET_MB`` (default 4) and reduces each with one
collective.  ``dist_async`` runs synchronously, the reference's
documented drop (there is no parameter server).  Every cross-process
collective is guarded by ``MXTPU_COLLECTIVE_TIMEOUT``'s watchdog.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from . import optimizer as opt
from . import resilience
from . import telemetry
from .base import MXNetError
from .ndarray.ndarray import NDArray

_LOCAL_TYPES = ("local", "device", "nccl", "local_allreduce_device",
                "local_allreduce_cpu")
_DIST_TYPES = ("dist_sync", "dist_device_sync", "dist_async",
               "dist_sync_device", "horovod")


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


#: elastic membership epoch, bumped by ``notify_mesh_reshape``: part of
#: ``device_fingerprint``, so a gang reshape re-captures every captured
#: step even where a survivor's visible cards did not change
_MESH_EPOCH = 0


def notify_mesh_reshape(epoch):
    """Called by ``resilience.ElasticGang.recover`` after a membership
    change: the next captured step records against the new topology, and
    a default rank mesh is dropped (its axis groups belong to the old
    process group).  The store's collectives run over the process group
    current at each call and ``collectives.bucketed_all_reduce`` plans
    its buckets at each call, so no other group or bucket plan is
    cached."""
    global _MESH_EPOCH
    _MESH_EPOCH = int(epoch)
    from .parallel import mesh as _mesh

    cur = _mesh.default_mesh()
    if cur is not None and cur.is_rank_mesh:
        _mesh.set_default_mesh(None)


def device_fingerprint():
    """Part of every captured-step key: the membership epoch and the
    visible CUDA devices (the device set a captured graph was recorded
    against)."""
    if not torch.cuda.is_available():
        return (_MESH_EPOCH,)
    return (_MESH_EPOCH,) + tuple(torch.cuda.get_device_name(i)
                                  for i in range(torch.cuda.device_count()))


def captured_step_compatible(kv):
    """Whether ``gluon.captured`` may fold this trainer's gradient
    reduction into the captured step: only the local path (no store: one
    worker, in-process tensors).  A dist store reduces through
    ``bucketed_pushpull`` between backward and update, so its trainer
    takes the eager path."""
    return kv is None


def _cross_process_allreduce(t, label=None):
    """Sum every worker's ``t`` over the process group; returns a new
    tensor (``label`` names the collective in a watchdog report)."""
    from .parallel import collectives

    return collectives.all_reduce_(t.detach().clone(), dist.group.WORLD,
                                   label or "kvstore_allreduce")


def _cross_process_f16_allreduce(h16):
    """fp16 wire: all-gather the f16 values (half the bytes), sum them in
    f32 (no f16 accumulation overflow)."""
    from .parallel import collectives

    rows = collectives.all_gather_dim(h16.reshape(1, -1), dist.group.WORLD)
    return rows.float().sum(dim=0).reshape(h16.shape)


def _cross_process_compressed_allreduce(packed, n, threshold, dtype):
    """2-bit wire: all-gather every worker's packed codes (four gradients
    a byte), decode and sum on this worker's device."""
    from .gradient_compression import GradientCompression
    from .parallel import collectives

    rows = collectives.all_gather_dim(packed.reshape(1, -1),
                                      dist.group.WORLD)
    return GradientCompression.decode_sum(rows, n, threshold, dtype)


class KVStore:
    """KVStore over one worker's tensors and, for the dist types, the
    process group (reference: include/mxnet/kvstore.h)."""

    def __init__(self, kv_type="local"):
        self._type = kv_type
        self._store = {}
        self._updater = None
        self._optimizer = None
        self._compression = None
        self._is_dist = kv_type.startswith("dist")
        if self._is_dist:
            from . import distributed

            distributed.init_from_env()

    @property
    def type(self):
        return self._type

    @property
    def rank(self):
        if self._is_dist:
            from . import distributed

            return distributed.rank()
        return 0

    @property
    def num_workers(self):
        if self._is_dist:
            from . import distributed

            return distributed.num_workers()
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

    def _merge(self, values):
        """The sum of one key's value list (the reference's Comm tree)."""
        vals = _as_list(values)
        if len(vals) == 1:
            return vals[0]
        merged = vals[0]._data.detach()
        for v in vals[1:]:
            merged = merged + v._data.detach().to(merged.device)
        return NDArray(merged, vals[0]._ctx)

    def _reduce(self, key, values):
        """Sum a key's value list and, for a dist type over more than one
        worker, across the process group; with compression on, each
        worker's contribution is quantised (error feedback) first."""
        merged = self._merge(values)
        gc = self._compression
        multi = self._is_dist and self.num_workers > 1
        if gc is None:
            if multi:
                return NDArray(_cross_process_allreduce(merged._data),
                               merged._ctx)
            return merged
        from .ndarray.sparse import RowSparseNDArray, row_sparse_array

        if isinstance(merged, RowSparseNDArray) and not multi:
            union, q = gc.quantize_rowsparse(key, merged._rs_indices,
                                             merged._rs_values)
            return row_sparse_array((q, union), shape=merged.shape,
                                    ctx=merged._ctx)
        # across workers a row-sparse gradient goes through the dense
        # compressed all-reduce as its dense view, as the reference's does
        raw = merged._data.detach()
        with torch.no_grad():
            if multi and gc.type == "2bit":
                packed = gc.codes(key, raw)
                summed = _cross_process_compressed_allreduce(
                    packed, raw.numel(), gc.threshold,
                    raw.dtype).reshape(raw.shape)
            elif multi:
                summed = _cross_process_f16_allreduce(
                    gc.quantize_fp16_wire(key, raw)).to(raw.dtype)
            else:
                summed = gc.quantize(key, raw)
        return NDArray(summed, merged._ctx)

    def push(self, key, value, priority=0):
        keys, values = self._normalize(key, value)
        for k, v in zip(keys, values):
            if k not in self._store:
                raise MXNetError(f"key {k} not initialized")
            merged = self._reduce(k, v)
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

    def bucketed_pushpull(self, keys, values, outs=None, priority=0,
                          health=False):
        """Bucketed all-reduce: dense values are flattened into flat
        buckets of about ``MXTPU_ALLREDUCE_BUCKET_MB`` per dtype, each
        reduced with ONE collective, and split back.

        Keys bucketing cannot express go through per-key ``pushpull``:
        row-sparse values, any active compression (its residuals are
        per key) and a store-side updater (the update reads each key's
        reduction).  With ``health=True`` the fused
        ``numerics.grad_health`` runs over the reduced buckets and its
        ``(2,)`` [all_finite, global_sq_norm] tensor is returned (None
        when nothing was bucketable)."""
        from . import numerics
        from .ndarray.sparse import RowSparseNDArray

        if outs is None:
            outs = [None] * len(keys)
        gc = self._compression
        if self._updater is not None or \
                (gc is not None and not gc.supports_bucketing):
            for k, v, o in zip(keys, values, outs):
                self.pushpull(k, v, out=o, priority=priority)
            if health:
                raws = [self._store[k]._data for k in keys
                        if k in self._store
                        and not isinstance(self._store[k],
                                           RowSparseNDArray)]
                return numerics.grad_health(raws) if raws else None
            return None
        dense = []                      # (key, merged tensor, out)
        for k, v, o in zip(keys, values, outs):
            if k not in self._store:
                raise MXNetError(f"key {k} not initialized")
            vals = _as_list(v)
            if any(isinstance(x, RowSparseNDArray) for x in vals) or \
                    isinstance(self._store[k], RowSparseNDArray):
                self.pushpull(k, v, out=o, priority=priority)
                continue
            dense.append((k, self._merge(v)._data.detach(), o))
        if not dense:
            return None
        from .parallel import collectives

        multi = self._is_dist and self.num_workers > 1
        reduced, flats = collectives.bucketed_all_reduce(
            [raw for _, raw, _ in dense], dist.group.WORLD if multi else None,
            "kvstore_allreduce")
        for flat, _ in flats:
            telemetry.count("collective.bytes",
                            flat.numel() * flat.element_size())
            telemetry.count("collective.buckets")
        for (k, _, o), piece in zip(dense, reduced):
            stored = self._store[k]
            with torch.no_grad():
                stored._data.copy_(piece)
            stored._version += 1
            if o is not None:
                for dst in _as_list(o):
                    dst._set_data(piece)
        if health and flats:
            return numerics.grad_health([flat for flat, _ in flats])
        return None

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
        """Turn on gradient compression (reference:
        src/kvstore/gradient_compression.cc): '2bit' threshold
        quantisation with per-key error feedback, or 'fp16'.  As in the
        reference, for the 'device' and 'dist_*' types only."""
        from .gradient_compression import GradientCompression

        if not (self._is_dist or self._type == "device"):
            raise MXNetError(
                "gradient compression is supported for 'device' and "
                "'dist_*' kvstore types (reference semantics)")
        self._compression = GradientCompression(compression_params)
        self._compression_params = compression_params

    def barrier(self):
        """Wait for every worker (a no-op on one), watchdog-guarded."""
        if self._is_dist and self.num_workers > 1:
            with resilience.guard_collective("kvstore_barrier"):
                dist.barrier()

    def _send_command_to_servers(self, head, body):
        """The reference's server command channel: there is no server."""


def create(name="local"):
    """mx.kv.create (reference: KVStore::Create, src/kvstore/
    kvstore.cc).  A dist type joins the process group of the launch
    variables (``distributed.init_from_env``); on one worker it is a
    store of one."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if name not in _LOCAL_TYPES + _DIST_TYPES:
        raise MXNetError(f"unknown KVStore type {name}")
    return KVStore(name)
