"""Subgraph partitioning: ``SubgraphProperty``, the backend registry,
``partition`` and ``Symbol.optimize_for``.

Counterpart of ``mxnet_tpu/subgraph.py:28-319`` (reference:
src/operator/subgraph/, MXNET_REGISTER_SUBGRAPH_PROPERTY): select the
nodes a backend supports, group them into maximal regions that create no
cycle, and replace each region by one ``_subgraph_exec`` node.  The
default backend keeps the reference's name, ``"XLA"`` (``optimize_for``'s
default, which scripts pass): it takes every registered op that is not
opaque, in regions of at least two nodes.

``subgraph_exec`` runs a region's members in one call under the same
injection contract as ``Symbol`` evaluation (``symbol.run_node``): the
mode from ``autograd.is_training()``, a generator from
``random.current_generator`` for each random member, BatchNorm's moving
statistics updated in training mode.  The members run op by op; nothing
is compiled.
"""

from __future__ import annotations

import itertools

from .base import MXNetError
from .ops import registry as _registry

_BACKENDS = {}


class SubgraphProperty:
    """Node-selection contract (reference: SubgraphProperty)."""

    #: regions smaller than this stay unpartitioned
    min_size = 1

    def op_filter(self, op_name, attrs):
        """True if the op may live inside a partitioned region."""
        raise NotImplementedError

    def name(self):
        return self.__class__.__name__


class XLASubgraphProperty(SubgraphProperty):
    """Every registered op but the opaque (host-level) ones, in regions of
    two nodes or more."""

    min_size = 2

    def op_filter(self, op_name, attrs):
        try:
            opdef = _registry.get(op_name)
        except MXNetError:
            return False
        return not opdef.opaque


def register_subgraph_property(backend, prop):
    """Register ``prop`` under ``backend`` (reference:
    MXNET_REGISTER_SUBGRAPH_PROPERTY)."""
    if not isinstance(prop, SubgraphProperty):
        raise MXNetError("prop must be a SubgraphProperty instance")
    _BACKENDS[backend] = prop
    return prop


def list_backends():
    return sorted(_BACKENDS)


register_subgraph_property("XLA", XLASubgraphProperty())

_SUBGRAPH_COUNTER = itertools.count()


class _Entry:
    __slots__ = ("name", "out_index")

    def __init__(self, name, out_index):
        self.name = name
        self.out_index = out_index


def partition(sym, backend="XLA"):
    """``sym`` with each maximal supported region grouped into one
    ``_subgraph_exec`` node (the reference's BuildSubgraph pass).

    The pass is keyed by node name (output views share their node).  A
    node joins a producer's region only when no path outside the region
    leads from the region back into the node (tracked through transitive
    region-dependency sets); a region exposes as many outputs as the rest
    of the graph reads."""
    from . import symbol as _sym_mod

    prop = _BACKENDS.get(backend)
    if prop is None:
        raise MXNetError(f"unknown subgraph backend '{backend}' "
                         f"(registered: {list_backends()})")
    topo, seen_names = [], set()
    for n in sym._topo():
        if n.name not in seen_names:
            seen_names.add(n.name)
            topo.append(n)
    by_name = {n.name: n for n in topo}
    supported = {n.name: (n.op is not None and n.op != "_group"
                          and prop.op_filter(n.op, n.attrs))
                 for n in topo}

    group_of = {}            # node name -> region id
    members = {}             # region id -> member names in topo order
    depends_on = {}          # node name -> regions upstream of it
    group_deps = {}          # region id -> regions it reads (direct)
    gid_counter = itertools.count()

    def _gclosure(gids, acc=None):
        acc = set() if acc is None else acc
        for g in gids:
            if g not in acc:
                acc.add(g)
                _gclosure(group_deps.get(g, ()), acc)
        return acc

    def _input_dep_groups(i):
        base = set(depends_on.get(i.name, ()))
        g = group_of.get(i.name)
        if g is not None:
            base.add(g)
        return _gclosure(base)

    for n in topo:
        node_deps = set()
        for i in n.inputs:
            node_deps |= depends_on.get(i.name, set())
            g = group_of.get(i.name)
            if g is not None:
                node_deps.add(g)
        if not supported[n.name]:
            depends_on[n.name] = node_deps
            continue
        gid = None
        for g in sorted({group_of[i.name] for i in n.inputs
                         if i.name in group_of}):
            # joining g is safe iff no input reaching n outside g depends
            # on g: that path would leave the region and come back
            if all(group_of.get(i.name) == g
                   or g not in _input_dep_groups(i) for i in n.inputs):
                gid = g
                break
        if gid is None:
            gid = next(gid_counter)
            members[gid] = []
            group_deps[gid] = set()
        for i in n.inputs:
            if group_of.get(i.name) != gid:
                group_deps[gid] |= _input_dep_groups(i)
        group_deps[gid].discard(gid)
        group_of[n.name] = gid
        members[gid].append(n.name)
        depends_on[n.name] = node_deps - {gid}

    for gid, mem in list(members.items()):
        if len(mem) < prop.min_size:
            for nm in mem:
                del group_of[nm]
            del members[gid]

    # the member outputs (name, out_index) read outside their region
    consumers_outside = {gid: [] for gid in members}
    head_name = topo[-1].name
    for n in topo:
        for i in n.inputs:
            g = group_of.get(i.name)
            if g is not None and group_of.get(n.name) != g:
                key = (i.name, i.out_index)
                if key not in consumers_outside[g]:
                    consumers_outside[g].append(key)
    hg = group_of.get(head_name)
    if hg is not None:
        key = (head_name, sym.out_index)
        if key not in consumers_outside[hg]:
            consumers_outside[hg].append(key)

    # rebuild: rebuilt[name] is a node's Symbol, or for a region member
    # {out_index: Symbol} onto the region node's outputs
    rebuilt = {}

    def lookup(entry):
        r = rebuilt[entry.name]
        if isinstance(r, dict):
            return r[entry.out_index]
        return r[entry.out_index] if entry.out_index else r

    last_member = {gid: mem[-1] for gid, mem in members.items()}
    for n in topo:
        if n.op is None:
            v = _sym_mod.var(n.name)
            v.attrs.update(n.attrs)
            v._attr_dict.update(n._attr_dict)
            rebuilt[n.name] = v
            continue
        if n.op == "_group":
            rebuilt[n.name] = _sym_mod.Group([lookup(i) for i in n.inputs])
            continue
        gid = group_of.get(n.name)
        if gid is None:
            rebuilt[n.name] = _sym_mod.apply_op(
                n.op, *[lookup(i) for i in n.inputs], name=n.name,
                **n.attrs)
            continue
        if n.name != last_member[gid]:
            continue      # the region is emitted at its last member
        mem = members[gid]
        mem_set = set(mem)
        ext, seen = [], set()
        for nm in mem:
            for i in by_name[nm].inputs:
                key = (i.name, i.out_index)
                if i.name not in mem_set and key not in seen:
                    seen.add(key)
                    ext.append(i)
        visible = consumers_outside[gid] or [(mem[-1], 0)]
        node = _sym_mod.Symbol(
            "_subgraph_exec", f"xla_subgraph{next(_SUBGRAPH_COUNTER)}",
            [lookup(i) for i in ext], {"__backend__": backend},
            n_outputs=len(visible))
        node._attr_dict["__members__"] = [by_name[nm] for nm in mem]
        node._attr_dict["__ext__"] = [(i.name, i.out_index) for i in ext]
        node._attr_dict["__visible__"] = list(visible)
        for k, (nm, oi) in enumerate(visible):
            rebuilt.setdefault(nm, {})[oi] = \
                node[k] if len(visible) > 1 else node
    return lookup(_Entry(head_name, sym.out_index))


def subgraph_exec(node, ext_vals):
    """Run one region (called from Symbol evaluation): its members in
    topological order on the region's inputs, under ``run_node``'s
    injection."""
    from .symbol.symbol import run_node

    ext = node._attr_dict["__ext__"]
    visible = node._attr_dict["__visible__"]
    env = {}
    for (nm, oi), v in zip(ext, ext_vals):
        env.setdefault(nm, {})[oi] = v
    for m in node._attr_dict["__members__"]:
        ins = []
        for i in m.inputs:
            slot = env[i.name]
            ins.append(slot.get(i.out_index) if isinstance(slot, dict)
                       else slot[i.out_index])
        out = run_node(m, ins)
        env[m.name] = out if isinstance(out, (tuple, list)) else (out,)
    outs = tuple(env[nm][oi] for nm, oi in visible)
    return outs if len(visible) > 1 else outs[0]
