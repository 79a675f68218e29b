"""Parameter sharding rules (tensor parallelism and FSDP) and their
placements on a rank mesh.

Counterpart of ``mxnet_tpu/parallel/sharding.py``.  A rule set maps
parameter-name regexes to ``PartitionSpec``s (a tuple of mesh axis names
or None, one per dim).  The rule classes are plain Python and the same as
the JAX package's: ``ShardingRules`` (FIRST MATCH WINS, in insertion
order), ``FSDPRules`` with its shape heuristic and ``fsdp_min_size``
(``MXTPU_FSDP_MIN_SIZE``), the composable ``PPRules`` and
``EmbeddingRules`` overlays, ``combined_rules`` and
``match_partition_rules``; ``TRANSFORMER_TP_RULES`` and ``MOE_EP_RULES``
keep their patterns.

Megatron's recipe on (out, in) weights: column-parallel (shard the
OUTPUT dim, ('tp', None)) for the qkv projection, the FFN
up-projection and the embedding's vocabulary; row-parallel (shard the
INPUT dim, (None, 'tp')) for the attention output projection and the FFN
down-projection.  GSPMD makes any layout correct from the annotations;
here a rank holds its shard and the tp-aware ops do the collectives
(``parallel.collectives``):

- ``param_sharding`` turns a parameter's spec into DTensor placements on
  the rank mesh (``Shard(dim)`` / ``Replicate()``), with the JAX
  package's leniencies (an axis the mesh lacks, or a dim the axis does
  not divide, replicates);
- ``local_shard`` / ``full_from_shards`` cut a full tensor into this
  rank's shard and put the shards back together.  The packed qkv
  (``qkv_weight``, ``qkv_stack_weight`` and their biases, ``[q; k; v]``
  along the sharded dim) is the one re-layout: a contiguous block of the
  packed rows would give rank 0 all of q and half of k, so rank r's shard
  is ``[q_r; k_r; v_r]``, the rows of ITS heads of each, and the trunk
  runs its heads alone;
- ``shard_model`` stamps a block's specs and, on a rank mesh, places its
  parameters as DTensors (``DTensor.from_local``, no collective) over
  ``Mesh.device_mesh``.  ``parallel.ShardedTrainer`` trains such a block;
  ``gluon.Trainer`` and the captured ``train_step`` over a rank mesh wait
  for the next multi-GPU slice (ROADMAP queue 1 item 1b) and refuse it.
"""

from __future__ import annotations

import os
import re

import torch

from .mesh import DP, EP, PP, TP


class PartitionSpec(tuple):
    """A partition spec: one mesh axis name (or None) per dim, as the JAX
    package's ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


class ShardingRules:
    """Ordered (regex → PartitionSpec tuple) rules; first match wins.

    ``spec_for(name, shape=None)`` resolves a parameter name to a
    `PartitionSpec`.  The base class ignores ``shape`` (shape-aware
    subclasses like `FSDPRules` consume it); a ``shape=None`` call is
    always legal and resolves regex rules only.  When nothing matches,
    the ``default`` spec applies — ``()`` (fully replicated) unless the
    rule set was built with another default.

    ``composable`` rule sets (class attribute, see `PPRules`) are
    overlays: inside `combined_rules` their matches merge per-dim into
    the winning base spec instead of competing whole-spec.
    """

    composable = False

    def __init__(self, rules=(), default=()):
        self._rules = [(re.compile(p), spec) for p, spec in rules]
        self._default = tuple(default)

    def _match(self, name, shape=None):
        """The first matching spec, or None (→ caller's default)."""
        for pat, spec in self._rules:
            if pat.search(name):
                return PartitionSpec(*spec)
        return None

    def spec_for(self, name, shape=None):
        spec = self._match(name, shape)
        return spec if spec is not None \
            else PartitionSpec(*self._default)

    def add(self, pattern, spec):
        self._rules.append((re.compile(pattern), tuple(spec)))
        return self


def fsdp_min_size():
    """MXTPU_FSDP_MIN_SIZE: parameters with fewer elements stay
    replicated under FSDP (biases, layernorm scales — sharding them
    buys nothing and costs a collective each)."""
    try:
        return int(os.environ.get("MXTPU_FSDP_MIN_SIZE", "1024"))
    except ValueError:
        return 1024


class FSDPRules(ShardingRules):
    """Shape-driven FSDP: shard each parameter over the data axis.

    Explicit regex ``rules`` outrank the shape heuristic (so TP rules
    can sit in front via ``combined_rules(TRANSFORMER_TP_RULES,
    fsdp_rules(mesh))`` for tp-within-fsdp layouts).  The heuristic
    shards the FIRST dimension the axis size divides; parameters with
    fewer than ``min_size`` elements (default `fsdp_min_size()`), with
    no divisible dimension, or with unknown shape stay replicated.
    """

    def __init__(self, axis=DP, axis_size=None, min_size=None,
                 rules=(), default=()):
        super().__init__(rules=rules, default=default)
        self.axis = axis
        self.axis_size = axis_size
        self.min_size = fsdp_min_size() if min_size is None \
            else int(min_size)

    def _match(self, name, shape=None):
        spec = super()._match(name, shape)
        if spec is not None:
            return spec
        return self._heuristic(shape)

    def _heuristic(self, shape, avoid_dims=()):
        """The shape heuristic alone (no regex): shard the FIRST
        divisible dim not in ``avoid_dims`` — the avoidance hook lets
        `combined_rules` re-run the heuristic around dims a composable
        overlay (e.g. `PPRules`) already claimed, so pp+fsdp composes
        instead of colliding on the stack dim."""
        if not shape:
            return None
        n = 1
        for d in shape:
            n *= int(d)
        if n < self.min_size:
            return None
        for dim, d in enumerate(shape):
            if dim in avoid_dims:
                continue
            if self.axis_size is None or \
                    (self.axis_size > 0 and d % self.axis_size == 0):
                entries = [None] * len(shape)
                entries[dim] = self.axis
                return PartitionSpec(*entries)
        return None

    def _match_detail(self, name, shape=None):
        """(spec, from_heuristic) — `combined_rules` uses the flag to
        decide whether a same-dim overlay claim is a hard conflict (an
        explicit regex said so) or a re-route (heuristic moves over)."""
        spec = super()._match(name, shape)
        if spec is not None:
            return spec, False
        return self._heuristic(shape), True


def fsdp_rules(mesh=None, axis=DP, axis_size=None, min_size=None,
               rules=()):
    """`FSDPRules` bound to ``mesh``'s data-axis size (divisibility is
    checked against it); with no mesh, pass ``axis_size`` directly or
    leave both None to shard dim 0 unconditionally."""
    if axis_size is None and mesh is not None:
        axis_size = mesh.shape.get(axis, 1)
    return FSDPRules(axis=axis, axis_size=axis_size, min_size=min_size,
                     rules=rules)


class PPRules(ShardingRules):
    """Pipeline-stage partitioning of the scanned trunk: a COMPOSABLE
    overlay claiming the leading (layer-stack) dimension of every
    ``*_stack_*`` parameter for the ``pp`` axis.

    `combined_rules(PPRules(...), TRANSFORMER_TP_RULES)` merges the
    claim per-dim into the base spec — ``qkv_stack_weight`` resolves to
    ``('pp', 'tp', None)`` — rather than competing whole-spec; two sets
    assigning DIFFERENT axes to the same dim of the same param is a
    hard ValueError.  ``axis_size`` (bound via `pp_rules(mesh)`) guards
    divisibility: a stack whose layer count the stage count does not
    divide stays unclaimed rather than forcing an uneven shard.
    """

    composable = True

    def __init__(self, axis=PP, axis_size=None, pattern=r"_stack_",
                 rules=None):
        if rules is None:
            rules = [(pattern, (axis,))]
        super().__init__(rules=rules)
        self.axis = axis
        self.axis_size = axis_size

    def _match(self, name, shape=None):
        spec = super()._match(name, shape)
        if spec is None:
            return None
        if self.axis_size and self.axis_size > 1 and shape:
            for dim, e in enumerate(tuple(spec)):
                if e is not None and (dim >= len(shape)
                                      or shape[dim] % self.axis_size):
                    return None
        return spec


def pp_rules(mesh=None, axis=PP, axis_size=None, pattern=r"_stack_"):
    """`PPRules` bound to ``mesh``'s pp-axis size (stack-length
    divisibility is checked against it); with no mesh, pass
    ``axis_size`` directly or leave both None to claim unconditionally."""
    if axis_size is None and mesh is not None:
        axis_size = mesh.shape.get(axis, 1)
    return PPRules(axis=axis, axis_size=axis_size, pattern=pattern)


class EmbeddingRules(ShardingRules):
    """Row-shard `embedding.ShardedEmbedding` tables: a COMPOSABLE
    overlay claiming dim 0 (the vocab dim) of every ``*_embed_table``
    parameter for ``axis`` (default the data axis).

    Row sharding is the memory play for recommender-scale tables — the
    vocab dim is the one that reaches hundreds of millions — and the
    data axis is where the memory is: dp ranks otherwise hold identical
    replicas.  The claim merges per-dim with TP/PP sets, so an
    explicit column rule on the output dim coexists: ('dp', 'tp').
    Tables are named ``embed_table`` precisely so the
    ``embedding\\d*_weight`` column-parallel rule in
    `TRANSFORMER_TP_RULES` does not capture them whole-spec first.

    No divisibility guard at the RULE level — the claim always lands,
    so the spec stays stable while a deferred-init table's vocab is
    still unknown.  Divisibility is `param_sharding`'s problem: a
    placement cannot be uneven (a shard of a dim the axis does not divide),
    so a vocab the axis does not divide degrades that dim to None
    (replicated) at placement time, per mesh — the same table row-
    shards on one layout and replicates on another, and the elastic
    checkpoint plane carries it bitwise between the two.
    """

    composable = True

    def __init__(self, axis=DP, pattern=r"_embed_table$"):
        super().__init__(rules=[(pattern, (axis,))])
        self.axis = axis


def embedding_rules(axis=DP, pattern=r"_embed_table$"):
    """`EmbeddingRules` — named constructor for symmetry with
    `fsdp_rules` / `pp_rules` (no mesh binding needed: there is no
    divisibility guard to size)."""
    return EmbeddingRules(axis=axis, pattern=pattern)


# default rule set for the transformer family (gluon/model_zoo/bert.py
# parameter names)
TRANSFORMER_TP_RULES = ShardingRules(rules=[
    (r"(query|key|value|qkv)_weight$", (TP, None)),   # column-parallel
    (r"(query|key|value|qkv)_bias$", (TP,)),
    (r"proj_weight$", (None, TP)),                    # row-parallel
    (r"ffn1_weight$", (TP, None)),
    (r"ffn1_bias$", (TP,)),
    (r"ffn2_weight$", (None, TP)),
    (r"word_embed_weight$|embedding\d*_weight$", (TP, None)),
    # scanned trunk (ScanTransformerEncoder): (L, ...) stacks — layer
    # dim unsharded, same Megatron column/row split on dims 1+
    (r"qkv_stack_weight$", (None, TP, None)),
    (r"qkv_stack_bias$", (None, TP)),
    (r"proj_stack_weight$", (None, None, TP)),
    (r"ffn1_stack_weight$", (None, TP, None)),
    (r"ffn1_stack_bias$", (None, TP)),
    (r"ffn2_stack_weight$", (None, None, TP)),
], default=())

# expert parallelism: MoE expert weights shard on their leading E axis
# (gluon/contrib/moe.py MoEFFN); the router gate stays replicated so
# every ep slice routes identically
MOE_EP_RULES = ShardingRules(rules=[
    (r"expert_ffn\d_weight$", (EP, None, None)),
    (r"expert_ffn\d_bias$", (EP, None)),
], default=())


class _CombinedRules(ShardingRules):
    """First match wins ACROSS rule sets, shape heuristics included.

    Composable sets (`PPRules`) are the one exception: their matches
    are per-dim CLAIMS merged into the winning base spec.  A claim on a
    dim the base left None (or an absent trailing dim) fills it in; the
    same axis on the same dim is idempotent; a DIFFERENT axis on a dim
    an explicit base rule already assigned raises — silent override
    here would reshard a param two sets disagree about.  When the base
    came from the FSDP shape heuristic, the heuristic re-routes around
    claimed dims instead (it never outranks an explicit claim)."""

    def __init__(self, sets):
        super().__init__()
        self._sets = list(sets)

    def _match(self, name, shape=None):
        base = None            # (tuple spec, from_heuristic, rule set)
        claims = []            # composable (tuple spec, rule set) in order
        for rs in self._sets:
            if getattr(rs, "composable", False):
                spec = rs._match(name, shape)
                if spec is not None:
                    claims.append((tuple(spec), rs))
            elif base is None:
                if hasattr(rs, "_match_detail"):
                    spec, heur = rs._match_detail(name, shape)
                else:
                    spec, heur = rs._match(name, shape), False
                if spec is not None:
                    base = (tuple(spec), heur, rs)
        if not claims:
            if base is None:
                return None
            return PartitionSpec(*base[0])
        return self._merge(name, shape, base, claims)

    @staticmethod
    def _merge(name, shape, base, claims):
        ndim = len(shape) if shape else max(
            [len(s) for s, _ in claims]
            + ([len(base[0])] if base else []))
        merged = [None] * ndim
        base_spec, base_heur, base_set = base if base else ((), False,
                                                            None)
        for dim, e in enumerate(base_spec[:ndim]):
            merged[dim] = e
        claimed_dims = set()
        for spec, rs in claims:
            for dim, e in enumerate(spec[:ndim]):
                if e is None:
                    continue
                have = merged[dim]
                if have is not None and have != e:
                    if base_heur and dim not in claimed_dims:
                        merged[dim] = None  # heuristic re-routes below
                    else:
                        raise ValueError(
                            "combined_rules: conflicting axes for "
                            f"{name!r} dim {dim}: {e!r} "
                            f"(from {type(rs).__name__}) vs {have!r} — "
                            "two rule sets may not assign different "
                            "axes to the same dim of the same param")
                if e in merged and merged.index(e) != dim:
                    prev = merged.index(e)
                    if base_heur and prev not in claimed_dims:
                        # the duplicate placement came from the FSDP
                        # shape heuristic (e.g. it picked an embedding
                        # table's divisible dim 1 when the vocab dim is
                        # uneven): an explicit claim outranks it — drop
                        # it and let the end-of-merge re-route look for
                        # another dim
                        merged[prev] = None
                    else:
                        raise ValueError(
                            "combined_rules: axis {!r} claimed twice "
                            "for {!r} (dims {} and {}) — a mesh axis "
                            "shards at most one dim per param".format(
                                e, name, prev, dim))
                merged[dim] = e
                claimed_dims.add(dim)
        if base_heur and base_set is not None:
            # the heuristic's dim was taken: re-run it around the
            # claimed dims and fold in what it finds
            redo = base_set._heuristic(shape, avoid_dims=claimed_dims)
            if redo is not None:
                for dim, e in enumerate(tuple(redo)[:ndim]):
                    if e is not None and merged[dim] is None \
                            and e not in merged:
                        merged[dim] = e
        return PartitionSpec(*merged)

    def add(self, pattern, spec):
        # appended rules have the LOWEST precedence, matching the
        # concatenation semantics
        self._sets.append(ShardingRules(rules=[(pattern, spec)]))
        return self


def combined_rules(*rule_sets):
    """Merge rule sets — e.g. combined_rules(TRANSFORMER_TP_RULES,
    MOE_EP_RULES) for a tp×ep transformer, or
    combined_rules(TRANSFORMER_TP_RULES, fsdp_rules(mesh)) for TP
    weights with an FSDP fallback.

    Precedence (pinned by tests/test_parallel.py): FIRST MATCH WINS
    across the concatenation — every rule (and shape heuristic) of an
    earlier set overrides every rule of a later set on conflicting
    names, whole-spec, with no per-dim merging between ordinary sets.
    `PPRules`-style ``composable`` overlays are the exception: their
    per-dim claims merge into the winning base spec, and a conflicting
    axis on the same dim of the same param is a hard ValueError (see
    `_CombinedRules`)."""
    return _CombinedRules(rule_sets)


def match_partition_rules(rules, params):
    """Bulk resolution: ``{name: PartitionSpec}`` for every entry of
    ``params`` (a dict of name → Parameter / array / shape tuple) —
    the pytree-of-specs step between a rule set and `NamedSharding`
    placement."""
    specs = {}
    for name, p in params.items():
        shape = p if isinstance(p, (tuple, list)) \
            else getattr(p, "shape", None)
        specs[name] = rules.spec_for(name, shape)
    return specs


def annotate_block(block, rules):
    """Stamp ``partition_spec`` onto every Parameter of a block (read by
    ShardedTrainer and ``shard_model`` when laying out the parameters)."""
    for name, param in block.collect_params().items():
        param.partition_spec = rules.spec_for(name, param.shape)
    return block


def clean_spec(spec, shape, mesh):
    """``spec`` with the JAX package's two leniencies: an axis ``mesh``
    does not have (or of size 1) drops to None, and so does a sharded dim
    whose size the axis does not divide."""
    spec = tuple(spec or ())
    out = []
    for dim, entry in enumerate(spec):
        if entry is not None and mesh.shape.get(entry, 1) > 1 and (
                shape is None or dim >= len(shape)
                or shape[dim] % mesh.shape[entry] == 0):
            out.append(entry)
        else:
            out.append(None)
    return PartitionSpec(*out)


def param_sharding(param, mesh):
    """The DTensor placements of a Parameter on ``mesh`` (one per mesh
    axis: ``Shard(dim)`` where its cleaned spec names the axis, else
    ``Replicate()``); replicated when it has no spec."""
    from .mesh import sharded

    spec = clean_spec(getattr(param, "partition_spec", None),
                      getattr(param, "shape", None), mesh)
    return sharded(mesh, *spec)


_PACKED = re.compile(r"qkv(_stack)?_(weight|bias)$")


def _packed_dim(name, spec, axis):
    """The packed [q; k; v] dim of ``name`` when ``axis`` shards it."""
    if not _PACKED.search(name):
        return None
    want = 1 if "_stack_" in name else 0
    return want if want < len(spec) and spec[want] == axis else None


def local_shard(name, full, spec, mesh):
    """This rank's shard of ``full`` under the cleaned ``spec`` on
    ``mesh``: along each sharded dim, the block of the rank's coordinate
    on that axis; for the packed qkv along tp, the rows of the rank's
    heads of q, k and v (``[q_r; k_r; v_r]``)."""
    t = full
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n, r = mesh.shape[axis], mesh.coord(axis)
        if _packed_dim(name, spec, axis) == dim:
            t = t.unflatten(dim, (3, n, -1)).select(dim + 1, r).flatten(
                dim, dim + 1)
        else:
            t = t.chunk(n, dim=dim)[r]
    return t.contiguous()


def full_from_shards(name, local, spec, mesh):
    """Inverse of ``local_shard``: all-gather the shards along each
    sharded dim (and undo the packed qkv's head layout)."""
    from .collectives import all_gather_dim

    t = local
    for dim in reversed(range(len(spec))):
        axis = spec[dim]
        if axis is None:
            continue
        n = mesh.shape[axis]
        t = all_gather_dim(t, mesh.group(axis), dim)
        if _packed_dim(name, spec, axis) == dim:
            t = t.unflatten(dim, (n, 3, -1)).transpose(dim, dim + 1) \
                .flatten(dim, dim + 2)
    return t


# -- placement of a block ------------------------------------------------------

def _rules_for(mode, mesh, rules, axis, min_size):
    """The combined rule set of a ``shard_model`` mode; every mode carries
    the ``EmbeddingRules`` overlay as a sibling set."""
    emb = EmbeddingRules(axis=axis)
    user = [] if rules is None else [rules]
    if mode == "fsdp":
        sets = [emb] + user \
            + [fsdp_rules(mesh=mesh, axis=axis, min_size=min_size)]
    elif mode == "tp":
        sets = [emb, TRANSFORMER_TP_RULES] if rules is None \
            else [emb] + user
    elif mode == "pp":
        sets = [pp_rules(mesh=mesh), emb] + user
    elif mode == "tp_pp":
        sets = [pp_rules(mesh=mesh), emb,
                TRANSFORMER_TP_RULES if rules is None else rules]
    elif mode == "pp_fsdp":
        sets = [pp_rules(mesh=mesh), emb] + user \
            + [fsdp_rules(mesh=mesh, axis=axis, min_size=min_size)]
    else:
        raise ValueError(f"shard_model: unknown mode {mode!r} (expected "
                         "'tp', 'fsdp', 'pp', 'tp_pp' or 'pp_fsdp')")
    return combined_rules(*sets)


def shard_model(block, mesh, mode="tp", rules=None, axis=DP,
                min_size=None, trainer=None):
    """Stamp a Gluon block's parameter specs for ``mode`` and, on a rank
    mesh, place its initialised parameters as DTensors of their
    placements (``param_sharding``).  Aux parameters (``grad_req='null'``,
    BatchNorm statistics) replicate.  Sets the process default mesh and
    returns ``{name: spec}``.

    Modes (one rule surface, as the JAX package's): ``'tp'`` (``rules`` or
    ``TRANSFORMER_TP_RULES``), ``'fsdp'`` (every large-enough parameter
    over the data axis, ``rules`` in front of the shape heuristic),
    ``'pp'``, ``'tp_pp'`` and ``'pp_fsdp'``; the ``pp`` ones stamp specs
    and wait for the pipeline slice to be placed (ROADMAP queue 1 item
    2).  A ``trainer`` whose optimizer already holds states would have
    them re-placed with their weights: that, like the captured step over
    a rank mesh, waits for the next slice and raises."""
    from .mesh import set_default_mesh

    combo = _rules_for(mode, mesh, rules, axis, min_size)
    specs = {}
    params = block.collect_params()
    for name, p in params.items():
        p.partition_spec = PartitionSpec() if p.grad_req == "null" \
            else combo.spec_for(name, p.shape)
        specs[name] = p.partition_spec
    set_default_mesh(mesh)
    if not mesh.is_rank_mesh:
        return specs
    if "pp" in mode:
        raise NotImplementedError(
            f"shard_model(mode={mode!r}): placing pipeline stages on a rank "
            "mesh waits for the pipeline slice (ROADMAP queue 1 item 2)")
    if trainer is not None and any(
            st is not None for u in trainer._updaters
            for st in u.states.values()):
        raise NotImplementedError(
            "shard_model(trainer=...): re-placing a trained gluon.Trainer's "
            "states on a rank mesh waits for the next multi-GPU slice "
            "(ROADMAP queue 1 item 1b)")
    from torch.distributed.tensor import DTensor

    for name, p in params.items():
        if p._tensor is None or isinstance(p._tensor, DTensor):
            continue
        spec = clean_spec(p.partition_spec, p.shape, mesh)
        local = local_shard(name, p._tensor.detach(), spec, mesh)
        d = DTensor.from_local(local, mesh.device_mesh,
                               param_sharding(p, mesh), run_check=False)
        p._bind(d, p._ctx)
    return specs


def unplace(block, mesh):
    """Undo ``shard_model``'s DTensor placement: every DTensor parameter
    of ``block`` goes back to its full tensor in the canonical layout (a
    collective: every rank of ``mesh`` calls it)."""
    from torch.distributed.tensor import DTensor

    for name, p in block.collect_params().items():
        if isinstance(p._tensor, DTensor):
            spec = clean_spec(p.partition_spec, p.shape, mesh)
            full = full_from_shards(name, p._tensor.to_local().detach(),
                                    spec, mesh)
            p._bind(full, p._ctx)
    return block


def mesh_of_params(params):
    """The mesh of the first Parameter that ``shard_model`` placed on a
    rank mesh, or None."""
    from .mesh import default_mesh

    for p in params:
        if type(p._tensor).__name__ == "DTensor":
            return default_mesh()
    return None


def batch_sharding(mesh, dim_size=None, leading=0, axis=DP):
    """The placements splitting the batch dim (``leading``) over the data
    axis; replicated when the mesh has no such axis or ``dim_size`` is not
    divisible by it."""
    from .mesh import replicated, sharded

    size = mesh.shape.get(axis, 1)
    if size <= 1 or (dim_size is not None and dim_size % size != 0):
        return replicated(mesh)
    return sharded(mesh, *([None] * leading + [axis]))


def constrain(x, mesh, spec):
    """``x`` laid out as ``spec`` says, with ``clean_spec``'s leniencies
    (and a spec longer than ``x``'s rank a no-op): on a one-device mesh,
    ``x`` as it is; on a rank mesh, this rank's shard of the full ``x``
    that every rank holds."""
    if mesh is None or not getattr(mesh, "is_rank_mesh", False):
        return x
    if len(tuple(spec)) > x.dim():
        return x
    return local_shard("", x, clean_spec(spec, tuple(x.shape), mesh), mesh)


def annotate_activations(block, rules, mesh=None):
    """Activation constraints by block name ride on
    ``HybridBlock.shard_activations``, which waits for the symbolic slice
    (ROADMAP queue 1 item 3); the sharded trainer does not need them (its
    tp-aware ops lay out their own activations)."""
    raise NotImplementedError(
        "annotate_activations: HybridBlock.shard_activations is not ported "
        "yet (ROADMAP queue 1 item 3)")
