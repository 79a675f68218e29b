"""Mixture-of-Experts ops (Switch/GShard-style sparse FFN).

Counterpart of ``mxnet_tpu/ops/moe.py``, registered under the same name.
The JAX op dispatches by a dense (tokens, experts, capacity) one-hot
product, the shape XLA compiles well; this one dispatches by index: each
token's (expert, slot) is computed as the JAX op computes it, the kept
tokens are scattered into the (E, C) slots (``index_add``), the experts
run as batched products over their slots, and each token gathers its
slots back with its combine weight.  The routing is the JAX op's:

- capacity ``ceil(n / E * capacity_factor)`` (at least 1);
- top-1 rounds: ``argmax`` of the router probabilities (first index on
  ties), a token's slot is its place in its expert's queue in token
  order, after the slots earlier rounds filled (``base_counts``), so the
  slots of top-2 never collide; a token past the capacity is dropped
  (combine weight 0); the next round masks the chosen expert out by
  selection, kept or not;
- k > 1: the combine weights are renormalised over the picks;
- ``output_aux_loss``: the Switch load-balancing loss ``E * sum_e f_e *
  p_e`` (f: the share of tokens whose first pick is e, p: the mean router
  probability).

Inside a sharded step (``collectives.parallel_scope``) the tokens of the
global batch are split over the scope's dp group (dp and ep ranks, in
the order of their blocks): the capacity is that of the global token
count, and a token's slot counts the tokens of the ranks before it, so
routing, drops and combine weights are the one-device op's.  When the
expert weights hold this rank's experts (``scope.ep_shards``, the
``MOE_EP_RULES`` layout), the tokens reach their experts and come back
through ``all_to_all_single`` over the ep group: each rank sends every
owner the (experts, capacity) slots its own tokens fill, an owner sums
what arrives (the ranks fill disjoint slots), runs its experts and sends
every rank their outputs.
"""

from __future__ import annotations

import math

import torch

from .._parallel_scope import current_scope
from .registry import register


def _top1_route(probs, capacity, base_counts, group):
    """One top-1 round over this rank's tokens.

    probs: (n, E) (the chosen experts of earlier rounds masked to 0);
    base_counts: (E,) slots each expert has filled in earlier rounds.
    Returns (expert (n,), slot (n,), kept (n,) bool, gate (n,) with the
    dropped tokens' gate 0, new base_counts, selection one-hot (n, E))."""
    n, e = probs.shape
    idx = torch.argmax(probs, dim=1)
    gate = probs.gather(1, idx[:, None])[:, 0]
    sel = torch.nn.functional.one_hot(idx, e)
    every = sel.sum(0)[None]                       # (ranks, E)
    me = 0
    if group is not None:
        from ..parallel.collectives import all_gather_dim

        every = all_gather_dim(every, group, 0)
        me = torch.distributed.get_rank(group)
    before = every[:me].sum(0)
    pos = torch.cumsum(sel, dim=0) - 1 + before + base_counts
    slot = pos.gather(1, idx[:, None])[:, 0]
    kept = slot < capacity
    gate = gate * kept.to(gate.dtype)
    total = every.sum(0)
    new_counts = base_counts + torch.clamp(capacity - base_counts, min=0) \
        .minimum(total)
    return idx, slot, kept, gate, new_counts, sel


def _activate(h, activation):
    if activation == "relu":
        return torch.relu(h)
    if activation == "gelu":
        # jax.nn.gelu's default is the tanh approximation
        return torch.nn.functional.gelu(h, approximate="tanh")
    return h


def _experts(xs, w1, b1, w2, b2, activation, dtype):
    """The experts on their slots: xs (E, C, M) -> (E, C, M), products
    summed in f32 and rounded to ``dtype`` as the JAX op's
    ``preferred_element_type`` einsums."""
    h = torch.bmm(xs.float(), w1.float()).to(dtype) + b1[:, None, :]
    h = _activate(h, activation)
    out = torch.bmm(h.float(), w2.float()).to(dtype)
    return out + b2[:, None, :]


@register("moe_ffn", aliases=("MoEFFN_op",))
def moe_ffn(data, gate_weight, w1, b1, w2, b2, num_experts=None, k=1,
            capacity_factor=1.25, activation="relu",
            output_aux_loss=False):
    """Sparse MoE FFN: route -> dispatch -> per-expert FFN -> combine.

    data: (..., M); gate_weight: (E, M) (FullyConnected layout);
    w1: (E, M, F); b1: (E, F); w2: (E, F, M); b2: (E, M) (or this rank's
    E/ep experts of each inside an expert-parallel step).  Returns y
    (same shape as data); with output_aux_loss also the Switch
    load-balancing loss (a 0-dim tensor in data's dtype)."""
    scope = current_scope()
    if scope is not None and scope.sp_group is not None:
        raise NotImplementedError(
            "moe_ffn inside a sequence-parallel step: the routing order "
            "over tokens split along the sequence is not ported")
    group = None if scope is None else scope.dp_group
    ranks = 1 if group is None else torch.distributed.get_world_size(group)
    owned = None if scope is None else [scope.experts_of(t)
                                        for t in (w1, b1, w2, b2)]
    if owned is not None and not any(owned):
        owned = None
    elif owned is not None and not all(owned):
        from ..base import MXNetError

        raise MXNetError("moe_ffn: the expert weights and biases must all "
                         "hold this rank's experts (MOE_EP_RULES), or none")
    ep_group = scope.ep_group if owned is not None else None
    orig_shape = data.shape
    m = orig_shape[-1]
    x = data.reshape(-1, m)
    n = x.shape[0]
    e = gate_weight.shape[0]
    capacity = max(1, int(math.ceil(n * ranks / e * capacity_factor)))

    logits = torch.matmul(x.float(), gate_weight.float().t())
    probs = torch.softmax(logits, dim=-1)

    masked = probs
    counts = torch.zeros(e, dtype=torch.long, device=x.device)
    picks = []
    for _ in range(int(k)):
        idx, slot, kept, gate, counts, sel = _top1_route(masked, capacity,
                                                         counts, group)
        picks.append((idx, slot, kept, gate))
        masked = masked * (1.0 - sel.to(masked.dtype))
    weights = [g for _, _, _, g in picks]
    if k > 1:
        denom = torch.stack(weights).sum(0)
        weights = [w / torch.clamp(denom, min=1e-9) for w in weights]

    # dispatch: the kept tokens into the (E, C) slots, by index
    dtype = data.dtype
    flat = [torch.where(kept, idx * capacity + slot, torch.zeros_like(slot))
            for idx, slot, kept, _ in picks]
    keep = torch.cat([kept for _, _, kept, _ in picks])
    src = torch.cat([x] * len(picks))[keep]
    slots = x.new_zeros((e * capacity, m)).index_add(0, torch.cat(flat)[keep],
                                                     src)
    if owned is None:
        out_e = _experts(slots.view(e, capacity, m), w1, b1, w2, b2,
                         activation, dtype).reshape(e * capacity, m)
    else:
        out_e = _expert_parallel(slots, e, capacity, m, w1, b1, w2, b2,
                                 activation, dtype, ep_group)
    # the JAX op casts the combine weights to data's dtype
    y = sum(w.to(dtype).float()[:, None] * out_e[f].float()
            for w, f in zip(weights, flat))
    y = y.to(dtype).reshape(orig_shape)

    if not output_aux_loss:
        return y
    first = torch.nn.functional.one_hot(torch.argmax(probs, dim=1), e) \
        .float()
    f_sum, p_sum = first.sum(0), probs.sum(0)
    if group is not None:
        from ..parallel.collectives import all_reduce_, global_sum

        f_sum = all_reduce_(f_sum.clone(), group, "moe_aux")
        p_sum = global_sum(p_sum, group)
    total = n * ranks
    aux = e * torch.sum((f_sum / total) * (p_sum / total))
    return y, aux.to(dtype)


def _expert_parallel(slots, e, capacity, m, w1, b1, w2, b2, activation,
                     dtype, group):
    """The experts over the ep group: slots (E*C, M) this rank's tokens
    fill -> (E*C, M) every expert's output on every slot."""
    from ..parallel.collectives import all_to_all_single

    ep = torch.distributed.get_world_size(group)
    e_loc = e // ep
    # chunk j: the slots of owner j's experts
    got = all_to_all_single(slots.reshape(ep, e_loc * capacity * m), group)
    xs = got.reshape(ep, e_loc, capacity, m).sum(0)
    out = _experts(xs, w1, b1, w2, b2, activation, dtype)
    back = all_to_all_single(
        out.reshape(1, -1).expand(ep, -1).contiguous(), group)
    return back.reshape(e * capacity, m)
