"""Mixture-of-Experts Gluon layers (Switch/GShard sparse FFN).

Counterpart of ``mxnet_tpu/gluon/contrib/moe.py``, with its parameter
names.  The expert weights carry a leading E axis: under a rank mesh with
an ``ep`` axis, ``MOE_EP_RULES`` gives each ep rank E/ep of the experts and
``ShardedTrainer`` hands ``moe_ffn`` the rank's shard, which moves the
tokens to their experts and back over the ep group.

Usage::

    ffn = MoEFFN(units=512, hidden=2048, num_experts=8, k=2)
    trainer = parallel.ShardedTrainer(net, loss, 'adamw', {...},
                                      mesh=parallel.make_mesh(dp=2, ep=4),
                                      rules=parallel.MOE_EP_RULES)
"""

from __future__ import annotations

from ..block import HybridBlock


class MoEFFN(HybridBlock):
    """Sparse MoE feed-forward block: router -> top-k dispatch ->
    per-expert FFN -> weighted combine (op: ``ops/moe.py`` ``moe_ffn``).

    ``units``: model width M; ``hidden``: per-expert hidden width F;
    ``num_experts``: E; ``k``: experts a token (1 = Switch, 2 = GShard
    top-2); ``capacity_factor``: per-expert capacity = ceil(tokens / E *
    capacity_factor); ``activation``: 'relu' or 'gelu'.  Each forward
    stashes the Switch load-balancing loss in ``aux_loss``."""

    def __init__(self, units, hidden, num_experts, k=1,
                 capacity_factor=1.25, activation="relu", **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._hidden = hidden
        self._num_experts = num_experts
        self._k = int(k)
        self._capacity_factor = float(capacity_factor)
        self._activation = activation
        self.aux_loss = None
        with self.name_scope():
            self.gate_weight = self.params.get(
                "gate_weight", shape=(num_experts, units))
            self.expert_w1 = self.params.get(
                "expert_ffn1_weight", shape=(num_experts, units, hidden))
            self.expert_b1 = self.params.get(
                "expert_ffn1_bias", shape=(num_experts, hidden),
                init="zeros")
            self.expert_w2 = self.params.get(
                "expert_ffn2_weight", shape=(num_experts, hidden, units))
            self.expert_b2 = self.params.get(
                "expert_ffn2_bias", shape=(num_experts, units), init="zeros")

    def hybrid_forward(self, F, x, gate_weight, expert_w1, expert_b1,
                       expert_w2, expert_b2):
        y, aux = F.moe_ffn(x, gate_weight, expert_w1, expert_b1, expert_w2,
                           expert_b2, num_experts=self._num_experts,
                           k=self._k, capacity_factor=self._capacity_factor,
                           activation=self._activation, output_aux_loss=True)
        self.aux_loss = aux
        return y

    def __repr__(self):
        return (f"{self.__class__.__name__}(units={self._units}, "
                f"hidden={self._hidden}, experts={self._num_experts}, "
                f"k={self._k})")
