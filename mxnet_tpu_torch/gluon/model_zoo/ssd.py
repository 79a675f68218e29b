"""SSD: the Single Shot MultiBox Detector (Liu et al. 2016).

Counterpart of ``mxnet_tpu/gluon/model_zoo/ssd.py`` (reference:
example/ssd/ symbol/symbol_builder.py over the MultiBox ops).  A backbone
of conv-BN-ReLU-maxpool stages, one a feature map, with a class head, a
box head and an anchor generator on each; the anchors, the training
targets and the decode are ``ops/contrib_det.py``'s padded, fixed-shape
ops.

``SSDTrainLoss`` is one function through ``invoke_simple``: one node on
the imperative tape, plain autograd on tensors.  Its targets
(``MultiBoxTarget``) carry no gradient: they see the class scores only
through the hard-negative rank, an integer, so they are computed under
``torch.no_grad()`` on a detached softmax, and the loss's gradients are
the JAX package's.
"""

from __future__ import annotations

import functools

import torch

from ..block import HybridBlock
from .. import nn


class SSDAnchorGenerator(HybridBlock):
    """A feature map's anchors (reference: the MultiBoxPrior of
    symbol_builder)."""

    def __init__(self, sizes, ratios, **kwargs):
        super().__init__(**kwargs)
        self._sizes = tuple(sizes)
        self._ratios = tuple(ratios)

    @property
    def num_anchors(self):
        return len(self._sizes) + len(self._ratios) - 1

    def hybrid_forward(self, F, x):
        return F.MultiBoxPrior(x, sizes=self._sizes, ratios=self._ratios)


class SSD(HybridBlock):
    """SSD over a stack of conv-BN-ReLU-maxpool stages, one a scale
    (``base_channels``), each halving the map.  Returns (cls_preds (B,
    C+1, N), loc_preds (B, N*4), anchors (1, N, 4))."""

    def __init__(self, num_classes=20, base_channels=(32, 64, 128),
                 scale_sizes=((0.2,), (0.4,), (0.7,)),
                 scale_ratios=((1, 2, 0.5),) * 3, **kwargs):
        super().__init__(**kwargs)
        self.num_classes = num_classes
        with self.name_scope():
            self.stages = nn.HybridSequential(prefix="backbone_")
            with self.stages.name_scope():
                seen = {}
                for c in base_channels:
                    # a width's first stage is stage{c}_, as in the JAX
                    # package; a repeat is stage{c}_{k}_ (the JAX package
                    # names it stage{c}_ again, and its parameter names
                    # collide)
                    k = seen[c] = seen.get(c, -1) + 1
                    blk = nn.HybridSequential(
                        prefix=f"stage{c}_" if not k else f"stage{c}_{k}_")
                    with blk.name_scope():
                        blk.add(nn.Conv2D(c, 3, padding=1, use_bias=False),
                                nn.BatchNorm(),
                                nn.Activation("relu"),
                                nn.MaxPool2D(2))
                    self.stages.add(blk)
            self.anchor_gens = []
            self.cls_heads = nn.HybridSequential(prefix="cls_")
            self.loc_heads = nn.HybridSequential(prefix="loc_")
            for i, (sizes, ratios) in enumerate(zip(scale_sizes,
                                                    scale_ratios)):
                gen = SSDAnchorGenerator(sizes, ratios, prefix=f"anchor{i}_")
                self.anchor_gens.append(gen)
                setattr(self, f"anchor_gen{i}", gen)
                na = gen.num_anchors
                with self.cls_heads.name_scope():
                    self.cls_heads.add(nn.Conv2D(na * (num_classes + 1), 3,
                                                 padding=1))
                with self.loc_heads.name_scope():
                    self.loc_heads.add(nn.Conv2D(na * 4, 3, padding=1))

    def hybrid_forward(self, F, x):
        cls_preds, loc_preds, anchors = [], [], []
        for stage, gen, cls_head, loc_head in zip(
                self.stages._children.values(), self.anchor_gens,
                self.cls_heads._children.values(),
                self.loc_heads._children.values()):
            x = stage(x)
            anchors.append(gen(x))
            c = cls_head(x)                     # (B, A*(C+1), H, W)
            l = loc_head(x)                     # (B, A*4, H, W)
            cls_preds.append(F.reshape(F.transpose(c, axes=(0, 2, 3, 1)),
                                       shape=(0, -1, self.num_classes + 1)))
            loc_preds.append(F.reshape(F.transpose(l, axes=(0, 2, 3, 1)),
                                       shape=(0, -1)))
        cls_all = F.concat(*cls_preds, dim=1)     # (B, N, C+1)
        loc_all = F.concat(*loc_preds, dim=1)     # (B, N*4)
        anc_all = F.concat(*anchors, dim=1)       # (1, N, 4)
        return F.transpose(cls_all, axes=(0, 2, 1)), loc_all, anc_all


def ssd_loss(cls_p, loc_p, anc, lab, ratio=3):
    """The SSD training loss on tensors: ``cls_p`` (B, C+1, N), ``loc_p``
    (B, N*4), ``anc`` (1, N, 4), ``lab`` (B, M, 5).  Cross-entropy over the
    anchors whose target is not ``ignore_label`` (the mined-out
    negatives), over their count; smooth-L1 on the matched anchors' boxes,
    over the matched count."""
    from ...ops.contrib_det import multibox_target

    with torch.no_grad():
        loc_t, loc_m, cls_t = multibox_target(
            anc.detach(), lab.detach(), torch.softmax(cls_p.detach(), dim=1),
            negative_mining_ratio=ratio)
    logp = torch.log_softmax(cls_p, dim=1)
    tgt = torch.clamp(cls_t, min=0).to(torch.int64)
    nll = -torch.gather(logp, 1, tgt[:, None, :])[:, 0]
    valid = cls_t >= 0
    denom = torch.clamp(valid.sum(), min=1)
    cls_loss = torch.where(valid, nll, torch.zeros_like(nll)).sum() / denom
    diff = (loc_p - loc_t) * loc_m
    absd = torch.abs(diff)
    sl1 = torch.where(absd < 1.0, 0.5 * diff * diff, absd - 0.5)
    pos = torch.clamp(loc_m.sum() / 4.0, min=1.0)
    return cls_loss + sl1.sum() / pos


class SSDTrainLoss(HybridBlock):
    """``MultiBoxTarget``, then the class cross-entropy (mined-out
    negatives ignored) and the smooth-L1 box loss (reference: example/ssd
    training targets over MultiBoxTarget), as one op."""

    def __init__(self, negative_mining_ratio=3, **kwargs):
        super().__init__(**kwargs)
        self._ratio = negative_mining_ratio

    def hybrid_forward(self, F, outputs, label):
        from ...ndarray.register import invoke_simple

        cls_preds, loc_preds, anchors = outputs
        fn = functools.partial(ssd_loss, ratio=self._ratio)
        return invoke_simple(fn, (cls_preds, loc_preds, anchors, label),
                             name="ssd_loss")


def ssd_detect(net, x, nms_threshold=0.45, score_threshold=0.01,
               nms_topk=400):
    """Inference: the forward, a softmax over the classes, then
    ``MultiBoxDetection`` (reference: example/ssd/demo.py).  Returns (B,
    N, 6) rows [id, score, xmin, ymin, xmax, ymax]."""
    from ... import ndarray as nd

    cls_preds, loc_preds, anchors = net(x)
    probs = nd.softmax(cls_preds, axis=1)                     # (B, C+1, N)
    return nd.MultiBoxDetection(probs, loc_preds, anchors,
                                nms_threshold=nms_threshold,
                                threshold=score_threshold,
                                nms_topk=nms_topk)
