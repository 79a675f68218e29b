"""Vision Transformer (Dosovitskiy et al. 2021), as a Gluon block.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/vit.py``: a
``Conv2D(units, k=patch, s=patch)`` patch embedding, a class token and a
learned position embedding, the zoo's pre-LN trunk (``bert``'s
``ScanTransformerEncoder`` or per-layer ``TransformerEncoder``,
``encoder_``; ``attention_impl="flash"`` runs the hand-written flash
kernels, at T = patches + 1, 197 for 224/16), and a classification head
on the class position.  Names and shapes are the JAX package's
(``visiontransformer0_encoder_qkv_stack_weight`` ...).  As the other
vision models, it is built uninitialised: ``initialize(init, ctx=...)``.
"""

from __future__ import annotations

from ...block import HybridBlock
from ... import nn
from ..bert import ScanTransformerEncoder, TransformerEncoder

__all__ = ["VisionTransformer", "vit_tiny", "vit_small", "vit_base",
           "vit_large"]


class VisionTransformer(HybridBlock):
    def __init__(self, image_size=224, patch_size=16, units=768,
                 num_layers=12, num_heads=12, hidden_size=None,
                 classes=1000, dropout=0.0, attention_impl="dense",
                 scan_layers=True, remat=False, **kwargs):
        super().__init__(**kwargs)
        assert image_size % patch_size == 0, \
            f"image_size {image_size} must be divisible by patch_size " \
            f"{patch_size}"
        n_patches = (image_size // patch_size) ** 2
        self._units = units
        self._dropout = dropout
        with self.name_scope():
            self.patch_embed = nn.Conv2D(
                units, kernel_size=patch_size, strides=patch_size,
                prefix="patch_embed_")
            self.cls_token = self.params.get(
                "cls_token", shape=(1, 1, units), init="zeros")
            self.pos_embed = self.params.get(
                "pos_embed", shape=(1, n_patches + 1, units),
                init="normal")
            if remat and not scan_layers:
                raise ValueError(
                    "VisionTransformer: remat=True requires "
                    "scan_layers=True (per-layer remat lives in the "
                    "scanned trunk)")
            enc = ScanTransformerEncoder if scan_layers \
                else TransformerEncoder
            enc_kwargs = {"remat": remat} if scan_layers else {}
            self.encoder = enc(
                num_layers=num_layers, units=units, num_heads=num_heads,
                hidden_size=hidden_size, dropout=dropout,
                attention_impl=attention_impl, prefix="encoder_",
                **enc_kwargs)
            self.head = nn.Dense(classes, in_units=units,
                                 prefix="head_")
            if dropout:
                self.drop = nn.Dropout(dropout)

    def hybrid_forward(self, F, x, cls_token, pos_embed):
        p = self.patch_embed(x)                     # (B, U, H/ps, W/ps)
        p = F.reshape(p, shape=(0, self._units, -1))
        p = F.transpose(p, axes=(0, 2, 1))          # (B, N, U)
        cls = F.broadcast_like(
            cls_token, F.slice_axis(p, axis=1, begin=0, end=1))
        h = F.broadcast_add(F.concat(cls, p, dim=1), pos_embed)
        if self._dropout:
            h = self.drop(h)
        h = self.encoder(h)
        return self.head(F.reshape(
            F.slice_axis(h, axis=1, begin=0, end=1),
            shape=(-1, self._units)))


def vit_tiny(image_size=32, patch_size=4, classes=10, **kwargs):
    """CI-scale ViT (32x32/p4 defaults for tests and examples)."""
    return VisionTransformer(image_size, patch_size, units=64,
                             num_layers=4, num_heads=4, classes=classes,
                             **kwargs)


def vit_small(image_size=224, patch_size=16, classes=1000, **kwargs):
    return VisionTransformer(image_size, patch_size, units=384,
                             num_layers=12, num_heads=6, classes=classes,
                             **kwargs)


def vit_base(image_size=224, patch_size=16, classes=1000, **kwargs):
    return VisionTransformer(image_size, patch_size, units=768,
                             num_layers=12, num_heads=12,
                             classes=classes, **kwargs)


def vit_large(image_size=224, patch_size=16, classes=1000, **kwargs):
    return VisionTransformer(image_size, patch_size, units=1024,
                             num_layers=24, num_heads=16,
                             classes=classes, **kwargs)
