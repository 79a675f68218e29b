"""Deformable convolution as a Gluon layer.

Counterpart of ``mxnet_tpu/gluon/contrib/cnn.py`` (reference:
python/mxnet/gluon/contrib/cnn/conv_layers.py).  The layer holds two
sets of weights, as the reference's does: a plain convolution that
predicts each tap's sampling offsets (zero-initialised, so the layer
starts as a plain convolution), and the deformable convolution
(``ops/vision_extra.py``) that samples by them.
"""

from __future__ import annotations

from ..block import HybridBlock
from ..nn.activations import Activation
from ..nn.conv_layers import _to_tuple


class DeformableConvolution(HybridBlock):
    """2-D deformable convolution v1 (Dai et al. 2017).

    ``offset_*`` kwargs configure the offset-predicting convolution
    branch; the main branch consumes its output (reference signature
    kept)."""

    def __init__(self, channels, kernel_size=(1, 1), strides=(1, 1),
                 padding=(0, 0), dilation=(1, 1), groups=1,
                 num_deformable_group=1, layout="NCHW", use_bias=True,
                 in_channels=0, activation=None, weight_initializer=None,
                 bias_initializer="zeros",
                 offset_weight_initializer="zeros",
                 offset_bias_initializer="zeros", offset_use_bias=True,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        assert layout == "NCHW", \
            "DeformableConvolution supports layout='NCHW'"
        kernel_size = _to_tuple(kernel_size, 2)
        strides = _to_tuple(strides, 2)
        padding = _to_tuple(padding, 2)
        dilation = _to_tuple(dilation, 2)
        with self.name_scope():
            self._channels = channels
            self._kwargs = {
                "kernel": kernel_size, "stride": strides, "pad": padding,
                "dilate": dilation, "num_filter": channels,
                "num_group": groups,
                "num_deformable_group": num_deformable_group,
                "no_bias": not use_bias}
            offset_channels = 2 * kernel_size[0] * kernel_size[1] \
                * num_deformable_group
            self._offset_kwargs = {
                "kernel": kernel_size, "stride": strides, "pad": padding,
                "dilate": dilation, "num_filter": offset_channels,
                "num_group": 1, "no_bias": not offset_use_bias,
                "layout": layout}
            self.weight = self.params.get(
                "weight",
                shape=(channels, in_channels // groups) + kernel_size,
                init=weight_initializer, allow_deferred_init=True)
            self.bias = self.params.get(
                "bias", shape=(channels,), init=bias_initializer,
                allow_deferred_init=True) if use_bias else None
            # zero-init offsets: the layer starts as a plain convolution
            # (the reference's deformable_conv_offset_initializer)
            self.offset_weight = self.params.get(
                "offset_weight",
                shape=(offset_channels, in_channels) + kernel_size,
                init=offset_weight_initializer, allow_deferred_init=True)
            self.offset_bias = self.params.get(
                "offset_bias", shape=(offset_channels,),
                init=offset_bias_initializer,
                allow_deferred_init=True) if offset_use_bias else None
            self.act = Activation(activation) if activation else None

    def infer_shape(self, x, *args):
        in_channels = x.shape[1]
        k = tuple(self._kwargs["kernel"])
        groups = self._kwargs["num_group"]
        self.weight.shape = (self._channels, in_channels // groups) + k
        self.offset_weight.shape = \
            (self.offset_weight.shape[0], in_channels) + k

    def hybrid_forward(self, F, x, weight, offset_weight, bias=None,
                       offset_bias=None):
        offset = F.Convolution(x, offset_weight, offset_bias,
                               **self._offset_kwargs)
        out = F.DeformableConvolution(
            x, offset, weight, bias, **self._kwargs)
        if self.act is not None:
            out = self.act(out)
        return out
