"""Convolution and pooling layers.

Counterpart of ``mxnet_tpu/gluon/nn/conv_layers.py`` (reference:
python/mxnet/gluon/nn/conv_layers.py): Conv1D/2D/3D, their transposes,
Max/Avg/GlobalMax/GlobalAvgPool1D/2D/3D and ReflectionPad2D.  ``layout``
is channel-first by default or channel-last; the weights are O-I-spatial
in both (``ops/nn.py``), and ``in_channels`` is deferred from the
channel axis of ``layout``.
"""

from __future__ import annotations

from ..block import HybridBlock
from .activations import Activation


def _to_tuple(v, n):
    if isinstance(v, (tuple, list)):
        return tuple(v)
    return (v,) * n


class _Conv(HybridBlock):
    """Base convolution (reference: nn._Conv;
    op: src/operator/nn/convolution.cc)."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", op_name="Convolution",
                 adj=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self._channels = channels
            self._in_channels = in_channels
            ndim = len(kernel_size)
            strides = _to_tuple(strides, ndim)
            padding = _to_tuple(padding, ndim)
            dilation = _to_tuple(dilation, ndim)
            self._op_name = op_name
            self._kwargs = {
                "kernel": kernel_size, "stride": strides, "dilate": dilation,
                "pad": padding, "num_filter": channels, "num_group": groups,
                "no_bias": not use_bias, "layout": layout}
            if adj is not None:
                self._kwargs["adj"] = adj
            if op_name == "Convolution":
                wshape = (channels, in_channels // groups) + \
                    tuple(kernel_size)
            else:  # Deconvolution: (in, out/groups, *k) reference layout
                wshape = (in_channels, channels // groups) + \
                    tuple(kernel_size)
            self._wshape_template = wshape
            self.weight = self.params.get(
                "weight", shape=wshape, init=weight_initializer,
                allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(channels,), init=bias_initializer,
                    allow_deferred_init=True)
            else:
                self.bias = None
            if activation is not None:
                self.act = Activation(activation, prefix=activation + "_")
            else:
                self.act = None

    def infer_shape(self, x, *args):
        in_channels = x.shape[self._kwargs["layout"].index("C")]
        groups = self._kwargs["num_group"]
        k = tuple(self._kwargs["kernel"])
        if self._op_name == "Convolution":
            self.weight.shape = (self._channels, in_channels // groups) + k
        else:
            self.weight.shape = (in_channels, self._channels // groups) + k
        self._in_channels = in_channels

    def hybrid_forward(self, F, x, weight, bias=None):
        op = getattr(F, self._op_name)
        act = op(x, weight, bias, **self._kwargs)
        if self.act is not None:
            act = self.act(act)
        return act

    def _alias(self):
        return "conv"

    def __repr__(self):
        s = "{name}({mapping}, kernel_size={kernel}, stride={stride}"
        len_kernel_size = len(self._kwargs["kernel"])
        if self._kwargs["pad"] != (0,) * len_kernel_size:
            s += ", padding={pad}"
        if self._kwargs["dilate"] != (1,) * len_kernel_size:
            s += ", dilation={dilate}"
        if hasattr(self, "out_pad") and self.out_pad != (0,) * len_kernel_size:
            s += ", output_padding={out_pad}".format(out_pad=self.out_pad)
        if self._kwargs["num_group"] != 1:
            s += ", groups={num_group}"
        if self.bias is None:
            s += ", bias=False"
        if self.act:
            s += ", {}".format(self.act)
        s += ")"
        shape = self.weight.shape
        return s.format(name=self.__class__.__name__,
                        mapping="{0} -> {1}".format(
                            shape[1] if shape[1] else None, shape[0]),
                        **self._kwargs)


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,)
        assert len(kernel_size) == 1, "kernel_size must be a number or a " \
            "list of 1 ints"
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,) * 2
        assert len(kernel_size) == 2, "kernel_size must be a number or a " \
            "list of 2 ints"
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,) * 3
        assert len(kernel_size) == 3, "kernel_size must be a number or a " \
            "list of 3 ints"
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class _ConvTranspose(_Conv):
    def infer_shape(self, x, *args):
        in_channels = x.shape[self._kwargs["layout"].index("C")]
        groups = self._kwargs["num_group"]
        k = tuple(self._kwargs["kernel"])
        self.weight.shape = (in_channels, self._channels // groups) + k
        self._in_channels = in_channels


class Conv1DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,)
        if isinstance(output_padding, int):
            output_padding = (output_padding,)
        assert len(kernel_size) == 1
        assert len(output_padding) == 1
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name="Deconvolution", adj=output_padding,
                         **kwargs)
        self.outpad = output_padding


class Conv2DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,) * 2
        if isinstance(output_padding, int):
            output_padding = (output_padding,) * 2
        assert len(kernel_size) == 2
        assert len(output_padding) == 2
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name="Deconvolution", adj=output_padding,
                         **kwargs)
        self.outpad = output_padding


class Conv3DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,) * 3
        if isinstance(output_padding, int):
            output_padding = (output_padding,) * 3
        assert len(kernel_size) == 3
        assert len(output_padding) == 3
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name="Deconvolution", adj=output_padding,
                         **kwargs)
        self.outpad = output_padding


class _Pooling(HybridBlock):
    """Base pooling (reference: nn._Pooling;
    op: src/operator/nn/pooling.cc)."""

    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, layout, count_include_pad=None, **kwargs):
        super().__init__(**kwargs)
        if strides is None:
            strides = pool_size
        if isinstance(strides, int):
            strides = (strides,) * len(pool_size)
        if isinstance(padding, int):
            padding = (padding,) * len(pool_size)
        self._kwargs = {
            "kernel": pool_size, "stride": strides, "pad": padding,
            "global_pool": global_pool, "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid",
            "layout": layout}
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def _alias(self):
        return "pool"

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)

    def __repr__(self):
        return ("{name}(size={kernel}, stride={stride}, padding={pad}, "
                "ceil_mode={ceil_mode})").format(
            name=self.__class__.__name__,
            ceil_mode=self._kwargs["pooling_convention"] == "full",
            **self._kwargs)


class MaxPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, **kwargs):
        if isinstance(pool_size, int):
            pool_size = (pool_size,)
        assert layout in ("NCW", "NWC"), layout
        super().__init__(pool_size, strides, padding, ceil_mode, False,
                         "max", layout, **kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        if isinstance(pool_size, int):
            pool_size = (pool_size,) * 2
        assert layout in ("NCHW", "NHWC"), layout
        super().__init__(pool_size, strides, padding, ceil_mode, False,
                         "max", layout, **kwargs)


class MaxPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, **kwargs):
        if isinstance(pool_size, int):
            pool_size = (pool_size,) * 3
        assert layout in ("NCDHW", "NDHWC"), layout
        super().__init__(pool_size, strides, padding, ceil_mode, False,
                         "max", layout, **kwargs)


class AvgPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, count_include_pad=True, **kwargs):
        if isinstance(pool_size, int):
            pool_size = (pool_size,)
        assert layout in ("NCW", "NWC"), layout
        super().__init__(pool_size, strides, padding, ceil_mode, False,
                         "avg", layout, count_include_pad, **kwargs)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        if isinstance(pool_size, int):
            pool_size = (pool_size,) * 2
        assert layout in ("NCHW", "NHWC"), layout
        super().__init__(pool_size, strides, padding, ceil_mode, False,
                         "avg", layout, count_include_pad, **kwargs)


class AvgPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        if isinstance(pool_size, int):
            pool_size = (pool_size,) * 3
        assert layout in ("NCDHW", "NDHWC"), layout
        super().__init__(pool_size, strides, padding, ceil_mode, False,
                         "avg", layout, count_include_pad, **kwargs)


class GlobalMaxPool1D(_Pooling):
    def __init__(self, layout="NCW", **kwargs):
        assert layout in ("NCW", "NWC"), layout
        super().__init__((1,), None, 0, True, True, "max", layout, **kwargs)


class GlobalMaxPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        assert layout in ("NCHW", "NHWC"), layout
        super().__init__((1, 1), None, 0, True, True, "max", layout,
                         **kwargs)


class GlobalMaxPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kwargs):
        assert layout in ("NCDHW", "NDHWC"), layout
        super().__init__((1, 1, 1), None, 0, True, True, "max", layout,
                         **kwargs)


class GlobalAvgPool1D(_Pooling):
    def __init__(self, layout="NCW", **kwargs):
        assert layout in ("NCW", "NWC"), layout
        super().__init__((1,), None, 0, True, True, "avg", layout, **kwargs)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        assert layout in ("NCHW", "NHWC"), layout
        super().__init__((1, 1), None, 0, True, True, "avg", layout,
                         **kwargs)


class GlobalAvgPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kwargs):
        assert layout in ("NCDHW", "NDHWC"), layout
        super().__init__((1, 1, 1), None, 0, True, True, "avg", layout,
                         **kwargs)


class ReflectionPad2D(HybridBlock):
    """Reflection padding (reference: nn.ReflectionPad2D; op: Pad)."""

    def __init__(self, padding=0, **kwargs):
        super().__init__(**kwargs)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        assert len(padding) == 8
        self._padding = padding

    def hybrid_forward(self, F, x):
        return F.Pad(x, mode="reflect", pad_width=self._padding)
