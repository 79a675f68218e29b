"""Symbol -> ONNX export.

Counterpart of ``mxnet_tpu/contrib/onnx/mx2onnx.py`` (reference:
python/mxnet/contrib/onnx/mx2onnx export_model /
MXNetGraph.create_onnx_graph_proto) over the port's ``Symbol``, written
through the port's own codec (``onnx_minimal``): for the same graph and
parameters the file is the JAX package's message.  Targets opset 9
(attribute-style Clip/Dropout, input-style Reshape).
"""

from __future__ import annotations

import numpy as _np

from ...base import MXNetError
from . import onnx_minimal as _pb

_OPSET = 9

_DT = {"float32": _pb.TensorProto.FLOAT, "float64": _pb.TensorProto.DOUBLE,
       "float16": _pb.TensorProto.FLOAT16, "int32": _pb.TensorProto.INT32,
       "int64": _pb.TensorProto.INT64, "int8": _pb.TensorProto.INT8,
       "uint8": _pb.TensorProto.UINT8, "bool": _pb.TensorProto.BOOL,
       "bfloat16": _pb.TensorProto.BFLOAT16}

_ACT = {"relu": "Relu", "sigmoid": "Sigmoid", "tanh": "Tanh",
        "softrelu": "Softplus", "softsign": "Softsign", "gelu": "Gelu",
        "erf": "Erf"}

_ELEM = {"broadcast_add": "Add", "elemwise_add": "Add", "_plus": "Add",
         "broadcast_sub": "Sub", "elemwise_sub": "Sub",
         "broadcast_mul": "Mul", "elemwise_mul": "Mul",
         "broadcast_div": "Div", "elemwise_div": "Div",
         "broadcast_maximum": "Max", "broadcast_minimum": "Min",
         "broadcast_power": "Pow", "dot": "MatMul"}

_REDUCE = {"mean": "ReduceMean", "sum": "ReduceSum", "max": "ReduceMax",
           "min": "ReduceMin", "prod": "ReduceProd"}

_UNARY = {"exp": "Exp", "log": "Log", "sqrt": "Sqrt", "abs": "Abs",
          "negative": "Neg", "floor": "Floor", "ceil": "Ceil",
          "relu": "Relu", "sigmoid": "Sigmoid", "tanh": "Tanh",
          "erf": "Erf", "identity": "Identity", "_copy": "Identity"}


def _attr(node, name, value):
    a = node.attribute.add()
    a.name = name
    if isinstance(value, bool):
        a.i = int(value)
        a.type = _pb.AttributeProto.INT
    elif isinstance(value, int):
        a.i = value
        a.type = _pb.AttributeProto.INT
    elif isinstance(value, float):
        a.f = value
        a.type = _pb.AttributeProto.FLOAT
    elif isinstance(value, str):
        a.s = value.encode()
        a.type = _pb.AttributeProto.STRING
    elif isinstance(value, (list, tuple)):
        if value and isinstance(value[0], float):
            a.floats.extend(value)
            a.type = _pb.AttributeProto.FLOATS
        else:
            a.ints.extend(int(v) for v in value)
            a.type = _pb.AttributeProto.INTS
    else:
        raise MXNetError(f"onnx attr {name}: unsupported {type(value)}")


def _tensor(name, arr):
    t = _pb.TensorProto()
    t.name = name
    arr = _np.ascontiguousarray(arr)
    t.dims.extend(arr.shape)
    dt = _DT.get(str(arr.dtype))
    if dt is None:
        raise MXNetError(f"onnx export: dtype {arr.dtype} unsupported")
    t.data_type = dt
    t.raw_data = arr.tobytes()
    return t


def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return [int(x) for x in v]
    return [int(v)] * n


def _scalar_value(sym):
    return sym.attrs.get("__scalar__")


class _Ctx:
    def __init__(self, graph, params):
        self.graph = graph
        self.params = params
        self.names = {}        # id(sym-node) -> output name
        self.extra_init = {}   # name -> ndarray (generated consts)
        self.counter = [0]

    def fresh(self, hint):
        self.counter[0] += 1
        return f"{hint}_{self.counter[0]}"


def _convert_node(node, ins, ctx):
    """Returns the ONNX output name for `node` (appends NodeProto(s))."""
    g = ctx.graph
    op = node.op
    attrs = {k: v for k, v in node.attrs.items() if not k.startswith("_")}
    out = node.name

    def emit(op_type, inputs, outputs=None, **oattrs):
        n = g.node.add()
        n.op_type = op_type
        n.name = out
        n.input.extend(inputs)
        n.output.extend(outputs or [out])
        for k, v in oattrs.items():
            _attr(n, k, v)
        return (outputs or [out])[0]

    if op == "Convolution":
        spatial = 2
        kw = {"kernel_shape": _pair(attrs.get("kernel"), spatial),
              "strides": _pair(attrs.get("stride", 1), spatial),
              "dilations": _pair(attrs.get("dilate", 1), spatial),
              "group": int(attrs.get("num_group", 1))}
        pads = _pair(attrs.get("pad", 0), spatial)
        kw["pads"] = pads + pads
        return emit("Conv", ins, **kw)
    if op == "Deconvolution":
        spatial = 2
        kw = {"kernel_shape": _pair(attrs.get("kernel"), spatial),
              "strides": _pair(attrs.get("stride", 1), spatial),
              "group": int(attrs.get("num_group", 1))}
        pads = _pair(attrs.get("pad", 0), spatial)
        kw["pads"] = pads + pads
        return emit("ConvTranspose", ins, **kw)
    if op == "FullyConnected":
        no_bias = bool(attrs.get("no_bias", False)) or len(ins) < 3
        data = ins[0]
        if attrs.get("flatten", True):
            data = emit("Flatten", [ins[0]],
                        outputs=[ctx.fresh(out + "_flat")], axis=1)
        gemm_in = [data, ins[1]]
        if not no_bias:
            gemm_in.append(ins[2])
        else:
            zname = out + "_zero_bias"
            nh = int(attrs.get("num_hidden"))
            ctx.extra_init[zname] = _np.zeros(nh, _np.float32)
            gemm_in.append(zname)
        n = g.node.add()
        n.op_type = "Gemm"
        n.name = out
        n.input.extend(gemm_in)
        n.output.append(out)
        _attr(n, "transB", 1)
        return out
    if op == "Activation":
        act = attrs.get("act_type", "relu")
        if act not in _ACT:
            raise MXNetError(f"onnx export: Activation {act}")
        return emit(_ACT[act], ins)
    if op == "LeakyReLU":
        act = attrs.get("act_type", "leaky")
        if act == "leaky":
            return emit("LeakyRelu", ins,
                        alpha=float(attrs.get("slope", 0.25)))
        if act == "elu":
            return emit("Elu", ins, alpha=float(attrs.get("slope", 0.25)))
        if act == "prelu":
            return emit("PRelu", ins)
        raise MXNetError(f"onnx export: LeakyReLU {act}")
    if op == "BatchNorm":
        return emit("BatchNormalization", ins[:5],
                    epsilon=float(attrs.get("eps", 1e-5)),
                    momentum=float(attrs.get("momentum", 0.9)))
    if op == "Pooling":
        pt = attrs.get("pool_type", "max")
        if attrs.get("global_pool", False):
            return emit("GlobalMaxPool" if pt == "max"
                        else "GlobalAveragePool", ins)
        spatial = 2
        kw = {"kernel_shape": _pair(attrs.get("kernel"), spatial),
              "strides": _pair(attrs.get("stride", 1), spatial)}
        pads = _pair(attrs.get("pad", 0), spatial)
        kw["pads"] = pads + pads
        if pt == "avg":
            kw["count_include_pad"] = int(attrs.get("count_include_pad",
                                                    True))
        return emit("MaxPool" if pt == "max" else "AveragePool", ins,
                    **kw)
    if op == "Flatten":
        return emit("Flatten", ins, axis=1)
    if op == "Dropout":
        return emit("Dropout", ins, ratio=float(attrs.get("p", 0.5)))
    if op in ("softmax", "log_softmax"):
        ax = int(attrs.get("axis", -1))
        name = emit("Softmax", ins, axis=ax)
        if op == "log_softmax":
            return emit("Log", [name], outputs=[out + "_log"])
        return name
    if op == "Concat":
        return emit("Concat", ins,
                    axis=int(attrs.get("dim", attrs.get("axis", 1))))
    if op == "clip":
        return emit("Clip", ins[:1],
                    min=float(attrs.get("a_min",
                                        _scalar_value_or(node, 1, -3.4e38))),
                    max=float(attrs.get("a_max",
                                        _scalar_value_or(node, 2, 3.4e38))))
    if op == "Reshape":
        shape = attrs.get("shape")
        sname = out + "_shape"
        ctx.extra_init[sname] = _np.asarray(shape, _np.int64)
        return emit("Reshape", [ins[0], sname])
    if op == "Embedding":
        # ONNX Gather(weight, indices)
        return emit("Gather", [ins[1], ins[0]], axis=0)
    if op == "transpose":
        return emit("Transpose", ins,
                    perm=[int(v) for v in attrs.get("axes", ())])
    if op == "expand_dims":
        return emit("Unsqueeze", ins, axes=[int(attrs.get("axis", 0))])
    if op in _REDUCE:
        ax = attrs.get("axis")
        kw = {"keepdims": int(attrs.get("keepdims", False))}
        if ax is not None:
            kw["axes"] = [ax] if isinstance(ax, int) else list(ax)
        return emit(_REDUCE[op], ins, **kw)
    if op in _ELEM:
        return emit(_ELEM[op], ins[:2])
    if op in _UNARY:
        return emit(_UNARY[op], ins)
    raise MXNetError(
        f"onnx export: op '{op}' has no ONNX mapping (supported: conv "
        "family, FC, norm, pool, activations, elemwise, reduce, reshape)")


def _scalar_value_or(node, idx, default):
    if len(node.inputs) > idx:
        v = _scalar_value(node.inputs[idx])
        if v is not None:
            return v
    return default


def _numpy(v):
    """A parameter's values as a host numpy array (an NDArray, a tensor or
    an array)."""
    from ...ndarray.ndarray import NDArray

    if isinstance(v, NDArray):
        return v.asnumpy()
    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    return _np.asarray(v)


def get_model_proto(sym, params, input_shape, input_type="float32",
                    input_names=("data",)):
    """Build a ModelProto from a Symbol + param dict."""

    model = _pb.ModelProto()
    model.ir_version = 4
    model.producer_name = "mxnet_tpu"
    ops = model.opset_import.add()
    ops.domain = ""
    ops.version = _OPSET
    g = model.graph
    g.name = getattr(sym, "name", "mxnet_tpu_graph")

    params = {k.split(":", 1)[-1]: v for k, v in (params or {}).items()}
    raw = {k: _numpy(v) for k, v in params.items()}

    ctx = _Ctx(g, raw)
    topo = sym._topo()
    names = {}
    input_names = ([input_names] if isinstance(input_names, str)
                   else list(input_names))

    for node in topo:
        if node.op is None:
            if "__scalar__" in node.attrs or node.attrs.get("__null__"):
                names[id(node)] = None  # resolved by consumers
            else:
                names[id(node)] = node.name
            continue
        ins = []
        for i in node.inputs:
            nm = names[id(i)]
            ins.append(nm)
        ins = [i for i in ins if i is not None]
        names[id(node)] = _convert_node(node, ins, ctx)

    # graph inputs: data + every free variable not in params
    shapes = (input_shape if isinstance(input_shape, list)
              else [input_shape])
    for nm, shp in zip(input_names, shapes):
        vi = g.input.add()
        vi.name = nm
        vi.type.tensor_type.elem_type = _DT[input_type]
        for d in shp:
            vi.type.tensor_type.shape.dim.add().dim_value = int(d)
    for nm, arr in raw.items():
        g.initializer.append(_tensor(nm, arr))
        vi = g.input.add()
        vi.name = nm
        vi.type.tensor_type.elem_type = _DT.get(str(arr.dtype),
                                                _pb.TensorProto.FLOAT)
        for d in arr.shape:
            vi.type.tensor_type.shape.dim.add().dim_value = int(d)
    for nm, arr in ctx.extra_init.items():
        g.initializer.append(_tensor(nm, arr))
        vi = g.input.add()
        vi.name = nm
        vi.type.tensor_type.elem_type = _DT[str(arr.dtype)]
        for d in arr.shape:
            vi.type.tensor_type.shape.dim.add().dim_value = int(d)

    vo = g.output.add()
    vo.name = names[id(topo[-1])] if topo else ""
    vo.type.tensor_type.elem_type = _DT[input_type]
    return model


def export_model(sym, params, input_shape, input_type="float32",
                 onnx_file_path="model.onnx", verbose=False,
                 input_names=("data",)):
    """Reference signature: onnx_mxnet.export_model.  ``sym`` may be a
    Symbol or a path to a -symbol.json; ``params`` a dict or .params
    path (read to the host)."""
    from ... import symbol as _sym_mod
    from ...context import cpu
    from ...ndarray import load as nd_load

    if isinstance(sym, str):
        sym = _sym_mod.load(sym)
    if isinstance(params, str):
        params = nd_load(params, ctx=cpu())
    model = get_model_proto(sym, params, input_shape, input_type,
                            input_names)
    with open(onnx_file_path, "wb") as f:
        f.write(model.SerializeToString())
    return onnx_file_path
