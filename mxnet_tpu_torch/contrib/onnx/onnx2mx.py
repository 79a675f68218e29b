"""ONNX -> Symbol import.

Counterpart of ``mxnet_tpu/contrib/onnx/onnx2mx.py`` (reference:
python/mxnet/contrib/onnx/onnx2mx import_model): the inverse of
``mx2onnx`` for its op table, read through the port's own codec
(``onnx_minimal``), into the port's ``Symbol``.  BatchNorm's moving
statistics come back as auxiliary states.
"""

from __future__ import annotations

import numpy as _np

from ...base import MXNetError
from . import onnx_minimal as _pb

_NP_DT = {_pb.TensorProto.FLOAT: _np.float32,
          _pb.TensorProto.DOUBLE: _np.float64,
          _pb.TensorProto.FLOAT16: _np.float16,
          _pb.TensorProto.INT32: _np.int32,
          _pb.TensorProto.INT64: _np.int64,
          _pb.TensorProto.INT8: _np.int8,
          _pb.TensorProto.UINT8: _np.uint8,
          _pb.TensorProto.BOOL: _np.bool_}


def _tensor_to_np(t):
    dt = _NP_DT.get(t.data_type)
    if dt is None:
        raise MXNetError(f"onnx import: tensor dtype {t.data_type}")
    if t.raw_data:
        arr = _np.frombuffer(t.raw_data, dtype=dt).copy()
    elif t.float_data:
        arr = _np.asarray(list(t.float_data), dtype=dt)
    elif t.int64_data:
        arr = _np.asarray(list(t.int64_data), dtype=dt)
    elif t.int32_data:
        arr = _np.asarray(list(t.int32_data), dtype=dt)
    else:
        arr = _np.zeros(0, dt)
    return arr.reshape(tuple(t.dims))


def _attrs(node):
    out = {}
    for a in node.attribute:
        if a.type == _pb.AttributeProto.INT:
            out[a.name] = int(a.i)
        elif a.type == _pb.AttributeProto.FLOAT:
            out[a.name] = float(a.f)
        elif a.type == _pb.AttributeProto.STRING:
            out[a.name] = a.s.decode()
        elif a.type == _pb.AttributeProto.INTS:
            out[a.name] = [int(v) for v in a.ints]
        elif a.type == _pb.AttributeProto.FLOATS:
            out[a.name] = [float(v) for v in a.floats]
        elif a.type == _pb.AttributeProto.TENSOR:
            out[a.name] = _tensor_to_np(a.t)
    return out


def _depair(pads):
    """ONNX pads [b0,b1,e0,e1] -> symmetric mxnet pad (p0,p1)."""
    if not pads:
        return (0, 0)
    half = len(pads) // 2
    begin, end = pads[:half], pads[half:]
    if list(begin) != list(end):
        raise MXNetError(f"onnx import: asymmetric pads {pads}")
    return tuple(begin)


def import_model(model_file):
    """Load an .onnx file -> (sym, arg_params, aux_params) on
    ``current_context()``.  Reference: onnx_mxnet.import_model."""
    from ... import ndarray as _nd
    from ... import symbol as _sym_mod

    model = _pb.ModelProto()
    with open(model_file, "rb") as f:
        model.ParseFromString(f.read())
    g = model.graph

    inits = {t.name: _tensor_to_np(t) for t in g.initializer}
    arg_params, aux_params = {}, {}
    sym_of = {}

    graph_inputs = [vi.name for vi in g.input if vi.name not in inits]
    for nm in graph_inputs:
        sym_of[nm] = _sym_mod.var(nm)

    consumed_as_const = set()

    def sym_in(name):
        if name in sym_of:
            return sym_of[name]
        if name in inits:
            v = _sym_mod.var(name)
            sym_of[name] = v
            return v
        raise MXNetError(f"onnx import: undefined input {name}")

    for node in g.node:
        op = node.op_type
        a = _attrs(node)
        ins = list(node.input)
        out = node.output[0]

        def mk(mxop, inputs, **kw):
            return _sym_mod.apply_op(mxop, *inputs, name=out, **kw)

        if op == "Conv":
            s = mk("Convolution", [sym_in(i) for i in ins],
                   kernel=tuple(a.get("kernel_shape", ())),
                   stride=tuple(a.get("strides", (1, 1))),
                   dilate=tuple(a.get("dilations", (1, 1))),
                   pad=_depair(a.get("pads", ())),
                   num_group=a.get("group", 1),
                   num_filter=int(inits[ins[1]].shape[0])
                   if ins[1] in inits else 0,
                   no_bias=len(ins) < 3)
        elif op == "ConvTranspose":
            s = mk("Deconvolution", [sym_in(i) for i in ins],
                   kernel=tuple(a.get("kernel_shape", ())),
                   stride=tuple(a.get("strides", (1, 1))),
                   pad=_depair(a.get("pads", ())),
                   num_group=a.get("group", 1),
                   no_bias=len(ins) < 3)
        elif op == "Gemm":
            if a.get("transB", 0) != 1 or a.get("transA", 0) != 0:
                raise MXNetError("onnx import: Gemm needs transB=1")
            s = mk("FullyConnected", [sym_in(i) for i in ins],
                   num_hidden=int(inits[ins[1]].shape[0])
                   if ins[1] in inits else 0,
                   no_bias=len(ins) < 3, flatten=False)
        elif op == "BatchNormalization":
            s = mk("BatchNorm", [sym_in(i) for i in ins[:5]],
                   eps=a.get("epsilon", 1e-5),
                   momentum=a.get("momentum", 0.9), fix_gamma=False)
            for aux_nm in ins[3:5]:
                sym_of[aux_nm]._set_attr(__aux__=True)
                if aux_nm in inits:
                    aux_params[aux_nm] = _nd.array(inits[aux_nm])
                    consumed_as_const.add(aux_nm)
        elif op in ("MaxPool", "AveragePool"):
            s = mk("Pooling", [sym_in(ins[0])],
                   kernel=tuple(a.get("kernel_shape", ())),
                   stride=tuple(a.get("strides", (1, 1))),
                   pad=_depair(a.get("pads", ())),
                   pool_type="max" if op == "MaxPool" else "avg",
                   count_include_pad=bool(a.get("count_include_pad", 1)))
        elif op in ("GlobalMaxPool", "GlobalAveragePool"):
            s = mk("Pooling", [sym_in(ins[0])],
                   kernel=(1, 1), global_pool=True,
                   pool_type="max" if op == "GlobalMaxPool" else "avg")
        elif op == "Flatten":
            s = mk("Flatten", [sym_in(ins[0])])
        elif op == "Dropout":
            s = mk("Dropout", [sym_in(ins[0])], p=a.get("ratio", 0.5))
        elif op == "Softmax":
            s = mk("softmax", [sym_in(ins[0])], axis=a.get("axis", -1))
        elif op == "Concat":
            s = mk("Concat", [sym_in(i) for i in ins],
                   dim=a.get("axis", 1))
        elif op == "Clip":
            s = mk("clip", [sym_in(ins[0])],
                   a_min=a.get("min", -3.4e38), a_max=a.get("max", 3.4e38))
        elif op == "Reshape":
            shape = inits.get(ins[1])
            if shape is None:
                raise MXNetError("onnx import: dynamic Reshape shape")
            consumed_as_const.add(ins[1])
            s = mk("Reshape", [sym_in(ins[0])],
                   shape=tuple(int(v) for v in shape))
        elif op == "Gather":
            s = mk("Embedding", [sym_in(ins[1]), sym_in(ins[0])],
                   input_dim=int(inits[ins[0]].shape[0])
                   if ins[0] in inits else 0,
                   output_dim=int(inits[ins[0]].shape[1])
                   if ins[0] in inits else 0)
        elif op == "Transpose":
            s = mk("transpose", [sym_in(ins[0])],
                   axes=tuple(a.get("perm", ())))
        elif op == "Unsqueeze":
            s = mk("expand_dims", [sym_in(ins[0])],
                   axis=int(a.get("axes", [0])[0]))
        elif op in ("Relu", "Sigmoid", "Tanh", "Softplus", "Erf"):
            table = {"Relu": "relu", "Sigmoid": "sigmoid",
                     "Tanh": "tanh", "Softplus": "softrelu",
                     "Erf": "erf"}
            s = mk("Activation", [sym_in(ins[0])], act_type=table[op])
        elif op == "LeakyRelu":
            s = mk("LeakyReLU", [sym_in(ins[0])], act_type="leaky",
                   slope=a.get("alpha", 0.01))
        elif op == "Elu":
            s = mk("LeakyReLU", [sym_in(ins[0])], act_type="elu",
                   slope=a.get("alpha", 1.0))
        elif op in ("Add", "Sub", "Mul", "Div", "Pow"):
            table = {"Add": "broadcast_add", "Sub": "broadcast_sub",
                     "Mul": "broadcast_mul", "Div": "broadcast_div",
                     "Pow": "broadcast_power"}
            s = mk(table[op], [sym_in(i) for i in ins])
        elif op == "MatMul":
            s = mk("dot", [sym_in(i) for i in ins])
        elif op == "Log":
            s = mk("log", [sym_in(ins[0])])
        elif op == "Exp":
            s = mk("exp", [sym_in(ins[0])])
        elif op == "Identity":
            s = sym_in(ins[0])
        elif op in ("ReduceMean", "ReduceSum", "ReduceMax", "ReduceMin",
                    "ReduceProd"):
            table = {"ReduceMean": "mean", "ReduceSum": "sum",
                     "ReduceMax": "max", "ReduceMin": "min",
                     "ReduceProd": "prod"}
            ax = a.get("axes")
            s = mk(table[op], [sym_in(ins[0])],
                   axis=tuple(ax) if ax else None,
                   keepdims=bool(a.get("keepdims", 1)))
        else:
            raise MXNetError(f"onnx import: unsupported op {op}")
        sym_of[out] = s

    for nm, arr in inits.items():
        if nm in aux_params or nm in consumed_as_const:
            continue
        if nm in sym_of:  # actually referenced by the graph
            arg_params[nm] = _nd.array(arr)

    out_name = g.output[0].name
    return sym_of[out_name], arg_params, aux_params


def import_to_gluon(model_file, ctx=None):
    """Reference: onnx_mxnet.import_to_gluon: a SymbolBlock, its
    parameters on ``ctx`` (default ``current_context()``)."""
    from ...gluon.block import SymbolBlock
    from ... import symbol as _sym_mod

    sym, arg_params, aux_params = import_model(model_file)
    free = [n for n in sym.list_inputs()
            if n not in arg_params and n not in aux_params]
    sb = SymbolBlock(sym, [_sym_mod.var(n) for n in free])
    allp = {**arg_params, **aux_params}
    for name, p in sb.params.items():
        if name in allp:
            p._load_init(allp[name], ctx, cast_dtype=True)
    return sb
