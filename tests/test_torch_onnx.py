"""ONNX export and import in the PyTorch port against the JAX package.

The port writes and reads ONNX through its own pure-Python codec
(``contrib/onnx/onnx_minimal.py``), with no ``google.protobuf``.  Held
here: the codec's messages against the JAX package's generated protobuf
classes (field numbers, types, labels; edge values both ways); round trips
of the conv net and ``resnet18_v1`` through the port; the port's bytes
parsed by the JAX package's ``onnx_minimal_pb2`` into a message equal to
the one the JAX package writes for the same graph and parameters, and the
other way; a file the JAX package wrote, imported by the port, giving the
JAX outputs.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import nd as jnd
from mxnet_tpu.contrib import onnx as jonnx
from mxnet_tpu.contrib.onnx import onnx_minimal_pb2 as jpb

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch import initializer as tinit
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.contrib import onnx as tonnx
from mxnet_tpu_torch.contrib.onnx import onnx_minimal as tpb
from mxnet_tpu_torch.context import cpu
from torch_one_thread import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def _convnet(g):
    net = g.nn.HybridSequential()
    net.add(g.nn.Conv2D(8, 3, padding=1), g.nn.BatchNorm(),
            g.nn.Activation("relu"), g.nn.MaxPool2D(2), g.nn.Flatten(),
            g.nn.Dense(5))
    return net


def _resnet18(g):
    return g.model_zoo.vision.resnet18_v1(classes=10)


MODELS = {"convnet": (_convnet, (2, 3, 16, 16)),
          "resnet18": (_resnet18, (2, 3, 32, 32))}


def _draw(params, seed):
    """BatchNorm's statistics drawn, so predict mode is not the identity."""
    rs = np.random.RandomState(seed)
    for name, p in params.items():
        if name.endswith(("gamma", "running_var")):
            p.set_data(tnd.array(rs.uniform(0.5, 1.5, p.shape), ctx=cpu()))
        elif name.endswith(("beta", "running_mean")):
            p.set_data(tnd.array(rs.uniform(-0.2, 0.2, p.shape), ctx=cpu()))


def _port_net(name, seed):
    make, shape = MODELS[name]
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    with cpu():
        net = make(tgluon)
        net.initialize(init=tinit.Xavier(),
                       generator=torch.Generator().manual_seed(seed))
        net.hybridize()
        with torch.no_grad():
            net(tnd.array(x))
        _draw(net.collect_params(), seed)
        with torch.no_grad():
            ref = net(tnd.array(x)).asnumpy()
    return net, x, ref


@pytest.mark.parametrize("name", sorted(MODELS))
def test_port_round_trip(name, tmp_path):
    """export_model then import_model / import_to_gluon, all in the port:
    the imported graph runs the block's ops in its order, so the outputs
    are the block's bit for bit."""
    net, x, ref = _port_net(name, 1)
    sym = tmx.sym.trace_block(net)
    params = {n: p.data() for n, p in net.collect_params().items()}
    path = str(tmp_path / "m.onnx")
    assert tonnx.export_model(sym, params, [x.shape],
                              onnx_file_path=path) == path
    with cpu(), torch.no_grad():
        sym2, arg2, aux2 = tonnx.import_model(path)
        out = sym2.eval(data=tnd.array(x), **arg2, **aux2).asnumpy()
        sb = tonnx.import_to_gluon(path, ctx=cpu())
        got = sb(tnd.array(x)).asnumpy()
    assert sorted(sym2.list_auxiliary_states()) == sorted(aux2)
    assert all(k.endswith(("running_mean", "running_var")) for k in aux2)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(got, ref)


@pytest.fixture(scope="module")
def models():
    """Each model built once, in the port (its values drawn from a seed):
    its net, input, output, parameters (numpy) and its graph in both
    packages (the JAX one read from the port's JSON, so node names match)
    with the JAX package's ModelProto of it."""
    out = {}
    for name in MODELS:
        net, x, ref = _port_net(name, 2)
        tsym = tmx.sym.trace_block(net)
        jsym = mx.sym.fromjson(tsym.tojson())
        params = {n: p.data().asnumpy() for n, p in
                  net.collect_params().items()}
        proto = jonnx.get_model_proto(jsym, {k: jnd.array(v) for k, v in
                                             params.items()}, [x.shape])
        out[name] = (x, ref, tsym, jsym, params, proto)
    return out


@pytest.mark.parametrize("name", sorted(MODELS))
def test_messages_agree_both_ways(models, name):
    """The same graph and parameters: the port's bytes parse under the JAX
    package's pb2 into the JAX package's message, and the JAX bytes parse
    under the port's codec into the port's."""
    x, _ref, tsym, _jsym, params, jproto = models[name]
    with cpu():
        tproto = tonnx.get_model_proto(tsym, {k: tnd.array(v) for k, v in
                                              params.items()}, [x.shape])
    tbytes, jbytes = tproto.SerializeToString(), jproto.SerializeToString()
    assert jpb.ModelProto.FromString(tbytes) == jproto
    assert tpb.ModelProto.FromString(jbytes) == tproto
    assert tbytes == jbytes


@pytest.mark.parametrize("name", sorted(MODELS))
def test_jax_file_imported_by_port(models, name, tmp_path):
    """A file the JAX package wrote, imported by the port, gives the JAX
    package's outputs (its graph evaluated as one jitted program)."""
    x, _ref, _tsym, jsym, params, _proto = models[name]
    feed = {k: jnp.asarray(v) for k, v in params.items()}
    with mx.autograd.predict_mode():
        want = np.asarray(jax.jit(lambda p, d: jsym.eval_raw(data=d, **p))(
            feed, jnp.asarray(x)))
    path = str(tmp_path / "j.onnx")
    jonnx.export_model(jsym, {k: jnd.array(v) for k, v in params.items()},
                       [x.shape], onnx_file_path=path)
    with cpu(), torch.no_grad():
        got = tonnx.import_to_gluon(path, ctx=cpu())(tnd.array(x)).asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def _field_table(descriptor):
    return sorted((f.number, f.name, f.type, f.is_repeated)
                  for f in descriptor.fields)


_PB_TYPES = {"int64": 3, "uint64": 4, "int32": 5, "float": 2, "double": 1,
             "string": 9, "bytes": 12, "message": 11, "enum": 14}


def test_codec_fields_are_the_protos():
    """Every message of the port's codec has the JAX package's generated
    fields: number, name, wire type and repetition; the enums match."""
    for name, desc in jpb.DESCRIPTOR.message_types_by_name.items():
        for cls, d in [(getattr(tpb, name), desc)] + [
                (getattr(getattr(tpb, name), n.name), n)
                for n in desc.nested_types]:
            ours = sorted((n, f, _PB_TYPES[k], rep)
                          for n, f, k, rep, _m in cls.FIELDS)
            assert ours == _field_table(d), (name, d.name)
        for enum in desc.enum_types:
            for v in enum.values:
                assert getattr(getattr(tpb, name), v.name) == v.number


def test_codec_edge_values_both_ways():
    """Negative int64 and int32 values, floats rounded to f32, packed and
    empty repeated fields, nested messages and an unknown field."""
    t = tpb.TensorProto()
    t.name = "w"
    t.dims.extend([0, 3, 2 ** 40])
    t.data_type = tpb.TensorProto.FLOAT
    t.float_data.extend([0.1, -2.5, 3e38])
    t.int32_data.extend([-1, 2 ** 31 - 1, -2 ** 31])
    t.int64_data.extend([-(2 ** 63), 2 ** 63 - 1])
    t.double_data.append(0.1)
    t.uint64_data.append(2 ** 64 - 1)
    t.raw_data = b"\x00\xff"
    a = tpb.AttributeProto()
    a.name = "alpha"
    a.f = 0.1
    a.i = -7
    a.type = tpb.AttributeProto.FLOAT
    a.t.name = "inner"
    a.ints.extend([-1, 5])
    a.strings.append(b"s")
    data = t.SerializeToString()
    j = jpb.TensorProto.FromString(data)
    assert list(j.dims) == [0, 3, 2 ** 40]
    assert list(j.int32_data) == [-1, 2 ** 31 - 1, -2 ** 31]
    assert list(j.int64_data) == [-(2 ** 63), 2 ** 63 - 1]
    assert list(j.uint64_data) == [2 ** 64 - 1]
    assert tpb.TensorProto.FromString(j.SerializeToString()) == t
    ja = jpb.AttributeProto.FromString(a.SerializeToString())
    assert (ja.f, ja.i, ja.t.name, list(ja.ints)) == (a.f, -7, "inner",
                                                       [-1, 5])
    assert tpb.AttributeProto.FromString(ja.SerializeToString()) == a
    # an unknown field (number 3 is unused in TensorProto) is skipped
    extra = data + bytes([3 << 3 | 0, 42])
    assert tpb.TensorProto.FromString(extra) == t
    # unpacked repeated ints (a writer may emit either) parse the same
    dims = b"".join(bytes([1 << 3 | 0, v]) for v in (4, 5))
    assert list(tpb.TensorProto.FromString(dims).dims) == [4, 5]
    empty = tpb.ModelProto()
    assert empty.SerializeToString() == b""
    assert not empty.HasField("graph")


def test_codec_needs_no_protobuf():
    """No file of the port's ONNX package imports google.protobuf (nor
    onnx), lazily inside a function included; the package walk of
    ``test_torch_package.py`` holds the imported modules to the same."""
    import ast

    files = sorted((ROOT / "mxnet_tpu_torch" / "contrib" / "onnx")
                   .glob("*.py"))
    assert len(files) == 4
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                roots = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = {node.module.split(".")[0]}
            else:
                continue
            assert not roots & {"google", "onnx"}, (f, roots)
