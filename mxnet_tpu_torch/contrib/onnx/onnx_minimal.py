"""A pure-Python protobuf codec for the ONNX message subset.

The messages, field names and field numbers of ``onnx_minimal.proto``
(beside this file: a subset of the public ONNX schema, proto3), encoded
and decoded with no ``google.protobuf``: varints, fixed32/fixed64 and
length-delimited fields.  The API is the part of the generated protobuf
classes the ONNX converters use: attribute access with proto3 defaults,
``add()`` on repeated messages, ``append``/``extend`` on repeated scalars,
``SerializeToString``, ``ParseFromString`` and ``==``.

Encoding follows protobuf's own writer so the bytes parse, in any
protobuf reader, into an equal message: fields in field-number order,
proto3 scalars left out at their default, repeated numeric fields
packed, a sub-message written when it or anything under it was set.
The parser takes packed and unpacked repeated fields alike and skips
unknown fields.
"""

from __future__ import annotations

import struct

# wire types
_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5

_SCALAR_DEFAULTS = {"int64": 0, "int32": 0, "uint64": 0, "enum": 0,
                    "float": 0.0, "double": 0.0, "string": "",
                    "bytes": b""}
_NUMERIC = ("int64", "int32", "uint64", "enum", "float", "double")


def _varint(value):
    value &= (1 << 64) - 1          # negative ints: two's complement, 10 bytes
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _read_varint(buf, pos):
    result = shift = 0
    while True:
        byte = buf[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, pos
        shift += 7


def _signed(value, bits):
    value &= (1 << bits) - 1
    return value - (1 << bits) if value >> (bits - 1) else value


def _encode_scalar(kind, value):
    """(wire type, payload) of one scalar."""
    if kind in ("int64", "int32", "uint64", "enum"):
        return _VARINT, _varint(int(value))
    if kind == "float":
        return _I32, struct.pack("<f", value)
    if kind == "double":
        return _I64, struct.pack("<d", value)
    if kind == "string":
        data = value.encode("utf-8")
        return _LEN, _varint(len(data)) + data
    data = bytes(value)
    return _LEN, _varint(len(data)) + data


def _decode_scalar(kind, wire, buf, pos):
    """(value, new pos) of one scalar of wire type ``wire``."""
    if wire == _VARINT:
        raw, pos = _read_varint(buf, pos)
        if kind in ("int64", "enum"):
            return _signed(raw, 64), pos
        if kind == "int32":
            return _signed(raw, 32), pos
        return raw, pos
    if wire == _I32:
        return struct.unpack_from("<f", buf, pos)[0], pos + 4
    if wire == _I64:
        return struct.unpack_from("<d", buf, pos)[0], pos + 8
    n, pos = _read_varint(buf, pos)
    data = bytes(buf[pos:pos + n])
    return (data.decode("utf-8") if kind == "string" else data), pos + n


def _coerce(kind, value):
    """A scalar as the field stores it: a float rounded to f32."""
    if kind == "float":
        return struct.unpack("<f", struct.pack("<f", float(value)))[0]
    if kind == "double":
        return float(value)
    if kind in ("int64", "int32", "uint64", "enum"):
        return int(value)
    if kind == "bytes":
        return bytes(value)
    return value


def _skip(wire, buf, pos):
    if wire == _VARINT:
        return _read_varint(buf, pos)[1]
    if wire == _I64:
        return pos + 8
    if wire == _I32:
        return pos + 4
    if wire == _LEN:
        n, pos = _read_varint(buf, pos)
        return pos + n
    raise ValueError(f"unsupported wire type {wire}")


class _Repeated(list):
    """A repeated field: a list that marks its message set when it grows."""

    def __init__(self, owner, kind, msg_cls):
        super().__init__()
        self._owner, self._kind, self._msg_cls = owner, kind, msg_cls

    def add(self):
        msg = self._msg_cls(_parent=self._owner)
        super().append(msg)
        self._owner._mark()
        return msg

    def append(self, v):
        super().append(_coerce(self._kind, v))
        self._owner._mark()

    def extend(self, vs):
        vs = [_coerce(self._kind, v) for v in vs]
        super().extend(vs)
        if vs:
            self._owner._mark()


class Message:
    """Base of the generated-style message classes: ``FIELDS`` is a tuple
    of (number, name, kind, repeated, message class name)."""

    FIELDS: tuple = ()

    def __init__(self, _parent=None):
        object.__setattr__(self, "_parent", _parent)
        object.__setattr__(self, "_present", False)
        object.__setattr__(self, "_values", {})

    @classmethod
    def _spec(cls):
        spec = cls.__dict__.get("_SPEC")
        if spec is None:
            spec = {f[1]: f for f in cls.FIELDS}
            cls._SPEC = spec
            cls._BY_NUMBER = {f[0]: f for f in cls.FIELDS}
        return spec

    def _mark(self):
        node = self
        while node is not None and not node._present:
            object.__setattr__(node, "_present", True)
            node = node._parent

    def _field(self, name):
        spec = self._spec().get(name)
        if spec is None:
            raise AttributeError(f"{type(self).__name__} has no field {name}")
        return spec

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        number, _, kind, repeated, msg = self._field(name)
        values = self._values
        if name not in values:
            if repeated:
                values[name] = _Repeated(self, kind, _MESSAGES.get(msg))
            elif kind == "message":
                values[name] = _MESSAGES[msg](_parent=self)
            else:
                return _SCALAR_DEFAULTS[kind]
        return values[name]

    def __setattr__(self, name, value):
        number, _, kind, repeated, msg = self._field(name)
        if repeated or kind == "message":
            raise AttributeError(f"assignment to composite field {name}")
        self._values[name] = _coerce(kind, value)
        self._mark()

    def HasField(self, name):
        value = self._values.get(name)
        return value is not None and getattr(value, "_present", True)

    # -- encoding --------------------------------------------------------------

    def SerializeToString(self):
        out = bytearray()
        for number, name, kind, repeated, _msg in sorted(self.FIELDS):
            value = self._values.get(name)
            if value is None:
                continue
            if kind == "message":
                items = value if repeated else (
                    [value] if value._present else [])
                for item in items:
                    data = item.SerializeToString()
                    out += _varint(number << 3 | _LEN)
                    out += _varint(len(data)) + data
            elif repeated and kind in _NUMERIC:
                if not value:
                    continue
                payload = b"".join(_encode_scalar(kind, v)[1] for v in value)
                out += _varint(number << 3 | _LEN)
                out += _varint(len(payload)) + payload
            elif repeated:
                for v in value:
                    wire, payload = _encode_scalar(kind, v)
                    out += _varint(number << 3 | wire) + payload
            elif value != _SCALAR_DEFAULTS[kind] or (
                    kind in ("float", "double") and
                    struct.pack("<d", value) != struct.pack("<d", 0.0)):
                wire, payload = _encode_scalar(kind, value)
                out += _varint(number << 3 | wire) + payload
        return bytes(out)

    def ParseFromString(self, data):
        object.__setattr__(self, "_values", {})
        self._parse(memoryview(data), 0, len(data))
        return len(data)

    @classmethod
    def FromString(cls, data):
        msg = cls()
        msg.ParseFromString(data)
        return msg

    def _parse(self, buf, pos, end):
        self._spec()
        by_number = type(self)._BY_NUMBER
        while pos < end:
            key, pos = _read_varint(buf, pos)
            number, wire = key >> 3, key & 7
            spec = by_number.get(number)
            if spec is None:
                pos = _skip(wire, buf, pos)
                continue
            _, name, kind, repeated, msg = spec
            if kind == "message":
                n, pos = _read_varint(buf, pos)
                if repeated:
                    child = getattr(self, name).add()
                else:
                    child = getattr(self, name)
                    child._mark()
                child._parse(buf, pos, pos + n)
                pos += n
            elif repeated and kind in _NUMERIC and wire == _LEN:
                n, pos = _read_varint(buf, pos)
                stop, field = pos + n, getattr(self, name)
                while pos < stop:
                    value, pos = _decode_scalar(kind, _packed_wire(kind),
                                                buf, pos)
                    field.append(value)
            else:
                value, pos = _decode_scalar(kind, wire, buf, pos)
                if repeated:
                    getattr(self, name).append(value)
                else:
                    setattr(self, name, value)
        self._mark()

    # -- comparison ------------------------------------------------------------

    def _listed(self):
        out = {}
        for _n, name, kind, repeated, _m in self.FIELDS:
            value = self._values.get(name)
            if value is None:
                continue
            if repeated:
                if value:
                    out[name] = list(value)
            elif kind == "message":
                if value._present:
                    out[name] = value
            elif value != _SCALAR_DEFAULTS[kind]:
                out[name] = value
        return out

    def __eq__(self, other):
        if type(other) is not type(self):
            return NotImplemented
        return self._listed() == other._listed()

    def __repr__(self):
        return f"{type(self).__name__}({self._listed()})"


def _packed_wire(kind):
    if kind == "float":
        return _I32
    if kind == "double":
        return _I64
    return _VARINT


def _message(name, fields, **consts):
    cls = type(name, (Message,), {"FIELDS": tuple(fields), **consts})
    _MESSAGES[name] = cls
    return cls


_MESSAGES: dict = {}

_ATTRIBUTE_TYPES = dict(UNDEFINED=0, FLOAT=1, INT=2, STRING=3, TENSOR=4,
                        GRAPH=5, FLOATS=6, INTS=7, STRINGS=8, TENSORS=9,
                        GRAPHS=10)
_DATA_TYPES = dict(UNDEFINED=0, FLOAT=1, UINT8=2, INT8=3, UINT16=4, INT16=5,
                   INT32=6, INT64=7, STRING=8, BOOL=9, FLOAT16=10, DOUBLE=11,
                   UINT32=12, UINT64=13, COMPLEX64=14, COMPLEX128=15,
                   BFLOAT16=16)

AttributeProto = _message("AttributeProto", [
    (1, "name", "string", False, None),
    (2, "f", "float", False, None),
    (3, "i", "int64", False, None),
    (4, "s", "bytes", False, None),
    (5, "t", "message", False, "TensorProto"),
    (6, "g", "message", False, "GraphProto"),
    (7, "floats", "float", True, None),
    (8, "ints", "int64", True, None),
    (9, "strings", "bytes", True, None),
    (10, "tensors", "message", True, "TensorProto"),
    (11, "graphs", "message", True, "GraphProto"),
    (20, "type", "enum", False, None),
], **_ATTRIBUTE_TYPES)

ValueInfoProto = _message("ValueInfoProto", [
    (1, "name", "string", False, None),
    (2, "type", "message", False, "TypeProto"),
    (3, "doc_string", "string", False, None),
])

NodeProto = _message("NodeProto", [
    (1, "input", "string", True, None),
    (2, "output", "string", True, None),
    (3, "name", "string", False, None),
    (4, "op_type", "string", False, None),
    (5, "attribute", "message", True, "AttributeProto"),
    (6, "doc_string", "string", False, None),
    (7, "domain", "string", False, None),
])

ModelProto = _message("ModelProto", [
    (1, "ir_version", "int64", False, None),
    (2, "producer_name", "string", False, None),
    (3, "producer_version", "string", False, None),
    (4, "domain", "string", False, None),
    (5, "model_version", "int64", False, None),
    (6, "doc_string", "string", False, None),
    (7, "graph", "message", False, "GraphProto"),
    (8, "opset_import", "message", True, "OperatorSetIdProto"),
])

GraphProto = _message("GraphProto", [
    (1, "node", "message", True, "NodeProto"),
    (2, "name", "string", False, None),
    (5, "initializer", "message", True, "TensorProto"),
    (10, "doc_string", "string", False, None),
    (11, "input", "message", True, "ValueInfoProto"),
    (12, "output", "message", True, "ValueInfoProto"),
    (13, "value_info", "message", True, "ValueInfoProto"),
])

TensorProto = _message("TensorProto", [
    (1, "dims", "int64", True, None),
    (2, "data_type", "int32", False, None),
    (4, "float_data", "float", True, None),
    (5, "int32_data", "int32", True, None),
    (6, "string_data", "bytes", True, None),
    (7, "int64_data", "int64", True, None),
    (8, "name", "string", False, None),
    (9, "raw_data", "bytes", False, None),
    (10, "double_data", "double", True, None),
    (11, "uint64_data", "uint64", True, None),
], **_DATA_TYPES)

Dimension = _message("TensorShapeProto.Dimension", [
    (1, "dim_value", "int64", False, None),
    (2, "dim_param", "string", False, None),
])

TensorShapeProto = _message("TensorShapeProto", [
    (1, "dim", "message", True, "TensorShapeProto.Dimension"),
], Dimension=Dimension)

TypeProtoTensor = _message("TypeProto.Tensor", [
    (1, "elem_type", "int32", False, None),
    (2, "shape", "message", False, "TensorShapeProto"),
])

TypeProto = _message("TypeProto", [
    (1, "tensor_type", "message", False, "TypeProto.Tensor"),
], Tensor=TypeProtoTensor)

OperatorSetIdProto = _message("OperatorSetIdProto", [
    (1, "domain", "string", False, None),
    (2, "version", "int64", False, None),
])
