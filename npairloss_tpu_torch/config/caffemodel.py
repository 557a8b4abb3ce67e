"""Binary ``.caffemodel`` / ``.solverstate`` reader and writer — the port's
own copy of ``npairloss_tpu/config/caffemodel.py`` (numpy and the wire
format only, no protobuf runtime), which must read and write the same
bytes.

A reference user's primary asset is a trained ``.caffemodel``: a
binary-protobuf ``NetParameter`` holding per-layer weight blobs.  The
supported schema subset (field numbers from the public caffe.proto):

    NetParameter:    name=1 (string), layer=100 (LayerParameter,
                     repeated), layers=2 (V1LayerParameter, repeated)
    LayerParameter:  name=1 (string), type=2 (string),
                     blobs=7 (BlobProto, repeated)
    V1LayerParameter:name=4 (string), blobs=6 (BlobProto, repeated)
    BlobProto:       num/channels/height/width=1..4 (old 4-D shape),
                     data=5 (repeated float, packed or unpacked),
                     shape=7 (BlobShape), double_data=9
    BlobShape:       dim=1 (repeated int64, packed or unpacked)
    SolverState:     iter=1, learned_net=2, history=3 (BlobProto,
                     repeated), current_step=4

Unknown fields are skipped (a full caffemodel carries layer params,
phase rules, etc. — irrelevant for weight migration).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

_WIRE_VARINT = 0
_WIRE_I64 = 1
_WIRE_LEN = 2
_WIRE_I32 = 5


# -- wire primitives --------------------------------------------------------


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def _write_varint(out: bytearray, value: int) -> None:
    if value < 0:
        raise ValueError("negative varint unsupported")
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _skip(buf: memoryview, pos: int, wire: int) -> int:
    if wire == _WIRE_VARINT:
        _, pos = _read_varint(buf, pos)
        return pos
    if wire == _WIRE_I64:
        return pos + 8
    if wire == _WIRE_LEN:
        n, pos = _read_varint(buf, pos)
        return pos + n
    if wire == _WIRE_I32:
        return pos + 4
    raise ValueError(f"unsupported wire type {wire}")


def _fields(buf: memoryview):
    """Yield (field_number, wire_type, value) over a message buffer.

    value is an int for varint fields, a memoryview for LEN fields, and
    raw 4/8-byte memoryviews for fixed-width fields.
    """
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == _WIRE_VARINT:
            v, pos = _read_varint(buf, pos)
            yield field, wire, v
        elif wire == _WIRE_LEN:
            n, pos = _read_varint(buf, pos)
            yield field, wire, buf[pos:pos + n]
            pos += n
        elif wire == _WIRE_I32:
            yield field, wire, buf[pos:pos + 4]
            pos += 4
        elif wire == _WIRE_I64:
            yield field, wire, buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire} (field {field})")


# -- BlobProto --------------------------------------------------------------


def _parse_blob(buf: memoryview) -> np.ndarray:
    shape: List[int] = []
    old_shape = {}
    floats: List[np.ndarray] = []
    doubles: List[np.ndarray] = []
    for field, wire, val in _fields(buf):
        if field == 7 and wire == _WIRE_LEN:  # BlobShape
            for f2, w2, v2 in _fields(val):
                if f2 == 1 and w2 == _WIRE_LEN:  # packed int64 dims
                    p = 0
                    while p < len(v2):
                        d, p = _read_varint(v2, p)
                        shape.append(d)
                elif f2 == 1 and w2 == _WIRE_VARINT:  # unpacked dim
                    shape.append(v2)
        elif field == 5:  # float data
            if wire == _WIRE_LEN:  # packed
                floats.append(np.frombuffer(bytes(val), dtype="<f4"))
            elif wire == _WIRE_I32:  # unpacked
                floats.append(np.frombuffer(bytes(val), dtype="<f4"))
        elif field == 9:  # double data
            if wire == _WIRE_LEN:
                doubles.append(np.frombuffer(bytes(val), dtype="<f8"))
            elif wire == _WIRE_I64:
                doubles.append(np.frombuffer(bytes(val), dtype="<f8"))
        elif field in (1, 2, 3, 4) and wire == _WIRE_VARINT:
            old_shape[field] = val
    if doubles:
        data = np.concatenate(doubles).astype(np.float32)
    elif floats:
        data = np.concatenate(floats)
    else:
        data = np.zeros((0,), np.float32)
    if not shape and old_shape:
        shape = [old_shape.get(k, 1) for k in (1, 2, 3, 4)]
    if shape:
        data = data.reshape(shape)
    return data


def _write_blob(arr: np.ndarray) -> bytes:
    out = bytearray()
    # shape = 7 (BlobShape with packed dims)
    dims = bytearray()
    for d in arr.shape:
        _write_varint(dims, int(d))
    inner = bytearray()
    _write_varint(inner, (1 << 3) | _WIRE_LEN)
    _write_varint(inner, len(dims))
    inner += dims
    _write_varint(out, (7 << 3) | _WIRE_LEN)
    _write_varint(out, len(inner))
    out += inner
    # data = 5 (packed floats)
    payload = np.ascontiguousarray(arr, dtype="<f4").tobytes()
    _write_varint(out, (5 << 3) | _WIRE_LEN)
    _write_varint(out, len(payload))
    out += payload
    return bytes(out)


# -- NetParameter -----------------------------------------------------------


def parse_caffemodel(data: bytes) -> Dict[str, List[np.ndarray]]:
    """{layer_name: [blob arrays]} from .caffemodel bytes.

    Reads both the modern ``layer`` (field 100) and legacy ``layers``
    (field 2, V1LayerParameter) encodings; layers without blobs (data,
    loss, pooling...) are omitted.
    """
    buf = memoryview(data)
    out: Dict[str, List[np.ndarray]] = {}
    for field, wire, val in _fields(buf):
        if wire != _WIRE_LEN or field not in (2, 100):
            continue
        name_field = 1 if field == 100 else 4
        blob_field = 7 if field == 100 else 6
        name = None
        blobs: List[np.ndarray] = []
        for f2, w2, v2 in _fields(val):
            if f2 == name_field and w2 == _WIRE_LEN:
                name = bytes(v2).decode("utf-8")
            elif f2 == blob_field and w2 == _WIRE_LEN:
                blobs.append(_parse_blob(v2))
        if name and blobs:
            out[name] = blobs
    return out


def parse_solverstate(data: bytes) -> Dict[str, object]:
    """Decode ``.solverstate`` bytes (Caffe's optimizer snapshot — the
    file ``caffe train --snapshot`` resumes from; the reference's solver
    writes one next to each .caffemodel, solver.prototxt:15-16).

    SolverState wire layout (public Caffe proto): ``iter``=1 (varint),
    ``learned_net``=2 (string path of the paired .caffemodel),
    ``history``=3 (repeated BlobProto — SGD momentum, one blob per
    learnable parameter in net order), ``current_step``=4 (varint).
    Returns {"iter", "learned_net", "history": [np.ndarray],
    "current_step"}.
    """
    buf = memoryview(data)
    out: Dict[str, object] = {
        "iter": 0, "learned_net": "", "history": [], "current_step": 0,
    }
    for field, wire, val in _fields(buf):
        if field == 1 and wire == _WIRE_VARINT:
            out["iter"] = int(val)
        elif field == 2 and wire == _WIRE_LEN:
            out["learned_net"] = bytes(val).decode("utf-8")
        elif field == 3 and wire == _WIRE_LEN:
            out["history"].append(_parse_blob(val))
        elif field == 4 and wire == _WIRE_VARINT:
            out["current_step"] = int(val)
    return out


def write_solverstate(
    iteration: int,
    history: List[np.ndarray],
    current_step: int = 0,
    learned_net: str = "",
) -> bytes:
    """Serialize optimizer state as ``.solverstate`` bytes — the inverse
    of :func:`parse_solverstate`, so a run trained here can be resumed
    by a Caffe stack (and for round-trip tests)."""
    out = bytearray()
    _write_varint(out, (1 << 3) | _WIRE_VARINT)
    _write_varint(out, int(iteration))
    if learned_net:
        nm = learned_net.encode("utf-8")
        _write_varint(out, (2 << 3) | _WIRE_LEN)
        _write_varint(out, len(nm))
        out += nm
    for arr in history:
        payload = _write_blob(np.asarray(arr))
        _write_varint(out, (3 << 3) | _WIRE_LEN)
        _write_varint(out, len(payload))
        out += payload
    _write_varint(out, (4 << 3) | _WIRE_VARINT)
    _write_varint(out, int(current_step))
    return bytes(out)


def write_caffemodel(
    layers: Dict[str, List[np.ndarray]], net_name: str = "npairloss_tpu"
) -> bytes:
    """Serialize {layer_name: [blobs]} as modern-layer caffemodel bytes.

    The inverse of :func:`parse_caffemodel` — used by the export tool
    (deploy a trunk trained here back into a Caffe stack) and by the
    round-trip tests.
    """
    out = bytearray()
    nm = net_name.encode("utf-8")
    _write_varint(out, (1 << 3) | _WIRE_LEN)
    _write_varint(out, len(nm))
    out += nm
    for name, blobs in layers.items():
        layer = bytearray()
        nb = name.encode("utf-8")
        _write_varint(layer, (1 << 3) | _WIRE_LEN)
        _write_varint(layer, len(nb))
        layer += nb
        for arr in blobs:
            payload = _write_blob(np.asarray(arr))
            _write_varint(layer, (7 << 3) | _WIRE_LEN)
            _write_varint(layer, len(payload))
            layer += payload
        _write_varint(out, (100 << 3) | _WIRE_LEN)
        _write_varint(out, len(layer))
        out += layer
    return bytes(out)
