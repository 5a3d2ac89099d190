"""Minimal protobuf wire-format encode/decode.

The YT8M dataset is TFRecord files of `tf.train.SequenceExample` /
`tf.train.Example` protos (parsed by the reference via
`tf.parse_single_sequence_example`, readers.py:193-201). The rebuild
parses the public wire format directly — no TensorFlow, no generated
code. Only the pieces those two messages need are implemented:

  varint, 64-bit, length-delimited fields; packed repeated scalars;
  nested messages; map fields (= repeated MapEntry{key=1, value=2}).

Message shapes (public tensorflow/core/example/{example,feature}.proto):

  Example         { Features features = 1; }
  SequenceExample { Features context = 1; FeatureLists feature_lists = 2; }
  Features        { map<string, Feature> feature = 1; }
  Feature         { oneof kind { BytesList bytes_list = 1;
                                 FloatList float_list = 2;
                                 Int64List int64_list = 3; } }
  BytesList       { repeated bytes value = 1; }
  FloatList       { repeated float value = 1 [packed]; }
  Int64List       { repeated int64 value = 1 [packed]; }
  FeatureLists    { map<string, FeatureList> feature_list = 1; }
  FeatureList     { repeated Feature feature = 1; }
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple, Union

# ---------------------------------------------------------------------------
# wire primitives
# ---------------------------------------------------------------------------

_WIRE_VARINT = 0
_WIRE_64BIT = 1
_WIRE_LEN = 2
_WIRE_32BIT = 5


def read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def write_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _skip_field(buf: bytes, pos: int, wire_type: int) -> int:
    if wire_type == _WIRE_VARINT:
        _, pos = read_varint(buf, pos)
        return pos
    if wire_type == _WIRE_64BIT:
        return pos + 8
    if wire_type == _WIRE_LEN:
        n, pos = read_varint(buf, pos)
        return pos + n
    if wire_type == _WIRE_32BIT:
        return pos + 4
    raise ValueError(f"unsupported wire type {wire_type}")


def iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a serialized message.
    LEN fields yield memoryview payloads; scalars yield ints."""
    pos = 0
    n = len(buf)
    view = memoryview(buf)
    while pos < n:
        tag, pos = read_varint(buf, pos)
        field_num = tag >> 3
        wire_type = tag & 7
        if wire_type == _WIRE_VARINT:
            val, pos = read_varint(buf, pos)
            yield field_num, wire_type, val
        elif wire_type == _WIRE_LEN:
            ln, pos = read_varint(buf, pos)
            yield field_num, wire_type, view[pos : pos + ln]
            pos += ln
        elif wire_type == _WIRE_64BIT:
            yield field_num, wire_type, view[pos : pos + 8]
            pos += 8
        elif wire_type == _WIRE_32BIT:
            yield field_num, wire_type, view[pos : pos + 4]
            pos += 4
        else:
            pos = _skip_field(buf, pos, wire_type)


# ---------------------------------------------------------------------------
# Feature / Features / FeatureLists decode
# ---------------------------------------------------------------------------

FeatureValue = Union[List[bytes], List[float], List[int]]


def decode_feature(buf) -> Tuple[str, FeatureValue]:
    """Returns (kind, values) with kind in {bytes, float, int64}.

    Proto MERGE semantics, like a real protobuf parser: repeated
    occurrences of the same list field on one Feature concatenate (a
    legal wire encoding some streaming writers produce — returning on
    the first occurrence would silently truncate the values), and for
    the `kind` oneof the LAST field present wins."""
    kind: str = "bytes"
    values: FeatureValue = []
    seen = 0
    for field_num, wire_type, val in iter_fields(bytes(buf)):
        if field_num == 1:  # BytesList
            decoded = [
                bytes(v) for fn, _, v in iter_fields(bytes(val)) if fn == 1
            ]
            new_kind = "bytes"
        elif field_num == 2:  # FloatList (packed or not)
            floats: List[float] = []
            for fn, wt, v in iter_fields(bytes(val)):
                if fn != 1:
                    continue
                if wt == _WIRE_LEN:  # packed
                    raw = bytes(v)
                    floats.extend(struct.unpack(f"<{len(raw)//4}f", raw))
                elif wt == _WIRE_32BIT:
                    floats.append(struct.unpack("<f", bytes(v))[0])
            decoded, new_kind = floats, "float"
        elif field_num == 3:  # Int64List (packed or not)
            ints: List[int] = []
            for fn, wt, v in iter_fields(bytes(val)):
                if fn != 1:
                    continue
                if wt == _WIRE_LEN:  # packed varints
                    raw = bytes(v)
                    p = 0
                    while p < len(raw):
                        x, p = read_varint(raw, p)
                        ints.append(_to_signed64(x))
                elif wt == _WIRE_VARINT:
                    ints.append(_to_signed64(v))
            decoded, new_kind = ints, "int64"
        else:
            continue
        if seen and new_kind == kind:
            values.extend(decoded)  # same oneof member split into chunks
        else:
            kind, values = new_kind, decoded  # oneof: last one wins
        seen += 1
    return kind, values


def _to_signed64(x: int) -> int:
    return x - (1 << 64) if x >= (1 << 63) else x


def decode_features_map(buf) -> Dict[str, Tuple[str, FeatureValue]]:
    """Features message: map<string, Feature>."""
    out: Dict[str, Tuple[str, FeatureValue]] = {}
    for field_num, _, entry in iter_fields(bytes(buf)):
        if field_num != 1:
            continue
        key, feat = None, ("bytes", [])
        for fn, _, v in iter_fields(bytes(entry)):
            if fn == 1:
                key = bytes(v).decode("utf-8")
            elif fn == 2:
                feat = decode_feature(v)
        if key is not None:
            out[key] = feat
    return out


def decode_feature_lists(buf) -> Dict[str, List[Tuple[str, FeatureValue]]]:
    """FeatureLists message: map<string, FeatureList>."""
    out: Dict[str, List[Tuple[str, FeatureValue]]] = {}
    for field_num, _, entry in iter_fields(bytes(buf)):
        if field_num != 1:
            continue
        key = None
        feats: List[Tuple[str, FeatureValue]] = []
        for fn, _, v in iter_fields(bytes(entry)):
            if fn == 1:
                key = bytes(v).decode("utf-8")
            elif fn == 2:  # FeatureList
                feats = [
                    decode_feature(fv)
                    for ffn, _, fv in iter_fields(bytes(v))
                    if ffn == 1
                ]
        if key is not None:
            out[key] = feats
    return out


def decode_sequence_example(buf: bytes):
    """Returns (context: features map, feature_lists: map)."""
    context: Dict = {}
    feature_lists: Dict = {}
    for field_num, _, val in iter_fields(buf):
        if field_num == 1:
            context = decode_features_map(val)
        elif field_num == 2:
            feature_lists = decode_feature_lists(val)
    return context, feature_lists


def decode_example(buf: bytes) -> Dict[str, Tuple[str, FeatureValue]]:
    for field_num, _, val in iter_fields(buf):
        if field_num == 1:
            return decode_features_map(val)
    return {}


# ---------------------------------------------------------------------------
# encode (for fixtures / synthetic datasets)
# ---------------------------------------------------------------------------


def _tag(field_num: int, wire_type: int) -> bytes:
    return write_varint((field_num << 3) | wire_type)


def _len_field(field_num: int, payload: bytes) -> bytes:
    return _tag(field_num, _WIRE_LEN) + write_varint(len(payload)) + payload


def encode_feature(kind: str, values) -> bytes:
    if kind == "bytes":
        inner = b"".join(_len_field(1, v) for v in values)
        return _len_field(1, inner)
    if kind == "float":
        packed = struct.pack(f"<{len(values)}f", *values)
        return _len_field(2, _len_field(1, packed))
    if kind == "int64":
        packed = b"".join(write_varint(v & ((1 << 64) - 1)) for v in values)
        return _len_field(3, _len_field(1, packed))
    raise ValueError(kind)


def encode_features_map(features: Dict[str, Tuple[str, FeatureValue]]) -> bytes:
    out = bytearray()
    for key, (kind, values) in features.items():
        entry = _len_field(1, key.encode("utf-8")) + _len_field(
            2, encode_feature(kind, values)
        )
        out += _len_field(1, entry)
    return bytes(out)


def encode_sequence_example(
    context: Dict[str, Tuple[str, FeatureValue]],
    feature_lists: Dict[str, List[Tuple[str, FeatureValue]]],
) -> bytes:
    out = _len_field(1, encode_features_map(context))
    fl = bytearray()
    for key, feats in feature_lists.items():
        inner = b"".join(_len_field(1, encode_feature(k, v)) for k, v in feats)
        entry = _len_field(1, key.encode("utf-8")) + _len_field(2, inner)
        fl += _len_field(1, entry)
    out += _len_field(2, bytes(fl))
    return out


def encode_example(features: Dict[str, Tuple[str, FeatureValue]]) -> bytes:
    return _len_field(1, encode_features_map(features))
