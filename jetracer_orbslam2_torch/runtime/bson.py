"""Minimal BSON codec (documents of int32/int64/double/string/binary/bool).

Counterpart of `jetracer_orbslam2_tpu/runtime/bson.py`, a copy of it: for
the same document `encode` gives the same bytes.  Functional equivalent of
the reference's hand-rolled writer (reference src/WebSocket/bson.h:39-107,
bson.cpp:46-130 — int32/int64/double/string/binary-subtype-0x80 documents)
plus a decoder for the command path its UI used (jsoncons `decode_bson`,
src/WebSocket/WebSocketCom.cpp:53).  Standard library and numpy only.
"""

from __future__ import annotations

import struct
from typing import Any, Dict

import numpy as np

_T_DOUBLE = 0x01
_T_STRING = 0x02
_T_BINARY = 0x05
_T_BOOL = 0x08
_T_INT32 = 0x10
_T_INT64 = 0x12


def encode(doc: Dict[str, Any]) -> bytes:
    """Encode a flat dict.  bytes/bytearray/np.ndarray -> binary (generic
    subtype 0x00; the reference used vendor subtype 0x80, reader-compatible)."""
    body = bytearray()
    for key, val in doc.items():
        k = key.encode() + b"\x00"
        if isinstance(val, bool):
            body += bytes([_T_BOOL]) + k + (b"\x01" if val else b"\x00")
        elif isinstance(val, (int, np.integer)):
            v = int(val)
            if -(2 ** 31) <= v < 2 ** 31:
                body += bytes([_T_INT32]) + k + struct.pack("<i", v)
            else:
                body += bytes([_T_INT64]) + k + struct.pack("<q", v)
        elif isinstance(val, (float, np.floating)):
            body += bytes([_T_DOUBLE]) + k + struct.pack("<d", float(val))
        elif isinstance(val, str):
            s = val.encode()
            body += (bytes([_T_STRING]) + k
                     + struct.pack("<i", len(s) + 1) + s + b"\x00")
        elif isinstance(val, (bytes, bytearray, memoryview, np.ndarray)):
            b = (val.tobytes() if isinstance(val, np.ndarray)
                 else bytes(val))
            body += (bytes([_T_BINARY]) + k
                     + struct.pack("<i", len(b)) + b"\x00" + b)
        else:
            raise TypeError(f"BSON: unsupported type {type(val)} for {key}")
    total = len(body) + 5
    return struct.pack("<i", total) + bytes(body) + b"\x00"


def decode(data: bytes) -> Dict[str, Any]:
    (total,) = struct.unpack_from("<i", data, 0)
    off = 4
    out: Dict[str, Any] = {}
    while off < total - 1:
        t = data[off]
        off += 1
        end = data.index(b"\x00", off)
        key = data[off:end].decode()
        off = end + 1
        if t == _T_DOUBLE:
            (out[key],) = struct.unpack_from("<d", data, off)
            off += 8
        elif t == _T_STRING:
            (n,) = struct.unpack_from("<i", data, off)
            off += 4
            out[key] = data[off:off + n - 1].decode()
            off += n
        elif t == _T_BINARY:
            (n,) = struct.unpack_from("<i", data, off)
            off += 5  # length + subtype byte
            out[key] = data[off:off + n]
            off += n
        elif t == _T_BOOL:
            out[key] = data[off] != 0
            off += 1
        elif t == _T_INT32:
            (out[key],) = struct.unpack_from("<i", data, off)
            off += 4
        elif t == _T_INT64:
            (out[key],) = struct.unpack_from("<q", data, off)
            off += 8
        else:
            raise ValueError(f"BSON: unsupported element type 0x{t:02x}")
    return out
