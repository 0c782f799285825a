"""The fabric's message envelope and pickle-free wire codec (the port's
twin of ``repro.fabric.envelope``: the same ``WIRE_VERSION``, framing,
CRC and type tags, so a frame either package encodes decodes in the
other to the same values).

Every hop in the fabric — loopback or socket, client or worker — speaks
one message shape: an :class:`Envelope` with a ``kind``, a
per-connection ``msg_id`` (replies echo it; that is the whole RPC
correlation story), an optional ``trace`` context tuple (cross-process
span propagation: the receiving side parents its spans under it), and a
``payload`` dict of plain values.

The codec is deliberately NOT pickle: a shard worker should only ever be
able to receive data, not code.  It round-trips exactly the types the
protocol needs — None, bool, int, float, str, bytes, list, tuple, dict,
and C-contiguous numpy arrays (dtype + shape + raw bytes) — and raises
on anything else, so an unserializable payload fails at the sender with
a type name instead of at the receiver with a parse error.  A torch
tensor is refused with :class:`WireError`: callers convert explicitly
(``.cpu().numpy()``), so a device tensor never travels by accident and
no hidden device-to-host copy hides in the codec.  Frames are
length-prefixed and CRC-guarded: a corrupted frame surfaces as
:class:`WireError`, never as silently wrong bits.

Queries cross the wire as structured trees (:func:`query_to_wire` /
:func:`query_from_wire`): ``repro_torch.engine.planner`` predicates and
``repro_torch.db.expr`` expressions both lower to tagged lists (the
reference's tags), so the shard
side rebuilds the exact expression object and its plan cache behaves as
if the query had been submitted locally.
"""
from __future__ import annotations

import dataclasses
import struct
import sys
import zlib

import numpy as np

__all__ = ["Envelope", "WireError", "encode", "decode",
           "query_to_wire", "query_from_wire"]

#: codec version stamped into every frame (reject, don't guess, on skew)
WIRE_VERSION = 1

_HEADER = struct.Struct("<IBI")        # payload length, version, crc32


class WireError(RuntimeError):
    """A frame failed to parse or verify (truncation, CRC, bad tag)."""


@dataclasses.dataclass(frozen=True)
class Envelope:
    """One fabric message (see module docstring)."""
    kind: str
    msg_id: int = 0
    trace: tuple | None = None         # (trace_id, span_id) or None
    payload: dict = dataclasses.field(default_factory=dict)

    def reply(self, kind: str, **payload) -> "Envelope":
        """A reply envelope correlated to this request (echoes msg_id;
        the trace context does NOT propagate back — the reply lands in
        the waiting span on the requesting side)."""
        return Envelope(kind, msg_id=self.msg_id, payload=payload)


# ------------------------------------------------------------------ values
_T_NONE, _T_TRUE, _T_FALSE, _T_INT, _T_FLOAT = b"n", b"t", b"f", b"i", b"d"
_T_STR, _T_BYTES, _T_LIST, _T_TUPLE, _T_DICT = b"s", b"b", b"l", b"u", b"m"
_T_NDARRAY = b"a"


def _is_tensor(v) -> bool:
    """True for a torch tensor (without importing torch: a process that
    holds one has imported it already)."""
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(v, torch.Tensor)


def _enc(v, out: list) -> None:
    if v is None:
        out.append(_T_NONE)
    elif v is True:
        out.append(_T_TRUE)
    elif v is False:
        out.append(_T_FALSE)
    elif isinstance(v, int) and not isinstance(v, bool):
        b = str(v).encode()
        out.append(_T_INT + struct.pack("<I", len(b)) + b)
    elif isinstance(v, float):
        out.append(_T_FLOAT + struct.pack("<d", v))
    elif isinstance(v, str):
        b = v.encode()
        out.append(_T_STR + struct.pack("<I", len(b)) + b)
    elif isinstance(v, (bytes, bytearray)):
        out.append(_T_BYTES + struct.pack("<I", len(v)) + bytes(v))
    elif isinstance(v, np.ndarray):
        arr = np.ascontiguousarray(v)
        dt = arr.dtype.str.encode()
        shape = ",".join(str(s) for s in arr.shape).encode()
        raw = arr.tobytes()
        out.append(_T_NDARRAY + struct.pack("<III", len(dt), len(shape),
                                            len(raw)) + dt + shape + raw)
    elif isinstance(v, (list, tuple)):
        out.append((_T_LIST if isinstance(v, list) else _T_TUPLE)
                   + struct.pack("<I", len(v)))
        for item in v:
            _enc(item, out)
    elif isinstance(v, dict):
        out.append(_T_DICT + struct.pack("<I", len(v)))
        for k, item in v.items():
            if not isinstance(k, str):
                raise TypeError(f"wire dict keys must be str, got "
                                f"{type(k).__name__}")
            _enc(k, out)
            _enc(item, out)
    elif isinstance(v, np.generic):          # numpy scalar -> python
        _enc(v.item(), out)
    elif _is_tensor(v):
        raise WireError(f"a torch tensor ({tuple(v.shape)} {v.dtype} on "
                        f"{v.device}) does not cross the fabric wire: "
                        "convert it to a numpy array first")
    else:
        raise TypeError(f"type {type(v).__name__} does not cross the "
                        f"fabric wire (value {v!r:.60})")


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        b = self.buf[self.pos:self.pos + n]
        if len(b) != n:
            raise WireError(f"truncated frame: wanted {n} bytes at "
                            f"{self.pos}, have {len(b)}")
        self.pos += n
        return b


def _dec(r: _Reader):
    tag = r.take(1)
    if tag == _T_NONE:
        return None
    if tag == _T_TRUE:
        return True
    if tag == _T_FALSE:
        return False
    if tag == _T_INT:
        (n,) = struct.unpack("<I", r.take(4))
        return int(r.take(n))
    if tag == _T_FLOAT:
        return struct.unpack("<d", r.take(8))[0]
    if tag == _T_STR:
        (n,) = struct.unpack("<I", r.take(4))
        return r.take(n).decode()
    if tag == _T_BYTES:
        (n,) = struct.unpack("<I", r.take(4))
        return r.take(n)
    if tag == _T_NDARRAY:
        nd, ns, nr = struct.unpack("<III", r.take(12))
        dt = np.dtype(r.take(nd).decode())
        shape_s = r.take(ns).decode()
        shape = tuple(int(s) for s in shape_s.split(",")) if shape_s \
            else ()
        raw = r.take(nr)
        return np.frombuffer(raw, dtype=dt).reshape(shape).copy()
    if tag in (_T_LIST, _T_TUPLE):
        (n,) = struct.unpack("<I", r.take(4))
        items = [_dec(r) for _ in range(n)]
        return items if tag == _T_LIST else tuple(items)
    if tag == _T_DICT:
        (n,) = struct.unpack("<I", r.take(4))
        return {_dec(r): _dec(r) for _ in range(n)}
    raise WireError(f"unknown wire tag {tag!r} at {r.pos - 1}")


# ---------------------------------------------------------------- envelope
def encode(env: Envelope) -> bytes:
    """Envelope -> one self-delimited CRC-guarded frame."""
    out: list[bytes] = []
    _enc({"kind": env.kind, "msg_id": env.msg_id,
          "trace": env.trace, "payload": env.payload}, out)
    body = b"".join(out)
    return _HEADER.pack(len(body), WIRE_VERSION,
                        zlib.crc32(body) & 0xFFFFFFFF) + body


def decode(frame: bytes) -> Envelope:
    """One full frame -> Envelope (raises :class:`WireError` on any
    truncation, version skew, or checksum mismatch)."""
    if len(frame) < _HEADER.size:
        raise WireError(f"frame shorter than header ({len(frame)} bytes)")
    length, version, crc = _HEADER.unpack_from(frame)
    if version != WIRE_VERSION:
        raise WireError(f"wire version {version} != {WIRE_VERSION}")
    body = frame[_HEADER.size:]
    if len(body) != length:
        raise WireError(f"frame body {len(body)} bytes, header says "
                        f"{length}")
    if zlib.crc32(body) & 0xFFFFFFFF != crc:
        raise WireError("frame checksum mismatch")
    obj = _dec(_Reader(body))
    trace = obj.get("trace")
    return Envelope(kind=obj["kind"], msg_id=obj["msg_id"],
                    trace=tuple(trace) if trace is not None else None,
                    payload=obj["payload"])


def header_size() -> int:
    return _HEADER.size


def frame_length(header: bytes) -> int:
    """Body length promised by a raw header (socket readers use this to
    know how much more to recv)."""
    length, version, _ = _HEADER.unpack(header)
    if version != WIRE_VERSION:
        raise WireError(f"wire version {version} != {WIRE_VERSION}")
    return length


# ------------------------------------------------------------------ queries
def query_to_wire(q):
    """A planner predicate / db expression -> a tagged tree of plain
    values.  Raises TypeError on anything else (pre-built plans do not
    cross the wire — the shard side plans against ITS stats)."""
    from repro_torch.db import expr as expr_mod
    from repro_torch.engine import planner

    if isinstance(q, planner.Key):
        return ["key", q.index]
    if isinstance(q, planner.Not):
        return ["not", query_to_wire(q.child)]
    if isinstance(q, planner.And):
        return ["and", [query_to_wire(c) for c in q.children]]
    if isinstance(q, planner.Or):
        return ["or", [query_to_wire(c) for c in q.children]]
    if isinstance(q, expr_mod.NotExpr):
        return ["enot", query_to_wire(q.child)]
    if isinstance(q, expr_mod.AndExpr):
        return ["eand", [query_to_wire(c) for c in q.children]]
    if isinstance(q, expr_mod.OrExpr):
        return ["eor", [query_to_wire(c) for c in q.children]]
    if isinstance(q, expr_mod.Eq):
        return ["eq", q.column, q.value]
    if isinstance(q, expr_mod.In):
        return ["in", q.column, list(q.values)]
    if isinstance(q, expr_mod.Between):
        return ["between", q.column, q.lo, q.hi]
    raise TypeError(f"cannot send {type(q).__name__} over the fabric "
                    "wire (expressions and predicate trees only)")


def query_from_wire(obj):
    """Inverse of :func:`query_to_wire` — rebuilds the exact expression/
    predicate object, so shard-side plan caches key identically."""
    from repro_torch.db import expr as expr_mod
    from repro_torch.engine import planner

    obj = list(obj)
    tag = obj[0]
    if tag == "key":
        return planner.key(obj[1])
    if tag == "not":
        return planner.Not(query_from_wire(obj[1]))
    if tag == "and":
        return planner.And(tuple(query_from_wire(c) for c in obj[1]))
    if tag == "or":
        return planner.Or(tuple(query_from_wire(c) for c in obj[1]))
    if tag == "enot":
        return expr_mod.NotExpr(query_from_wire(obj[1]))
    if tag == "eand":
        return expr_mod.AndExpr(tuple(query_from_wire(c) for c in obj[1]))
    if tag == "eor":
        return expr_mod.OrExpr(tuple(query_from_wire(c) for c in obj[1]))
    if tag == "eq":
        return expr_mod.Eq(obj[1], obj[2])
    if tag == "in":
        return expr_mod.In(obj[1], tuple(obj[2]))
    if tag == "between":
        return expr_mod.Between(obj[1], obj[2], obj[3])
    raise WireError(f"unknown query tag {tag!r}")
