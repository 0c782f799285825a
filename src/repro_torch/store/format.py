"""Versioned, checksummed on-disk serialization — the substrate shared by
the segment store (``repro_torch.store``) and the training checkpoint store
(``repro_torch.checkpoint.store``).

Two container shapes cover every durability need in the repo:

  * **Array files** — a single immutable file holding named numpy arrays
    plus a JSON meta dict.  Layout: magic, version, a JSON directory
    (name/dtype/shape/nbytes/crc32 per array) protected by its own CRC,
    then the raw array payloads.  Readers verify every CRC before any
    byte reaches a consumer, so a torn or bit-flipped file raises
    :class:`CorruptFileError` instead of silently feeding garbage bits
    into an index.  Writes are atomic (tmp file + fsync + ``os.replace``
    + directory fsync): a crash mid-write never leaves a half-visible
    file under the final name.
  * **Framed append logs** — the write-ahead log format: a fixed header
    followed by length+CRC framed entries.  The reader stops at the first
    torn or corrupt frame (the expected state after a crash mid-append)
    and returns everything before it.

Only stdlib + numpy: this module sits *below* the engine and must import
nothing above it (:mod:`repro_torch.fault.seam`, the fault-injection seam the
writers and readers fire through, is itself stdlib-only and sits beside
this module — one global ``None`` check when no injector is installed).
"""
from __future__ import annotations

import errno
import io
import json
import os
import struct
import zlib
from typing import Any, BinaryIO, Iterator

import numpy as np

from repro_torch.fault import seam

ARRAY_MAGIC = b"RBSF"          # Repro Bitmap Store File
LOG_MAGIC = b"RBWL"            # Repro Bitmap Write-ahead Log
VERSION = 1

_U32S = struct.Struct("<I")    # little-endian u32 framing


class CorruptFileError(RuntimeError):
    """A store file failed magic/version/CRC validation."""


def crc32(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def fsync_dir(path: str) -> None:
    """fsync a directory so a rename inside it is durable (POSIX)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:            # platforms without directory fds
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_replace(tmp_path: str, final_path: str) -> None:
    """Durable rename: the final name either has the complete old content
    or the complete new content, never a torn mix."""
    os.replace(tmp_path, final_path)
    fsync_dir(os.path.dirname(final_path) or ".")


def write_bytes_atomic(path: str, data: bytes) -> None:
    act = seam.fire("format.write", path=path, size=len(data))
    tmp = path + ".tmp"
    if act and act.get("torn_bytes") is not None:
        # injected crash-mid-write: a prefix of the payload reaches the
        # .tmp and "the process dies" before any cleanup — the final
        # name never appears (atomicity holds) and the orphan debris is
        # exactly what gc() must collect
        with open(tmp, "wb") as f:
            f.write(data[:act["torn_bytes"]])
        raise OSError(errno.EIO, f"injected torn write: {path}")
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
    except BaseException:
        # a FAILED (not crashed) write cleans up its own debris: the
        # caller sees the error, the directory holds no orphan .tmp
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    atomic_replace(tmp, path)


def write_json_atomic(path: str, obj: Any) -> None:
    write_bytes_atomic(path, json.dumps(obj, sort_keys=True).encode())


# ----------------------------------------------------------------- array file
#: dtype names numpy may not know (``bfloat16`` comes from ``ml_dtypes``,
#: which JAX brings and this package does not need): such arrays travel as
#: their raw bits in an unsigned integer of the same width
RAW_BITS = {"bfloat16": np.uint16}


def _np_dtype(name: str) -> np.dtype:
    try:
        return np.dtype(name)
    except TypeError:
        if name in RAW_BITS:
            return np.dtype(RAW_BITS[name])
        raise


def _array_entry(name: str, arr: np.ndarray, dtype: str | None = None
                 ) -> dict:
    return {"name": name, "dtype": dtype or str(arr.dtype),
            "shape": list(arr.shape), "nbytes": arr.nbytes,
            "crc32": crc32(arr.tobytes())}


def write_array_file(path: str, arrays: dict[str, np.ndarray],
                     meta: dict | None = None,
                     dtype_names: dict[str, str] | None = None) -> None:
    """Atomically write named arrays + meta as one checksummed file.
    ``dtype_names`` names the dtype stored for some arrays in place of
    their own: a bf16 array handed over as its ``uint16`` bits is stored
    as ``bfloat16``, the name the JAX package writes."""
    arrays = {k: np.ascontiguousarray(v) for k, v in arrays.items()}
    names = dtype_names or {}
    header = json.dumps(
        {"meta": meta or {},
         "arrays": [_array_entry(k, v, names.get(k))
                    for k, v in arrays.items()]},
        sort_keys=True).encode()
    buf = io.BytesIO()
    buf.write(ARRAY_MAGIC)
    buf.write(_U32S.pack(VERSION))
    buf.write(_U32S.pack(len(header)))
    buf.write(header)
    buf.write(_U32S.pack(crc32(header)))
    for arr in arrays.values():
        buf.write(arr.tobytes())
    write_bytes_atomic(path, buf.getvalue())


def read_array_file(path: str, *, verify: bool = True
                    ) -> tuple[dict[str, np.ndarray], dict]:
    """Read back (arrays, meta); raises :class:`CorruptFileError` on any
    magic/version/CRC mismatch or truncation.  An array of a dtype numpy
    does not know (:data:`RAW_BITS`) comes back as its raw bits."""
    with open(path, "rb") as f:
        data = f.read()
    act = seam.fire("format.read", path=path, data=data)
    if act and act.get("data") is not None:
        data = act["data"]              # injected read-side bit rot
    if data[:4] != ARRAY_MAGIC:
        raise CorruptFileError(f"{path}: bad magic {data[:4]!r}")
    if len(data) < 12:
        raise CorruptFileError(f"{path}: truncated preamble "
                               f"({len(data)} bytes)")
    (version,) = _U32S.unpack_from(data, 4)
    if version != VERSION:
        raise CorruptFileError(f"{path}: unsupported version {version}")
    (hlen,) = _U32S.unpack_from(data, 8)
    hdr_end = 12 + hlen
    if len(data) < hdr_end + 4:
        raise CorruptFileError(f"{path}: truncated header")
    header = data[12:hdr_end]
    (hcrc,) = _U32S.unpack_from(data, hdr_end)
    if verify and crc32(header) != hcrc:
        raise CorruptFileError(f"{path}: header CRC mismatch")
    directory = json.loads(header)
    arrays: dict[str, np.ndarray] = {}
    off = hdr_end + 4
    for ent in directory["arrays"]:
        end = off + ent["nbytes"]
        if end > len(data):
            raise CorruptFileError(f"{path}: truncated payload for "
                                   f"{ent['name']!r}")
        raw = data[off:end]
        if verify and crc32(raw) != ent["crc32"]:
            raise CorruptFileError(f"{path}: payload CRC mismatch for "
                                   f"{ent['name']!r}")
        arrays[ent["name"]] = np.frombuffer(
            raw, dtype=_np_dtype(ent["dtype"])).reshape(ent["shape"])
        off = end
    return arrays, directory["meta"]


# ----------------------------------------------------------------- framed log
def write_log_header(f: BinaryIO) -> None:
    f.write(LOG_MAGIC)
    f.write(_U32S.pack(VERSION))
    f.flush()
    os.fsync(f.fileno())


def append_log_entry(f: BinaryIO, meta: dict, payload: bytes) -> None:
    """Append one durable length+CRC framed entry (meta JSON + raw bytes).

    Failure modes surface, never corrupt silently: a torn frame (injected
    crash) or a failed fsync raises — the caller must treat the entry as
    NOT durable (see ``WriteAheadLog.append_block``, which rewinds the
    handle to the last intact frame boundary so later appends never land
    behind an unreachable tail)."""
    head = json.dumps(meta, sort_keys=True).encode()
    body = _U32S.pack(len(head)) + head + payload
    frame = _U32S.pack(len(body)) + _U32S.pack(crc32(body)) + body
    act = seam.fire("log.append", path=getattr(f, "name", ""),
                    size=len(frame))
    if act and act.get("torn_bytes") is not None:
        f.write(frame[:act["torn_bytes"]])  # crash mid-append: torn tail
        f.flush()
        raise OSError(errno.EIO, "injected torn log append")
    f.write(frame)
    f.flush()
    if act and act.get("fail_fsync"):
        raise OSError(errno.EIO, "injected fsync failure (entry written "
                                 "but not durable)")
    os.fsync(f.fileno())


def read_log_entries(path: str) -> Iterator[tuple[dict, bytes]]:
    """Yield (meta, payload) per intact entry; a torn/corrupt tail (the
    normal post-crash state) ends iteration instead of raising."""
    for meta, payload, _ in read_log_entries_from(path, 8):
        yield meta, payload


def read_log_entries_from(path: str, offset: int
                          ) -> Iterator[tuple[dict, bytes, int]]:
    """Like :func:`read_log_entries` but starting at byte ``offset``
    (pass 8 for the whole log) and yielding ``(meta, payload,
    end_offset)`` — ``end_offset`` is the resume point for an
    incremental re-read of a log that is still being appended to."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        return
    if data[:4] != LOG_MAGIC:
        return
    off = max(offset, 8)
    while off + 8 <= len(data):
        (blen,) = _U32S.unpack_from(data, off)
        (bcrc,) = _U32S.unpack_from(data, off + 4)
        end = off + 8 + blen
        if end > len(data):
            return                               # torn tail
        body = data[off + 8:end]
        if crc32(body) != bcrc:
            return                               # corrupt tail
        (hlen,) = _U32S.unpack_from(body, 0)
        meta = json.loads(body[4:4 + hlen])
        yield meta, body[4 + hlen:], end
        off = end


def intact_log_length(path: str) -> int:
    """Byte length of the intact prefix of a framed log (header + every
    complete, CRC-valid entry).  0 for a missing/headerless file.  A
    writer reopening a crashed log MUST truncate to this before appending
    — bytes written after a torn frame would be unreachable to readers."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        return 0
    if data[:4] != LOG_MAGIC:
        return 0
    off = 8
    while off + 8 <= len(data):
        (blen,) = _U32S.unpack_from(data, off)
        (bcrc,) = _U32S.unpack_from(data, off + 4)
        end = off + 8 + blen
        if end > len(data) or crc32(data[off + 8:end]) != bcrc:
            break
        off = end
    return off
