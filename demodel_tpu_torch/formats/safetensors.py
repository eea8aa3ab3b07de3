"""safetensors parsing/serialization, range-read oriented (the port's copy
of what the HBM sink needs from ``demodel_tpu/formats/safetensors.py``).

The sink never loads whole checkpoint files: it reads the 8-byte length
prefix + JSON header, then issues per-tensor byte-range reads. The dtype
table maps each tag to a torch dtype, so bf16 and fp8 need no numpy
extension type.

Format: ``u64le header_len | header JSON | data``; each tensor entry is
``{"dtype": TAG, "shape": [...], "data_offsets": [start, end]}`` with
offsets relative to the data section.
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass

import numpy as np
import torch

#: safetensors dtype tag → torch dtype
_DTYPES: dict[str, torch.dtype] = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
    "U16": torch.uint16,
    "U32": torch.uint32,
    "U64": torch.uint64,
    "F8_E4M3": torch.float8_e4m3fn,
    "F8_E5M2": torch.float8_e5m2,
}

_TAGS = {v: k for k, v in _DTYPES.items()}

MAX_HEADER = 100 << 20  # defensive: a 100MB header is not a checkpoint


def torch_dtype(tag: str) -> torch.dtype:
    try:
        return _DTYPES[tag]
    except KeyError:
        raise ValueError(f"unsupported safetensors dtype {tag!r}") from None


@dataclass(frozen=True)
class TensorSpec:
    name: str
    dtype: str                 # safetensors tag
    shape: tuple[int, ...]
    start: int                 # ABSOLUTE offset of first data byte
    end: int                   # absolute end (exclusive)

    @property
    def nbytes(self) -> int:
        return self.end - self.start


@dataclass(frozen=True)
class Index:
    tensors: dict[str, TensorSpec]
    metadata: dict
    data_start: int            # absolute offset where the data section begins
    total_size: int | None     # file size when known (validation)


def _parse_header_json(hdr: bytes, data_start: int,
                       total_size: int | None) -> Index:
    try:
        obj = json.loads(hdr.decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        raise ValueError(f"safetensors header is not valid JSON: {e}") from None
    if not isinstance(obj, dict):
        raise ValueError("safetensors header must be a JSON object")
    metadata = obj.pop("__metadata__", {}) or {}
    tensors: dict[str, TensorSpec] = {}
    data_len = None if total_size is None else total_size - data_start
    for name, info in obj.items():
        if not isinstance(info, dict):
            raise ValueError(f"{name}: bad tensor entry")
        try:
            tag = info["dtype"]
            shape = tuple(int(d) for d in info["shape"])
            s, e = info["data_offsets"]
        except (KeyError, TypeError, ValueError):
            raise ValueError(f"{name}: malformed tensor entry") from None
        dt = torch_dtype(tag)
        want = int(np.prod(shape, dtype=np.int64)) * dt.itemsize if shape \
            else dt.itemsize
        if e - s != want:
            raise ValueError(
                f"{name}: data_offsets span {e - s} != dtype×shape {want}")
        if s < 0 or e < s or (data_len is not None and e > data_len):
            raise ValueError(f"{name}: data_offsets [{s},{e}) out of bounds")
        tensors[name] = TensorSpec(name=name, dtype=tag, shape=shape,
                                   start=data_start + s, end=data_start + e)
    return Index(tensors=tensors, metadata=metadata, data_start=data_start,
                 total_size=total_size)


def read_index_from(read_at, total_size: int | None = None) -> Index:
    """Parse a header through a range-reader ``read_at(offset, length)`` —
    the store path, no whole-file load."""
    prefix = bytes(read_at(0, 8))
    if len(prefix) < 8:
        raise ValueError("truncated safetensors file (no length prefix)")
    (n,) = struct.unpack("<Q", prefix)
    if n > MAX_HEADER or (total_size is not None and 8 + n > total_size):
        raise ValueError(f"safetensors header length {n} out of bounds")
    hdr = bytes(read_at(8, n))
    if len(hdr) != n:
        raise ValueError("truncated safetensors header")
    return _parse_header_json(hdr, 8 + n, total_size)


def serialize(tensors: dict[str, np.ndarray | torch.Tensor],
              metadata: dict | None = None) -> bytes:
    """Write a safetensors blob (sorted offsets, upstream-compatible).
    Takes numpy arrays or CPU tensors (a tensor for bf16 or fp8)."""
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    bodies: list[bytes] = []
    off = 0
    for name, arr in tensors.items():
        t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(arr) if np.ndim(arr) else np.asarray(arr))
        try:
            tag = _TAGS[t.dtype]
        except KeyError:
            raise ValueError(f"unsupported dtype {t.dtype!r}") from None
        raw = t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {
            "dtype": tag,
            "shape": list(t.shape),
            "data_offsets": [off, off + len(raw)],
        }
        bodies.append(raw)
        off += len(raw)
    hdr = json.dumps(header, separators=(",", ":")).encode()
    # upstream pads the header with spaces to 8-byte alignment
    pad = (8 - (len(hdr) % 8)) % 8
    hdr += b" " * pad
    return struct.pack("<Q", len(hdr)) + hdr + b"".join(bodies)
