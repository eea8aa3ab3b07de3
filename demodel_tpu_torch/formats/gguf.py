"""GGUF container + quant-block codecs (the port's copy of
``demodel_tpu/formats/gguf.py``, which is pure numpy).

Parsing is range-read oriented like :mod:`.safetensors`: the header walk
yields absolute byte ranges per tensor so the HBM sink can stream each
device's rows without loading the file. Block layouts follow the public
llama.cpp/ggml format spec (the unavoidable constants: block sizes, scale
packing); all encode/decode here is an original numpy implementation, with
the on-device dequant kernels in :mod:`demodel_tpu_torch.ops.dequant`.

One change from the original: :func:`serialize` writes its header
through :func:`write_header`, so a caller with bodies already packed
(random valid blocks at full model width) lays out a file without
encoding floats. The blobs are byte-identical to the original's.

Container: ``GGUF`` magic, version 3, tensor/kv counts, metadata KVs,
tensor infos (name, dims innermost-first, ggml type, data offset), then the
data section aligned to ``general.alignment`` (default 32).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

MAGIC = b"GGUF"
VERSION = 3
DEFAULT_ALIGNMENT = 32

# ggml tensor types (stable public ABI ids)
GGML_F32 = 0
GGML_F16 = 1
GGML_Q4_0 = 2
GGML_Q8_0 = 8
GGML_Q2_K = 10
GGML_Q3_K = 11
GGML_Q4_K = 12
GGML_Q5_K = 13
GGML_Q6_K = 14

QK = 32       # elements per Q4_0/Q8_0 block
QK_K = 256    # elements per K-quant super-block

Q4_0_BLOCK_BYTES = 2 + QK // 2          # f16 d + 16 nibble bytes = 18
Q8_0_BLOCK_BYTES = 2 + QK               # f16 d + 32 int8        = 34
K_BLOCK_BYTES = {
    GGML_Q2_K: 16 + QK_K // 4 + 2 + 2,              # scales+qs+d+dmin = 84
    GGML_Q3_K: QK_K // 8 + QK_K // 4 + 12 + 2,      # hmask+qs+scales+d = 110
    GGML_Q4_K: 2 + 2 + 12 + QK_K // 2,              # d+dmin+scales+qs = 144
    GGML_Q5_K: 2 + 2 + 12 + QK_K // 8 + QK_K // 2,  # +qh              = 176
    GGML_Q6_K: QK_K // 2 + QK_K // 4 + QK_K // 16 + 2,  # ql+qh+sc+d   = 210
}

_BLOCK_GEOM = {
    GGML_F32: (1, 4),
    GGML_F16: (1, 2),
    GGML_Q4_0: (QK, Q4_0_BLOCK_BYTES),
    GGML_Q8_0: (QK, Q8_0_BLOCK_BYTES),
    **{t: (QK_K, b) for t, b in K_BLOCK_BYTES.items()},
}

# GGUF metadata value types
_T_U8, _T_I8, _T_U16, _T_I16, _T_U32, _T_I32 = 0, 1, 2, 3, 4, 5
_T_F32, _T_BOOL, _T_STR, _T_ARR, _T_U64, _T_I64, _T_F64 = 6, 7, 8, 9, 10, 11, 12

_SCALAR_FMT = {_T_U8: "<B", _T_I8: "<b", _T_U16: "<H", _T_I16: "<h",
               _T_U32: "<I", _T_I32: "<i", _T_F32: "<f", _T_BOOL: "<?",
               _T_U64: "<Q", _T_I64: "<q", _T_F64: "<d"}


@dataclass(frozen=True)
class GGUFTensor:
    name: str
    ggml_type: int
    shape: tuple[int, ...]   # numpy (row-major) order — file stores reversed
    start: int               # absolute offset of first data byte
    nbytes: int


@dataclass(frozen=True)
class GGUFIndex:
    tensors: dict[str, GGUFTensor]
    metadata: dict
    alignment: int
    data_start: int


def tensor_nbytes(ggml_type: int, n_elems: int) -> int:
    blk, bpb = _BLOCK_GEOM[ggml_type]
    if n_elems % blk != 0:
        raise ValueError(f"{n_elems} elements not a multiple of block {blk}")
    return n_elems // blk * bpb


# ------------------------------------------------------------------ reader


class _Cursor:
    """Sequential reader over a range-reader with a sliding buffer."""

    def __init__(self, read_at):
        self.read_at = read_at
        self.pos = 0

    def take(self, n: int) -> bytes:
        b = bytes(self.read_at(self.pos, n))
        if len(b) != n:
            raise ValueError(f"truncated GGUF (wanted {n} at {self.pos})")
        self.pos += n
        return b

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def string(self) -> str:
        n = self.u64()
        if n > (1 << 20):
            raise ValueError(f"GGUF string length {n} out of bounds")
        return self.take(n).decode("utf-8")

    def value(self, t: int):
        if t in _SCALAR_FMT:
            fmt = _SCALAR_FMT[t]
            return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]
        if t == _T_STR:
            return self.string()
        if t == _T_ARR:
            et = self.u32()
            n = self.u64()
            if n > (1 << 24):
                raise ValueError(f"GGUF array length {n} out of bounds")
            return [self.value(et) for _ in range(n)]
        raise ValueError(f"unknown GGUF value type {t}")


def read_index_from(read_at) -> GGUFIndex:
    c = _Cursor(read_at)
    if c.take(4) != MAGIC:
        raise ValueError("not a GGUF file (bad magic)")
    version = c.u32()
    if version not in (2, 3):
        raise ValueError(f"unsupported GGUF version {version}")
    n_tensors = c.u64()
    n_kv = c.u64()
    if n_tensors > (1 << 20) or n_kv > (1 << 20):
        raise ValueError("GGUF counts out of bounds")
    metadata = {}
    for _ in range(n_kv):
        key = c.string()
        t = c.u32()
        metadata[key] = c.value(t)
    alignment = int(metadata.get("general.alignment", DEFAULT_ALIGNMENT))
    infos = []
    for _ in range(n_tensors):
        name = c.string()
        n_dims = c.u32()
        if n_dims > 8:
            raise ValueError(f"{name}: {n_dims} dims out of bounds")
        dims = [c.u64() for _ in range(n_dims)]
        ggml_type = c.u32()
        offset = c.u64()
        if ggml_type not in _BLOCK_GEOM:
            raise ValueError(f"{name}: unsupported ggml type {ggml_type}")
        # file order is innermost-first; numpy shape is the reverse
        shape = tuple(reversed([int(d) for d in dims])) if dims else ()
        infos.append((name, ggml_type, shape, offset))
    data_start = (c.pos + alignment - 1) // alignment * alignment
    tensors = {}
    for name, ggml_type, shape, offset in infos:
        n_elems = int(np.prod(shape, dtype=np.int64)) if shape else 1
        tensors[name] = GGUFTensor(
            name=name, ggml_type=ggml_type, shape=shape,
            start=data_start + offset,
            nbytes=tensor_nbytes(ggml_type, n_elems),
        )
    return GGUFIndex(tensors=tensors, metadata=metadata, alignment=alignment,
                     data_start=data_start)


def parse(blob: bytes) -> GGUFIndex:
    mv = memoryview(blob)
    return read_index_from(lambda off, ln: mv[off:off + ln])


# ------------------------------------------------------------------ writer


def _w_string(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack("<Q", len(b)) + b


def write_header(entries: list[tuple[str, tuple[int, ...], int]],
                 metadata: dict | None = None,
                 alignment: int = DEFAULT_ALIGNMENT
                 ) -> tuple[bytes, list[int]]:
    """Header of a GGUF blob whose tensors ``(name, shape, ggml_type)``
    follow in order, each body padded to ``alignment``.

    Returns the header, itself padded to ``alignment``, and each body's
    offset from the start of the data section; the data section is
    ``offsets[-1] + padded size of the last body`` long."""
    out = bytearray()
    meta = dict(metadata or {})
    meta.setdefault("general.alignment", alignment)
    out += MAGIC
    out += struct.pack("<IQQ", VERSION, len(entries), len(meta))
    for k, v in meta.items():
        out += _w_string(k)
        if isinstance(v, bool):
            out += struct.pack("<I", _T_BOOL) + struct.pack("<?", v)
        elif isinstance(v, int):
            out += struct.pack("<I", _T_U32) + struct.pack("<I", v)
        elif isinstance(v, float):
            out += struct.pack("<I", _T_F32) + struct.pack("<f", v)
        elif isinstance(v, str):
            out += struct.pack("<I", _T_STR) + _w_string(v)
        else:
            raise ValueError(f"unsupported metadata value for {k}: {v!r}")
    offsets = []
    offset = 0
    for name, shape, t in entries:
        out += _w_string(name)
        dims = list(reversed(shape))
        out += struct.pack("<I", len(dims))
        for d in dims:
            out += struct.pack("<Q", d)
        out += struct.pack("<IQ", t, offset)
        offsets.append(offset)
        n_elems = int(np.prod(shape, dtype=np.int64)) if shape else 1
        offset += tensor_nbytes(t, n_elems)
        offset += (-offset) % alignment
    out += b"\0" * ((-len(out)) % alignment)
    return bytes(out), offsets


def serialize(tensors: dict[str, np.ndarray],
              types: dict[str, int] | int = GGML_F32,
              metadata: dict | None = None,
              alignment: int = DEFAULT_ALIGNMENT) -> bytes:
    """Write a GGUF blob, quantizing each tensor to its requested type."""
    entries, bodies = [], []
    for name, arr in tensors.items():
        t = types if isinstance(types, int) else types.get(name, GGML_F32)
        raw = encode(np.asarray(arr, dtype=np.float32), t)
        entries.append((name, tuple(np.shape(arr)), t))
        bodies.append(raw + b"\0" * ((-len(raw)) % alignment))
    header, _ = write_header(entries, metadata, alignment)
    return header + b"".join(bodies)


# ------------------------------------------------------ block encode/decode
#
# Encoders here exist for fixtures and round-trip tests: they produce VALID
# blocks with sane (absmax / absmax-min) scale choices, not llama.cpp's
# search-optimized ones. Decoders are the normative spec implementation the
# dequant kernels are tested against.


def encode(arr: np.ndarray, ggml_type: int) -> bytes:
    flat = np.ascontiguousarray(arr, dtype=np.float32).reshape(-1)
    if ggml_type == GGML_F32:
        return flat.tobytes()
    if ggml_type == GGML_F16:
        return flat.astype(np.float16).tobytes()
    blk, _ = _BLOCK_GEOM[ggml_type]
    if flat.size % blk != 0:
        raise ValueError(f"{flat.size} elements not a multiple of {blk}")
    x = flat.reshape(-1, blk)
    if ggml_type == GGML_Q8_0:
        return _enc_q8_0(x)
    if ggml_type == GGML_Q4_0:
        return _enc_q4_0(x)
    if ggml_type == GGML_Q2_K:
        return _enc_q2_k(x)
    if ggml_type == GGML_Q3_K:
        return _enc_q3_k(x)
    if ggml_type == GGML_Q4_K:
        return _enc_q4_k(x)
    if ggml_type == GGML_Q5_K:
        return _enc_q5_k(x)
    if ggml_type == GGML_Q6_K:
        return _enc_q6_k(x)
    raise ValueError(f"unsupported ggml type {ggml_type}")


def decode_raw(t: GGUFTensor, raw: bytes):
    """Split packed blocks into typed column arrays ("parts").

    F32/F16 → the numpy array itself. Quant types → a tuple of arrays
    (scales first) that :mod:`demodel_tpu_torch.ops.dequant` consumes on device —
    the host→device link carries only the quantized payload.
    """
    if t.ggml_type == GGML_F32:
        return np.frombuffer(raw, np.float32).reshape(t.shape)
    if t.ggml_type == GGML_F16:
        return np.frombuffer(raw, np.float16).reshape(t.shape)
    blk, bpb = _BLOCK_GEOM[t.ggml_type]
    b = np.frombuffer(raw, np.uint8).reshape(-1, bpb)
    if t.ggml_type == GGML_Q8_0:
        d = b[:, 0:2].copy().view(np.float16).reshape(-1)
        qs = b[:, 2:].view(np.int8)
        return d, qs
    if t.ggml_type == GGML_Q4_0:
        d = b[:, 0:2].copy().view(np.float16).reshape(-1)
        qs = b[:, 2:]
        return d, qs
    if t.ggml_type == GGML_Q2_K:
        scales = b[:, 0:16]
        qs = b[:, 16:80]
        d = b[:, 80:82].copy().view(np.float16).reshape(-1)
        dmin = b[:, 82:84].copy().view(np.float16).reshape(-1)
        return d, dmin, scales, qs
    if t.ggml_type == GGML_Q3_K:
        hmask = b[:, 0:32]
        qs = b[:, 32:96]
        scales = b[:, 96:108]
        d = b[:, 108:110].copy().view(np.float16).reshape(-1)
        return d, scales, hmask, qs
    if t.ggml_type == GGML_Q4_K:
        d = b[:, 0:2].copy().view(np.float16).reshape(-1)
        dmin = b[:, 2:4].copy().view(np.float16).reshape(-1)
        scales = b[:, 4:16]
        qs = b[:, 16:144]
        return d, dmin, scales, qs
    if t.ggml_type == GGML_Q5_K:
        d = b[:, 0:2].copy().view(np.float16).reshape(-1)
        dmin = b[:, 2:4].copy().view(np.float16).reshape(-1)
        scales = b[:, 4:16]
        qh = b[:, 16:48]
        qs = b[:, 48:176]
        return d, dmin, scales, qh, qs
    if t.ggml_type == GGML_Q6_K:
        ql = b[:, 0:128]
        qh = b[:, 128:192]
        sc = b[:, 192:208].view(np.int8)
        d = b[:, 208:210].copy().view(np.float16).reshape(-1)
        return d, sc, ql, qh
    raise ValueError(f"unsupported ggml type {t.ggml_type}")


# -- Q8_0 / Q4_0 ----------------------------------------------------------


def _enc_q8_0(x: np.ndarray) -> bytes:
    amax = np.abs(x).max(axis=1)
    d = (amax / 127.0).astype(np.float16)
    ds = d.astype(np.float32)
    ds[ds == 0] = 1.0
    q = np.clip(np.rint(x / ds[:, None]), -127, 127).astype(np.int8)
    out = np.empty((x.shape[0], Q8_0_BLOCK_BYTES), np.uint8)
    out[:, 0:2] = d.view(np.uint8).reshape(-1, 2)
    out[:, 2:] = q.view(np.uint8)
    return out.tobytes()


def _enc_q4_0(x: np.ndarray) -> bytes:
    amax_idx = np.abs(x).argmax(axis=1)
    maxv = x[np.arange(x.shape[0]), amax_idx]
    d = (maxv / -8.0).astype(np.float16)
    ds = d.astype(np.float32)
    ds[ds == 0] = 1.0
    q = np.clip(np.rint(x / ds[:, None]) + 8, 0, 15).astype(np.uint8)
    lo, hi = q[:, :QK // 2], q[:, QK // 2:]
    out = np.empty((x.shape[0], Q4_0_BLOCK_BYTES), np.uint8)
    out[:, 0:2] = d.view(np.uint8).reshape(-1, 2)
    out[:, 2:] = lo | (hi << 4)
    return out.tobytes()


def ref_dequant_q8_0(d: np.ndarray, qs: np.ndarray) -> np.ndarray:
    return (d.astype(np.float32)[:, None] * qs.astype(np.float32)).reshape(-1)


def ref_dequant_q4_0(d: np.ndarray, qs: np.ndarray) -> np.ndarray:
    lo = (qs & 0xF).astype(np.int16) - 8
    hi = (qs >> 4).astype(np.int16) - 8
    q = np.concatenate([lo, hi], axis=1).astype(np.float32)
    return (d.astype(np.float32)[:, None] * q).reshape(-1)


# -- Q2_K ------------------------------------------------------------------


def _enc_q2_k(x: np.ndarray) -> bytes:
    nb = x.shape[0]
    sub = x.reshape(nb, 16, 16)  # 16 sub-blocks of 16 (logical order)
    mins = np.maximum(0.0, -sub.min(axis=2))
    maxs = sub.max(axis=2) + mins
    d = (maxs.max(axis=1) / (3 * 15)).astype(np.float16)  # scale of scales
    dmin = (mins.max(axis=1) / 15).astype(np.float16)
    ds = d.astype(np.float32)
    ds[ds == 0] = 1.0
    dm = dmin.astype(np.float32)
    dm[dm == 0] = 1.0
    m4 = np.clip(np.rint(mins / dm[:, None]), 0, 15).astype(np.uint8)
    sc_eff = maxs / 3.0
    s4 = np.clip(np.rint(sc_eff / ds[:, None]), 0, 15).astype(np.uint8)
    scales = (s4 | (m4 << 4))
    # quantize against the encoded (decoded-back) scale/min
    dl = ds[:, None] * s4
    ml = dm[:, None] * m4
    dl[dl == 0] = 1.0
    q = np.clip(np.rint((sub + ml[:, :, None]) / dl[:, :, None]), 0, 3)
    q = q.astype(np.uint8)
    # pack: halves of 128; within a half, shift j covers elements 32j..32j+31
    qs = np.zeros((nb, 64), np.uint8)
    for half in range(2):
        for j in range(4):
            seg = q.reshape(nb, 256)[:, half * 128 + 32 * j:
                                     half * 128 + 32 * (j + 1)]
            qs[:, half * 32:half * 32 + 32] |= seg << (2 * j)
    out = np.empty((nb, K_BLOCK_BYTES[GGML_Q2_K]), np.uint8)
    out[:, 0:16] = scales
    out[:, 16:80] = qs
    out[:, 80:82] = d.view(np.uint8).reshape(-1, 2)
    out[:, 82:84] = dmin.view(np.uint8).reshape(-1, 2)
    return out.tobytes()


def ref_dequant_q2_k(d, dmin, scales, qs) -> np.ndarray:
    nb = d.shape[0]
    y = np.empty((nb, 256), np.float32)
    df = d.astype(np.float32)
    mf = dmin.astype(np.float32)
    for half in range(2):
        q = qs[:, half * 32:(half + 1) * 32]
        for j in range(4):
            grp = ((q >> (2 * j)) & 3).astype(np.float32)  # (nb, 32)
            for sub in range(2):
                is_ = half * 8 + 2 * j + sub
                sc = scales[:, is_]
                dl = df * (sc & 0xF)
                ml = mf * (sc >> 4)
                seg = grp[:, sub * 16:(sub + 1) * 16]
                y[:, half * 128 + 32 * j + 16 * sub:
                  half * 128 + 32 * j + 16 * (sub + 1)] = \
                    dl[:, None] * seg - ml[:, None]
    return y.reshape(-1)


# -- Q3_K ------------------------------------------------------------------


def unpack_q3k_scales(scales: np.ndarray) -> np.ndarray:
    """12 packed bytes → 16 signed 6-bit scales (already -32), via the
    spec's three-dword shuffle."""
    aux = np.empty((scales.shape[0], 4), np.uint32)
    raw = scales.copy().view("<u4")  # (nb, 3)
    tmp = raw[:, 2]
    kmask1, kmask2 = 0x03030303, 0x0F0F0F0F
    aux[:, 0] = (raw[:, 0] & kmask2) | (((tmp >> 0) & kmask1) << 4)
    aux[:, 1] = (raw[:, 1] & kmask2) | (((tmp >> 2) & kmask1) << 4)
    aux[:, 2] = ((raw[:, 0] >> 4) & kmask2) | (((tmp >> 4) & kmask1) << 4)
    aux[:, 3] = ((raw[:, 1] >> 4) & kmask2) | (((tmp >> 6) & kmask1) << 4)
    sc = aux.view(np.int8).reshape(scales.shape[0], 16).astype(np.int32) - 32
    return sc


def _enc_q3_k(x: np.ndarray) -> bytes:
    nb = x.shape[0]
    sub = x.reshape(nb, 16, 16)
    amax = np.abs(sub).max(axis=2)
    d = (amax.max(axis=1) / (4 * 31)).astype(np.float16)
    ds = d.astype(np.float32)
    ds[ds == 0] = 1.0
    sc6 = np.clip(np.rint((amax / 4.0) / ds[:, None]), -32, 31).astype(np.int32)
    dl = ds[:, None] * sc6
    dl[dl == 0] = 1.0
    q = np.clip(np.rint(sub / dl[:, :, None]), -4, 3).astype(np.int32) + 4
    q = q.reshape(nb, 256).astype(np.uint8)  # 0..7: low 2 bits + high bit
    low = (q & 3)
    high = (q >> 2) & 1
    qs = np.zeros((nb, 64), np.uint8)
    hmask = np.zeros((nb, 32), np.uint8)
    for half in range(2):
        for j in range(4):
            seg = low[:, half * 128 + 32 * j: half * 128 + 32 * (j + 1)]
            qs[:, half * 32:half * 32 + 32] |= seg << (2 * j)
    for grp in range(8):
        hmask |= high[:, 32 * grp:32 * (grp + 1)] << grp
    # pack 16 6-bit scales (+32 offset) into 12 bytes: the inverse of
    # unpack_q3k_scales' three-dword shuffle
    v = (sc6 + 32).astype(np.uint32)  # (nb, 16), values 0..63

    def low_nibbles(cols):
        b = np.zeros(nb, np.uint32)
        for i, c in enumerate(cols):
            b |= (v[:, c] & 0xF) << (8 * i)
        return b

    raw0 = low_nibbles([0, 1, 2, 3]) | (low_nibbles([8, 9, 10, 11]) << 4)
    raw1 = low_nibbles([4, 5, 6, 7]) | (low_nibbles([12, 13, 14, 15]) << 4)
    raw2 = np.zeros(nb, np.uint32)
    for i in range(4):
        raw2 |= ((v[:, 0 + i] >> 4) & 3) << (8 * i + 0)
        raw2 |= ((v[:, 4 + i] >> 4) & 3) << (8 * i + 2)
        raw2 |= ((v[:, 8 + i] >> 4) & 3) << (8 * i + 4)
        raw2 |= ((v[:, 12 + i] >> 4) & 3) << (8 * i + 6)
    scales = np.stack([raw0, raw1, raw2], axis=1).astype("<u4").view(np.uint8)
    out = np.empty((nb, K_BLOCK_BYTES[GGML_Q3_K]), np.uint8)
    out[:, 0:32] = hmask
    out[:, 32:96] = qs
    out[:, 96:108] = scales.reshape(nb, 12)
    out[:, 108:110] = d.view(np.uint8).reshape(-1, 2)
    return out.tobytes()


def ref_dequant_q3_k(d, scales, hmask, qs) -> np.ndarray:
    nb = d.shape[0]
    sc = unpack_q3k_scales(scales)  # (nb,16) int32, -32 applied
    df = d.astype(np.float32)
    y = np.empty((nb, 256), np.float32)
    for half in range(2):
        q = qs[:, half * 32:(half + 1) * 32]
        for j in range(4):
            grp_i = half * 4 + j
            low = ((q >> (2 * j)) & 3).astype(np.int32)
            hbit = ((hmask >> grp_i) & 1).astype(np.int32)
            qv = low - np.where(hbit != 0, 0, 4)
            for sub in range(2):
                is_ = half * 8 + 2 * j + sub
                dl = df * sc[:, is_]
                seg = qv[:, sub * 16:(sub + 1) * 16].astype(np.float32)
                y[:, half * 128 + 32 * j + 16 * sub:
                  half * 128 + 32 * j + 16 * (sub + 1)] = dl[:, None] * seg
    return y.reshape(-1)


# -- Q4_K / Q5_K ------------------------------------------------------------


def unpack_k4_scales(scales: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """12 packed bytes → (sc, m): 8 six-bit scales + 8 six-bit mins."""
    q = scales.astype(np.uint16)
    sc = np.empty((scales.shape[0], 8), np.uint16)
    m = np.empty((scales.shape[0], 8), np.uint16)
    for j in range(8):
        if j < 4:
            sc[:, j] = q[:, j] & 63
            m[:, j] = q[:, j + 4] & 63
        else:
            sc[:, j] = (q[:, j + 4] & 0xF) | ((q[:, j - 4] >> 6) << 4)
            m[:, j] = (q[:, j + 4] >> 4) | ((q[:, j] >> 6) << 4)
    return sc, m


def _pack_k4_scales(sc: np.ndarray, m: np.ndarray) -> np.ndarray:
    nb = sc.shape[0]
    out = np.zeros((nb, 12), np.uint8)
    for j in range(4):
        out[:, j] = (sc[:, j] & 63) | ((sc[:, j + 4] >> 4) << 6)
        out[:, j + 4] = (m[:, j] & 63) | ((m[:, j + 4] >> 4) << 6)
        out[:, j + 8] = (sc[:, j + 4] & 0xF) | ((m[:, j + 4] & 0xF) << 4)
    return out


def _kq_scale_min(x_sub: np.ndarray, qmax: int):
    """Per-sub-block (scale, min) for absmax-style K-quant encoding."""
    mins = np.maximum(0.0, -x_sub.min(axis=2))
    maxs = x_sub.max(axis=2) + mins
    d = (maxs.max(axis=1) / (63 * qmax)).astype(np.float16)
    dmin = (mins.max(axis=1) / 63).astype(np.float16)
    ds = d.astype(np.float32)
    ds[ds == 0] = 1.0
    dm = dmin.astype(np.float32)
    dm[dm == 0] = 1.0
    sc = np.clip(np.rint((maxs / qmax) / ds[:, None]), 0, 63).astype(np.uint16)
    mn = np.clip(np.rint(mins / dm[:, None]), 0, 63).astype(np.uint16)
    return d, dmin, sc, mn


def _enc_q4_k(x: np.ndarray) -> bytes:
    nb = x.shape[0]
    sub = x.reshape(nb, 8, 32)
    d, dmin, sc, mn = _kq_scale_min(sub, 15)
    ds = d.astype(np.float32)
    dm = dmin.astype(np.float32)
    dl = ds[:, None] * sc
    ml = dm[:, None] * mn
    dl[dl == 0] = 1.0
    q = np.clip(np.rint((sub + ml[:, :, None]) / dl[:, :, None]), 0, 15)
    q = q.astype(np.uint8).reshape(nb, 256)
    qs = np.zeros((nb, 128), np.uint8)
    for j in range(4):
        lo = q[:, 64 * j:64 * j + 32]
        hi = q[:, 64 * j + 32:64 * (j + 1)]
        qs[:, 32 * j:32 * (j + 1)] = lo | (hi << 4)
    out = np.empty((nb, K_BLOCK_BYTES[GGML_Q4_K]), np.uint8)
    out[:, 0:2] = d.view(np.uint8).reshape(-1, 2)
    out[:, 2:4] = dmin.view(np.uint8).reshape(-1, 2)
    out[:, 4:16] = _pack_k4_scales(sc, mn)
    out[:, 16:] = qs
    return out.tobytes()


def ref_dequant_q4_k(d, dmin, scales, qs) -> np.ndarray:
    nb = d.shape[0]
    sc, mn = unpack_k4_scales(scales)
    df = d.astype(np.float32)
    mf = dmin.astype(np.float32)
    y = np.empty((nb, 256), np.float32)
    for j in range(4):
        q = qs[:, 32 * j:32 * (j + 1)]
        d1 = df * sc[:, 2 * j]
        m1 = mf * mn[:, 2 * j]
        d2 = df * sc[:, 2 * j + 1]
        m2 = mf * mn[:, 2 * j + 1]
        y[:, 64 * j:64 * j + 32] = d1[:, None] * (q & 0xF) - m1[:, None]
        y[:, 64 * j + 32:64 * (j + 1)] = d2[:, None] * (q >> 4) - m2[:, None]
    return y.reshape(-1)


def _enc_q5_k(x: np.ndarray) -> bytes:
    nb = x.shape[0]
    sub = x.reshape(nb, 8, 32)
    d, dmin, sc, mn = _kq_scale_min(sub, 31)
    ds = d.astype(np.float32)
    dm = dmin.astype(np.float32)
    dl = ds[:, None] * sc
    ml = dm[:, None] * mn
    dl[dl == 0] = 1.0
    q = np.clip(np.rint((sub + ml[:, :, None]) / dl[:, :, None]), 0, 31)
    q = q.astype(np.uint8).reshape(nb, 256)
    qs = np.zeros((nb, 128), np.uint8)
    qh = np.zeros((nb, 32), np.uint8)
    for j in range(4):
        q1 = q[:, 64 * j:64 * j + 32]
        q2 = q[:, 64 * j + 32:64 * (j + 1)]
        qs[:, 32 * j:32 * (j + 1)] = (q1 & 0xF) | ((q2 & 0xF) << 4)
        qh |= (q1 >> 4) << (2 * j)
        qh |= (q2 >> 4) << (2 * j + 1)
    out = np.empty((nb, K_BLOCK_BYTES[GGML_Q5_K]), np.uint8)
    out[:, 0:2] = d.view(np.uint8).reshape(-1, 2)
    out[:, 2:4] = dmin.view(np.uint8).reshape(-1, 2)
    out[:, 4:16] = _pack_k4_scales(sc, mn)
    out[:, 16:48] = qh
    out[:, 48:] = qs
    return out.tobytes()


def ref_dequant_q5_k(d, dmin, scales, qh, qs) -> np.ndarray:
    nb = d.shape[0]
    sc, mn = unpack_k4_scales(scales)
    df = d.astype(np.float32)
    mf = dmin.astype(np.float32)
    y = np.empty((nb, 256), np.float32)
    for j in range(4):
        q = qs[:, 32 * j:32 * (j + 1)]
        h1 = ((qh >> (2 * j)) & 1).astype(np.uint8)
        h2 = ((qh >> (2 * j + 1)) & 1).astype(np.uint8)
        q1 = (q & 0xF) + (h1 << 4)
        q2 = (q >> 4) + (h2 << 4)
        d1 = df * sc[:, 2 * j]
        m1 = mf * mn[:, 2 * j]
        d2 = df * sc[:, 2 * j + 1]
        m2 = mf * mn[:, 2 * j + 1]
        y[:, 64 * j:64 * j + 32] = d1[:, None] * q1 - m1[:, None]
        y[:, 64 * j + 32:64 * (j + 1)] = d2[:, None] * q2 - m2[:, None]
    return y.reshape(-1)


# -- Q6_K ------------------------------------------------------------------


def _enc_q6_k(x: np.ndarray) -> bytes:
    nb = x.shape[0]
    sub = x.reshape(nb, 16, 16)
    amax = np.abs(sub).max(axis=2)
    d = (amax.max(axis=1) / (32 * 127)).astype(np.float16)
    ds = d.astype(np.float32)
    ds[ds == 0] = 1.0
    sc = np.clip(np.rint((amax / 32.0) / ds[:, None]), -128, 127).astype(np.int8)
    dl = ds[:, None] * sc.astype(np.float32)
    dl[dl == 0] = 1.0
    q = np.clip(np.rint(sub / dl[:, :, None]), -32, 31).astype(np.int32) + 32
    q = q.reshape(nb, 256).astype(np.uint8)  # 6-bit values
    ql = np.zeros((nb, 128), np.uint8)
    qh = np.zeros((nb, 64), np.uint8)
    for half in range(2):
        base = half * 128
        q1 = q[:, base + 0:base + 32]
        q2 = q[:, base + 32:base + 64]
        q3 = q[:, base + 64:base + 96]
        q4 = q[:, base + 96:base + 128]
        ql[:, half * 64 + 0:half * 64 + 32] = (q1 & 0xF) | ((q3 & 0xF) << 4)
        ql[:, half * 64 + 32:half * 64 + 64] = (q2 & 0xF) | ((q4 & 0xF) << 4)
        qh[:, half * 32:half * 32 + 32] = (
            (q1 >> 4) | ((q2 >> 4) << 2) | ((q3 >> 4) << 4) | ((q4 >> 4) << 6))
    out = np.empty((nb, K_BLOCK_BYTES[GGML_Q6_K]), np.uint8)
    out[:, 0:128] = ql
    out[:, 128:192] = qh
    out[:, 192:208] = sc.view(np.uint8)
    out[:, 208:210] = d.view(np.uint8).reshape(-1, 2)
    return out.tobytes()


def ref_dequant_q6_k(d, sc, ql, qh) -> np.ndarray:
    nb = d.shape[0]
    df = d.astype(np.float32)
    scf = sc.astype(np.float32)
    y = np.empty((nb, 256), np.float32)
    for half in range(2):
        base = half * 128
        l = ql[:, half * 64:half * 64 + 32]
        l2 = ql[:, half * 64 + 32:half * 64 + 64]
        h = qh[:, half * 32:half * 32 + 32]
        q1 = ((l & 0xF) | (((h >> 0) & 3) << 4)).astype(np.int32) - 32
        q2 = ((l2 & 0xF) | (((h >> 2) & 3) << 4)).astype(np.int32) - 32
        q3 = ((l >> 4) | (((h >> 4) & 3) << 4)).astype(np.int32) - 32
        q4 = ((l2 >> 4) | (((h >> 6) & 3) << 4)).astype(np.int32) - 32
        for qv, col in ((q1, 0), (q2, 32), (q3, 64), (q4, 96)):
            for subi in range(2):
                is_ = half * 8 + col // 16 + subi
                seg = qv[:, subi * 16:(subi + 1) * 16].astype(np.float32)
                y[:, base + col + 16 * subi:base + col + 16 * (subi + 1)] = \
                    (df * scf[:, is_])[:, None] * seg
    return y.reshape(-1)


#: numpy reference decoders by type (normative for the dequant kernels)
REF_DEQUANT = {
    GGML_Q8_0: ref_dequant_q8_0,
    GGML_Q4_0: ref_dequant_q4_0,
    GGML_Q2_K: ref_dequant_q2_k,
    GGML_Q3_K: ref_dequant_q3_k,
    GGML_Q4_K: ref_dequant_q4_k,
    GGML_Q5_K: ref_dequant_q5_k,
    GGML_Q6_K: ref_dequant_q6_k,
}
