"""GGUF dequantization: hand-written CUDA kernels for Hopper and their
plain PyTorch versions.

Counterpart of ``demodel_tpu/ops/dequant.py``, same public surface and
parts signatures: ``dequant_q8_0(d, qs)``, ``dequant_q4_0(d, qs)``,
``dequant_q2_k(d, dmin, scales, qs)``, ``dequant_q3_k(d, scales, hmask,
qs)``, ``dequant_q4_k(d, dmin, scales, qs)``, ``dequant_q5_k(d, dmin,
scales, qh, qs)``, ``dequant_q6_k(d, sc, ql, qh)``, each returning the
flat ``(nb * values-per-block,)`` tensor in ``out_dtype`` (bf16 by
default), plus :data:`_FNS` and :func:`dequant_gguf_tensor`. The parts
are what :func:`demodel_tpu_torch.formats.gguf.decode_raw` splits a
tensor's blocks into.

Dispatch is by the tensors' device alone:

- CPU tensors go to the plain version (``_q8_0_math`` ... ``_q6_k_math``,
  fp32 math then a cast), which is what the tests compare with the JAX
  package;
- CUDA tensors go to the kernels in ``csrc/dequant.cu``, built with nvcc
  at first use and loaded with ctypes. A build or launch failure raises;
  nothing falls back, and there is no switch that picks the plain
  version on the card;
- any other device raises ``ValueError``.

``nb == 0`` returns an empty tensor without a launch. :data:`launches`
counts kernel launches per format, so a run can show that its main path
went through the kernels.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from demodel_tpu_torch.device import resolve
from demodel_tpu_torch.formats import gguf
from demodel_tpu_torch.ops import _build

#: kernel launches so far per format (CUDA tensors only); the chip smoke
#: resets the counts to 0 around the run it observes
launches = {"q8_0": 0, "q4_0": 0, "q2_k": 0, "q3_k": 0, "q4_k": 0,
            "q5_k": 0, "q6_k": 0}
_launch_lock = threading.Lock()

SOURCES = (_build.CSRC / "dequant.cu",)
BUILD_DIR = _build.BUILD_DIR
CUDA_DEFAULT = _build.CUDA_DEFAULT
#: no FMA contraction: `dl * q - ml` rounds twice, as the plain version's
#: two elementwise operations do, so the kernels match it bit for bit
NVCC_FLAGS = _build.NVCC_FLAGS + ("--fmad=false",)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: ggml type id of each K-quant, the format argument of the k_quant kernel
_GGML_TYPE = {"q2_k": gguf.GGML_Q2_K, "q3_k": gguf.GGML_Q3_K,
              "q4_k": gguf.GGML_Q4_K, "q5_k": gguf.GGML_Q5_K,
              "q6_k": gguf.GGML_Q6_K}
_F16, _U8, _I8 = torch.float16, torch.uint8, torch.int8
#: each format's parts as decode_raw gives them: (dtype, row width), a
#: width of None for the (nb,) scale vectors
_PARTS = {
    "q8_0": ((_F16, None), (_I8, gguf.QK)),
    "q4_0": ((_F16, None), (_U8, gguf.QK // 2)),
    "q2_k": ((_F16, None), (_F16, None), (_U8, 16), (_U8, 64)),
    "q3_k": ((_F16, None), (_U8, 12), (_U8, 32), (_U8, 64)),
    "q4_k": ((_F16, None), (_F16, None), (_U8, 12), (_U8, 128)),
    "q5_k": ((_F16, None), (_F16, None), (_U8, 12), (_U8, 32), (_U8, 128)),
    "q6_k": ((_F16, None), (_I8, 16), (_U8, 128), (_U8, 64)),
}


# ------------------------------------------------------------ plain math


def _q8_0_math(d, qs, out_dtype):
    return (d.float()[:, None] * qs.float()).to(out_dtype)


def _q4_0_math(d, qs, out_dtype):
    qs = qs.to(torch.int32)
    lo = (qs & 0xF) - 8
    hi = (qs >> 4) - 8
    q = torch.cat([lo, hi], dim=-1).float()
    return (d.float()[:, None] * q).to(out_dtype)


def _q2_k_math(d, dmin, scales, qs, out_dtype):
    nb = d.shape[0]
    df, mf = d.float(), dmin.float()
    scales = scales.to(torch.int32)
    qs = qs.to(torch.int32)
    cols = []
    for half in range(2):
        q = qs[:, half * 32:(half + 1) * 32]
        for j in range(4):
            grp = (q >> (2 * j)) & 3
            for sub in range(2):
                sc = scales[:, half * 8 + 2 * j + sub]
                dl = df * (sc & 0xF).float()
                ml = mf * (sc >> 4).float()
                seg = grp[:, sub * 16:(sub + 1) * 16].float()
                cols.append(dl[:, None] * seg - ml[:, None])
    # cols are in y-order by construction: (half, j, sub)
    return torch.cat(cols, dim=1).reshape(nb, 256).to(out_dtype)


def _q3_k_scales(scales):
    """12 packed bytes → 16 signed 6-bit scales, -32 applied (the spec's
    three-dword shuffle; dwords in int64 so no shift reaches a sign)."""
    s = scales.to(torch.int64)

    def dword(i):
        return (s[:, 4 * i] | (s[:, 4 * i + 1] << 8) | (s[:, 4 * i + 2] << 16)
                | (s[:, 4 * i + 3] << 24))

    raw0, raw1, tmp = dword(0), dword(1), dword(2)
    kmask1, kmask2 = 0x03030303, 0x0F0F0F0F
    aux0 = (raw0 & kmask2) | (((tmp >> 0) & kmask1) << 4)
    aux1 = (raw1 & kmask2) | (((tmp >> 2) & kmask1) << 4)
    aux2 = ((raw0 >> 4) & kmask2) | (((tmp >> 4) & kmask1) << 4)
    aux3 = ((raw1 >> 4) & kmask2) | (((tmp >> 6) & kmask1) << 4)
    bytes_ = [(aux >> shift) & 0xFF
              for aux in (aux0, aux1, aux2, aux3) for shift in (0, 8, 16, 24)]
    sc = torch.stack(bytes_, dim=1).to(torch.int32)
    sc = torch.where(sc >= 128, sc - 256, sc)  # int8 reinterpret
    return sc - 32


def _q3_k_math(d, scales, hmask, qs, out_dtype):
    nb = d.shape[0]
    df = d.float()
    sc = _q3_k_scales(scales)
    hmask = hmask.to(torch.int32)
    qs = qs.to(torch.int32)
    cols = []
    for half in range(2):
        q = qs[:, half * 32:(half + 1) * 32]
        for j in range(4):
            low = (q >> (2 * j)) & 3
            hbit = (hmask >> (half * 4 + j)) & 1
            qv = low - torch.where(hbit != 0, 0, 4)
            for sub in range(2):
                dl = df * sc[:, half * 8 + 2 * j + sub].float()
                seg = qv[:, sub * 16:(sub + 1) * 16].float()
                cols.append(dl[:, None] * seg)
    return torch.cat(cols, dim=1).reshape(nb, 256).to(out_dtype)


def _k4_scales(scales):
    """(nb, 12) packed bytes → (sc, m), each (nb, 8) six-bit values."""
    q = scales.to(torch.int32)
    sc, m = [], []
    for j in range(8):
        if j < 4:
            sc.append(q[:, j] & 63)
            m.append(q[:, j + 4] & 63)
        else:
            sc.append((q[:, j + 4] & 0xF) | (((q[:, j - 4] >> 6) & 3) << 4))
            m.append((q[:, j + 4] >> 4) | (((q[:, j] >> 6) & 3) << 4))
    return torch.stack(sc, dim=1), torch.stack(m, dim=1)


def _q4_k_math(d, dmin, scales, qs, out_dtype):
    nb = d.shape[0]
    df, mf = d.float(), dmin.float()
    sc, mn = _k4_scales(scales)
    qs = qs.to(torch.int32)
    cols = []
    for j in range(4):
        q = qs[:, 32 * j:32 * (j + 1)]
        d1, m1 = df * sc[:, 2 * j].float(), mf * mn[:, 2 * j].float()
        d2, m2 = df * sc[:, 2 * j + 1].float(), mf * mn[:, 2 * j + 1].float()
        cols.append(d1[:, None] * (q & 0xF).float() - m1[:, None])
        cols.append(d2[:, None] * (q >> 4).float() - m2[:, None])
    return torch.cat(cols, dim=1).reshape(nb, 256).to(out_dtype)


def _q5_k_math(d, dmin, scales, qh, qs, out_dtype):
    nb = d.shape[0]
    df, mf = d.float(), dmin.float()
    sc, mn = _k4_scales(scales)
    qh = qh.to(torch.int32)
    qs = qs.to(torch.int32)
    cols = []
    for j in range(4):
        q = qs[:, 32 * j:32 * (j + 1)]
        q1 = (q & 0xF) + (((qh >> (2 * j)) & 1) << 4)
        q2 = (q >> 4) + (((qh >> (2 * j + 1)) & 1) << 4)
        d1, m1 = df * sc[:, 2 * j].float(), mf * mn[:, 2 * j].float()
        d2, m2 = df * sc[:, 2 * j + 1].float(), mf * mn[:, 2 * j + 1].float()
        cols.append(d1[:, None] * q1.float() - m1[:, None])
        cols.append(d2[:, None] * q2.float() - m2[:, None])
    return torch.cat(cols, dim=1).reshape(nb, 256).to(out_dtype)


def _q6_k_math(d, sc, ql, qh, out_dtype):
    nb = d.shape[0]
    df = d.float()
    scf = sc.float()
    ql = ql.to(torch.int32)
    qh = qh.to(torch.int32)
    cols = []
    for half in range(2):
        l1 = ql[:, half * 64:half * 64 + 32]
        l2 = ql[:, half * 64 + 32:half * 64 + 64]
        h = qh[:, half * 32:half * 32 + 32]
        q1 = ((l1 & 0xF) | (((h >> 0) & 3) << 4)) - 32
        q2 = ((l2 & 0xF) | (((h >> 2) & 3) << 4)) - 32
        q3 = ((l1 >> 4) | (((h >> 4) & 3) << 4)) - 32
        q4 = ((l2 >> 4) | (((h >> 6) & 3) << 4)) - 32
        for qv, col in ((q1, 0), (q2, 32), (q3, 64), (q4, 96)):
            for subi in range(2):
                dl = df * scf[:, half * 8 + col // 16 + subi]
                seg = qv[:, subi * 16:(subi + 1) * 16].float()
                cols.append(dl[:, None] * seg)
    return torch.cat(cols, dim=1).reshape(nb, 256).to(out_dtype)


# ---------------------------------------------------------------- kernel


def build_library():
    """Compile ``csrc/dequant.cu`` for sm_90a (once per content; see
    :mod:`demodel_tpu_torch.ops._build`). Raises on a missing nvcc or a
    failed compile."""
    return _build.build_library("demodel_dequant", SOURCES, NVCC_FLAGS,
                                BUILD_DIR, CUDA_DEFAULT)


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name in ("demodel_dequant_q8_0", "demodel_dequant_q4_0"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, ll, i, p]
        fn.restype = i
    fn = lib.demodel_dequant_k_quant
    fn.argtypes = [i, p, p, p, p, p, p, ll, i, p]
    fn.restype = i


_LIB = _build.LazyLibrary(build_library, _bind)


def _library() -> ctypes.CDLL:
    return _LIB.get()


def _dense(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned, as the kernels' vector loads need."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(fmt: str, parts, out_dtype, values: int):
    """Check the parts against the format's layout and launch its kernel
    on the current stream (no synchronise)."""
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"dequant kernel writes float32 or bfloat16, got "
                        f"{out_dtype}")
    dev = parts[0].device
    nb = parts[0].shape[0]
    layout = _PARTS[fmt]
    if len(parts) != len(layout):
        raise ValueError(f"dequant_{fmt}: {len(parts)} parts, want "
                         f"{len(layout)}")
    for k, (t, (dtype, w)) in enumerate(zip(parts, layout)):
        if t.device != dev:
            raise ValueError(f"dequant_{fmt}: parts on {t.device} and {dev}")
        shape = (nb,) if w is None else (nb, w)
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"dequant_{fmt}: part {k} is {tuple(t.shape)} "
                             f"{t.dtype}, want {shape} {dtype}")
    parts = [_dense(t) for t in parts]
    out = torch.empty(nb * values, dtype=out_dtype, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = [t.data_ptr() for t in parts]
        code = _DTYPE_CODE[out_dtype]
        if fmt in ("q8_0", "q4_0"):
            err = getattr(lib, f"demodel_dequant_{fmt}")(
                *ptrs, out.data_ptr(), nb, code, stream)
        else:
            ptrs += [None] * (5 - len(ptrs))
            err = lib.demodel_dequant_k_quant(
                _GGML_TYPE[fmt], *ptrs, out.data_ptr(), nb, code, stream)
    if err != 0:
        raise RuntimeError(f"dequant_{fmt} kernel launch failed: "
                           f"cudaError {err}")
    with _launch_lock:
        launches[fmt] += 1
    return out


def _dispatch(fmt: str, math_fn, parts, out_dtype, values: int):
    dev = parts[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"dequant_{fmt}: unsupported device {dev}")
    if parts[0].shape[0] == 0:
        return torch.empty(0, dtype=out_dtype, device=dev)
    if dev.type == "cpu":
        return math_fn(*parts, out_dtype).reshape(-1)
    return _launch(fmt, parts, out_dtype, values)


def dequant_q8_0(d, qs, out_dtype=torch.bfloat16):
    """d: (nb,) f16, qs: (nb, 32) i8 → flat (nb*32,) out_dtype."""
    return _dispatch("q8_0", _q8_0_math, (d, qs), out_dtype,
                     gguf.QK)


def dequant_q4_0(d, qs, out_dtype=torch.bfloat16):
    """d: (nb,) f16, qs: (nb, 16) u8 → flat (nb*32,) out_dtype."""
    return _dispatch("q4_0", _q4_0_math, (d, qs), out_dtype,
                     gguf.QK)


def dequant_q2_k(d, dmin, scales, qs, out_dtype=torch.bfloat16):
    return _dispatch("q2_k", _q2_k_math, (d, dmin, scales, qs), out_dtype,
                     gguf.QK_K)


def dequant_q3_k(d, scales, hmask, qs, out_dtype=torch.bfloat16):
    return _dispatch("q3_k", _q3_k_math, (d, scales, hmask, qs), out_dtype,
                     gguf.QK_K)


def dequant_q4_k(d, dmin, scales, qs, out_dtype=torch.bfloat16):
    return _dispatch("q4_k", _q4_k_math, (d, dmin, scales, qs), out_dtype,
                     gguf.QK_K)


def dequant_q5_k(d, dmin, scales, qh, qs, out_dtype=torch.bfloat16):
    return _dispatch("q5_k", _q5_k_math, (d, dmin, scales, qh, qs), out_dtype,
                     gguf.QK_K)


def dequant_q6_k(d, sc, ql, qh, out_dtype=torch.bfloat16):
    return _dispatch("q6_k", _q6_k_math, (d, sc, ql, qh), out_dtype,
                     gguf.QK_K)


# ------------------------------------------------------------- whole tensor

_FNS = {
    gguf.GGML_Q8_0: dequant_q8_0,
    gguf.GGML_Q4_0: dequant_q4_0,
    gguf.GGML_Q2_K: dequant_q2_k,
    gguf.GGML_Q3_K: dequant_q3_k,
    gguf.GGML_Q4_K: dequant_q4_k,
    gguf.GGML_Q5_K: dequant_q5_k,
    gguf.GGML_Q6_K: dequant_q6_k,
}


def to_device(a, device: torch.device) -> torch.Tensor:
    """A part from ``decode_raw`` (a numpy view, maybe strided or
    read-only) as a dense tensor on ``device``; a tensor moves as is."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(np.array(a, copy=True, order="C")).to(device)


def dequant_gguf_tensor(t: gguf.GGUFTensor, decoded,
                        out_dtype=torch.bfloat16,
                        device: str | torch.device | None = None
                        ) -> torch.Tensor:
    """Whole-tensor dequant (the sink's non-shardwise fallback path):
    ``decoded`` from ``decode_raw`` lands on ``device`` (CUDA unless the
    caller asks for the CPU) and comes back in ``t.shape``."""
    dev = resolve(device)
    if t.ggml_type in (gguf.GGML_F32, gguf.GGML_F16):
        return to_device(decoded, dev).to(out_dtype)
    fn = _FNS[t.ggml_type]
    flat = fn(*[to_device(p, dev) for p in decoded], out_dtype)
    return flat.reshape(t.shape)
