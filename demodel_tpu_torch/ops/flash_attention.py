"""Fused flash attention: hand-written CUDA kernels for Hopper and their
plain PyTorch version.

Counterpart of ``demodel_tpu/ops/flash_attention.py``, same public
surface and ``(B, S, H, D)`` layout: ``flash_attention(q, k, v, kv_len,
causal, scale, causal_offset, return_lse)`` with q ``(B, Sq, H, D)`` and
k/v ``(B, Sk, G, D)``, G | H (GQA). ``kv_len`` bounds the valid key
prefix and ``causal_offset`` shifts the diagonal (query i sees keys
``<= i + offset``; default ``kv_len - Sq``); both may be scalars or
per-batch vectors (ragged batched decode). A row with no visible key
comes out as zeros with an LSE of :data:`NEG_INF`.

Dispatch is by the tensors' device alone:

- CPU tensors go to :func:`_flash_plain`, the kernels' plain version
  (fp32 math, the same masking), which is what the tests compare with
  the JAX package;
- CUDA tensors go to a kernel in ``csrc/flash_attention.cu``, built
  with nvcc at first use into ``build/torch_kernels/`` and loaded with
  ctypes: bf16 and f16 at every head dim from 1 to 256 to the
  ``wgmma`` kernel (over a TMA ring, instantiated per type at the head
  dim padded to 64, 128 or 256), float32 at every head dim up to 256 to
  the 3xTF32 kernel (``mma.sync`` with every operand split into two TF32
  values, instantiated at the head dim rounded up to a multiple of 16);
  both run on the tensor cores.
  A dtype or head dim that no kernel takes (float64, D > 256), a build
  or a launch failure raises, and nothing falls back.

Gradients: where one is wanted, the call goes through
:class:`FlashAttention`, whose backward recomputes
:func:`reference_attention_lse` and takes its VJP, the JAX package's
``custom_vjp`` rule; the forward is the same one launch.

:func:`launch_plan` makes every host-side choice of a launch (checks,
kernel, windows by value or as a tensor, which TMA map reads each of q,
k and v, copies where neither can, grid and shared memory) from the
tensors' metadata alone, so the CPU tests reach it. The tensor-core
kernel reads a tensor through a 4-D map over (D, heads, rows, batch)
when its head stride is a multiple of 16 bytes, else through a 3-D row
map over (heads·D, rows, batch) when its heads are packed (OpenLLaMA-3B's
D=100: a 200-byte head stride, a 6400-byte row stride); a tensor neither
map takes is copied once into a contiguous buffer whose head dim is
padded to a multiple of 8 (``LaunchPlan.copy``). A call with int windows
and no copy is one launch and nothing else.

:data:`launches` counts kernel launches (one per call that reaches the
card) and :data:`launches_by_kernel` splits them by kernel, so a run can
show that its main path went through the tensor-core kernel.
"""

from __future__ import annotations

import ctypes
import struct
import threading
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from demodel_tpu_torch.ops import _build

NEG_INF = -1e30

#: kernel launches so far (CUDA tensors only); tests and the chip smoke
#: reset it to 0 around the run they observe
launches = 0
#: the same launches by kernel (the names :func:`kernel_for` gives)
launches_by_kernel = {"wgmma_bf16": 0, "wgmma_f16": 0, "tf32x3_f32": 0}
_launch_lock = threading.Lock()

SOURCES = (_build.CSRC / "flash_attention.cu",)
BUILD_DIR = _build.BUILD_DIR
CUDA_DEFAULT = _build.CUDA_DEFAULT
NVCC_FLAGS = _build.NVCC_FLAGS
#: padded head dims of the tensor-core kernel's instantiations, each
#: taking every D up to it
WGMMA_HEAD_DIMS = (64, 128, 256)
#: the same for the float32 (3xTF32) kernel: every multiple of 16
TF32X3_HEAD_DIMS = tuple(range(16, 257, 16))
MAX_HEAD_DIM = 256
_WGMMA = {torch.bfloat16: "wgmma_bf16", torch.float16: "wgmma_f16"}
#: kernel name → (C enum, query rows per block, threads per block)
KERNELS = {"tf32x3_f32": (0, 64, 128), "wgmma_bf16": (1, 64, 160),
           "wgmma_f16": (2, 64, 160)}
#: LaunchArgs.maps bits: q, k, v read through the row map
_ROW_MAP_BITS = (1, 2, 4)
#: K/V ring depth of both kernels
STAGES = 2
#: keys per K/V tile of the float32 kernel, and the floats past the padded
#: head dim in each of its shared-memory rows of Q and K (where the head
#: dim is a multiple of 32), and of V
F32_KEYS = 32
F32_PAD_QK = 16
F32_PAD_V = 4
_INT32 = (-2 ** 31, 2 ** 31 - 1)


# ------------------------------------------------------------- reference


def _windows(kv_len, causal_offset, B: int, Sq: int, Sk: int,
             device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-batch int32 ``(kv_len, causal_offset)`` vectors, shape (B,):
    scalars broadcast across the batch, ``kv_len`` defaults to Sk and
    ``causal_offset`` to ``kv_len - Sq``. A Python int becomes a fill on
    ``device`` — no host-to-device copy, which would wait for the
    stream on every call."""

    def vec(x) -> torch.Tensor:
        if isinstance(x, (int, np.integer)):
            return torch.full((B,), int(x), dtype=torch.int32, device=device)
        t = torch.as_tensor(x, dtype=torch.int32)
        return t.to(device).expand(B).contiguous()

    kv = vec(Sk if kv_len is None else kv_len)
    off = kv - Sq if causal_offset is None else vec(causal_offset)
    return kv, off


def _mask(kvb: torch.Tensor, offb: torch.Tensor, Sq: int, Sk: int,
          causal: bool) -> torch.Tensor:
    """(B, 1, Sq, Sk) visibility: key < kv_len, and key <= query + offset
    when causal."""
    ki = torch.arange(Sk, device=kvb.device)[None, None, None, :]
    qi = torch.arange(Sq, device=kvb.device)[None, None, :, None]
    mask = ki < kvb[:, None, None, None]
    if causal:
        mask = mask & (ki <= qi + offb[:, None, None, None])
    return mask


def reference_attention_lse(q, k, v, causal: bool = True, scale=None,
                            kv_len=None, causal_offset=None):
    """Einsum attention (GQA-aware) returning ``(out, lse)``, the
    numerics oracle of the JAX package: scores in q's dtype then fp32,
    probabilities back in q's dtype. A row with no visible key averages
    V (softmax over all-NEG_INF scores), as the JAX reference does."""
    B, Sq, H, D = q.shape
    Sk, G = k.shape[1], k.shape[2]
    if G != H:
        k = k.repeat_interleave(H // G, dim=2)
        v = v.repeat_interleave(H // G, dim=2)
    if scale is None:
        scale = D ** -0.5
    kvb, offb = _windows(kv_len, causal_offset, B, Sq, Sk, q.device)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    scores = scores.masked_fill(~_mask(kvb, offb, Sq, Sk, causal), NEG_INF)
    lse = torch.logsumexp(scores, dim=-1)             # (B, H, Sq)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v)
    return out, lse.transpose(1, 2)                   # lse → (B, Sq, H)


def reference_attention(q, k, v, causal: bool = True, scale=None,
                        kv_len=None, causal_offset=None):
    return reference_attention_lse(q, k, v, causal, scale, kv_len,
                                   causal_offset)[0]


def _flash_plain(q, k, v, kvb, offb, causal: bool, scale: float):
    """What the kernel computes, in plain PyTorch: fp32 scores, softmax
    and accumulation, output in q's dtype, and rows with no visible key
    set to zeros with an LSE of NEG_INF (the kernel's ``l == 0`` rule).
    A row sees a key iff key 0 is visible: ``kv_len > 0``, ``Sk > 0``
    and, when causal, ``row + offset >= 0``."""
    Sq, Sk = q.shape[1], k.shape[1]
    out, lse = reference_attention_lse(q.float(), k.float(), v.float(),
                                       causal, scale, kvb, offb)
    seen = (kvb > 0)[:, None] & (Sk > 0)                       # (B, 1)
    if causal:
        seen = seen & (torch.arange(Sq, device=q.device)[None, :]
                       + offb[:, None] >= 0)                   # (B, Sq)
    seen = seen.expand(q.shape[0], Sq)
    out = torch.where(seen[:, :, None, None], out, 0.0).to(q.dtype)
    lse = torch.where(seen[:, :, None], lse, NEG_INF)
    return out, lse


# ---------------------------------------------------------------- kernel


def build_library() -> Path:
    """Compile ``csrc/flash_attention.cu`` for sm_90a (once per content;
    see :mod:`demodel_tpu_torch.ops._build`). Raises on a missing nvcc or
    a failed compile."""
    return _build.build_library("demodel_flash", SOURCES, NVCC_FLAGS,
                                BUILD_DIR, CUDA_DEFAULT)


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.demodel_flash_attention_fwd
    fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int


_LIB = _build.LazyLibrary(build_library, _bind)


def _library() -> ctypes.CDLL:
    return _LIB.get()


#: ``LaunchArgs`` of csrc/flash_attention.cu, field by field (int64 each,
#: then the double ``scale``)
ARG_FIELDS = ("q", "k", "v", "o", "lse", "win", "kv_len", "causal_offset",
              "B", "Sq", "Sk", "H", "G", "D",
              "q_sb", "q_ss", "q_sh", "k_sb", "k_ss", "k_sh",
              "v_sb", "v_ss", "v_sh", "o_sb", "o_ss", "o_sh",
              "causal", "kernel", "maps", "grid_x", "threads", "smem",
              "device", "scale")
_ARGS = struct.Struct(f"<{len(ARG_FIELDS) - 1}qd")


class LaunchPlan(NamedTuple):
    """Every host-side choice of one kernel launch."""

    kernel: str                    # :data:`launches_by_kernel` key
    code: int                      # the C side's kernel enum
    grid: tuple[int, int, int]     # (q tiles, H, B)
    threads: int
    smem_bytes: int
    #: "scalar": kv_len / causal_offset go by value; "vector": as an
    #: int32 (2, B) tensor on the card
    windows: str
    kv_len: int                    # scalar windows only (else 0)
    causal_offset: int
    #: q, k, v: copy first (bf16/f16: contiguous, the head dim padded to
    #: a multiple of 8, where neither TMA map reads the tensor in place;
    #: float32: contiguous where the last stride is not 1)
    copy: tuple[bool, bool, bool]
    #: q, k, v: how the ``wgmma`` kernel reads each (after any copy):
    #: "4d" (D, heads, rows, batch) or "rows" (heads·D, rows, batch);
    #: "strides" for the float32 kernel, which reads through strides
    maps: tuple[str, str, str]


def _as_int(x) -> int | None:
    if isinstance(x, (int, np.integer)) and not isinstance(x, bool):
        x = int(x)
        if not _INT32[0] <= x <= _INT32[1]:
            raise ValueError(f"window {x} out of int32 range")
        return x
    return None


def tma_map(t: torch.Tensor) -> str | None:
    """How the tensor-core kernel's TMA maps read the 2-byte ``t``
    ``(B, S, heads, D)`` in place, or None: both maps need a unit last
    stride, a 16-byte aligned base and row and batch strides that are
    multiples of 16 bytes (8 elements); the 4-D map ("4d") a head stride
    that is one too. The row map ("rows") needs packed heads (head
    stride D, or one head): a head's tile starts at its first column
    rounded down to a multiple of 8, so the head sits up to 7 columns in
    and those plus D must fit the padded head dim."""
    B, S, heads, D = t.shape
    sb, ss, sh, sd = t.stride()
    if sd != 1 or (sb | ss) % 8 or t.data_ptr() % 16:
        return None
    if sh % 8 == 0:
        return "4d"
    if heads == 1:
        return "rows"
    shift = max((h * sh) % 8 for h in range(min(heads, 8)))
    if sh == D and D + shift <= padded_head_dim("wgmma", D):
        return "rows"
    return None


def _pad8(t: torch.Tensor) -> torch.Tensor:
    """``t`` copied into a contiguous zero buffer whose head dim is padded
    to a multiple of 8, as a view of its first D columns: the 4-D map
    reads it (every stride a multiple of 16 bytes)."""
    D = t.shape[3]
    buf = t.new_zeros((*t.shape[:3], -(-D // 8) * 8))
    buf[..., :D] = t
    return buf[..., :D]


def kernel_for(dtype: torch.dtype, D: int) -> str:
    """The kernel that takes ``dtype`` at head dim ``D``: bf16 and f16 on
    ``wgmma``, float32 on the 3xTF32 ``mma.sync`` kernel, each at every
    head dim from 1 to :data:`MAX_HEAD_DIM`. Raises on what no kernel
    takes."""
    if dtype != torch.float32 and dtype not in _WGMMA:
        raise TypeError(f"flash kernel takes float32, bfloat16 or float16, "
                        f"got {dtype}")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"flash kernel takes head dims 1..{MAX_HEAD_DIM}, "
                         f"got {D}")
    return _WGMMA.get(dtype, "tf32x3_f32")


def padded_head_dim(kernel: str, D: int) -> int:
    """The instantiation of ``kernel`` that takes head dim ``D``."""
    dims = WGMMA_HEAD_DIMS if kernel.startswith("wgmma") else \
        TF32X3_HEAD_DIMS
    return next(dp for dp in dims if D <= dp)


def smem_bytes(kernel: str, D: int) -> int:
    """Dynamic shared memory of one block at the padded head dim (mirrors
    csrc's ``tc_smem_bytes``, 164,864 bytes at 256, and
    ``f32_smem_bytes``: the Q tile and the K ring in rows of DP + 16
    floats where DP is a multiple of 32, else DP (``f32_ld_qk``), the V
    ring in rows of DP + 4; 205,824 bytes at 256)."""
    dp = padded_head_dim(kernel, D)
    _, rows, _ = KERNELS[kernel]
    if kernel.startswith("wgmma"):
        return rows * dp * 2 * (1 + 2 * STAGES) + 1024
    ld_qk = dp + F32_PAD_QK if dp % 32 == 0 else dp
    return 4 * (ld_qk * (rows + STAGES * F32_KEYS)
                + (dp + F32_PAD_V) * STAGES * F32_KEYS)


def launch_plan(q, k, v, kv_len=None, causal_offset=None) -> LaunchPlan:
    """The launch for q ``(B, Sq, H, D)`` and k/v ``(B, Sk, G, D)`` of one
    dtype on one device, from their metadata alone (no launch, no device
    work). Raises on what no kernel takes."""
    B, Sq, H, D = q.shape
    Sk, G = k.shape[1], k.shape[2]
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes q, k, v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    kernel = kernel_for(q.dtype, D)
    if not (k.device == v.device == q.device):
        raise ValueError("q, k and v must be on one device")
    if H > 65535 or B > 65535:
        raise ValueError(f"grid too large: B={B}, H={H}")
    code, rows, threads = KERNELS[kernel]
    if kernel.startswith("wgmma"):
        found = [tma_map(t) for t in (q, k, v)]
        # q's and k's heads must sit at one shift into their tiles: the
        # row map takes them only together, with one kv head per q head
        if "rows" in found[:2] and (found[0] != found[1] or H != G):
            found[:2] = [None if m == "rows" else m for m in found[:2]]
        copy = tuple(m is None for m in found)
        maps = tuple(m or "4d" for m in found)
    else:
        copy = tuple(t.stride(-1) != 1 for t in (q, k, v))
        maps = ("strides",) * 3
    kv = Sk if kv_len is None else _as_int(kv_len)
    off = None
    if kv is not None:
        off = kv - Sq if causal_offset is None else _as_int(causal_offset)
    if kv is not None and off is not None:
        windows, kv, off = "scalar", kv, off
    else:
        windows, kv, off = "vector", 0, 0
    return LaunchPlan(kernel=kernel, code=code,
                      grid=(-(-Sq // rows), H, B), threads=threads,
                      smem_bytes=smem_bytes(kernel, D), windows=windows,
                      kv_len=kv, causal_offset=off, copy=copy, maps=maps)


def _flash_cuda(q, k, v, kv_len, causal_offset, causal: bool, scale: float,
                with_lse: bool):
    """Launch the planned kernel on the current stream (no synchronise):
    one launch, plus the (2, B) window tensor only for vector windows."""
    global launches
    plan = launch_plan(q, k, v, kv_len, causal_offset)
    if any(plan.copy):
        copy = _pad8 if plan.kernel.startswith("wgmma") else \
            torch.Tensor.contiguous
        q, k, v = (copy(t) if c else t for t, c in zip((q, k, v), plan.copy))
    B, Sq, H, D = q.shape
    Sk, G = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, Sq, H), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if B == 0 or Sq == 0 or H == 0:
        return out, lse
    lib = _library()
    win = None
    if plan.windows == "vector":
        win = torch.stack(_windows(kv_len, causal_offset, B, Sq, Sk,
                                   q.device))  # (2, B) int32
    device = q.device.index if q.device.index is not None else \
        torch.cuda.current_device()
    args = _ARGS.pack(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        0 if lse is None else lse.data_ptr(),
        0 if win is None else win.data_ptr(),
        plan.kv_len, plan.causal_offset, B, Sq, Sk, H, G, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], int(causal), plan.code,
        sum(bit for bit, m in zip(_ROW_MAP_BITS, plan.maps) if m == "rows"),
        plan.grid[0], plan.threads, plan.smem_bytes, device, float(scale))
    err = lib.demodel_flash_attention_fwd(
        args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: "
                           f"cudaError {err}")
    with _launch_lock:
        launches += 1
        launches_by_kernel[plan.kernel] += 1
    return out, lse


def _flash_forward(q, k, v, kv_len, causal_offset, causal: bool,
                   scale: float, with_lse: bool):
    """The forward on ``q``'s device: the plain version for CPU tensors,
    one kernel launch for CUDA tensors."""
    if q.device.type == "cpu":
        B, Sq, Sk = q.shape[0], q.shape[1], k.shape[1]
        kvb, offb = _windows(kv_len, causal_offset, B, Sq, Sk, q.device)
        return _flash_plain(q, k, v, kvb, offb, causal, scale)
    return _flash_cuda(q, k, v, kv_len, causal_offset, causal, scale,
                       with_lse)


class FlashAttention(torch.autograd.Function):
    """K1 with the JAX package's ``custom_vjp`` rule (``_flash_core``):
    the forward is :func:`_flash_forward` (one launch on the card), the
    backward recomputes :func:`reference_attention_lse` on the saved
    inputs with the same windows and takes its VJP, in ``(g_out, g_lse)``
    when the LSE is returned and in ``g_out`` alone otherwise. There is no
    backward kernel: the JAX package has none either. The integer windows
    get no gradient. A row with no visible key gets the reference's
    gradient (softmax over all-masked scores averages V), as in JAX, not
    the gradient of the forward's zeros."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, causal_offset, causal, scale,
                return_lse):
        out, lse = _flash_forward(q, k, v, kv_len, causal_offset, causal,
                                  scale, return_lse)
        ctx.save_for_backward(q, k, v)
        ctx.windows = (kv_len, causal_offset)
        ctx.causal, ctx.scale = causal, scale
        return (out, lse) if return_lse else out

    @staticmethod
    def backward(ctx, g_out, g_lse=None):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in (q, k, v)]
            out, lse = reference_attention_lse(*inputs, ctx.causal,
                                               ctx.scale, *ctx.windows)
            outs, grads = [out], [g_out]
            if g_lse is not None:
                outs.append(lse)
                grads.append(g_lse)
            dq, dk, dv = torch.autograd.grad(outs, inputs, grads)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, kv_len=None, causal: bool = True, scale=None,
                    causal_offset=None, return_lse: bool = False):
    """Fused attention. q: (B, Sq, H, D); k/v: (B, Sk, G, D) with G | H.
    Returns (B, Sq, H, D) in q's dtype (plus the per-row log-sum-exp,
    (B, Sq, H) fp32, when ``return_lse``). k and v in another dtype than
    q are promoted with q, as the JAX kernel reads every tile in fp32.
    Where a gradient is wanted (grad mode on and q, k or v requiring it)
    the call goes through :class:`FlashAttention`, which saves q, k and v
    for its recompute backward; otherwise it is the forward alone."""
    B, Sq, H, D = q.shape
    G = k.shape[2]
    if G == 0 or H % G != 0:
        raise ValueError(f"q heads {H} not a multiple of kv heads {G}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if scale is None:
        scale = D ** -0.5
    out_dtype = q.dtype
    if not (k.dtype == v.dtype == q.dtype):
        dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype),
                                 v.dtype)
        q, k, v = q.to(dt), k.to(dt), v.to(dt)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        res = FlashAttention.apply(q, k, v, kv_len, causal_offset, causal,
                                   scale, return_lse)
        out, lse = res if return_lse else (res, None)
    else:
        out, lse = _flash_forward(q, k, v, kv_len, causal_offset, causal,
                                  scale, return_lse)
    if out.dtype != out_dtype:
        out = out.to(out_dtype)
    return (out, lse) if return_lse else out
