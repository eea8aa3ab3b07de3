// GGUF dequantization for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of demodel_tpu/ops/dequant.py:
//   demodel_dequant_q8_0    <- `_q8_0_kernel` (launched by `dequant_q8_0`)
//   demodel_dequant_q4_0    <- `_q4_0_kernel` (launched by `dequant_q4_0`)
//   demodel_dequant_k_quant <- `_k_quant_call`'s `kernel` over `_q2_k_math`,
//                              `_q3_k_math`, `_q4_k_math`, `_q5_k_math` and
//                              `_q6_k_math` (one template, five formats)
// Each reads the dense "parts" that formats/gguf.py `decode_raw` splits a
// tensor's packed blocks into (f16 scales first, then byte rows) and writes
// the flat (blocks * values-per-block,) output in f32 or bf16.
//
// What bounds it. Every output value takes a handful of integer and float
// operations on data read once, so the kernels are pure streams: the least
// time is (quantized bytes in + output bytes) / 3.35 TB/s. At the Llama-2-7B
// ffn_gate shape (11008 x 4096, bf16 out) that is 0.03-0.04 ms; the output
// is 3.5-7x the input, so the stores dominate.
//
// What the design does about it. One pass, no tiles and no padding: each
// thread produces 8 (K-quants) or 16 (Q8_0, Q4_0) consecutive outputs of one
// block from one 8- or 16-byte vector load per part, and writes them with
// 16-byte stores, so a warp stores one contiguous 512-byte run. The ragged
// tail is bounded in the kernel, so the TPU path's padding to 256-row tiles
// and the slice after it are gone. For the K-quants one warp owns one
// 256-value super-block: the packed 6-bit scales (Q3_K's 12-byte shuffle,
// Q4_K/Q5_K's scale/min pairs) are unpacked once per super-block, one value
// per lane, and each lane takes the one its outputs use with a warp shuffle.
//
// Why CUDA and not Triton. Both would do for a fused elementwise pass. The
// byte-level unpacking here wants per-lane vector loads and warp shuffles,
// which CUDA states directly, and CUDA keeps one build route (nvcc into a
// plain C library, as for the flash kernel) with no dependence on the
// triton package.
//
// Arithmetic. Built with --fmad=false: `dl * q - ml` rounds after the
// multiply and after the subtraction, as the plain PyTorch version (two
// elementwise operations) does, so kernel and plain version agree bit for
// bit in f32; the bf16 cast is round-to-nearest-even in both.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// ggml type ids (formats/gguf.py)
constexpr int kQ2K = 10;
constexpr int kQ3K = 11;
constexpr int kQ4K = 12;
constexpr int kQ5K = 13;
constexpr int kQ6K = 14;

__device__ __forceinline__ unsigned pack_bf16(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // .x (a) at the low address
  return *reinterpret_cast<unsigned*>(&h);
}

// Store 8 consecutive outputs: 16 bytes of bf16 or 32 bytes of f32.
__device__ __forceinline__ void store8(float* out, const float (&v)[8]) {
  float4* o = reinterpret_cast<float4*>(out);
  o[0] = make_float4(v[0], v[1], v[2], v[3]);
  o[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* out,
                                       const float (&v)[8]) {
  uint4 w;
  w.x = pack_bf16(v[0], v[1]);
  w.y = pack_bf16(v[2], v[3]);
  w.z = pack_bf16(v[4], v[5]);
  w.w = pack_bf16(v[6], v[7]);
  *reinterpret_cast<uint4*>(out) = w;
}

// Byte k (0..7) of an 8-byte load; k is a constant after unrolling.
__device__ __forceinline__ int byte_of(uint2 w, int k) {
  return static_cast<int>(((k < 4 ? w.x : w.y) >> (8 * (k & 3))) & 0xffu);
}

__device__ __forceinline__ uint2 load8(const uint8_t* p) {
  return *reinterpret_cast<const uint2*>(p);
}

__device__ __forceinline__ float half_at(const void* p, long long i) {
  return __half2float(static_cast<const __half*>(p)[i]);
}

// ------------------------------------------------------------ Q8_0 / Q4_0
//
// One thread per half block: 16 outputs from 16 payload bytes (Q8_0) or
// from the low or high nibbles of the block's 16 bytes (Q4_0: the low
// nibbles are columns 0-15, the high nibbles 16-31, not interleaved).

template <typename T>
__global__ void __launch_bounds__(kThreads)
q8_0_kernel(const __half* __restrict__ d, const int8_t* __restrict__ qs,
            T* __restrict__ out, long long nb) {
  const long long t = blockIdx.x * static_cast<long long>(kThreads) +
                      threadIdx.x;
  if (t >= 2 * nb) return;
  const long long b = t >> 1;
  const float scale = __half2float(d[b]);
  const uint4 w = *reinterpret_cast<const uint4*>(qs + t * 16);
  const unsigned words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int q = static_cast<int8_t>(
          (words[2 * h + k / 4] >> (8 * (k & 3))) & 0xffu);
      v[k] = scale * static_cast<float>(q);
    }
    store8(out + t * 16 + h * 8, v);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
q4_0_kernel(const __half* __restrict__ d, const uint8_t* __restrict__ qs,
            T* __restrict__ out, long long nb) {
  const long long t = blockIdx.x * static_cast<long long>(kThreads) +
                      threadIdx.x;
  if (t >= 2 * nb) return;
  const long long b = t >> 1;
  const int shift = 4 * static_cast<int>(t & 1);  // high nibbles: 16-31
  const float scale = __half2float(d[b]);
  const uint4 w = *reinterpret_cast<const uint4*>(qs + b * 16);
  const unsigned words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int q = static_cast<int>(
          (words[2 * h + k / 4] >> (8 * (k & 3) + shift)) & 0xfu) - 8;
      v[k] = scale * static_cast<float>(q);
    }
    store8(out + t * 16 + h * 8, v);
  }
}

// --------------------------------------------------------------- K-quants
//
// One warp per 256-value super-block; lane l writes outputs y = 8l..8l+7,
// which always lie in one 16-value (Q2_K, Q3_K, Q6_K) or 32-value (Q4_K,
// Q5_K) sub-block, so each lane needs one scale (and one min). Parts come in
// the order of the `dequant_q*_k` signatures.

struct KParts {
  const void* p[5];
};

template <int kType>
struct KQuant;

// Q2_K parts: d, dmin, scales (16), qs (64). Outputs in (half, j, sub)
// order: y = 128 half + 32 j + 16 sub + e takes bits 2j..2j+1 of
// qs[32 half + 16 sub + e]; its 4-bit scale and min are byte y / 16.
template <>
struct KQuant<kQ2K> {
  static __device__ __forceinline__ void decode(const KParts& p, long long sb,
                                                int lane, float (&v)[8]) {
    const uint8_t* scales = static_cast<const uint8_t*>(p.p[2]) + sb * 16;
    const uint8_t* qs = static_cast<const uint8_t*>(p.p[3]) + sb * 64;
    const int y0 = lane * 8;
    const int half = y0 >> 7, j = (y0 >> 5) & 3, sub = (y0 >> 4) & 1;
    const int sc = scales[y0 >> 4];
    const float dl = half_at(p.p[0], sb) * static_cast<float>(sc & 0xf);
    const float ml = half_at(p.p[1], sb) * static_cast<float>(sc >> 4);
    const uint2 w = load8(qs + half * 32 + sub * 16 + (y0 & 15));
#pragma unroll
    for (int k = 0; k < 8; ++k)
      v[k] = dl * static_cast<float>((byte_of(w, k) >> (2 * j)) & 3) - ml;
  }
};

// Q3_K parts: d, scales (12), hmask (32), qs (64). Same (half, j, sub) order
// as Q2_K; value = low 2 bits - (high bit ? 0 : 4), the high bit being bit
// 4 half + j of hmask[16 sub + e]. Scale s (0..15) is 6 bits: the low 4 are
// nibble (s / 8) of byte 4 ((s / 4) % 2) + s % 4, the high 2 are bits
// 2 (s / 4) of byte 8 + s % 4 (the spec's three-dword shuffle), then the
// int8 reinterpretation (a no-op on 0..63) and -32.
template <>
struct KQuant<kQ3K> {
  static __device__ __forceinline__ void decode(const KParts& p, long long sb,
                                                int lane, float (&v)[8]) {
    const uint8_t* scales = static_cast<const uint8_t*>(p.p[1]) + sb * 12;
    const uint8_t* hmask = static_cast<const uint8_t*>(p.p[2]) + sb * 32;
    const uint8_t* qs = static_cast<const uint8_t*>(p.p[3]) + sb * 64;
    const int s = lane & 15, i = s >> 2, k4 = s & 3;
    const int low4 = (scales[4 * (i & 1) + k4] >> (4 * (i >> 1))) & 0xf;
    const int high2 = (scales[8 + k4] >> (2 * i)) & 3;
    const int unpacked = static_cast<int8_t>(low4 | (high2 << 4)) - 32;
    const int y0 = lane * 8;
    const int sc = __shfl_sync(kFull, unpacked, y0 >> 4);
    const float dl = half_at(p.p[0], sb) * static_cast<float>(sc);
    const int half = y0 >> 7, j = (y0 >> 5) & 3, sub = (y0 >> 4) & 1;
    const uint2 wq = load8(qs + half * 32 + sub * 16 + (y0 & 15));
    const uint2 wh = load8(hmask + sub * 16 + (y0 & 15));
    const int hshift = 4 * half + j;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int low = (byte_of(wq, k) >> (2 * j)) & 3;
      const int hbit = (byte_of(wh, k) >> hshift) & 1;
      v[k] = dl * static_cast<float>(low - (hbit ? 0 : 4));
    }
  }
};

// Q4_K / Q5_K: 8 six-bit scales and 8 six-bit mins packed in 12 bytes.
// Lanes 0-7 (and 16-23) unpack scale l % 8, lanes 8-15 (and 24-31) min
// l % 8; sub-block s takes its pair from lanes s and 8 + s.
__device__ __forceinline__ void k4_scale_min(const uint8_t* q, int lane,
                                             int sub, int* sc, int* mn) {
  const int s = lane & 7;
  int val;
  if (lane & 8) {
    val = s < 4 ? (q[s + 4] & 63) : ((q[s + 4] >> 4) | ((q[s] >> 6) << 4));
  } else {
    val = s < 4 ? (q[s] & 63) : ((q[s + 4] & 0xf) | ((q[s - 4] >> 6) << 4));
  }
  *sc = __shfl_sync(kFull, val, sub);
  *mn = __shfl_sync(kFull, val, 8 + sub);
}

// Q4_K parts: d, dmin, scales (12), qs (128). y = 64 j + 32 hi + e is
// nibble hi of qs[32 j + e], in sub-block y / 32.
template <>
struct KQuant<kQ4K> {
  static __device__ __forceinline__ void decode(const KParts& p, long long sb,
                                                int lane, float (&v)[8]) {
    const int y0 = lane * 8;
    int sc, mn;
    k4_scale_min(static_cast<const uint8_t*>(p.p[2]) + sb * 12, lane,
                 y0 >> 5, &sc, &mn);
    const float d1 = half_at(p.p[0], sb) * static_cast<float>(sc);
    const float m1 = half_at(p.p[1], sb) * static_cast<float>(mn);
    const int j = y0 >> 6, hi = (y0 >> 5) & 1;
    const uint2 w = load8(static_cast<const uint8_t*>(p.p[3]) + sb * 128 +
                          32 * j + (y0 & 31));
#pragma unroll
    for (int k = 0; k < 8; ++k)
      v[k] = d1 * static_cast<float>((byte_of(w, k) >> (4 * hi)) & 0xf) - m1;
  }
};

// Q5_K parts: d, dmin, scales (12), qh (32), qs (128). Q4_K's nibble plus
// 16 times bit 2 j + hi of qh[e].
template <>
struct KQuant<kQ5K> {
  static __device__ __forceinline__ void decode(const KParts& p, long long sb,
                                                int lane, float (&v)[8]) {
    const int y0 = lane * 8;
    int sc, mn;
    k4_scale_min(static_cast<const uint8_t*>(p.p[2]) + sb * 12, lane,
                 y0 >> 5, &sc, &mn);
    const float d1 = half_at(p.p[0], sb) * static_cast<float>(sc);
    const float m1 = half_at(p.p[1], sb) * static_cast<float>(mn);
    const int j = y0 >> 6, hi = (y0 >> 5) & 1, e0 = y0 & 31;
    const uint2 wh = load8(static_cast<const uint8_t*>(p.p[3]) + sb * 32 + e0);
    const uint2 wq = load8(static_cast<const uint8_t*>(p.p[4]) + sb * 128 +
                           32 * j + e0);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int q = ((byte_of(wq, k) >> (4 * hi)) & 0xf) +
                    (((byte_of(wh, k) >> (2 * j + hi)) & 1) << 4);
      v[k] = d1 * static_cast<float>(q) - m1;
    }
  }
};

// Q6_K parts: d, sc (16 x int8, signed), ql (128), qh (64).
// y = 128 half + 32 qi + c: low 4 bits are nibble (qi / 2) of
// ql[64 half + 32 (qi % 2) + c], high 2 bits are bits 2 qi of
// qh[32 half + c], minus 32; the scale index is y / 16.
template <>
struct KQuant<kQ6K> {
  static __device__ __forceinline__ void decode(const KParts& p, long long sb,
                                                int lane, float (&v)[8]) {
    const int y0 = lane * 8;
    const int8_t sc = static_cast<const int8_t*>(p.p[1])[sb * 16 + (y0 >> 4)];
    const float dl = half_at(p.p[0], sb) * static_cast<float>(sc);
    const int half = y0 >> 7, qi = (y0 >> 5) & 3, c0 = y0 & 31;
    const uint2 wl = load8(static_cast<const uint8_t*>(p.p[2]) + sb * 128 +
                           64 * half + 32 * (qi & 1) + c0);
    const uint2 wh = load8(static_cast<const uint8_t*>(p.p[3]) + sb * 64 +
                           32 * half + c0);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int q = (((byte_of(wl, k) >> (4 * (qi >> 1))) & 0xf) |
                     (((byte_of(wh, k) >> (2 * qi)) & 3) << 4)) - 32;
      v[k] = dl * static_cast<float>(q);
    }
  }
};

template <int kType, typename T>
__global__ void __launch_bounds__(kThreads)
k_quant_kernel(KParts parts, T* __restrict__ out, long long nb) {
  const long long sb = blockIdx.x * static_cast<long long>(kWarps) +
                       (threadIdx.x >> 5);
  if (sb >= nb) return;  // uniform across the warp: shuffles stay full
  const int lane = threadIdx.x & 31;
  float v[8];
  KQuant<kType>::decode(parts, sb, lane, v);
  store8(out + sb * 256 + lane * 8, v);
}

// ---------------------------------------------------------------- launch

int grid_for(long long items, int per_block, unsigned* grid) {
  const long long g = (items + per_block - 1) / per_block;
  if (items <= 0 || g > 0x7fffffffLL) return 1;
  *grid = static_cast<unsigned>(g);
  return 0;
}

template <typename T>
int launch_q8_0(const void* d, const void* qs, void* out, long long nb,
                cudaStream_t s) {
  unsigned grid;
  if (grid_for(2 * nb, kThreads, &grid)) return cudaErrorInvalidValue;
  q8_0_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const __half*>(d), static_cast<const int8_t*>(qs),
      static_cast<T*>(out), nb);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_q4_0(const void* d, const void* qs, void* out, long long nb,
                cudaStream_t s) {
  unsigned grid;
  if (grid_for(2 * nb, kThreads, &grid)) return cudaErrorInvalidValue;
  q4_0_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const __half*>(d), static_cast<const uint8_t*>(qs),
      static_cast<T*>(out), nb);
  return static_cast<int>(cudaGetLastError());
}

template <int kType, typename T>
int launch_k(const KParts& parts, void* out, long long nb, cudaStream_t s) {
  unsigned grid;
  if (grid_for(nb, kWarps, &grid)) return cudaErrorInvalidValue;
  k_quant_kernel<kType, T><<<grid, kThreads, 0, s>>>(
      parts, static_cast<T*>(out), nb);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_k_typed(int ggml_type, const KParts& parts, void* out,
                   long long nb, cudaStream_t s) {
  switch (ggml_type) {
    case kQ2K: return launch_k<kQ2K, T>(parts, out, nb, s);
    case kQ3K: return launch_k<kQ3K, T>(parts, out, nb, s);
    case kQ4K: return launch_k<kQ4K, T>(parts, out, nb, s);
    case kQ5K: return launch_k<kQ5K, T>(parts, out, nb, s);
    case kQ6K: return launch_k<kQ6K, T>(parts, out, nb, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32 out, 1 = bfloat16 out. Each returns the launch's
// cudaError_t (0 on success); pointers must be 16-byte aligned.

extern "C" int demodel_dequant_q8_0(const void* d, const void* qs, void* out,
                                    long long nb, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_q8_0<float>(d, qs, out, nb, s);
  if (dtype == 1) return launch_q8_0<__nv_bfloat16>(d, qs, out, nb, s);
  return cudaErrorInvalidValue;
}

extern "C" int demodel_dequant_q4_0(const void* d, const void* qs, void* out,
                                    long long nb, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_q4_0<float>(d, qs, out, nb, s);
  if (dtype == 1) return launch_q4_0<__nv_bfloat16>(d, qs, out, nb, s);
  return cudaErrorInvalidValue;
}

extern "C" int demodel_dequant_k_quant(int ggml_type, const void* p0,
                                       const void* p1, const void* p2,
                                       const void* p3, const void* p4,
                                       void* out, long long nb, int dtype,
                                       void* stream) {
  const KParts parts = {{p0, p1, p2, p3, p4}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_k_typed<float>(ggml_type, parts, out, nb, s);
  if (dtype == 1)
    return launch_k_typed<__nv_bfloat16>(ggml_type, parts, out, nb, s);
  return cudaErrorInvalidValue;
}
