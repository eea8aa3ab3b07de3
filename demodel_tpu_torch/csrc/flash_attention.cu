// Fused flash-attention forward for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel demodel_tpu/ops/flash_attention.py
// `_flash_kernel` (launched by `_flash_forward`, public entry
// `flash_attention`): GQA attention with an online softmax, per-batch int32
// `kv_len` / `causal_offset`, K tiles past the valid prefix or above the
// causal diagonal skipped, masked probabilities set to exactly 0, a row with
// no visible key giving zeros and an LSE of NEG_INF, optional per-row LSE.
//
// What bounds it. At the Llama-2-7B prefill shapes (B=1, H=G=32, D=128,
// S=512, causal, bf16) the work is 4*H*S*S*D/2 = 2.1 GFLOP over 16.8 MB of
// q, k, v and o: 2.2 us of tensor-core time against 5.0 us of HBM time, so
// the best possible kernel is bound by bytes. This first kernel computes in
// fp32 on the CUDA cores (no tensor cores), so in practice it is bound by
// its shared-memory reads and FMAs, far above that floor.
//
// What the design does about it. HBM traffic stays O(S*D) per head: each
// block reads its query tile once and streams K/V tiles through shared
// memory once, never writing the S*S score tensor, and skips the tiles the
// masks rule out (half the work when causal). (B, S, H, D) tensors are read
// through their strides, so there are none of the TPU path's transposes or
// padding copies; Sq and Sk tails are masked in the kernel.
//
// Layout of the work: one block of 8 warps per (q-tile of 32 rows, head,
// batch row); each warp owns 4 query rows. For every 32-key tile, lane j
// scores key j against the warp's 4 rows (q rows read as broadcast float4,
// key rows padded to D+1 floats so the 32 lanes hit 32 banks), the running
// max / denominator update with warp shuffles, and then each lane
// accumulates output columns lane, lane+32, ... of P.V in fp32 registers.
// The sequential minor grid axis of the TPU kernel becomes the loop over K
// tiles inside the block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 32;                      // query rows per block
constexpr int kBlockK = 32;                      // keys per tile (= lanes)
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = kBlockQ / kWarps;   // 4
constexpr float kNegInf = -1e30f;                // mask value and LSE sentinel

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;        // [B, Sq, H] or nullptr
  const int* win;    // [2, B]: kv_len per batch row, then causal_offset
  int B, Sq, Sk, H, G;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale;
  int causal;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr int smem_floats() {
  return kBlockQ * D + kBlockK * (D + 1) + kBlockK * D;
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
    flash_fwd_kernel(const Params p) {
  static_assert(D % 32 == 0, "head dim must be a multiple of 32");
  constexpr int kCols = D / 32;  // output columns per lane
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;                    // [kBlockQ][D]   q * scale
  float* sk = sq + kBlockQ * D;        // [kBlockK][D+1] keys
  float* sv = sk + kBlockK * (D + 1);  // [kBlockK][D]   values

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int g = h / (p.H / p.G);  // GQA: the kv head this q head reads
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int kv_len = p.win[b];
  const int offset = p.win[p.B + b];

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + g * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + g * p.v_sh;

  for (int i = tid; i < kBlockQ * D; i += kWarps * 32) {
    const int r = i / D;
    const int d = i - r * D;
    const int qi = q0 + r;
    sq[i] = qi < p.Sq ? to_f32(q[qi * p.q_ss + d]) * p.scale : 0.f;
  }

  // keys any row of this block can see: the valid prefix, cut at the
  // causal diagonal of the block's last real row (tiles past it skipped)
  int k_end = min(kv_len, p.Sk);
  if (p.causal) k_end = min(k_end, min(q0 + kBlockQ, p.Sq) + offset);

  float m[kRowsPerWarp];
  float l[kRowsPerWarp];
  float acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[rr][c] = 0.f;
  }

  for (int t0 = 0; t0 < k_end; t0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed (and sq is written)
    for (int i = tid; i < kBlockK * D; i += kWarps * 32) {
      const int j = i / D;
      const int d = i - j * D;
      const int kj = t0 + j;
      const bool in = kj < p.Sk;
      sk[j * (D + 1) + d] = in ? to_f32(k[kj * p.k_ss + d]) : 0.f;
      sv[j * D + d] = in ? to_f32(v[kj * p.v_ss + d]) : 0.f;
    }
    __syncthreads();

    // scores of this lane's key against the warp's rows
    float s[kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) s[rr] = 0.f;
    const float* krow = sk + lane * (D + 1);
    const float* qrow = sq + warp * kRowsPerWarp * D;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float k0 = krow[d];
      const float k1 = krow[d + 1];
      const float k2 = krow[d + 2];
      const float k3 = krow[d + 3];
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const float4 qv = *reinterpret_cast<const float4*>(qrow + rr * D + d);
        s[rr] = fmaf(qv.x, k0, s[rr]);
        s[rr] = fmaf(qv.y, k1, s[rr]);
        s[rr] = fmaf(qv.z, k2, s[rr]);
        s[rr] = fmaf(qv.w, k3, s[rr]);
      }
    }

    // online softmax; masked entries score NEG_INF and weigh exactly 0, so
    // a row with no visible key keeps l == 0
    const int kj = t0 + lane;
    float pr[kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int qi = q0 + warp * kRowsPerWarp + rr;
      const bool valid = kj < k_end && (!p.causal || kj <= qi + offset);
      const float sc = valid ? s[rr] : kNegInf;
      const float m_new = fmaxf(m[rr], warp_max(sc));
      const float alpha = expf(m[rr] - m_new);
      pr[rr] = valid ? expf(sc - m_new) : 0.f;
      l[rr] = l[rr] * alpha + warp_sum(pr[rr]);
      m[rr] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[rr][c] *= alpha;
    }

    // acc += P . V: lane owns output columns lane + 32 c
#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      float pj[kRowsPerWarp];
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr)
        pj[rr] = __shfl_sync(0xffffffffu, pr[rr], j);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vv = sv[j * D + c * 32 + lane];
#pragma unroll
        for (int rr = 0; rr < kRowsPerWarp; ++rr)
          acc[rr][c] = fmaf(pj[rr], vv, acc[rr][c]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int qi = q0 + warp * kRowsPerWarp + rr;
    if (qi >= p.Sq) continue;
    const float safe = l[rr] == 0.f ? 1.f : l[rr];
    const float inv = 1.f / safe;
    T* orow = static_cast<T*>(p.o) + b * p.o_sb + qi * p.o_ss + h * p.o_sh;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      orow[c * 32 + lane] = from_f32<T>(acc[rr][c] * inv);
    if (p.lse != nullptr && lane == 0)
      p.lse[(static_cast<long long>(b) * p.Sq + qi) * p.H + h] =
          l[rr] > 0.f ? m[rr] + logf(l[rr]) : kNegInf;
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kBlockQ - 1) / kBlockQ, p.H, p.B);
  flash_fwd_kernel<T, D><<<grid, kWarps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. Strides are in elements; the last
// dim of every tensor is contiguous. dtype: 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int demodel_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* win, int B, int Sq, int Sk, int H, int G, int D,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    float scale, int causal, int dtype, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.win = static_cast<const int*>(win);
  p.B = B;
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.G = G;
  p.q_sb = q_sb;
  p.q_ss = q_ss;
  p.q_sh = q_sh;
  p.k_sb = k_sb;
  p.k_ss = k_ss;
  p.k_sh = k_sh;
  p.v_sb = v_sb;
  p.v_ss = v_ss;
  p.v_sh = v_sh;
  p.o_sb = o_sb;
  p.o_ss = o_ss;
  p.o_sh = o_sh;
  p.scale = scale;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return launch<float, 64>(p, s);
  if (dtype == 0 && D == 128) return launch<float, 128>(p, s);
  if (dtype == 1 && D == 64) return launch<__nv_bfloat16, 64>(p, s);
  if (dtype == 1 && D == 128) return launch<__nv_bfloat16, 128>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
