// Fused flash-attention forward for NVIDIA Hopper (sm_90a): two kernels,
// chosen by the input dtype. bf16 and f16 go to the tensor-core kernel at
// every head dim up to 256; float32 goes to the CUDA-core kernel at every
// head dim up to 256. A head dim past 256, float64 or any other dtype has
// no kernel: the wrapper raises before a launch, and the entry point
// returns cudaErrorInvalidValue for a kernel code or head dim it does not
// know.
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
// the best possible kernel is bound by bytes there; from S of about 2048 on,
// a causal layer is bound by the tensor cores (34.7 us of operations at
// S=2048).
//
// bf16 and f16: `flash_fwd_wgmma<T, DP>`, on the tensor cores, instantiated
// at the padded head dims DP = 64, 128 and 256 with the true D (<= DP) a
// run-time parameter. One block per 64 query rows of one (batch row, head):
// one consumer warpgroup (4 warps) and one producer warp. The producer
// loads the Q tile once and streams 64-key K and V tiles through a 2-stage
// ring in shared memory with TMA (128-byte swizzle, out-of-bounds rows zero
// filled), each tile signalled through an mbarrier, so the next tile's
// loads overlap this tile's math. A row of a tile is DP/64 boxes of 64
// columns (128 bytes); boxes wholly past D are not loaded, and what lies in
// them is never read into a stored column.
//
// Two tensor maps read q, k and v where they lie. A tensor whose head
// stride is a multiple of 16 bytes is read through a 4-D map over (D,
// heads, rows, batch) whose innermost extent is the true D, so columns
// D..DP-1 of a box are zero filled. A tensor with packed heads (head stride
// D) whose head stride TMA cannot take (D = 100, 200 bytes: OpenLLaMA-3B)
// is read through a 3-D "row" map over (heads*D, rows, batch). TMA takes a
// box only at a 16-byte aligned start (on the H100 any other start is an
// illegal instruction), so a head's tile starts at column head*D rounded
// down to a multiple of 8 and the head sits `shift` = (head*D) % 8 columns
// into it (0 or 4 at D = 100). The tile's columns before the head and past
// it hold the neighbouring heads' values, so the consumer zeroes them in
// the Q tile in shared memory (through the swizzle) before its first
// wgmma; K's head sits at the same shift (the wrapper sends q and k
// through the row map only together, with one kv head per q head), so its
// extra columns multiply zeros, and V's land in accumulator columns that
// the epilogue skips (it stores columns v_shift..v_shift+D-1). The
// wrapper copies a tensor that no map takes into a contiguous buffer with
// its head dim padded to a multiple of 8.
//
// S = Q.K^T is `wgmma.m64n64k16` over ceil((shift+D)/16) steps of the Q
// and K tiles in shared memory; q is not pre-scaled, the fp32 scores are scaled
// by scale*log2(e) (scale = D^-0.5 of the true D, from the wrapper) so the
// softmax uses exp2. The online softmax runs on the accumulator in
// registers: a row's 16 values per thread reduce across the 4 threads that
// share the row (2 shuffles); the causal and kv_len masks are applied only
// on tiles that cross the diagonal or the kv_len edge. O += P.V is
// `wgmma.m64n{DP}k16` with P taken from registers (the S accumulator's
// fragment is the A operand's layout once packed to T) and V read MN-major
// from the ring. The epilogue divides by l, stores columns < D of o in T and
// the LSE, (m2 + log2 l) * ln 2. At DP=256 the block takes 164,864 bytes of
// shared memory (one block an SM) and 128 fp32 accumulator registers a
// thread for O.
//
// Numerics: P is rounded to T (against its row's running max) before P.V,
// where the plain version keeps fp32; the JAX reference itself rounds the
// probabilities to q's dtype. That is about 2^-9 relative per term in bf16
// and 2^-12 in f16, well inside the tolerance of 2e-2. The f16
// instantiations differ from the bf16 ones only in the operand type of both
// `wgmma`s (`.f32.f16.f16`), the TMA maps' element type and the packing of
// P and the output; a pulled Llama-2 or OpenLLaMA checkpoint is stored in
// f16 and reaches K1 so.
//
// float32: `flash_fwd_kernel<DP>`, on the CUDA cores, because the JAX
// kernel computes in fp32 and the f32 tolerances (1e-4) rule out bf16 or
// TF32 tensor cores. DP is the head dim padded up to 32, 64, 128 or 256 and
// the true D (<= DP) a runtime argument: columns past D load as zeros and
// are never stored. One block of 8 warps per (q-tile of 32 rows, head,
// batch row); each warp owns 4 query rows. For every 32-key tile, lane j
// scores key j against the warp's 4 rows (q rows read as broadcast float4,
// key rows padded to DP+1 floats so the 32 lanes hit 32 banks), the running
// max / denominator update with warp shuffles, and then each lane
// accumulates output columns lane, lane+32, ... of P.V in fp32 registers.
// The tiles take 98,432 bytes of shared memory at DP=256, above the 48 KB
// default, so the launch raises the block's dynamic shared memory limit.
// This kernel is bound by its FMA issue rate.
//
// Both kernels keep HBM traffic at O(S*D) per head (the S*S scores never
// leave the SM), read (B, S, H, D) tensors through their strides, and take
// the windows either by value (one kv_len and causal_offset for the whole
// batch, the main path) or as an int32 [2, B] tensor (ragged decode). One
// call is one launch.

#include <cuda.h>  // CUtensorMap and the encoder's types; no -lcuda needed
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstdint>

// The launch, as the wrapper's plan packs it: every field 8 bytes, no
// padding. Strides are in elements; the last dim of every tensor is
// contiguous.
struct LaunchArgs {
  long long q, k, v, o, lse, win;  // device pointers (lse, win may be 0)
  long long kv_len, causal_offset; // when win == 0
  long long B, Sq, Sk, H, G, D;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
  long long causal;
  long long kernel;  // 0: f32 CUDA cores; 1, 2: bf16, f16 tensor cores
  long long maps;    // tensor cores: bit 0, 1, 2 set when q, k, v are read
                     // through the row map (else the 4-D map)
  long long grid_x, threads, smem;
  long long device;
  double scale;
};

namespace {

constexpr float kNegInf = -1e30f;  // mask value and LSE sentinel

// ---------------------------------------------------------------- float32

constexpr int kBlockQ = 32;                      // query rows per block
constexpr int kBlockK = 32;                      // keys per tile (= lanes)
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = kBlockQ / kWarps;   // 4

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;        // [B, Sq, H] or nullptr
  const int* win;    // [2, B]: kv_len per batch row, then causal_offset;
                     // nullptr: kv_len / causal_offset below for every row
  int kv_len, causal_offset;
  int B, Sq, Sk, H, G;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale;
  int causal;
};

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

template <int DP>
constexpr int smem_floats() {
  return kBlockQ * DP + kBlockK * (DP + 1) + kBlockK * DP;
}

// DP is the head dim padded up to a multiple of 32 (32, 64, 128 or 256) and
// `D` <= DP the true one. Columns D..DP-1 are zeros in shared memory, so
// they add nothing to the scores and produce columns that are never stored.
template <int DP>
__global__ void __launch_bounds__(kWarps * 32)
    flash_fwd_kernel(const Params p, const int D) {
  static_assert(DP % 32 == 0, "padded head dim must be a multiple of 32");
  constexpr int kCols = DP / 32;  // output columns per lane
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;                     // [kBlockQ][DP]   q * scale
  float* sk = sq + kBlockQ * DP;        // [kBlockK][DP+1] keys
  float* sv = sk + kBlockK * (DP + 1);  // [kBlockK][DP]   values

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int g = h / (p.H / p.G);  // GQA: the kv head this q head reads
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int kv_len = p.win != nullptr ? p.win[b] : p.kv_len;
  const int offset = p.win != nullptr ? p.win[p.B + b] : p.causal_offset;

  const float* q = p.q + b * p.q_sb + h * p.q_sh;
  const float* k = p.k + b * p.k_sb + g * p.k_sh;
  const float* v = p.v + b * p.v_sb + g * p.v_sh;

  for (int i = tid; i < kBlockQ * DP; i += kWarps * 32) {
    const int r = i / DP;
    const int d = i - r * DP;
    const int qi = q0 + r;
    sq[i] = qi < p.Sq && d < D ? q[qi * p.q_ss + d] * p.scale : 0.f;
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
    for (int i = tid; i < kBlockK * DP; i += kWarps * 32) {
      const int j = i / DP;
      const int d = i - j * DP;
      const int kj = t0 + j;
      const bool in = kj < p.Sk && d < D;
      sk[j * (DP + 1) + d] = in ? k[kj * p.k_ss + d] : 0.f;
      sv[j * DP + d] = in ? v[kj * p.v_ss + d] : 0.f;
    }
    __syncthreads();

    // scores of this lane's key against the warp's rows
    float s[kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) s[rr] = 0.f;
    const float* krow = sk + lane * (DP + 1);
    const float* qrow = sq + warp * kRowsPerWarp * DP;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      const float k0 = krow[d];
      const float k1 = krow[d + 1];
      const float k2 = krow[d + 2];
      const float k3 = krow[d + 3];
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const float4 qv = *reinterpret_cast<const float4*>(qrow + rr * DP + d);
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
      const float e = valid ? expf(sc - m_new) : 0.f;
      l[rr] = l[rr] * alpha + warp_sum(e);
      pr[rr] = e;
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
        const float vv = sv[j * DP + c * 32 + lane];
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
    float* orow = p.o + b * p.o_sb + qi * p.o_ss + h * p.o_sh;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (c * 32 + lane < D) orow[c * 32 + lane] = acc[rr][c] * inv;
    if (p.lse != nullptr && lane == 0)
      p.lse[(static_cast<long long>(b) * p.Sq + qi) * p.H + h] =
          l[rr] > 0.f ? m[rr] + logf(l[rr]) : kNegInf;
  }
}

// ---------------------------------------------------- bf16 and f16, wgmma

constexpr int kTcRows = 64;     // query rows per block (one wgmma M)
constexpr int kTcKeys = 64;     // keys per K/V tile
constexpr int kStages = 2;      // K/V ring depth
constexpr int kTcThreads = 160; // consumer warpgroup + producer warp
constexpr int kBoxBytes = 64 * 64 * 2;  // one TMA box: 64 rows x 128 bytes
constexpr float kLn2 = 0.6931471805599453f;

template <int DP>
__host__ __device__ constexpr int tc_tile_bytes() {
  return kTcKeys * DP * 2;
}
// Q tile + the K and V rings + slack to align the base to 1024 bytes (the
// 128-byte swizzle repeats every 8 rows of 128 bytes): 164,864 at DP=256
template <int DP>
constexpr int tc_smem_bytes() {
  return tc_tile_bytes<DP>() * (1 + 2 * kStages) + 1024;
}

struct TcParams {
  void* o;
  float* lse;
  const int* win;
  int kv_len, causal_offset;
  int B, Sq, Sk, H, G, D;
  // head stride (elements) of q, k, v where the row map reads them (head h
  // starts at column h * stride); -1 where the 4-D map does
  int q_hcol, k_hcol, v_hcol;
  long long o_sb, o_ss, o_sh;
  float scale_log2;  // softmax scale * log2(e)
  int causal;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one TMA box of a 4-D map (d, head, row, batch) into shared memory,
// completion counted in bytes on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// the same for a 3-D row map (column, row, batch)
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// Where head `head` of a tensor starts in its tile: through the row map
// (`hcol` >= 0) a box must start on a 16-byte boundary (TMA refuses any
// other start: H100, cudaErrorIllegalInstruction), so the tile starts at
// column head * hcol rounded down to a multiple of 8 and the head sits
// `shift` = (head * hcol) % 8 columns into it; through the 4-D map at 0.
__device__ __forceinline__ int head_shift(int hcol, int head) {
  return hcol >= 0 ? (head * hcol) & 7 : 0;
}

// the 64-column boxes of one tile (rows `row`.., head `head`) that hold
// its D columns past `shift`, loaded through the row map (`hcol` >= 0) or
// the 4-D map
__device__ __forceinline__ void tma_load_tile(uint32_t dst,
                                              const CUtensorMap* map, int hcol,
                                              int D, int head, int row, int b,
                                              uint32_t bar) {
  const int shift = head_shift(hcol, head);
  const int nbox = (D + shift + 63) / 64;
  for (int x = 0; x < nbox; ++x) {
    if (hcol >= 0)
      tma_load_3d(dst + x * kBoxBytes, map, head * hcol - shift + 64 * x,
                  row, b, bar);
    else
      tma_load_4d(dst + x * kBoxBytes, map, 64 * x, head, row, b, bar);
  }
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma and its wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The element type of the tensor-core kernel: how P and the output pack,
// and which TMA element type maps q, k and v
template <typename T>
struct TcType;
template <>
struct TcType<__nv_bfloat16> {
  static constexpr bool kHalf = false;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ __nv_bfloat16 one(float x) {
    return __float2bfloat16_rn(x);
  }
};
template <>
struct TcType<__half> {
  static constexpr bool kHalf = true;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ __half one(float x) {
    return __float2half_rn(x);
  }
};

// the 32, 64 and 128 fp32 accumulator registers of a 64x64, a 64x128 and
// a 64x256 tile
#define DM_ACC32(d)                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),      \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),             \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),         \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),         \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),         \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),         \
      "+f"(d[31])
#define DM_ACC64(d)                                                            \
  DM_ACC32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),             \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),         \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),         \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),         \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),         \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),         \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define DM_ACC128(d)                                                          \
  DM_ACC64(d), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),            \
      "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),        \
      "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),        \
      "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]),        \
      "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),        \
      "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]),        \
      "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),        \
      "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),     \
      "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),   \
      "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]),   \
      "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]),   \
      "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]),   \
      "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
#define DM_REGS128                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "    \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "    \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "    \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "    \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "    \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "  \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "  \
  "%124, %125, %126, %127}"
#define DM_REGS32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "    \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "     \
  "%30, %31}"
#define DM_REGS64                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "    \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "     \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "     \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "     \
  "%58, %59, %60, %61, %62, %63}"
// D[64x64] (+)= A[64x16] . B[16x64], A and B K-major in shared memory
#define DM_WGMMA_SS_64(TY)                                                     \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                 \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " DM_REGS32      \
  ", %32, %33, p, 1, 1, 0, 0;\n}\n"
// D[64xN] += A[64x16] . B[16xN], A in registers, B MN-major in shared memory
#define DM_WGMMA_RS_64(TY)                                                     \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                 \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " DM_REGS32      \
  ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
#define DM_WGMMA_RS_128(TY)                                                    \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                                 \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " DM_REGS64     \
  ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
#define DM_WGMMA_RS_256(TY)                                                    \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"                                \
  "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " " DM_REGS128    \
  ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"

template <bool kHalf>
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t da,
                                                  uint64_t db, int scale_d) {
  if constexpr (kHalf)
    asm volatile(DM_WGMMA_SS_64("f16")
                 : DM_ACC32(d)
                 : "l"(da), "l"(db), "r"(scale_d));
  else
    asm volatile(DM_WGMMA_SS_64("bf16")
                 : DM_ACC32(d)
                 : "l"(da), "l"(db), "r"(scale_d));
}

template <bool kHalf>
__device__ __forceinline__ void wgmma_rs_m64n64k16_tb(float (&d)[32],
                                                     const uint32_t (&a)[4],
                                                     uint64_t db) {
  if constexpr (kHalf)
    asm volatile(DM_WGMMA_RS_64("f16")
                 : DM_ACC32(d)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  else
    asm volatile(DM_WGMMA_RS_64("bf16")
                 : DM_ACC32(d)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <bool kHalf>
__device__ __forceinline__ void wgmma_rs_m64n128k16_tb(float (&d)[64],
                                                      const uint32_t (&a)[4],
                                                      uint64_t db) {
  if constexpr (kHalf)
    asm volatile(DM_WGMMA_RS_128("f16")
                 : DM_ACC64(d)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  else
    asm volatile(DM_WGMMA_RS_128("bf16")
                 : DM_ACC64(d)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <bool kHalf>
__device__ __forceinline__ void wgmma_rs_m64n256k16_tb(float (&d)[128],
                                                      const uint32_t (&a)[4],
                                                      uint64_t db) {
  if constexpr (kHalf)
    asm volatile(DM_WGMMA_RS_256("f16")
                 : DM_ACC128(d)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  else
    asm volatile(DM_WGMMA_RS_256("bf16")
                 : DM_ACC128(d)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <bool kHalf, int DP>
__device__ __forceinline__ void wgmma_pv(float (&o)[DP / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (DP == 64)
    wgmma_rs_m64n64k16_tb<kHalf>(o, a, db);
  else if constexpr (DP == 128)
    wgmma_rs_m64n128k16_tb<kHalf>(o, a, db);
  else
    wgmma_rs_m64n256k16_tb<kHalf>(o, a, db);
}

// Accumulator layout of a 64xN wgmma tile (fp32): thread t of the
// warpgroup (warp w, lane l) holds rows r0 = 16w + l/4 and r0 + 8, columns
// 8j + 2(l%4) + {0,1}; register 4j + 2i + c is (row r0 + 8i, column
// 8j + 2(l%4) + c).
//
// kExact: D == DP and q, k and v all read through the 4-D map, the
// launch's choice. Then D, the shifts, the boxes and the Q.K^T steps are
// constants, and no run-time guard sits among the wgmmas or in the
// epilogue (Llama's D = 128 runs this body).
template <typename T, int DP, bool kExact>
__global__ void __launch_bounds__(kTcThreads, DP == 256 ? 1 : 2)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const TcParams p) {
  static_assert(DP == 64 || DP == 128 || DP == 256, "padded head dim");
  constexpr bool kHalf = TcType<T>::kHalf;
  const int D = kExact ? DP : p.D;
  const int q_hcol = kExact ? -1 : p.q_hcol;
  const int k_hcol = kExact ? -1 : p.k_hcol;
  const int v_hcol = kExact ? -1 : p.v_hcol;
  constexpr uint32_t kTile = tc_tile_bytes<DP>();
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 3 * kStages];

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sq = base;                      // [DP/64 boxes][64 rows][128 B]
  const uint32_t sk = base + kTile;              // kStages K tiles
  const uint32_t sv = base + (1 + kStages) * kTile;  // kStages V tiles
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t bar_k = smem_u32(&bars[1]);              // + 8 * stage
  const uint32_t bar_v = smem_u32(&bars[1 + kStages]);
  const uint32_t bar_free = smem_u32(&bars[1 + 2 * kStages]);

  // (q tile, head, batch row) from the linear block index, the q tile the
  // slowest and in descending order: the longest causal tiles start first
  const int hb = p.H * p.B;
  const int lin = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const int qt = gridDim.x - 1 - lin / hb;
  const int h = (lin % hb) % p.H;
  const int b = (lin % hb) / p.H;
  const int q0 = qt * kTcRows;
  const int g = h / (p.H / p.G);  // GQA: the kv head this q head reads
  const int kv_len = p.win != nullptr ? p.win[b] : p.kv_len;
  const int offset = p.win != nullptr ? p.win[p.B + b] : p.causal_offset;
  // q's and k's head sit at one shift into their tiles (the plan sends
  // them through the row map only together, with one kv head per q head),
  // v's at its own; the loaded boxes hold columns shift..shift+D-1 and
  // the Q.K^T steps cover them (boxes and steps past them are skipped)
  const int qk_shift = head_shift(q_hcol, h);
  const int v_shift = head_shift(v_hcol, g);
  const int qk_cols = qk_shift + D;
  const int ksteps = (qk_cols + 15) / 16;

  // keys any row of this block can see: the valid prefix, cut at the
  // causal diagonal of the block's last real row (tiles past it skipped)
  const int k_lim = min(kv_len, p.Sk);
  int k_end = k_lim;
  if (p.causal) k_end = min(k_end, min(q0 + kTcRows, p.Sq) + offset);
  const int n_tiles = k_end > 0 ? (k_end + kTcKeys - 1) / kTcKeys : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_free + 8 * s, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // producer warp: one lane issues every load, then the warp is done
    if (threadIdx.x == 128 && n_tiles > 0) {
      // expect_tx counts whole boxes, zero-filled columns included
      const uint32_t qk_bytes = (qk_cols + 63) / 64 * kBoxBytes;
      const uint32_t v_bytes = (v_shift + D + 63) / 64 * kBoxBytes;
      mbar_expect_tx(bar_q, qk_bytes);
      tma_load_tile(sq, &tq, q_hcol, D, h, q0, b, bar_q);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages)  // the consumer has released tile t - kStages
          mbar_wait(bar_free + 8 * s, ((t / kStages) - 1) & 1);
        mbar_expect_tx(bar_k + 8 * s, qk_bytes);
        tma_load_tile(sk + s * kTile, &tk, k_hcol, D, g, t * kTcKeys, b,
                      bar_k + 8 * s);
        mbar_expect_tx(bar_v + 8 * s, v_bytes);
        tma_load_tile(sv + s * kTile, &tv, v_hcol, D, g, t * kTcKeys, b,
                      bar_v + 8 * s);
      }
    }
    return;
  }

  // consumer warpgroup
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r0 = (tid >> 5) * 16 + (lane >> 2);  // rows r0 and r0 + 8
  const int cq = (lane & 3) * 2;                 // column pair in each 8

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max, log2 units
  float l[2] = {0.f, 0.f};              // this thread's share of the sum

  if (n_tiles > 0) {
    mbar_wait(bar_q, 0);
    // through the row map, the Q tile's columns before the head (the
    // shift) and past it to the end of the last loaded box hold the
    // neighbouring heads' values: zero them (element (r, c) of a box sits
    // in 16-byte chunk (c / 8) ^ (r % 8) of its 128-byte row), then hand
    // the writes to the async proxy that wgmma reads through
    const int tail = (qk_cols + 63) / 64 * 64 - qk_cols;
    const int width = qk_shift + tail;
    if (q_hcol >= 0 && width > 0) {
      uint8_t* gq = smem_raw + (sq - raw);
      for (int i = tid; i < kTcRows * width; i += 128) {
        const int r = i / width;
        const int j = i % width;
        const int c = j < qk_shift ? j : qk_cols + j - qk_shift;
        const int chunk = ((c & 63) >> 3) ^ (r & 7);
        *reinterpret_cast<uint16_t*>(gq + (c >> 6) * kBoxBytes + r * 128 +
                                     chunk * 16 + (c & 7) * 2) = 0;
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
    }
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const uint32_t phase = (t / kStages) & 1;
    const int t0 = t * kTcKeys;

    // S = Q . K^T over D in steps of 16 (the steps wholly past D skipped):
    // step kk reads 32 bytes at 32 * (kk % 4) into column box kk / 4 of Q
    // and of K
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    mbar_wait(bar_k + 8 * s, phase);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      if (kk < ksteps) {
        const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
        wgmma_ss_m64n64k16<kHalf>(sc, sw128_desc(sq + off, 16, 1024),
                                  sw128_desc(sk + s * kTile + off, 16, 1024),
                                  kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(sc);

    // masks only on the tiles that cross the kv_len edge or the diagonal
    const bool edge = t0 + kTcKeys > k_lim;
    const bool diag = p.causal && t0 + kTcKeys - 1 > q0 + offset;
    if (edge || diag) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int key = t0 + 8 * j + cq + c;
            const int row = q0 + r0 + 8 * i;
            const bool ok =
                key < k_lim && (!p.causal || key <= row + offset);
            if (!ok) sc[4 * j + 2 * i + c] = -INFINITY;
          }
    }

    // online softmax in base 2; masked scores give exactly 0
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx * p.scale_log2);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = fast_exp2(m[i] - m_use);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float e =
              fast_exp2(fmaf(sc[4 * j + 2 * i + c], p.scale_log2, -m_use));
          sc[4 * j + 2 * i + c] = e;
          sum += e;
        }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        o[4 * j + 2 * i] *= alpha;
        o[4 * j + 2 * i + 1] *= alpha;
      }
    }

    // P in T as the A operand: keys 16kk..16kk+15 are accumulator
    // columns 8(2kk) and 8(2kk+1), already in the A fragment's order
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = TcType<T>::pack(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

    // O += P . V: V tile read MN-major, 16 keys (2 groups of 8 rows,
    // 1024 bytes apart) per step; the DP/64 column boxes 8192 bytes apart
    mbar_wait(bar_v + 8 * s, phase);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv<kHalf, DP>(o, pa[kk],
                          sw128_desc(sv + s * kTile + kk * 2048, kBoxBytes,
                                     1024));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(o);
    mbar_arrive(bar_free + 8 * s);
  }

  // epilogue: the row sums over the 4 threads of a row, then out's D
  // columns (accumulator columns v_shift..v_shift+D-1; in pairs where D is
  // even: the wrapper's contiguous output and an even v_shift then keep
  // every pair 4-byte aligned) and the LSE
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const bool pairs = (D & 1) == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + 8 * i;
    if (row >= p.Sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    T* orow = static_cast<T*>(p.o) + b * p.o_sb + row * p.o_ss + h * p.o_sh;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + cq - v_shift;  // out's column of this pair
      const float lo = o[4 * j + 2 * i] * inv;
      const float hi = o[4 * j + 2 * i + 1] * inv;
      if (pairs) {
        if (kExact || (c >= 0 && c < D))
          *reinterpret_cast<uint32_t*>(orow + c) = TcType<T>::pack(lo, hi);
      } else {
        if (c >= 0 && c < D) orow[c] = TcType<T>::one(lo);
        if (c + 1 >= 0 && c + 1 < D) orow[c + 1] = TcType<T>::one(hi);
      }
    }
    if (p.lse != nullptr && (lane & 3) == 0)
      p.lse[(static_cast<long long>(b) * p.Sq + row) * p.H + h] =
          l[i] > 0.f ? (m[i] + log2f(l[i])) * kLn2 : kNegInf;
  }
}

// ------------------------------------------------------------------- host

// cuTensorMapEncodeTiled, reached through the runtime so the library needs
// no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<EncodeTiled>(ptr);
  }();
  return fn;
}

// A map of 2-byte elements (`type`) over a (B, S, heads, D) tensor with
// boxes of 64 columns (128 bytes, swizzled) x 64 rows; rows past S read as
// zeros. `rows` false: 4-D (D, heads, S, B), innermost extent the true D,
// so columns past D read as zeros too. `rows` true: 3-D (columns, S, B)
// over each row's (heads - 1) * s_head + D columns, a box of head h
// starting at column h * s_head. Strides in elements; the caller
// guarantees a 16-byte aligned base and 16-byte multiple strides (s_head
// too for the 4-D map).
bool encode_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
                int D, int heads, int S, int B, long long s_head,
                long long s_row, long long s_batch, bool rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t s_dim = static_cast<cuuint64_t>(S > 0 ? S : 1);
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  if (rows) {
    const cuuint64_t dims[3] = {
        static_cast<cuuint64_t>((heads - 1) * s_head + D), s_dim,
        static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(s_row) * 2,
                                   static_cast<cuuint64_t>(s_batch) * 2};
    const cuuint32_t box[3] = {64, kTcKeys, 1};
    return encode(map, type, 3, const_cast<void*>(ptr), dims, strides, box,
                  unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  }
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads), s_dim,
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s_head) * 2,
                                 static_cast<cuuint64_t>(s_row) * 2,
                                 static_cast<cuuint64_t>(s_batch) * 2};
  const cuuint32_t box[4] = {64, 1, kTcKeys, 1};
  return encode(map, type, 4, const_cast<void*>(ptr), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// dynamic shared memory above 48 KB, set once per kernel and device
template <int Kind, int DP>
cudaError_t allow_smem(const void* fn, int smem, int device) {
  static std::atomic<unsigned long long> done{0};
  const unsigned long long bit = 1ull << (device & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_acq_rel);
  return err;
}

template <int DP>
cudaError_t launch_simt(const LaunchArgs& a, cudaStream_t stream) {
  const int smem = smem_floats<DP>() * static_cast<int>(sizeof(float));
  if (a.smem != smem || a.threads != kWarps * 32 || a.D > DP || a.D < 1)
    return cudaErrorInvalidValue;
  // 98,432 bytes at DP=256: above the 48 KB default, so the attribute is
  // set for every instantiation before its first launch
  cudaError_t err =
      allow_smem<0, DP>(reinterpret_cast<const void*>(flash_fwd_kernel<DP>),
                        smem, static_cast<int>(a.device));
  if (err != cudaSuccess) return err;
  Params p;
  p.q = reinterpret_cast<const float*>(a.q);
  p.k = reinterpret_cast<const float*>(a.k);
  p.v = reinterpret_cast<const float*>(a.v);
  p.o = reinterpret_cast<float*>(a.o);
  p.lse = reinterpret_cast<float*>(a.lse);
  p.win = reinterpret_cast<const int*>(a.win);
  p.kv_len = static_cast<int>(a.kv_len);
  p.causal_offset = static_cast<int>(a.causal_offset);
  p.B = static_cast<int>(a.B);
  p.Sq = static_cast<int>(a.Sq);
  p.Sk = static_cast<int>(a.Sk);
  p.H = static_cast<int>(a.H);
  p.G = static_cast<int>(a.G);
  p.q_sb = a.q_sb; p.q_ss = a.q_ss; p.q_sh = a.q_sh;
  p.k_sb = a.k_sb; p.k_ss = a.k_ss; p.k_sh = a.k_sh;
  p.v_sb = a.v_sb; p.v_ss = a.v_ss; p.v_sh = a.v_sh;
  p.o_sb = a.o_sb; p.o_ss = a.o_ss; p.o_sh = a.o_sh;
  p.scale = static_cast<float>(a.scale);
  p.causal = static_cast<int>(a.causal);
  const dim3 grid(static_cast<unsigned>(a.grid_x), p.H, p.B);
  flash_fwd_kernel<DP><<<grid, kWarps * 32, smem, stream>>>(
      p, static_cast<int>(a.D));
  return cudaGetLastError();
}

// the CUDA-core kernel at the head dim padded up to the next of 32, 64,
// 128, 256
cudaError_t launch_simt_any(const LaunchArgs& a, cudaStream_t stream) {
  if (a.D <= 32) return launch_simt<32>(a, stream);
  if (a.D <= 64) return launch_simt<64>(a, stream);
  if (a.D <= 128) return launch_simt<128>(a, stream);
  if (a.D <= 256) return launch_simt<256>(a, stream);
  return cudaErrorInvalidValue;
}

template <typename T, int DP, bool kExact>
cudaError_t launch_tc(const CUtensorMap& tq, const CUtensorMap& tk,
                      const CUtensorMap& tv, const TcParams& p, dim3 grid,
                      int smem, int device, cudaStream_t stream) {
  constexpr int kKind = (TcType<T>::kHalf ? 2 : 1) + (kExact ? 2 : 0);
  const cudaError_t err = allow_smem<kKind, DP>(
      reinterpret_cast<const void*>(flash_fwd_wgmma<T, DP, kExact>), smem,
      device);
  if (err != cudaSuccess) return err;
  flash_fwd_wgmma<T, DP, kExact><<<grid, kTcThreads, smem, stream>>>(tq, tk,
                                                                    tv, p);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_wgmma(const LaunchArgs& a, cudaStream_t stream) {
  constexpr CUtensorMapDataType kMap = TcType<T>::kMap;
  const int smem = tc_smem_bytes<DP>();
  if (a.smem != smem || a.threads != kTcThreads || a.D > DP || a.D < 1)
    return cudaErrorInvalidValue;
  const int B = static_cast<int>(a.B), Sq = static_cast<int>(a.Sq);
  const int Sk = static_cast<int>(a.Sk), H = static_cast<int>(a.H);
  const int G = static_cast<int>(a.G), D = static_cast<int>(a.D);
  const bool q_rows = a.maps & 1, k_rows = a.maps & 2, v_rows = a.maps & 4;
  // the kernel loads K at q's shift: q and k take the row map only
  // together, with one kv head per q head and one shift per head
  if (q_rows != k_rows ||
      (q_rows && (H != G || (H > 1 && (a.q_sh - a.k_sh) % 8 != 0))))
    return cudaErrorInvalidValue;
  // with no keys no K/V tile is ever loaded, and an empty tensor has no
  // address to map
  CUtensorMap tq, tk = {}, tv = {};
  if (!encode_map(&tq, kMap, reinterpret_cast<const void*>(a.q), D, H, Sq, B,
                  a.q_sh, a.q_ss, a.q_sb, q_rows) ||
      (Sk > 0 &&
       (!encode_map(&tk, kMap, reinterpret_cast<const void*>(a.k), D, G, Sk, B,
                    a.k_sh, a.k_ss, a.k_sb, k_rows) ||
        !encode_map(&tv, kMap, reinterpret_cast<const void*>(a.v), D, G, Sk, B,
                    a.v_sh, a.v_ss, a.v_sb, v_rows))))
    return cudaErrorInvalidValue;
  TcParams p;
  p.o = reinterpret_cast<void*>(a.o);
  p.lse = reinterpret_cast<float*>(a.lse);
  p.win = reinterpret_cast<const int*>(a.win);
  p.kv_len = static_cast<int>(a.kv_len);
  p.causal_offset = static_cast<int>(a.causal_offset);
  p.B = B;
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.G = G;
  p.D = D;
  p.q_hcol = q_rows ? static_cast<int>(a.q_sh) : -1;
  p.k_hcol = k_rows ? static_cast<int>(a.k_sh) : -1;
  p.v_hcol = v_rows ? static_cast<int>(a.v_sh) : -1;
  p.o_sb = a.o_sb;
  p.o_ss = a.o_ss;
  p.o_sh = a.o_sh;
  p.scale_log2 = static_cast<float>(a.scale * 1.4426950408889634);
  p.causal = static_cast<int>(a.causal);
  const dim3 grid(static_cast<unsigned>(a.grid_x), H, B);
  const int device = static_cast<int>(a.device);
  if (D == DP && a.maps == 0)
    return launch_tc<T, DP, true>(tq, tk, tv, p, grid, smem, device, stream);
  return launch_tc<T, DP, false>(tq, tk, tv, p, grid, smem, device, stream);
}

// the tensor-core kernel in element type T at the head dim padded up to
// the next of 64, 128, 256
template <typename T>
cudaError_t launch_wgmma_any(const LaunchArgs& a, cudaStream_t stream) {
  if (a.D <= 64) return launch_wgmma<T, 64>(a, stream);
  if (a.D <= 128) return launch_wgmma<T, 128>(a, stream);
  if (a.D <= 256) return launch_wgmma<T, 256>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point, loaded with ctypes: one launch on `stream` of the
// kernel `args->kernel` names, on device `args->device`. Returns the
// cudaError_t of the launch (0 = launched); a kernel code or head dim no
// instantiation takes gives cudaErrorInvalidValue.
extern "C" int demodel_flash_attention_fwd(const LaunchArgs* args,
                                           void* stream) {
  const LaunchArgs& a = *args;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != a.device)
    err = cudaSetDevice(static_cast<int>(a.device));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.kernel == 0) return launch_simt_any(a, s);
  if (a.kernel == 1) return launch_wgmma_any<__nv_bfloat16>(a, s);
  if (a.kernel == 2) return launch_wgmma_any<__half>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
