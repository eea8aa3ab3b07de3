// Fused flash-attention forward for NVIDIA Hopper (sm_90a): two kernels,
// chosen by the input dtype, both on the tensor cores at every head dim up
// to 256. bf16 and f16 go to the `wgmma` kernel; float32 goes to the
// `mma.sync` kernel that splits every operand into two TF32 values (3xTF32).
// A head dim past 256, float64 or any other dtype has no kernel: the
// wrapper raises before a launch, and the entry point returns
// cudaErrorInvalidValue for a kernel code or head dim it does not know.
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
// float32: `flash_fwd_tf32x3<DP>`, on the tensor cores. The JAX kernel
// computes in fp32 and the f32 limits (2e-5 against the reference, 1e-4 on
// the card) rule out one TF32 product (10 mantissa bits), but not three:
// each operand x is split in registers into x_hi (x with its 13 low
// mantissa bits cleared, a TF32 value) and x_lo = x - x_hi (exact), and
// a.b ~ a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, summed in fp32; the tensor core
// reads the top 19 bits of x_lo, and a_lo.b_lo is dropped, so a product is
// off by at most about 2^-19 relative (the card reads 2e-6 to 9e-6 against
// the plain version). Both products run on
// `mma.sync.m16n8k8.f32.tf32.tf32.f32`. What bounds it is operations: at
// S=512, H=32, G=8, D=256, causal, 4.3 GFLOP over 42 MB, i.e. 26 us of
// exact-f32 work at 495 / 3 TFLOP/s against 12.5 us of HBM time, where the
// CUDA cores' 67 TFLOP/s would need 64 us (a CUDA-core kernel with one key
// a lane reached 10.7 TFLOP/s there, bound by shared-memory loads). So the
// design spends ALU work (two operations an element for the split) to
// keep shared memory at one copy of each tile, and makes every fragment
// load a vector load (see the kernel). One block of 4 warps per (64 query
// rows, head, batch row), each warp 16 rows; 32-key K and V tiles stream
// through a 2-stage `cp.async` ring, as does the Q tile once (scaled by
// scale * log2 e in place): 16-byte copies where the base and strides
// allow, else 4-byte ones, so any stride with a unit last one is read in
// place (OpenLLaMA-3B's 400-byte f32 heads, strided views, D=99). Why
// `mma.sync` and not `wgmma`: `wgmma` reads tf32 operands K-major from
// shared memory, so the split would need hi and lo copies of every tile
// there (and V transposed), and at D=256 one 64 x 256 f32 tile alone is
// 64 KB; `mma.sync` takes its operands from registers, and a synchronous
// product needs no fence. P stays in registers between the two products
// (the P.V step's keys are permuted to match the accumulator's layout, and
// V's rows read in that order) and is split too. The softmax follows the
// bf16/f16 kernel's rules: `k_end` cut at the block's last causal row,
// masked scores weigh exactly 0 (l == 0 marks a row with no key), LSE
// m + log l. DP is the head dim rounded up to a multiple of 16, one
// instantiation each from 16 to 256, so the products' loops hold no
// run-time guard on D (a body at DP 32/64/128/256 with the guards took 19%
// longer on the card at D=128 and at D=256, DP the same); the block takes
// 205,824 bytes of shared memory at DP=256 (one block an SM) and 128 fp32
// accumulator registers a thread for O there (243 registers, no spill).
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
  long long kernel;  // 0: f32 (3xTF32); 1, 2: bf16, f16; all tensor cores
  long long maps;    // tensor cores: bit 0, 1, 2 set when q, k, v are read
                     // through the row map (else the 4-D map)
  long long grid_x, threads, smem;
  long long device;
  double scale;
};

namespace {

constexpr float kNegInf = -1e30f;  // mask value and LSE sentinel

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

// ---------------------------------------------------------- float32, 3xTF32

constexpr int kF32Rows = 64;      // query rows per block: 16 per warp
constexpr int kF32Keys = 32;      // keys per K/V tile
constexpr int kF32Stages = 2;     // K/V ring depth
constexpr int kF32Threads = 128;  // 4 warps
constexpr int kF32PadQK = 16;     // floats past DP in a Q or K row
constexpr int kF32PadV = 4;       // floats past DP in a V row

// Floats between Q or K rows: 16 banks mod 32 (DP is a multiple of 16)
template <int DP>
__host__ __device__ constexpr int f32_ld_qk() {
  return DP % 32 == 0 ? DP + kF32PadQK : DP;
}

// The Q tile and the K and V rings: 205,824 bytes at DP=256 (one block an
// SM), 107,520 at 128 and 96,768 at 112 (two)
template <int DP>
__host__ __device__ constexpr int f32_smem_bytes() {
  return 4 * (f32_ld_qk<DP>() * (kF32Rows + kF32Stages * kF32Keys) +
              (DP + kF32PadV) * kF32Stages * kF32Keys);
}

struct F32Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;       // [B, Sq, H] or nullptr
  const int* win;   // [2, B]: kv_len per batch row, then causal_offset;
                    // nullptr: kv_len / causal_offset below for every row
  int kv_len, causal_offset;
  int B, Sq, Sk, H, G, D;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale_log2;  // softmax scale * log2(e), folded into Q
  int causal;
  // 16-byte copies (q, k, v) and stores (o): base and strides allow them
  int q_vec, k_vec, v_vec, o_vec;
};

// x = hi + lo exactly: hi is x with its 13 low mantissa bits cleared (a
// TF32 value), lo = x - hi (exact in fp32, |lo| < 2^-10 |x|); the tensor
// core reads lo's top 19 bits, so lo loses at most 2^-10 of itself. Two
// ALU operations an element.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d[16x8] += a[16x8] . b[8x8] on the tensor cores, TF32 in, fp32 sum
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a.b to about fp32 accuracy (2^-19 relative a product at worst):
// the big x small terms, then big x big; small x small is dropped
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Rows row0..row0 + kRows - 1 of one (batch row, head) of q, k or v into a
// shared tile of rows `ld` floats apart, columns 0..DP-1 (what the products
// read). The copy itself zero fills columns past D and rows past `rows`
// (src-size 0 reads nothing): 16 bytes at a time where `vec` (a 16-byte
// aligned base and strides a multiple of 4 elements), else 4. Thread i
// takes rows i / 4 (+ 32, ...) and every fourth 4-column chunk.
template <int kRows, int DP>
__device__ __forceinline__ void f32_load_tile(uint32_t dst, int ld,
                                              const float* src,
                                              long long s_row, int row0,
                                              int rows, int D, bool vec) {
  static_assert(kRows % (kF32Threads / 4) == 0, "rows per thread");
  const int c0 = 4 * (threadIdx.x & 3);
#pragma unroll
  for (int rr = 0; rr < kRows / (kF32Threads / 4); ++rr) {
    const int r = (threadIdx.x >> 2) + rr * (kF32Threads / 4);
    const int row = row0 + r;
    const float* g = src + row * s_row;
    const uint32_t d = dst + 4 * r * ld;
#pragma unroll
    for (int c = c0; c < DP; c += 16) {
      if (vec) {
        const int n = row < rows ? min(max(D - c, 0), 4) : 0;
        cp_async16(d + 4 * c, n > 0 ? g + c : src, 4 * n);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in = row < rows && c + e < D;
          cp_async4(d + 4 * (c + e), in ? g + c + e : src, in ? 4 : 0);
        }
      }
    }
  }
}

// Fragment layouts of mma.m16n8k8 (TF32), lane = 4 g + t: A holds (row g,
// k t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B (k t, n g), (t + 4, g);
// the accumulator (g, n 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
// The order of k within a product and of n within O's columns is free, so
// both are permuted to make every fragment load a vector load:
// - Q.K^T takes 16 head-dim columns in two steps, step s giving k t to
//   column 4t + 2s and k t + 4 to 4t + 2s + 1: one 16-byte load of Q's rows
//   g and g + 8 and of K's row g serves both steps;
// - P.V's step of 8 keys gives k t to key 2t and t + 4 to key 2t + 1, which
//   is what the S accumulator holds (P never leaves registers); its two
//   n-blocks of a 16-column group give lane g the columns 2g (block 0) and
//   2g + 1 (block 1): one 8-byte load of V's rows 2t and 2t + 1 serves
//   both, and thread t ends up holding 4 adjacent output columns,
//   16q + 4t .. 16q + 4t + 3, stored as one 16-byte store.
// Shared rows are DP + 16 floats apart for Q and K (a 16-byte load's
// quarter-warp reads two rows 16 banks apart) and DP + 4 for V (an 8-byte
// load's half-warp reads rows 2t, 8 banks apart): no bank conflicts.
//
// DP is the head dim rounded up to a multiple of 16 (16 instantiations,
// 16..256) and p.D <= DP the true one: columns D..DP-1 are zeros in shared
// memory and columns < D are stored. The products' loops run over DP, a
// constant, so no run-time guard on D sits among them.
template <int DP>
__global__ void __launch_bounds__(kF32Threads)
    flash_fwd_tf32x3(const F32Params p) {
  static_assert(DP % 16 == 0 && DP <= 256, "padded head dim");
  constexpr int kLqk = f32_ld_qk<DP>();
  constexpr int kLv = DP + kF32PadV;
  constexpr int kTileK = kF32Keys * kLqk;
  constexpr int kTileV = kF32Keys * kLv;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;                          // [kF32Rows][kLqk] q * scale
  float* sk = sq + kF32Rows * kLqk;          // kF32Stages K tiles
  float* sv = sk + kF32Stages * kTileK;      // kF32Stages V tiles
  const uint32_t sq_u = smem_u32(sq);
  const uint32_t sk_u = smem_u32(sk);
  const uint32_t sv_u = smem_u32(sv);

  // (q tile, head, batch row) from the linear block index, the q tile the
  // slowest and in descending order: the longest causal tiles start first
  const int hb = p.H * p.B;
  const int lin = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const int qt = gridDim.x - 1 - lin / hb;
  const int h = (lin % hb) % p.H;
  const int b = (lin % hb) / p.H;
  const int q0 = qt * kF32Rows;
  const int g = h / (p.H / p.G);  // GQA: the kv head this q head reads
  const int kv_len = p.win != nullptr ? p.win[b] : p.kv_len;
  const int offset = p.win != nullptr ? p.win[p.B + b] : p.causal_offset;
  const int D = p.D;

  // keys any row of this block can see: the valid prefix, cut at the
  // causal diagonal of the block's last real row (tiles past it skipped);
  // keys past k_end load as zeros
  const int k_lim = min(kv_len, p.Sk);
  int k_end = k_lim;
  if (p.causal) k_end = min(k_end, min(q0 + kF32Rows, p.Sq) + offset);
  const int n_tiles = k_end > 0 ? (k_end + kF32Keys - 1) / kF32Keys : 0;

  const float* kg = p.k + b * p.k_sb + g * p.k_sh;
  const float* vg = p.v + b * p.v_sb + g * p.v_sh;
  if (n_tiles > 0) {
    f32_load_tile<kF32Rows, DP>(sq_u, kLqk, p.q + b * p.q_sb + h * p.q_sh,
                                p.q_ss, q0, p.Sq, D, p.q_vec);
    f32_load_tile<kF32Keys, DP>(sk_u, kLqk, kg, p.k_ss, 0, k_end, D,
                                p.k_vec);
    f32_load_tile<kF32Keys, DP>(sv_u, kLv, vg, p.v_ss, 0, k_end, D,
                                p.v_vec);
    cp_async_commit();
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;                 // fragment row group
  const int tc = lane & 3;                  // fragment column
  const int r0 = warp * 16 + gr;            // block rows r0 and r0 + 8

  float o[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[j][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max, log2 units
  float l[2] = {0.f, 0.f};              // this thread's share of the sum

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t & 1;
    const int t0 = t * kF32Keys;
    // the next tile streams into the other stage while this one is used
    if (t + 1 < n_tiles) {
      f32_load_tile<kF32Keys, DP>(sk_u + 4 * (s ^ 1) * kTileK, kLqk, kg,
                                  p.k_ss, t0 + kF32Keys, k_end, D, p.k_vec);
      f32_load_tile<kF32Keys, DP>(sv_u + 4 * (s ^ 1) * kTileV, kLv, vg,
                                  p.v_ss, t0 + kF32Keys, k_end, D, p.v_vec);
    }
    cp_async_commit();
    cp_async_wait1();  // this tile's copies have landed (this thread's)
    __syncthreads();   // ... and every thread's
    if (t == 0) {
      // Q scaled in place once (scale * log2 e: the softmax runs in base 2)
      for (int i = threadIdx.x; i < kF32Rows * DP; i += kF32Threads) {
        float* x = sq + (i / DP) * kLqk + i % DP;
        *x *= p.scale_log2;
      }
      __syncthreads();
    }

    // S = Q.K^T, 16 rows x 32 keys a warp (4 blocks of 8 keys), 16 columns
    // an iteration: big x big into `sb`, the two big x small terms into
    // `ss` (two accumulators: twice the independent chains)
    float sb[4][4], ss[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) sb[j][i] = ss[j][i] = 0.f;
    const float* qa = sq + r0 * kLqk + 4 * tc;
    const float* kb = sk + s * kTileK + gr * kLqk + 4 * tc;
    // unrolled whole up to DP=128 (8-10% faster at 128 on the card), in
    // pairs above it (whole was 5% slower at 256)
    constexpr int kUnrollQK = DP <= 128 ? DP / 16 : 2;
#pragma unroll kUnrollQK
    for (int d0 = 0; d0 < DP; d0 += 16) {
      const float4 qx = *reinterpret_cast<const float4*>(qa + d0);
      const float4 qy = *reinterpret_cast<const float4*>(qa + 8 * kLqk + d0);
      uint32_t ah[2][4], al[2][4];
      split_tf32(qx.x, ah[0][0], al[0][0]);
      split_tf32(qy.x, ah[0][1], al[0][1]);
      split_tf32(qx.y, ah[0][2], al[0][2]);
      split_tf32(qy.y, ah[0][3], al[0][3]);
      split_tf32(qx.z, ah[1][0], al[1][0]);
      split_tf32(qy.z, ah[1][1], al[1][1]);
      split_tf32(qx.w, ah[1][2], al[1][2]);
      split_tf32(qy.w, ah[1][3], al[1][3]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 kx =
            *reinterpret_cast<const float4*>(kb + j * 8 * kLqk + d0);
        uint32_t bh[2][2], bl[2][2];
        split_tf32(kx.x, bh[0][0], bl[0][0]);
        split_tf32(kx.y, bh[0][1], bl[0][1]);
        split_tf32(kx.z, bh[1][0], bl[1][0]);
        split_tf32(kx.w, bh[1][1], bl[1][1]);
#pragma unroll
        for (int st = 0; st < 2; ++st) {
          mma_tf32(ss[j], al[st], bh[st]);
          mma_tf32(ss[j], ah[st], bl[st]);
          mma_tf32(sb[j], ah[st], bh[st]);
        }
      }
    }
    float sc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[j][i] = sb[j][i] + ss[j][i];

    // masks only on the tiles that cross the kv_len edge or the diagonal;
    // sc[j][2i + c] is (row r0 + 8i, key t0 + 8j + 2tc + c)
    const bool edge = t0 + kF32Keys > k_lim;
    const bool diag = p.causal && t0 + kF32Keys - 1 > q0 + offset;
    if (edge || diag) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int key = t0 + 8 * j + 2 * tc + c;
            const int row = q0 + r0 + 8 * i;
            if (!(key < k_lim && (!p.causal || key <= row + offset)))
              sc[j][2 * i + c] = -INFINITY;
          }
    }

    // online softmax in base 2 over the 4 threads of a row; masked scores
    // weigh exactly 0, so a row with no visible key keeps l == 0
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mx = fmaxf(mx, fmaxf(sc[j][2 * i], sc[j][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = fast_exp2(m[i] - m_use);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float e = fast_exp2(sc[j][2 * i + c] - m_use);
          sc[j][2 * i + c] = e;
          sum += e;
        }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        o[j][2 * i] *= alpha;
        o[j][2 * i + 1] *= alpha;
      }
    }

    // O += P.V, 8 keys a step, 16 columns (two n-blocks) a load; P is split
    // like every operand: it must stay fp32 to hold 1e-4
    const float* vb = sv + s * kTileV + 2 * tc * kLv + 2 * gr;
#pragma unroll
    for (int kk = 0; kk < kF32Keys / 8; ++kk) {
      uint32_t ah[4], al[4];
      split_tf32(sc[kk][0], ah[0], al[0]);
      split_tf32(sc[kk][2], ah[1], al[1]);
      split_tf32(sc[kk][1], ah[2], al[2]);
      split_tf32(sc[kk][3], ah[3], al[3]);
#pragma unroll
      for (int q = 0; q < DP / 16; ++q) {
        const float2 va =
            *reinterpret_cast<const float2*>(vb + kk * 8 * kLv + 16 * q);
        const float2 vc = *reinterpret_cast<const float2*>(
            vb + kk * 8 * kLv + kLv + 16 * q);
        uint32_t bh[2], bl[2];
        split_tf32(va.x, bh[0], bl[0]);
        split_tf32(vc.x, bh[1], bl[1]);
        mma_3xtf32(o[2 * q], ah, al, bh, bl);
        split_tf32(va.y, bh[0], bl[0]);
        split_tf32(vc.y, bh[1], bl[1]);
        mma_3xtf32(o[2 * q + 1], ah, al, bh, bl);
      }
    }
    __syncthreads();  // every warp is done with stage s before it refills
  }

  // epilogue: the row sums over the 4 threads of a row, then out's D
  // columns (thread t holds 16q + 4t .. +3 of each 16-column group: one
  // 16-byte store where D is a multiple of 4 and the output allows it)
  // and the LSE, (m + log2 l) * ln 2
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const bool vec4 = p.o_vec && (D & 3) == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + 8 * i;
    if (row >= p.Sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    float* orow = p.o + b * p.o_sb + row * p.o_ss + h * p.o_sh;
#pragma unroll
    for (int q = 0; q < DP / 16; ++q) {
      const int c = 16 * q + 4 * tc;
      if (c < D) {
        const float4 x = make_float4(
            o[2 * q][2 * i] * inv, o[2 * q + 1][2 * i] * inv,
            o[2 * q][2 * i + 1] * inv, o[2 * q + 1][2 * i + 1] * inv);
        if (vec4) {
          *reinterpret_cast<float4*>(orow + c) = x;
        } else {
          orow[c] = x.x;
          if (c + 1 < D) orow[c + 1] = x.y;
          if (c + 2 < D) orow[c + 2] = x.z;
          if (c + 3 < D) orow[c + 3] = x.w;
        }
      }
    }
    if (p.lse != nullptr && tc == 0)
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

template <int DP>
cudaError_t launch_tf32x3(const LaunchArgs& a, cudaStream_t stream) {
  constexpr int smem = f32_smem_bytes<DP>();
  if (a.smem != smem || a.threads != kF32Threads || a.D > DP || a.D < 1)
    return cudaErrorInvalidValue;
  // above the 48 KB default from DP=48 on, so the attribute is set for
  // every instantiation before its first launch
  const cudaError_t err = allow_smem<0, DP>(
      reinterpret_cast<const void*>(flash_fwd_tf32x3<DP>), smem,
      static_cast<int>(a.device));
  if (err != cudaSuccess) return err;
  const auto vec = [](long long ptr, long long sb, long long ss,
                      long long sh) {
    return static_cast<int>(ptr % 16 == 0 && sb % 4 == 0 && ss % 4 == 0 &&
                            sh % 4 == 0);
  };
  F32Params p;
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
  p.D = static_cast<int>(a.D);
  p.q_sb = a.q_sb; p.q_ss = a.q_ss; p.q_sh = a.q_sh;
  p.k_sb = a.k_sb; p.k_ss = a.k_ss; p.k_sh = a.k_sh;
  p.v_sb = a.v_sb; p.v_ss = a.v_ss; p.v_sh = a.v_sh;
  p.o_sb = a.o_sb; p.o_ss = a.o_ss; p.o_sh = a.o_sh;
  p.scale_log2 = static_cast<float>(a.scale * 1.4426950408889634);
  p.causal = static_cast<int>(a.causal);
  p.q_vec = vec(a.q, a.q_sb, a.q_ss, a.q_sh);
  p.k_vec = vec(a.k, a.k_sb, a.k_ss, a.k_sh);
  p.v_vec = vec(a.v, a.v_sb, a.v_ss, a.v_sh);
  p.o_vec = vec(a.o, a.o_sb, a.o_ss, a.o_sh);
  const dim3 grid(static_cast<unsigned>(a.grid_x), p.H, p.B);
  flash_fwd_tf32x3<DP><<<grid, kF32Threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// the float32 kernel at the head dim rounded up to a multiple of 16
template <int DP = 16>
cudaError_t launch_tf32x3_any(const LaunchArgs& a, cudaStream_t stream) {
  if (a.D <= DP) return launch_tf32x3<DP>(a, stream);
  if constexpr (DP < 256) return launch_tf32x3_any<DP + 16>(a, stream);
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
  if (a.kernel == 0) return launch_tf32x3_any(a, s);
  if (a.kernel == 1) return launch_wgmma_any<__nv_bfloat16>(a, s);
  if (a.kernel == 2) return launch_wgmma_any<__half>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
