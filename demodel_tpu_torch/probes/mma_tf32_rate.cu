// Probe: how fast does the card run `mma.sync.m16n8k8` with TF32 operands,
// the product K1's float32 kernel (csrc/flash_attention.cu,
// `flash_fwd_tf32x3`) issues three times a pair? Its rate, and not the
// card's 495 TFLOP/s of dense TF32 (which `wgmma` reaches), bounds that
// kernel.
//
// Build and run on a machine with an sm_90a card, from the repo root:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//     -o build/mma_tf32_rate demodel_tpu_torch/probes/mma_tf32_rate.cu
//   build/mma_tf32_rate
//
// One block of W warps per SM (W = 1, 2, 4, 8, 16), each warp issuing
// 4096 rounds of 8 products into 8 independent accumulators (the
// throughput) or of 8 products into one accumulator (the dependent
// chain's latency, W = 1). It prints one JSON line: for each case the
// device ms (CUDA events, after a warm-up launch), the products issued,
// the TF32 TFLOP/s they make (2 * 16 * 8 * 8 a product) and the SM cycles
// a product takes on one of the SM's 4 sub-partitions, from the SM clock
// the kernel reads (clock64) over its longest block.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>

constexpr int kRounds = 4096;

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool kChain>
__global__ void run(float* out, long long* cycles) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1e-3f * (threadIdx.x + i));
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(1e-3f * (blockIdx.x + i));
  float d[8][4] = {};
  const long long t0 = clock64();
  for (int r = 0; r < kRounds; ++r) {
#pragma unroll
    for (int j = 0; j < 8; ++j) mma_tf32(d[kChain ? 0 : j], a, b);
  }
  __syncthreads();
  const long long t1 = clock64();
  float s = 0.f;
  for (int j = 0; j < 8; ++j)
    for (int i = 0; i < 4; ++i) s += d[j][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out = nullptr;
  long long* cycles = nullptr;
  cudaMalloc(&out, sizeof(float) * sms * 16 * 32);
  cudaMalloc(&cycles, sizeof(long long) * sms);
  long long host[1024];
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  printf("{\"sms\": %d, \"cases\": [", sms);
  const int warps[] = {1, 2, 4, 8, 16, 1};
  for (int c = 0; c < 6; ++c) {
    const bool chain = c == 5;
    const int w = warps[c];
    auto kernel = chain ? run<true> : run<false>;
    kernel<<<sms, 32 * w>>>(out, cycles);
    cudaEventRecord(e0);
    kernel<<<sms, 32 * w>>>(out, cycles);
    cudaEventRecord(e1);
    const cudaError_t err = cudaEventSynchronize(e1);
    float ms = 0.f;
    cudaEventElapsedTime(&ms, e0, e1);
    cudaMemcpy(host, cycles, sizeof(long long) * sms, cudaMemcpyDeviceToHost);
    long long most = 0;
    for (int i = 0; i < sms; ++i) most = host[i] > most ? host[i] : most;
    const double products = 8.0 * kRounds * w * sms;
    // one block an SM: its w warps share 4 sub-partitions
    const double per_sub = (w < 4 ? w : 4);
    printf("%s{\"warps_per_sm\": %d, \"dependent_chain\": %s, \"error\": %d, "
           "\"ms\": %.6f, \"products\": %.0f, \"tflops\": %.3f, "
           "\"sm_cycles\": %lld, \"cycles_per_product_per_subpartition\": "
           "%.3f}",
           c ? ", " : "", w, chain ? "true" : "false", static_cast<int>(err),
           ms, products, products * 2 * 16 * 8 * 8 / (ms * 1e-3) / 1e12, most,
           most * per_sub / (8.0 * kRounds * w));
  }
  printf("]}\n");
  return 0;
}
