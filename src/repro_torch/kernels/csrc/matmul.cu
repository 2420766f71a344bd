// Hand-written Hopper (sm_90a) tiled matrix product C = A B.
//
// Replaces the Pallas TPU kernel src/repro/kernels/tile_linalg.py
// (_matmul_kernel / matmul): C = A B with an fp32 accumulator over the K
// dimension, the result cast to A's dtype.  A is (M, K), B is (K, N), C is
// (M, N), all row-major and contiguous, fp32 or bf16 (both inputs of one
// dtype).  The Pallas kernel's (bm, bn, bk) blocks are the TPU's tiling;
// this kernel keeps its own tile and masks its edges, so any M, N, K >= 1
// are accepted (the wrapper keeps the JAX divisibility contract on top).
//
// One CTA of kThreads = 256 threads (16 x 16) per 128 x 128 tile of C.  It
// walks K in chunks of kBK = 16: the chunk of A (128 x 16, stored
// transposed, padded row stride) and of B (16 x 128) are staged in shared
// memory as fp32, then each thread accumulates an 8 x 8 register tile of C
// (rows ty * 4 + {0..3} and 64 + ty * 4 + {0..3}, columns likewise from
// tx), reading its 8 + 8 operands per k step as four float4 loads, so each
// shared load feeds 16 FMAs.
//
// What bounds it on H100: at 4096^3 fp32 the product does 137 GFLOP on
// 201 MB, 680 FLOP/byte, far above the fp32 ridge (67 TFLOP/s over
// 3.35 TB/s = 20 FLOP/byte): it is bound by operations.  The FMAs run in
// full fp32 on the CUDA cores (no TF32, so the results hold the float32
// reference's 1e-4); with bf16 inputs the same FMAs run on upcast values,
// so bf16 runs at the fp32 rate, far below the 989 TFLOP/s of the tensor
// cores.  Double-buffered cp.async / TMA staging and wgmma (bf16) or
// 3xTF32 (fp32) are the follow-up (ROADMAP queue D).
//
// Every entry point returns cudaGetLastError() (0 = launched); the Python
// wrapper raises on anything else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 16;
constexpr int kThreads = 256;
constexpr int kLdA = kBM + 4;  // padded, and a multiple of 4 floats for float4 reads

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads) matmul_kernel(const T* A, const T* B, T* C, int M, int N, int K) {
  __shared__ __align__(16) float As[kBK][kLdA];  // A chunk, transposed: As[k][row]
  __shared__ __align__(16) float Bs[kBK][kBN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int r = e / kBK, c = e % kBK;
      const int gr = m0 + r, gc = k0 + c;
      As[c][r] = gr < M && gc < K ? to_f32(A[(long long)gr * K + gc]) : 0.f;
    }
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int r = e / kBN, c = e % kBN;
      const int gr = k0 + r, gc = n0 + c;
      Bs[r][c] = gr < K && gc < N ? to_f32(B[(long long)gr * N + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (c < N) store(&C[(long long)r * N + c], acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, void* c, int M, int N, int K, void* stream) {
  if (M < 1 || N < 1 || K < 1 || (M + kBM - 1) / kBM > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  matmul_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c), M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int matmul_f32(const void* a, const void* b, void* c, int M, int N, int K, void* stream) {
  return launch<float>(a, b, c, M, N, K, stream);
}

extern "C" int matmul_bf16(const void* a, const void* b, void* c, int M, int N, int K, void* stream) {
  return launch<__nv_bfloat16>(a, b, c, M, N, K, stream);
}
