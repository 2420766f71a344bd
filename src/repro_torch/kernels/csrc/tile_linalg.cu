// Hand-written Hopper (sm_90a) kernels for the four Cholesky tile bodies.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/tile_linalg.py:
//   potrf_kernel  <- _potrf_tile / batched_potrf / grid_potrf
//   trsm_kernel   <- _trsm_tile  / batched_trsm  / grid_trsm
//   syrk_kernel   <- _syrk_tile  / batched_syrk  / grid_syrk
//   gemm_kernel   <- _gemm_tile  / batched_gemm  / grid_gemm
// and the fused gather/compute/scatter entry make_grid_fused (unstacked
// form): every kernel reads its task's blocks straight from the resident
// (nr, nc, b, b) grids through (n, 2) int32 block indices and writes the
// result in place into the written argument's grid.  The batched form is
// the same kernel on a stack viewed as an (n, 1, b, b) grid with identity
// indices.
//
// One CTA per task.  Tasks of one launch are independent (the planner's
// V3/V4 invariants: no task writes a block another task of the launch
// reads or writes), so CTAs never race and nothing needs atomics.  All
// arguments may point into the same grid, so no pointer is __restrict__.
//
// What bounds each kernel on H100, and what the design does about it:
// - POTRF and TRSM are column recurrences: b dependent steps per tile, so
//   they are bound by latency, not by bytes or FLOPs (a group holds few
//   tiles: one POTRF per panel, at most nr-1 TRSMs).  The whole tile (and
//   for TRSM the right-hand side too) sits in shared memory with a padded
//   row stride (b + 1, conflict-free column walks); one thread owns one row
//   and runs the recurrence over shared memory.  At b = 128 this needs
//   66 KB (POTRF) and 132 KB (TRSM) of dynamic shared memory, above the
//   48 KB default, so the launcher raises the limit first.
// - GEMM and SYRK (C -= A B^T, fp32) are the bulk of the FLOPs.  At b = 128
//   one task alone moves 4 tiles (256 KB) for 4.2 MFLOP, 16 FLOP/byte, just
//   below the card's fp32 ridge (67 TFLOP/s over 3.35 TB/s = 20 FLOP/byte);
//   but the tasks of a Cholesky group share their A and B blocks, so a
//   large group, each distinct block counted once, is bound by operations.
//   The kernel stages 32-deep K chunks of A and B in shared memory
//   (transposed, padded) and each of 256 threads keeps an R x R register
//   tile of C (R = ceil(b / 16)), so every shared load feeds R FMAs and a
//   CTA reads each of its input tiles from device memory once.
//   FMAs run on the CUDA cores in full fp32: no TF32, so the results hold
//   the float32 reference's tolerance.
//
// Every entry point returns cudaGetLastError() (0 = launched); the Python
// wrapper raises on anything else, since a refused launch never runs and
// a later synchronize would not report it.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxB = 128;  // largest tile edge the kernels accept
constexpr int kKC = 32;     // K chunk of the GEMM/SYRK shared-memory stage

__device__ __forceinline__ long long block_offset(const int* idx, int task, int nc, int b) {
  const long long r = idx[2 * task], c = idx[2 * task + 1];
  return (r * nc + c) * (long long)b * b;
}

// ---------------------------------------------------------------------------
// POTRF: lower Cholesky factor of one tile, zeros above the diagonal.
// Left-looking column recurrence of _potrf_tile: at step j, thread i >= j
// forms s_i = sum_{k<j} L[i,k] L[j,k] and keeps a[i,j] - s_i in place;
// then rows below the pivot divide by sqrt(a[j,j] - s_j).  The pivot
// itself stays un-rooted in shared memory until the write-back, so no
// thread reads a value another thread rewrites in the same phase.
// ---------------------------------------------------------------------------
__global__ void potrf_kernel(float* grid, int nc, const int* idx, int b) {
  extern __shared__ float T[];
  const int ld = b + 1;
  float* tile = grid + block_offset(idx, blockIdx.x, nc, b);
  for (int e = threadIdx.x; e < b * b; e += blockDim.x) T[(e / b) * ld + e % b] = tile[e];
  __syncthreads();
  const int i = threadIdx.x;  // the row this thread owns (blockDim.x >= b)
  for (int j = 0; j < b; ++j) {
    if (i >= j && i < b) {
      float s = 0.f;
      for (int k = 0; k < j; ++k) s += T[i * ld + k] * T[j * ld + k];
      T[i * ld + j] -= s;
    }
    __syncthreads();
    if (i > j && i < b) T[i * ld + j] /= sqrtf(T[j * ld + j]);
    __syncthreads();
  }
  for (int e = threadIdx.x; e < b * b; e += blockDim.x) {
    const int r = e / b, c = e % b;
    tile[e] = c < r ? T[r * ld + c] : (c == r ? sqrtf(T[r * ld + r]) : 0.f);
  }
}

// ---------------------------------------------------------------------------
// TRSM: X = B inv(L)^T.  Row p of X depends only on row p of B and on L:
// x_j = (b_j - sum_{k<j} x_k L[j,k]) / L[j,j], so one thread per row runs
// forward substitution over its row, overwriting B with X in shared
// memory.  L's upper triangle is never read.
// ---------------------------------------------------------------------------
__global__ void trsm_kernel(const float* lgrid, int lnc, const int* lidx,
                            float* bgrid, int bnc, const int* bidx, int b) {
  extern __shared__ float smem[];
  const int ld = b + 1;
  float* L = smem;
  float* X = smem + b * ld;
  const float* lt = lgrid + block_offset(lidx, blockIdx.x, lnc, b);
  float* bt = bgrid + block_offset(bidx, blockIdx.x, bnc, b);
  for (int e = threadIdx.x; e < b * b; e += blockDim.x) {
    L[(e / b) * ld + e % b] = lt[e];
    X[(e / b) * ld + e % b] = bt[e];
  }
  __syncthreads();
  const int p = threadIdx.x;
  if (p < b) {
    for (int j = 0; j < b; ++j) {
      float s = 0.f;
      for (int k = 0; k < j; ++k) s += X[p * ld + k] * L[j * ld + k];
      X[p * ld + j] = (X[p * ld + j] - s) / L[j * ld + j];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < b * b; e += blockDim.x) bt[e] = X[(e / b) * ld + e % b];
}

// ---------------------------------------------------------------------------
// GEMM / SYRK: C -= A B^T (SYRK: B = A).  256 threads as a 16 x 16 grid;
// thread (tx, ty) owns C[ty + 16 i][tx + 16 j] for i, j < R.
// ---------------------------------------------------------------------------
template <int R>
__device__ __forceinline__ void update_tile(const float* A, const float* Bm, float* C, int b) {
  __shared__ float As[kKC][kMaxB + 1];
  __shared__ float Bs[kKC][kMaxB + 1];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < b; k0 += kKC) {
    const int kc = min(kKC, b - k0);
    for (int e = threadIdx.x; e < b * kc; e += blockDim.x) {
      const int r = e / kc, kk = e % kc;
      As[kk][r] = A[r * b + k0 + kk];
      Bs[kk][r] = Bm[r * b + k0 + kk];
    }
    __syncthreads();
    for (int kk = 0; kk < kc; ++kk) {
      float av[R], bv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < R; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      if (r < b && c < b) C[r * b + c] -= acc[i][j];
    }
}

template <int R>
__global__ void __launch_bounds__(256)
gemm_kernel(const float* ag, int anc, const int* aidx, const float* bg, int bnc,
            const int* bidx, float* cg, int cnc, const int* cidx, int b) {
  update_tile<R>(ag + block_offset(aidx, blockIdx.x, anc, b),
                 bg + block_offset(bidx, blockIdx.x, bnc, b),
                 cg + block_offset(cidx, blockIdx.x, cnc, b), b);
}

template <int R>
__global__ void __launch_bounds__(256)
syrk_kernel(const float* ag, int anc, const int* aidx, float* cg, int cnc,
            const int* cidx, int b) {
  const float* a = ag + block_offset(aidx, blockIdx.x, anc, b);
  update_tile<R>(a, a, cg + block_offset(cidx, blockIdx.x, cnc, b), b);
}

int row_threads(int b) { return ((b + 31) / 32) * 32; }

bool bad_args(int n, int b) { return n < 1 || b < 1 || b > kMaxB; }

}  // namespace

extern "C" {

int tile_potrf(float* grid, int nc, const int* idx, int n, int b, void* stream) {
  if (bad_args(n, b)) return (int)cudaErrorInvalidValue;
  const int smem = b * (b + 1) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(potrf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  potrf_kernel<<<n, row_threads(b), smem, (cudaStream_t)stream>>>(grid, nc, idx, b);
  return (int)cudaGetLastError();
}

int tile_trsm(const float* lgrid, int lnc, const int* lidx, float* bgrid, int bnc,
              const int* bidx, int n, int b, void* stream) {
  if (bad_args(n, b)) return (int)cudaErrorInvalidValue;
  const int smem = 2 * b * (b + 1) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(trsm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  trsm_kernel<<<n, row_threads(b), smem, (cudaStream_t)stream>>>(lgrid, lnc, lidx, bgrid, bnc, bidx, b);
  return (int)cudaGetLastError();
}

#define TILE_DISPATCH(KERNEL, ...)                                      \
  switch ((b + 15) / 16) {                                              \
    case 1: KERNEL<1><<<n, 256, 0, s>>>(__VA_ARGS__); break;            \
    case 2: KERNEL<2><<<n, 256, 0, s>>>(__VA_ARGS__); break;            \
    case 3: KERNEL<3><<<n, 256, 0, s>>>(__VA_ARGS__); break;            \
    case 4: KERNEL<4><<<n, 256, 0, s>>>(__VA_ARGS__); break;            \
    case 5: KERNEL<5><<<n, 256, 0, s>>>(__VA_ARGS__); break;            \
    case 6: KERNEL<6><<<n, 256, 0, s>>>(__VA_ARGS__); break;            \
    case 7: KERNEL<7><<<n, 256, 0, s>>>(__VA_ARGS__); break;            \
    default: KERNEL<8><<<n, 256, 0, s>>>(__VA_ARGS__); break;           \
  }

int tile_syrk(const float* ag, int anc, const int* aidx, float* cg, int cnc,
              const int* cidx, int n, int b, void* stream) {
  if (bad_args(n, b)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  TILE_DISPATCH(syrk_kernel, ag, anc, aidx, cg, cnc, cidx, b)
  return (int)cudaGetLastError();
}

int tile_gemm(const float* ag, int anc, const int* aidx, const float* bg, int bnc,
              const int* bidx, float* cg, int cnc, const int* cidx, int n, int b,
              void* stream) {
  if (bad_args(n, b)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  TILE_DISPATCH(gemm_kernel, ag, anc, aidx, bg, bnc, bidx, cg, cnc, cidx, b)
  return (int)cudaGetLastError();
}

}  // extern "C"
