// Hand-written Hopper (sm_90a) kernels for three of the nine tile bodies of
// blocked Cholesky and pivot-free LU (GETRF, TRSML, TRSMU, SYRK, GEMM and
// GEMMNN, redesigned, are in tile_lu_sm90.cu).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/tile_linalg.py:
//   potrf_kernel   <- _potrf_tile  / batched_potrf  / grid_potrf
//   trsm_kernel    <- _trsm_tile   / batched_trsm   / grid_trsm
//   trsmul_kernel  <- _trsmul_tile / batched_trsmul / grid_trsmul
// and the fused gather/compute/scatter entry make_grid_fused, in both its
// forms: every kernel reads its task's blocks straight from the resident
// (nr, nc, br, bc) grids through (n, 2) int32 block indices and writes the
// result in place into the written argument's grid.  Each argument has its
// own tile shape.  The batched form is the same kernel on a stack viewed as
// an (n, 1, br, bc) grid with identity indices.
//
// The stacked form (make_grid_fused's kernel_stacked, grid (B, n)) is the
// same kernels under a second grid dimension: the grids are
// (B, nr, nc, br, bc), lane b = blockIdx.y reads and writes its blocks at
// b * lane_stride elements from the base of each argument's grid, and all
// B lanes share one index array.  The unstacked form is batch = 1.  A
// stacked drain's lanes are whole independent workloads, so one launch of
// B * n CTAs turns the small groups of a single drain (one POTRF per
// panel) into B-wide launches without new bodies.
//
// One CTA per (lane, task).  Tasks of one launch are independent (the
// planner's V3/V4 invariants: no task writes a block another task of the
// launch reads or writes; V5: lanes are disjoint), so CTAs never race and
// nothing needs atomics.  All arguments may point into the same grid, so
// no pointer is __restrict__.
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
// - TRSMUL is the LU family's bottom-up triangular solve, latency bound
//   for the same reason (at most nr a group).  It is a row recurrence whose
//   columns are independent; a right-hand side may be a single column (a
//   blocked vector), so each column gets a team of g lanes (g = 32 for one
//   column, 2 for 128) that split each row's inner product and reduce it
//   with warp shuffles.
//
// Every entry point returns cudaGetLastError() (0 = launched); the Python
// wrapper raises on anything else, since a refused launch never runs and
// a later synchronize would not report it.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxB = 128;     // largest tile edge the kernels accept
constexpr int kThreads = 256;  // threads of a TRSMUL CTA
constexpr int kMaxBatch = 65535;  // lanes of a stacked launch: gridDim.y's limit

// Element offset of this CTA's block: lane blockIdx.y of a stacked grid
// (lane = 0 for an unstacked one), block (idx[task]) of that lane.
__device__ __forceinline__ long long block_offset(const int* idx, int task, int nc, int br, int bc,
                                                  long long lane) {
  const long long r = idx[2 * task], c = idx[2 * task + 1];
  return blockIdx.y * lane + (r * nc + c) * (long long)br * bc;
}

// ---------------------------------------------------------------------------
// POTRF: lower Cholesky factor of one tile, zeros above the diagonal.
// Left-looking column recurrence of _potrf_tile: at step j, thread i >= j
// forms s_i = sum_{k<j} L[i,k] L[j,k] and keeps a[i,j] - s_i in place;
// then rows below the pivot divide by sqrt(a[j,j] - s_j).  The pivot
// itself stays un-rooted in shared memory until the write-back, so no
// thread reads a value another thread rewrites in the same phase.
// ---------------------------------------------------------------------------
__global__ void potrf_kernel(float* grid, int nc, const int* idx, long long lane, int b) {
  extern __shared__ float T[];
  const int ld = b + 1;
  float* tile = grid + block_offset(idx, blockIdx.x, nc, b, b, lane);
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
// TRSM: X = B inv(L)^T with L lower (_trsm_tile; B is b x b).  Row p of X
// depends only on row p of B and on the triangle:
//   x_j = (b_j - sum_{k<j} x_k L[j][k]) / L[j][j]
// so one thread per row runs forward substitution over its row, overwriting
// B with X in shared memory.  L's upper triangle is never read.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void trsm_right_rows(const float* tgrid, int tnc, const int* tidx,
                                                long long tlane, float* bgrid, int bnc,
                                                const int* bidx, long long blane, int br, int b) {
  extern __shared__ float smem[];
  const int ld = b + 1;
  float* T = smem;           // the triangle, row-major, padded
  float* X = smem + b * ld;  // B, then X, row-major, padded
  const float* tt = tgrid + block_offset(tidx, blockIdx.x, tnc, b, b, tlane);
  float* bt = bgrid + block_offset(bidx, blockIdx.x, bnc, br, b, blane);
  // both staged in one pass, two loads in flight per step
  for (int e = threadIdx.x; e < b * b; e += blockDim.x) {
    T[(e / b) * ld + e % b] = tt[e];
    X[(e / b) * ld + e % b] = bt[e];
  }
  __syncthreads();
  const int p = threadIdx.x;
  if (p < br) {
    for (int j = 0; j < b; ++j) {
      float s = 0.f;
      for (int k = 0; k < j; ++k) s += X[p * ld + k] * T[j * ld + k];
      X[p * ld + j] = (X[p * ld + j] - s) / T[j * ld + j];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < br * b; e += blockDim.x) bt[e] = X[(e / b) * ld + e % b];
}

__global__ void trsm_kernel(const float* lgrid, int lnc, const int* lidx, long long llane,
                            float* bgrid, int bnc, const int* bidx, long long blane, int b) {
  trsm_right_rows(lgrid, lnc, lidx, llane, bgrid, bnc, bidx, blane, b, b);
}

// ---------------------------------------------------------------------------
// TRSMUL: X = inv(U) B with U non-unit upper, bottom-up (_trsmul_tile); B is
// (b, bc).  Row recurrence, columns independent:
//   X[i] = (B[i] - sum_{k>i} U[i][k] X[k]) / U[i][i]
// so U's strictly-lower part is never read (packed L\U blocks pass
// unmasked).  Column c belongs to a team of g lanes of one warp (g a power
// of two, g * bc <= 256): the team splits each row's inner product, reduces
// it with xor shuffles inside the team, and its first lane writes X[i][c].
// Each column is written and read by its own warp only, so a row needs
// __syncwarp(), not a CTA barrier.  X is held transposed (ld b + 1), so a
// team's lanes read consecutive addresses.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
trsmul_kernel(const float* tgrid, int tnc, const int* tidx, long long tlane, float* bgrid,
              int bnc, const int* bidx, long long blane, int b, int bc, int g) {
  extern __shared__ float smem[];
  const int ld = b + 1;
  float* T = smem;           // the triangle, row-major, padded
  float* XT = smem + b * ld;  // X transposed: XT[c * ld + i] = X[i][c]
  const float* tt = tgrid + block_offset(tidx, blockIdx.x, tnc, b, b, tlane);
  float* bt = bgrid + block_offset(bidx, blockIdx.x, bnc, b, bc, blane);
  for (int e = threadIdx.x; e < b * b; e += kThreads) T[(e / b) * ld + e % b] = tt[e];
  for (int e = threadIdx.x; e < b * bc; e += kThreads) XT[(e % bc) * ld + e / bc] = bt[e];
  __syncthreads();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int sub = lane % g;
  const int c = warp * (32 / g) + lane / g;
  const bool own = c < bc;
  float* x = XT + (own ? c : 0) * ld;
  for (int step = 0; step < b; ++step) {
    const int i = b - 1 - step;
    float s = 0.f;
    if (own) {
      for (int k = i + 1 + sub; k < b; k += g) s += T[i * ld + k] * x[k];
    }
    for (int off = g / 2; off > 0; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (own && sub == 0) x[i] = (x[i] - s) / T[i * ld + i];
    __syncwarp();
  }
  __syncthreads();
  for (int e = threadIdx.x; e < b * bc; e += kThreads) bt[e] = XT[(e % bc) * ld + e / bc];
}

int row_threads(int b) { return ((b + 31) / 32) * 32; }

bool bad_edge(int e) { return e < 1 || e > kMaxB; }

bool bad_args(int n, int batch, int b) {
  return n < 1 || batch < 1 || batch > kMaxBatch || bad_edge(b);
}

// bytes of `rows` shared-memory rows of b floats at the padded stride b + 1
int padded_bytes(int rows, int b) { return rows * (b + 1) * (int)sizeof(float); }

// the largest power of two g <= 32 with g * bc <= kThreads: lanes per column
int team_lanes(int bc) {
  int g = 32;
  while (g > 1 && g * bc > kThreads) g /= 2;
  return g;
}

// Launch `kernel` on n x batch CTAs with `smem` bytes of dynamic shared
// memory, raising the kernel's limit first (above 48 KB it must be asked for).
template <typename K, typename... Args>
int launch_smem(K kernel, int n, int batch, int threads, int smem, void* stream, Args... args) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(n, batch), threads, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Every entry takes, per argument, its grid, the grid's block columns nc,
// its (n, 2) block indices and its lane stride in elements (the size of one
// lane of a stacked grid; unused when batch == 1), then the task count n,
// the lane count batch, the tile dimensions and the stream.
int tile_potrf(float* grid, int nc, const int* idx, long long lane, int n, int batch, int b,
               void* stream) {
  if (bad_args(n, batch, b)) return (int)cudaErrorInvalidValue;
  return launch_smem(potrf_kernel, n, batch, row_threads(b), padded_bytes(b, b), stream, grid, nc,
                     idx, lane, b);
}

int tile_trsm(const float* lgrid, int lnc, const int* lidx, long long llane, float* bgrid,
              int bnc, const int* bidx, long long blane, int n, int batch, int b, void* stream) {
  if (bad_args(n, batch, b)) return (int)cudaErrorInvalidValue;
  return launch_smem(trsm_kernel, n, batch, row_threads(b), padded_bytes(2 * b, b), stream, lgrid,
                     lnc, lidx, llane, bgrid, bnc, bidx, blane, b);
}

int tile_trsmul(const float* ugrid, int unc, const int* uidx, long long ulane, float* bgrid,
                int bnc, const int* bidx, long long blane, int n, int batch, int b, int bc,
                void* stream) {
  if (bad_args(n, batch, b) || bad_edge(bc)) return (int)cudaErrorInvalidValue;
  return launch_smem(trsmul_kernel, n, batch, kThreads, padded_bytes(b + bc, b), stream, ugrid,
                     unc, uidx, ulane, bgrid, bnc, bidx, blane, b, bc, team_lanes(bc));
}

}  // extern "C"
