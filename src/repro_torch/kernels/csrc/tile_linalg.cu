// Hand-written Hopper (sm_90a) kernel for POTRF, the one tile body of blocked
// Cholesky and pivot-free LU still in its simple form (the other eight,
// redesigned, are in tile_lu_sm90.cu).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/tile_linalg.py:
//   potrf_kernel   <- _potrf_tile  / batched_potrf  / grid_potrf
// and the fused gather/compute/scatter entry make_grid_fused, in both its
// forms: the kernel reads its task's block straight from the resident
// (nr, nc, b, b) grid through (n, 2) int32 block indices and writes the
// factor in place.  The batched form is the same kernel on a stack viewed as
// an (n, 1, b, b) grid with identity indices.
//
// The stacked form (make_grid_fused's kernel_stacked, grid (B, n)) is the
// same kernel under a second grid dimension: the grid is (B, nr, nc, b, b),
// lane = blockIdx.y reads and writes its block at lane * lane_stride elements
// from the grid's base, and all B lanes share one index array.  The
// unstacked form is batch = 1.  A stacked drain's lanes are whole
// independent workloads, so one launch of B * n CTAs turns a single drain's
// one POTRF a panel into a B-wide launch.
//
// One CTA per (lane, task).  Tasks of one launch are independent (the
// planner's V3/V4 invariants: no task writes a block another task of the
// launch reads or writes; V5: lanes are disjoint), so CTAs never race and
// nothing needs atomics.
//
// What bounds it on H100: latency, not bytes or FLOPs.  POTRF is a column
// recurrence, b dependent steps a tile, and a group holds one tile (one POTRF
// a panel).  The tile sits in shared memory with a padded row stride (b + 1,
// conflict-free column walks); one thread owns one row and runs the
// recurrence over shared memory.  At b = 128 this needs 66 KB of dynamic
// shared memory, above the 48 KB default, so the launcher raises the limit
// first.
//
// The entry point returns cudaGetLastError() (0 = launched); the Python
// wrapper raises on anything else, since a refused launch never runs and a
// later synchronize would not report it.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxB = 128;        // largest tile edge the kernel accepts
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

int row_threads(int b) { return ((b + 31) / 32) * 32; }

bool bad_edge(int e) { return e < 1 || e > kMaxB; }

bool bad_args(int n, int batch, int b) {
  return n < 1 || batch < 1 || batch > kMaxBatch || bad_edge(b);
}

// bytes of `rows` shared-memory rows of b floats at the padded stride b + 1
int padded_bytes(int rows, int b) { return rows * (b + 1) * (int)sizeof(float); }

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

// The entry takes the grid, its block columns nc, its (n, 2) block indices
// and its lane stride in elements (the size of one lane of a stacked grid;
// unused when batch == 1), then the task count n, the lane count batch, the
// tile edge b and the stream.
int tile_potrf(float* grid, int nc, const int* idx, long long lane, int n, int batch, int b,
               void* stream) {
  if (bad_args(n, batch, b)) return (int)cudaErrorInvalidValue;
  return launch_smem(potrf_kernel, n, batch, row_threads(b), padded_bytes(b, b), stream, grid, nc,
                     idx, lane, b);
}

}  // extern "C"
