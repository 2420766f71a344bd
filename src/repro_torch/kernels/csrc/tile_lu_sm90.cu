// Hand-written Hopper (sm_90a) kernels for the nine tile bodies of blocked
// Cholesky and pivot-free LU, each redesigned from a simple one-CTA-per-task
// kernel.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/tile_linalg.py:
//   potrf_kernel   <- _potrf_tile  / batched_potrf  / grid_potrf
//   getrf_kernel   <- _getrf_tile  / batched_getrf  / grid_getrf
//   trsml_kernel   <- _trsml_tile  / batched_trsml  / grid_trsml
//   trsmu_kernel   <- _trsmu_tile  / batched_trsmu  / grid_trsmu
//   trsmul_kernel  <- _trsmul_tile / batched_trsmul / grid_trsmul
//   trsm_kernel    <- _trsm_tile   / batched_trsm   / grid_trsm
//   syrk_kernel    <- _syrk_tile   / batched_syrk   / grid_syrk
//   gemm_kernel    <- _gemm_tile   / batched_gemm   / grid_gemm
//   gemmnn_kernel  <- _gemmnn_tile / batched_gemmnn / grid_gemmnn
// in three forms: the fused grid form (make_grid_fused's
// kernel: blocks read through (n, 2) int32 indices, the written block updated
// in place), the stacked form (kernel_stacked: lane blockIdx.y, at a lane
// stride per argument, all lanes sharing the indices) and the batched form
// (the grid entry on an (n, 1, r, c) view with identity indices).
//
// B5, make_grid_fused for a group of several segments (the planner's fusion
// across slot tuples: in the matrix-RHS LU solve, A's trailing update and the
// forward solve's update of b form one GEMMNN group, and their TRSMLs one
// TRSML group).  The reference gathers such a group's blocks, runs the
// batched kernel and scatters the result back; on H100 those copies took 9.6
// ms of the solve's 17.4 ms busy replay in 1705 small ops, against a bound
// of about 1 ms (bytes) for the 62 groups' work.  Here each argument of a
// launch carries a segment table (Segs, passed by value: up to kMaxSeg
// segments, each its own grid, block columns, lane stride and first task),
// and a task finds its segment by a scan of the bounds, so the whole group is
// one in-place launch over the same n tasks and launch shape as the gathered
// stack's, every task's arithmetic unchanged: the result equals the gather
// path's bit for bit.  No copy is needed before the write because no task of
// a group reads or writes a block another task of it writes, across segments
// too (the fusion merges only groups that no path connects).
//
// Tasks of one launch never race (the planner's V3/V4: no task writes a block
// another task of the launch reads or writes; V5: lanes are disjoint).  Each
// task's output is cut into pieces that one CTA owns alone, so no CTA writes
// what another reads or writes: nothing needs atomics, and every result is
// deterministic (a stacked padding lane equals the lane it copies, bit for
// bit).  All arguments may point into one grid, so no pointer is __restrict__.
//
// GETRF: pivot-free right-looking LU of one b x b tile, L\U packed in place.
// What bounds it on H100: latency.  Its bytes (0.00004 ms a tile) and FLOPs
// (1.4 M) are nothing; its b steps are a dependent chain, each a column
// division and a rank-1 update of the trailing block.  The simple kernel kept
// the tile in shared memory: every update a dependent shared load, FMA and
// store, two CTA barriers a step.  The design:
// - the tile lives in registers: 512 threads, thread (warp w, lane) holding
//   rows w + 16 i (i < 8) and columns lane + 32 j (j < 4), so every thread
//   keeps work as the trailing block shrinks, and a warp holds whole rows;
// - one CTA barrier a step.  Row k, with the pivot, sits in a shared vector
//   double-buffered by the step's parity: the warp that owns row k + 1 writes
//   it into the other buffer right after its update of step k, so a single
//   barrier both publishes it and retires the buffer step k - 1 read;
// - column k never leaves its warp: lane i takes row w + 16 i's entry from
//   the owner lane k % 32 by shuffle, divides it by the pivot (the
//   reference's division, once a row), and shuffles it back to every lane;
// - the update a[i][j] -= l[i] u[j] is a branch-free FMA over the registers
//   that can still change (l and u are zero at and above step k); each 32-step
//   block of pivots is its own instantiation, so the owner's register column
//   is a constant and the finished rows and columns drop out.  fp32 FMAs only.
//
// POTRF: lower Cholesky factor of one b x b tile, zeros above the diagonal,
// in place.  What bounds it on H100: latency, as GETRF (its bytes take
// 0.00004 ms a tile); b dependent steps, each a square root and a division on
// the chain.  The simple kernel kept the tile in shared memory, one thread a
// row: a dependent shared-memory dot product and two CTA barriers a step.
// The design is GETRF's, with the reference's left-looking arithmetic
// (_potrf_tile forms s = L L[j] and takes (a[:, j] - s) / d_j once):
// - the tile in registers, GETRF's mapping (512 threads; rows w + 16 i,
//   columns lane + 32 j), as A's transpose: it is staged through shared memory
//   (row stride b | 1, odd, so the transposed reads are conflict-free), and
//   the warp that owns row r holds column r of A, the lower triangle the
//   reference reads;
// - the sums apart from A: s[i][j] += l_i l_j by fmaf over the full square
//   in a second register array, and c = a - s taken once, when a column is
//   published (subtracting in turn raised the triangular solves' errors:
//   TRSML below).
//   fmaf(l_i, l_j, s) equals fmaf(l_j, l_i, s), so s is exactly symmetric
//   and row k + 1 of s is column k + 1;
// - one CTA barrier a step.  After its update of step k, the warp that owns
//   row k + 1 forms c along it, takes d = __fsqrt_rn(c_{k+1}) (the pivot by
//   shuffle from its lane) and l = c / d below the pivot with div_rn (IEEE's
//   quotient; a / d takes a slow path on the zero dividends), and writes l
//   (d at the pivot, 0 above) into a shared vector double-buffered by the
//   step's parity, in two orders, so that every thread reads its 8 rows' and
//   4 columns' l as three float4s (scripts/matmul_potrf_variants.py times the
//   one-order vector and twelve scalar loads against it): the square root
//   and the division sit on the chain once a step, in one warp;
// - column k of L takes the registers of column k of A's transpose, which no
//   later step reads; each 32-step block of pivots is its own instantiation,
//   as GETRF's, so finished rows and columns drop out of the update.  Zero
//   padding outside a ragged b gives l = 0 there (every pivot lies inside b),
//   and a non-SPD tile gives NaN from its first negative pivot on, as the
//   reference does.
//
// TRSMU: X = B inv(U), U (b x b) non-unit upper, B (br x b), in place.  U's
// strictly-lower part is L's junk of a packed L\U block and is never read.
// What bounds it on H100: latency.  Row p of X depends only on row p of B, but
// within a row the columns form the recurrence
//   x_j = (b_j - sum_{k<j} x_k U[k][j]) / U[j][j],
// which the simple kernel ran with one thread per row: b (b - 1) / 2 = 8128
// dependent FMA + shared-load steps at b = 128, on one CTA per task (31 SMs for
// the LU plan's 31-task group) with 132 KB of shared memory (one CTA an SM).
// Its bytes (0.0012 ms for that group) bound nothing.  The design:
// - rows split across CTAs: 16 or 32 rows each, chosen by the wrapper from the
//   group's size, so the 31-task group runs on 248 CTAs; every CTA reads the
//   task's U (from L2);
// - the recurrence blocked by 16 columns.  A half-warp owns a row, lane c the
//   column J0 + c of block J.  The block is first updated by the columns before
//   it, X_J -= X_{<J} U_{<J,J} (one independent FMA chain a lane, four columns
//   of X a shared load), then solved by a right-looking substitution inside the
//   half-warp: lane j scales by 1 / U[j][j] (read from U), broadcasts by
//   shuffle, lanes c > j subtract.  The dependent chain falls to 448 FMAs plus
//   128 shuffle steps.  A row never leaves its half-warp, so after the staging
//   no CTA barrier runs;
// - shared memory holds only U's upper panels (column block J, rows
//   0 .. J0 + 15, packed: 36 KB at b = 128) and the CTA's rows of X (9 or
//   17 KB), so five or four CTAs share an SM in a stacked launch.
//
// GEMMNN: C (m x q) -= A (m x k) B (k x q), fp32 in and out.  What bounds it
// on H100: bytes for large groups (the LU plan's 961-task group moves 127 MB
// of distinct blocks, 0.039 ms at 3.35 TB/s, against 0.024 ms for 3 x 4.03
// GFLOP at the TF32 rate), and filling the card for small ones (the simple
// kernel ran 4-task groups on 4 CTAs: 128 of 132 SMs idle).
// The design:
// - tensor cores at near-fp32 accuracy (3xTF32): each operand x splits into
//   big = tf32(x) and small = tf32(x - big), rounded as cvt.rna does, and the
//   product accumulates small*big + big*small + big*big in fp32 with
//   mma.sync.m16n8k8.  The split keeps about 22 of fp32's 24 mantissa bits
//   (x - big - small ~ 2^-22 |x|; the dropped small*small term is as small),
//   so a product is off by ~2^-21 relative against an fp32 FMA's 2^-24: the
//   float32 reference's 1e-4 at k = 128 holds with room.  One TF32 product
//   keeps only ~2^-11 relative a term, outside it.  The bound is then 3 x the
//   FLOPs at the TF32 rate;
// - each task's output cut into CTA tiles of 64 x 64 (4 warps of 32 x 32) or
//   32 x 32 (4 warps of 16 x 16): the wrapper takes 64^2 where its tiles still
//   give every SM a CTA, else 32^2 (the 961-task group: 3844 tiles of 64^2; a
//   4-task group: 64 of 32^2).  A 128^2 tile (8 warps, 240 registers, one CTA
//   an SM) was slower than 64^2 at every group size measured;
// - the sum kept apart from C.  The tensor cores' fp32 accumulation is not
//   round-to-nearest: an mma aligns its products to the largest addend and
//   truncates.  Started from -C, every mma of a task dropped the products'
//   low bits against C's exponent (on the LU's dd blocks a trailing update's
//   products are ~1e-12 against entries up to ~1.5), and the LU's 31 updates
//   of a block added the bias up: 28x the fp32 FMA kernel's error on the
//   LU.  One accumulator over a 128-deep product also truncates 48 times,
//   which leaves a Gaussian 128^3 tile ~3x torch.matmul's fp32 error; the
//   split alone stays below it.  (scripts/tf32_error_sources.py measures
//   each source on the card.)  So each 8-deep step's three mmas start from
//   zero, their partial (24 products) is added into an fp32 sum with
//   __fadd_rn, and C - sum is taken once in the epilogue, rounded to
//   nearest: a tile's error sits below torch.matmul's, and the LU's matches
//   the fp32 FMA kernel's;
// - A's rows and B's columns of the tile staged in 32-deep chunks by cp.async
//   into a ring of 3 slots in shared memory, a commit group a chunk: chunk
//   c + 2 loads while chunk c computes, and one barrier a chunk both publishes
//   chunk c and frees chunk c - 1's slot (55 KB for a 64^2 tile; its ~160
//   registers a thread let three such CTAs share an SM, so one CTA's products
//   overlap another's loads; four spill).  16-byte copies where every row is
//   16-byte aligned, 4-byte ones otherwise; zero fill masks the ragged edges
//   (k to a multiple of 8, rows past m, columns past q);
// - C read and written as float2 pairs (two neighbouring columns of an
//   accumulator fragment) where the 16-byte path holds, the stores masked;
// - q < 8 (a blocked vector): no tensor-core tile.  A matrix-vector mapping: a
//   warp per row of C, its lanes over k in full fp32, reduced by xor shuffles
//   in a fixed order; 32 rows a CTA.
//
// SYRK: C (b x b) -= A A^T, the full square (no mirroring: the same function
// as the reference).  The simple kernel ran one CTA a task (the Cholesky
// plan's 31-task group on 31 of 132 SMs) in fp32 FMAs behind synchronous
// staging.  Now it is GEMMNN's tile with B = A^T: the mma's row.col B operand
// is A's own rows, staged by the same cp.async path as A (no transpose), and
// the same output split (launch_shape: the 31-task group as 496 CTAs of
// 32^2, the served 7 x 64 group as 1792 of 64^2) and accumulation.  What
// bounds it: like GEMMNN, bytes for large groups, filling the card for
// small ones.
//
// GEMM: C (b x b) -= A B^T, the Cholesky trailing update, is SYRK with B's
// own block: the same tile, the same kBT staging (B^T from B's rows), the
// same split and accumulation.  The simple kernel ran one CTA a task in fp32
// FMAs behind synchronous staging, the 465-task group at 5.4x its bound;
// now that group runs as 1860 CTAs of 64^2, a 1-task group as 16 of 32^2.
// Both share one body (abt_piece); they keep two __global__ names because
// the profiler's trace tells the kernels apart by name.  Bound: bytes (the
// group's distinct blocks) for large groups, filling the card for small ones.
//
// TRSML: X = inv(L) B, L (b x b) unit lower, B (b x bc), in place.  L's
// diagonal and upper part are U's junk of a packed L\U block, never used.
// What bounds it on H100: latency.  It is TRSMU transposed: column c of X
// depends only on column c of B, but within a column the rows form the
// recurrence
//   x_i = b_i - sum_{k<i} L[i][k] x_k,
// which the simple kernel ran on one CTA a task, a team of lanes a column, b
// dependent steps each a team dot product and a 5-deep shuffle reduction
// (the LU plan's 31-task group on 31 of 132 SMs; at bc = 1 one warp did the
// whole solve).  The design mirrors TRSMU's:
// - columns split across CTAs: 16 or 32 columns each, chosen by the wrapper
//   from the group's size: 16 while those CTAs fit on the SMs at once, else
//   32, which stage L half as often (the 31-task group on 124 CTAs, the
//   served 7 x 64 group on 1792); every CTA reads the task's L (from L2);
// - the recurrence blocked by 16 rows.  A half-warp owns a column, lane r the
//   row I0 + r of block I.  The block is first updated by the rows before
//   it, X_I -= L_{I,<I} X_{<I} (a float4 of L's row and of X's column a
//   step, four FMA chains a lane, k mod 4), then solved by a unit-lower
//   substitution inside the half-warp: lane j hands x_j to the later lanes by
//   shuffle, lanes r > j take L[I0 + r][I0 + j] x_j; no division.  The
//   dependent chain falls to 112 FMAs plus 128 shuffle steps;
// - both sums start from zero and are subtracted once, as the plain version
//   does.  L's products are small against B's entries on the LU's blocks:
//   summed into B they lost their low bits, and the solves' errors rose
//   1.4x (matrix) and 1.7x (vector) over the simple kernel's; apart, they
//   equal them, for 2-3 % of the time;
// - at bc < 16 (the vector solve's bc = 1) one half-warp carries that chain
//   on a 16-column CTA.  A mapping that split each block's update over all
//   16 half-warps by slices of k (partials reduced through shared memory,
//   one CTA barrier a block) was slower at bc = 1, 8 and 15 on the card: the
//   in-block shuffle chain, the staging and the launch take most of the time
//   there, and it added a reduction and a barrier a block;
// - shared memory holds only L's lower panels (row block I, columns
//   0 .. I0 + 15, row-major: 38 KB at b = 128) and the CTA's columns of X,
//   transposed (9 or 17 KB), so four CTAs share an SM in a stacked launch;
//   both are staged by cp.async and X is written back coalesced at the end.
//
// TRSMUL: X = inv(U) B, U (b x b) non-unit upper, B (b x bc), in place: the LU
// solve's backward substitution.  U's strictly-lower part is L's junk of a
// packed L\U block and is never used.  What bounds it on H100: latency, as
// TRSML (its byte bound is 0.0002 ms for the LU solve's 4-task group).  The
// simple kernel ran one CTA a task (4 of 132 SMs for that group), a team of
// lanes a column, 128 dependent steps each a strided team dot product and a
// shuffle reduction.  It is TRSML run bottom-up with a division a row:
// - columns split across CTAs by TRSML's rule (the 4-task bc = 128 group on
//   32 CTAs of 16 columns, a bc = 1 task on one);
// - 16-row blocks from the last (the ragged one when b % 16 != 0) to the first:
//   block I first sums U_{I,>I} X_{>I} into t (float4s of U's row and X's
//   column, four FMA chains from zero), then runs an upper substitution
//   inside the half-warp from lane 15 down: lane j forms x_j =
//   (x_j - t_j) / U[j][j], the reference's correctly rounded division (div_rn:
//   the reciprocal taken once a block, off the chain), and shuffles it to the
//   lanes above, which add U[r][j] x_j into t;
// - shared memory holds U's upper panels (row block I, columns 16 I .. b - 1,
//   row-major at lpanel_ld's bank-safe kind of stride, zero-padded to it) and
//   the CTA's columns of X transposed, each zero from row b to the next
//   multiple of 4 (the update's last float4 reads there), all staged by
//   cp.async.
//
// TRSM: X = B inv(L)^T, L (b x b) non-unit lower, B (b x b), in place: the
// Cholesky panel solve.  L's strict upper triangle is junk and never used.
// What bounds it on H100: latency (its byte bound is 0.0012 ms for the
// Cholesky plan's 31-task group).  The simple kernel ran one CTA a task, one
// thread a row: b (b - 1) / 2 dependent shared-load + FMA steps.  Row p of X
// solves L x = B[p]^T, so a row is a TRSML column with a division by L's
// diagonal: TRSMU's row split (16 or 32 rows a CTA by TRSMU's rule: the 31-task
// group on 248 CTAs of 16, the served 7 x 64 group on 1792 of 32), TRSML's
// lower panels of L and its blocked forward substitution (lane c of a
// half-warp reads row J0 + c of L, which is column J0 + c of U = L^T), and
// the CTA's rows of B staged as they lie by cp.async.
//
// TRSM and TRSMUL share one body (diag_block, HalfWarpVectors: a half-warp a
// right-hand-side vector held contiguously in shared memory).  Each row's
// products, the block update's and the block's own, go into one sum kept
// apart from B and subtracted once, as the reference's row dot product is:
// subtracting the two sums in turn, as TRSML does, raised the LU solve's
// error 1.09x through TRSMUL.  TRSML keeps its own code: built from the shared
// body, the same arithmetic took 53 registers, not 50, and ran 3-4 % longer
// at bc = 1.
//
// Every entry point returns cudaGetLastError() (0 = launched); the Python
// wrapper raises on anything else, since a refused launch never runs and a
// later synchronize would not report it.

#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>
#include <utility>

namespace {

constexpr int kMaxB = 128;        // largest tile edge the kernels accept
constexpr int kMaxBatch = 65535;  // lanes of a stacked launch: gridDim.y's limit
constexpr int kMaxSeg = 8;        // segments of one launch (csrc side of tile_linalg.MAX_SEGMENTS)

// One argument of a launch (a kernel parameter, passed by value): the
// group's (n, 2) block indices and its segment table.  Segment s holds tasks
// first[s] .. first[s + 1] - 1 and addresses its own grid, of nc block
// columns and a lane stride (0 unstacked); entries past the table's end hold
// first = n, so no task falls in them.  Every argument of a launch has the
// same firsts.
struct Segs {
  const int* idx;
  int first[kMaxSeg];
  int nc[kMaxSeg];
  long long lane[kMaxSeg];
  float* grid[kMaxSeg];
};

// A task's block: its segment's index counted from the table's bounds (one
// segment for a whole CTA, so the scan never diverges), then lane blockIdx.y
// of that segment's grid, block idx[task] of that lane.  The parameters are
// __grid_constant__, so the entry is read where it lies, with no copy.
__device__ __forceinline__ float* task_block(const Segs& s, int task, int br, int bc) {
  int seg = 0;
#pragma unroll
  for (int i = 1; i < kMaxSeg; ++i) seg += task >= s.first[i];
  const long long r = s.idx[2 * task], c = s.idx[2 * task + 1], lane = s.lane[seg];
  return s.grid[seg] + blockIdx.y * lane + (r * s.nc[seg] + c) * (long long)br * bc;
}

// ---------------------------------------------------------------------------
// TRSMU
// ---------------------------------------------------------------------------
constexpr int kW = 16;                         // column block: a half-warp, a lane a column
constexpr int kSolveThreads = 256;
constexpr int kHalfWarps = kSolveThreads / kW;  // rows in flight: one a half-warp

// floats of U's first nblk packed upper panels (panel J is (16 J + 16) x 16)
__host__ __device__ constexpr int panel_floats(int nblk) { return kW * kW * nblk * (nblk + 1) / 2; }

template <int kRowsPerHalfWarp>
__global__ void __launch_bounds__(kSolveThreads)
trsmu_kernel(const __grid_constant__ Segs useg, const __grid_constant__ Segs bseg, int br, int b, int ldx) {
  constexpr int kRows = kHalfWarps * kRowsPerHalfWarp;  // rows of B this CTA solves
  extern __shared__ __align__(16) float smem[];
  const int nblk = (b + kW - 1) / kW;
  float* P = smem;                       // panel J at P + panel_floats(J): p[k * 16 + c] = U[k][16 J + c]
  float* X = smem + panel_floats(nblk);  // kRows x ldx: the CTA's rows; row kRows stays zero
  const int splits = (br + kRows - 1) / kRows;
  const int task = blockIdx.x / splits, r0 = (blockIdx.x % splits) * kRows;
  const int rows = min(kRows, br - r0);
  const float* U = task_block(useg, task, b, b);
  float* B = task_block(bseg, task, br, b) + (long long)r0 * b;

  for (int J = 0; J < nblk; ++J) {
    float* p = P + panel_floats(J);
    const int J0 = J * kW;
    for (int e = threadIdx.x; e < (J0 + kW) * kW; e += kSolveThreads) {
      const int k = e / kW, c = J0 + e % kW;
      p[e] = k < b && c < b ? U[k * b + c] : 0.f;
    }
  }
  for (int e = threadIdx.x; e < rows * b; e += kSolveThreads) X[(e / b) * ldx + e % b] = B[e];
  for (int e = threadIdx.x; e < ldx; e += kSolveThreads) X[kRows * ldx + e] = 0.f;
  __syncthreads();

  const int hw = threadIdx.x / kW, c = threadIdx.x % kW;
  // this half-warp's rows; a row past the CTA's last computes on the zero row
  // and writes nothing, so every shuffle runs on a converged warp
  const float* xr[kRowsPerHalfWarp];
  int row[kRowsPerHalfWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerHalfWarp; ++i) {
    row[i] = hw + kHalfWarps * i;
    xr[i] = X + (row[i] < rows ? row[i] : kRows) * ldx;
  }
  for (int J = 0; J < nblk; ++J) {
    const int J0 = J * kW, w = min(kW, b - J0);
    const float* p = P + panel_floats(J);
    float x[kRowsPerHalfWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerHalfWarp; ++i) x[i] = c < w ? xr[i][J0 + c] : 0.f;
    // X_J -= X_{<J} U_{<J,J}: four solved columns of the row a shared load
    for (int k = 0; k < J0; k += 4) {
      const float u0 = p[k * kW + c], u1 = p[(k + 1) * kW + c];
      const float u2 = p[(k + 2) * kW + c], u3 = p[(k + 3) * kW + c];
#pragma unroll
      for (int i = 0; i < kRowsPerHalfWarp; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(xr[i] + k);
        x[i] = fmaf(-v.x, u0, x[i]);
        x[i] = fmaf(-v.y, u1, x[i]);
        x[i] = fmaf(-v.z, u2, x[i]);
        x[i] = fmaf(-v.w, u3, x[i]);
      }
    }
    // the diagonal block, right-looking inside the half-warp
    const float dinv = c < w ? 1.f / p[(J0 + c) * kW + c] : 0.f;
#pragma unroll
    for (int j = 0; j < kW; ++j) {
      if (j < w) {
        const float u = p[(J0 + j) * kW + c];  // U[J0 + j][J0 + c]
#pragma unroll
        for (int i = 0; i < kRowsPerHalfWarp; ++i) {
          if (c == j) x[i] *= dinv;
          const float xj = __shfl_sync(0xffffffffu, x[i], j, kW);
          if (c > j) x[i] = fmaf(-xj, u, x[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerHalfWarp; ++i) {
      if (row[i] < rows && c < w) {
        X[row[i] * ldx + J0 + c] = x[i];
        B[row[i] * b + J0 + c] = x[i];
      }
    }
    __syncwarp();  // the row's new columns, before the next block reads them
  }
}

// ---------------------------------------------------------------------------
// GEMMNN
// ---------------------------------------------------------------------------
constexpr int kKC = 32;        // K chunk: one cp.async commit group, one ring slot
constexpr int kStages = 3;     // ring slots: chunk c + 2 loads while chunk c computes
// A's row stride in a slot: 4 (mod 8) words, so the fragment loads hit 32
// distinct banks, and 16-byte aligned rows for cp.async
constexpr int kLdA = kKC + 4;
constexpr int kMvRows = 32;    // rows of C a matrix-vector CTA takes
constexpr int kMvMaxQ = 7;     // widest C the matrix-vector mapping takes
constexpr int kMvThreads = 256;

// warps of a tile CTA (kWarpsM x kWarpsN) and m16 x n8 fragments of a warp
template <int kTile>
struct MmaShape;
template <>
struct MmaShape<32> {
  static constexpr int kWarpsM = 2, kWarpsN = 2, kFragsM = 1, kFragsN = 2;
};
template <>
struct MmaShape<64> {
  static constexpr int kWarpsM = 2, kWarpsN = 2, kFragsM = 2, kFragsN = 4;
};

// floats of one ring slot: A's kTile x kKC chunk, then B's: a kKC x kTile
// chunk of B (row stride kTile + 8 = 8 (mod 16) words: conflict-free fragment
// loads), or for SYRK (bt: B = A^T, read from A's rows) a kTile x kKC chunk
// of rows laid out as A's
__host__ __device__ constexpr int slot_floats(int tile, bool bt) {
  return tile * kLdA + (bt ? tile * kLdA : kKC * (tile + 8));
}

// threads of a GEMMNN CTA; tile 0 is the matrix-vector mapping
template <int kTile>
constexpr int kGemmnnThreads = 32 * MmaShape<kTile>::kWarpsM * MmaShape<kTile>::kWarpsN;
template <>
constexpr int kGemmnnThreads<0> = kMvThreads;

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from zero,
// as cvt.rna.tf32.f32 does: half a TF32 ulp added to the magnitude's bits,
// the 13 low bits cleared.  Two integer ops at full rate, where cvt runs at
// the conversion rate; every x this splits is also split by the warps that
// share its row or column.
__device__ __forceinline__ uint32_t tf32_rna(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }

// x = big + small + O(2^-22 |x|), both TF32 (a NaN stays NaN in one of them)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// d += a b on one m16n8k8 fragment, TF32 inputs, fp32 accumulate (kFresh:
// d = a b, the product alone from a zero accumulator)
template <bool kFresh = false>
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  if constexpr (kFresh) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
        "{%8, %9}, {%10, %10, %10, %10};"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
  } else {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
        "{%8, %9}, {%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

// cp.async of 16 or 4 bytes; when !valid nothing is read and dst is zeroed
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

// Stage K rows [k0, k0 + kKC) of the tile's operands into one ring slot:
// As[r][kk - k0] = A[m0 + r][kk], and Bs[kk - k0][c] = B[kk][n0 + c] or, for
// kBT (B = Bt^T with Bt (q x k) row-major: SYRK's A^T), Bs[c][kk - k0] =
// Bt[n0 + c][kk]; zero past m, k and q.
template <int kTile, bool kBT>
__device__ __forceinline__ void stage_chunk(float* As, float* Bs, const float* A, const float* Bm, int m, int k,
                                            int q, int m0, int n0, int k0, bool vec) {
  constexpr int kThreads = kGemmnnThreads<kTile>, lda = kLdA, ldb = kTile + 8;
  if (vec) {  // k % 4 == q % 4 == 0 and 16-byte aligned blocks: a quad is all in or all out
    constexpr int qa = kKC / 4, qb = kTile / 4;
    for (int e = threadIdx.x; e < kTile * qa; e += kThreads) {
      const int r = e / qa, kk = 4 * (e % qa);
      const bool ok = m0 + r < m && k0 + kk < k;
      cp_async16(As + r * lda + kk, ok ? A + (m0 + r) * k + k0 + kk : A, ok);
    }
    if constexpr (kBT) {
      for (int e = threadIdx.x; e < kTile * qa; e += kThreads) {
        const int r = e / qa, kk = 4 * (e % qa);
        const bool ok = n0 + r < q && k0 + kk < k;
        cp_async16(Bs + r * lda + kk, ok ? Bm + (n0 + r) * k + k0 + kk : Bm, ok);
      }
    } else {
      for (int e = threadIdx.x; e < kKC * qb; e += kThreads) {
        const int kk = e / qb, c = 4 * (e % qb);
        const bool ok = k0 + kk < k && n0 + c < q;
        cp_async16(Bs + kk * ldb + c, ok ? Bm + (k0 + kk) * q + n0 + c : Bm, ok);
      }
    }
  } else {
    for (int e = threadIdx.x; e < kTile * kKC; e += kThreads) {
      const int r = e / kKC, kk = e % kKC;
      const bool ok = m0 + r < m && k0 + kk < k;
      cp_async4(As + r * lda + kk, ok ? A + (m0 + r) * k + k0 + kk : A, ok);
    }
    if constexpr (kBT) {
      for (int e = threadIdx.x; e < kTile * kKC; e += kThreads) {
        const int r = e / kKC, kk = e % kKC;
        const bool ok = n0 + r < q && k0 + kk < k;
        cp_async4(Bs + r * lda + kk, ok ? Bm + (n0 + r) * k + k0 + kk : Bm, ok);
      }
    } else {
      for (int e = threadIdx.x; e < kKC * kTile; e += kThreads) {
        const int kk = e / kTile, c = e % kTile;
        const bool ok = k0 + kk < k && n0 + c < q;
        cp_async4(Bs + kk * ldb + c, ok ? Bm + (k0 + kk) * q + n0 + c : Bm, ok);
      }
    }
  }
}

// sum += part, rounded to nearest
template <int FM, int FN>
__device__ __forceinline__ void promote(float (&sum)[FM][FN][4], const float (&part)[FM][FN][4]) {
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int h = 0; h < 4; ++h) sum[i][j][h] = __fadd_rn(sum[i][j][h], part[i][j][h]);
}

// One kTile x kTile tile of C -= A B on the tensor cores, 3xTF32 (kBT: B =
// Bt^T, staged from Bt's rows).
template <int kTile, bool kBT>
__device__ __forceinline__ void gemmnn_mma(const float* A, const float* Bm, float* C, int m, int k, int q,
                                           int piece, bool vec) {
  using S = MmaShape<kTile>;
  constexpr int FM = S::kFragsM, FN = S::kFragsN;
  constexpr int lda = kLdA, ldb = kTile + 8;
  extern __shared__ __align__(16) float smem[];  // kStages slots: As (kTile x lda), then Bs
  const int tiles_n = (q + kTile - 1) / kTile;
  const int m0 = piece / tiles_n * kTile, n0 = piece % tiles_n * kTile;
  const int nchunks = (k + kKC - 1) / kKC;
  auto slot = [&](int ch) { return smem + ch % kStages * slot_floats(kTile, kBT); };
  // chunks 0 and 1 in flight before the first wait; every iteration commits
  // one group (empty past the last chunk), so chunk ch is always the group
  // before the newest: wait_group 1
  for (int ch = 0; ch < kStages - 1; ++ch) {
    if (ch < nchunks)
      stage_chunk<kTile, kBT>(slot(ch), slot(ch) + kTile * lda, A, Bm, m, k, q, m0, n0, ch * kKC, vec);
    cp_async_commit();
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wm0 = warp % S::kWarpsM * FM * 16, wn0 = warp / S::kWarpsM * FN * 8;
  // fragment (i, j) element h: row wm0 + 16 i + g + 8 (h / 2), column
  // wn0 + 8 j + 2 t + h % 2 of the tile.  acc holds the fp32 sum of A B so
  // far; part, the tensor cores' partial of the current 8-deep step
  float acc[FM][FN][4], part[FM][FN][4];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int h = 0; h < 4; ++h) acc[i][j][h] = 0.f;
  for (int ch = 0; ch < nchunks; ++ch) {
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    __syncthreads();  // chunk ch has landed, and every warp is done with chunk ch - 1's slot
    const int next = ch + kStages - 1;  // into the slot chunk ch - 1 left
    if (next < nchunks)
      stage_chunk<kTile, kBT>(slot(next), slot(next) + kTile * lda, A, Bm, m, k, q, m0, n0, next * kKC, vec);
    cp_async_commit();
    const float* As = slot(ch);
    const float* Bs = As + kTile * lda;
    const int steps = min(kKC, k - ch * kKC);  // zero fill pads the last chunk to a multiple of 8
    for (int kk = 0; kk < steps; kk += 8) {
      uint32_t ab[FM][4], as[FM][4], bb[FN][2], bs[FN][2];
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        const float* a = As + (wm0 + 16 * i + g) * lda + kk + t;
        split_tf32(a[0], ab[i][0], as[i][0]);
        split_tf32(a[8 * lda], ab[i][1], as[i][1]);
        split_tf32(a[4], ab[i][2], as[i][2]);
        split_tf32(a[8 * lda + 4], ab[i][3], as[i][3]);
      }
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        // B[kk + t][col] and B[kk + t + 4][col], col = wn0 + 8 j + g
        const float* bp = kBT ? Bs + (wn0 + 8 * j + g) * lda + kk + t : Bs + (kk + t) * ldb + wn0 + 8 * j + g;
        const int step4 = kBT ? 4 : 4 * ldb;
        split_tf32(bp[0], bb[j][0], bs[j][0]);
        split_tf32(bp[step4], bb[j][1], bs[j][1]);
      }
      // term by term over the fragments: FM x FN independent products in
      // flight; the step's partial starts from its first term
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) mma_tf32<true>(part[i][j], as[i], bb[j]);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) mma_tf32(part[i][j], ab[i], bs[j]);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) mma_tf32(part[i][j], ab[i], bb[j]);
      promote(acc, part);
    }
  }
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = m0 + wm0 + 16 * i + g + 8 * hh, c = n0 + wn0 + 8 * j + 2 * t;
        // C - sum, once, rounded to nearest
        float2 cv = make_float2(0.f, 0.f);
        if (vec) {  // q even: a pair is all in or all out
          if (r < m && c < q) cv = *reinterpret_cast<const float2*>(C + r * q + c);
        } else {
          if (r < m && c < q) cv.x = C[r * q + c];
          if (r < m && c + 1 < q) cv.y = C[r * q + c + 1];
        }
        const float2 v = make_float2(__fsub_rn(cv.x, acc[i][j][2 * hh]), __fsub_rn(cv.y, acc[i][j][2 * hh + 1]));
        if (vec) {
          if (r < m && c < q) *reinterpret_cast<float2*>(C + r * q + c) = v;
        } else {
          if (r < m && c < q) C[r * q + c] = v.x;
          if (r < m && c + 1 < q) C[r * q + c + 1] = v.y;
        }
      }
}

// Rows [32 piece, 32 piece + 32) of C -= A B for q <= kMvMaxQ, in fp32.
__device__ __forceinline__ void gemmnn_matvec(const float* A, const float* Bm, float* C, int m, int k, int q,
                                              int piece) {
  __shared__ float Bs[kMaxB * kMvMaxQ];
  for (int e = threadIdx.x; e < k * q; e += kMvThreads) Bs[e] = Bm[e];
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int end = min(m, (piece + 1) * kMvRows);
  for (int r = piece * kMvRows + warp; r < end; r += kMvThreads / 32) {
    float s[kMvMaxQ];
#pragma unroll
    for (int j = 0; j < kMvMaxQ; ++j) s[j] = 0.f;
    for (int kk = lane; kk < k; kk += 32) {
      const float a = A[r * k + kk];
#pragma unroll
      for (int j = 0; j < kMvMaxQ; ++j)
        if (j < q) s[j] = fmaf(a, Bs[kk * q + j], s[j]);
    }
#pragma unroll
    for (int j = 0; j < kMvMaxQ; ++j) {
      if (j < q) {
#pragma unroll
        for (int off = 16; off > 0; off /= 2) s[j] += __shfl_xor_sync(0xffffffffu, s[j], off);
        if (lane == j) C[r * q + j] -= s[j];
      }
    }
  }
}

// CTAs one task takes: tiles of C, or 32-row pieces for the matrix-vector mapping
__host__ __device__ inline int gemmnn_pieces(int tile, int m, int q) {
  return tile == 0 ? (m + kMvRows - 1) / kMvRows : ((m + tile - 1) / tile) * ((q + tile - 1) / tile);
}

template <int kTile>
__global__ void __launch_bounds__(kGemmnnThreads<kTile>)
gemmnn_kernel(const __grid_constant__ Segs aseg, const __grid_constant__ Segs bseg,
              const __grid_constant__ Segs cseg, int m, int k, int q, int vec) {
  const int pieces = gemmnn_pieces(kTile, m, q);
  const int task = blockIdx.x / pieces, piece = blockIdx.x % pieces;
  const float* A = task_block(aseg, task, m, k);
  const float* Bm = task_block(bseg, task, k, q);
  float* C = task_block(cseg, task, m, q);
  if constexpr (kTile == 0) {
    gemmnn_matvec(A, Bm, C, m, k, q, piece);
  } else {
    gemmnn_mma<kTile, false>(A, Bm, C, m, k, q, piece, vec != 0);
  }
}

// ---------------------------------------------------------------------------
// GEMM and SYRK: C (b x b) -= A B^T (SYRK: B = A), the full square, on
// GEMMNN's tensor-core tile with B^T staged from B's own rows
// ---------------------------------------------------------------------------
template <int kTile>
__device__ __forceinline__ void abt_piece(const Segs& aseg, const Segs& bseg, const Segs& cseg, int b, int vec) {
  const int pieces = gemmnn_pieces(kTile, b, b);
  const int task = blockIdx.x / pieces, piece = blockIdx.x % pieces;
  gemmnn_mma<kTile, true>(task_block(aseg, task, b, b), task_block(bseg, task, b, b), task_block(cseg, task, b, b),
                          b, b, b, piece, vec != 0);
}

// At most 128 registers a thread for 64^2 tiles, so four CTAs share an SM as
// their 55 KB of shared memory allow: left free, the segment tables' address
// arithmetic took GEMM and SYRK to 163-166 registers and three CTAs an SM,
// and their main-path groups ran 13-16 % slower (chip_smoke.py 2b, 2d)
template <int kTile>
__global__ void __launch_bounds__(kGemmnnThreads<kTile>, kTile == 64 ? 4 : 1)
gemm_kernel(const __grid_constant__ Segs aseg, const __grid_constant__ Segs bseg, const __grid_constant__ Segs cseg,
            int b, int vec) {
  abt_piece<kTile>(aseg, bseg, cseg, b, vec);
}

template <int kTile>
__global__ void __launch_bounds__(kGemmnnThreads<kTile>, kTile == 64 ? 4 : 1)
syrk_kernel(const __grid_constant__ Segs aseg, const __grid_constant__ Segs cseg, int b, int vec) {
  abt_piece<kTile>(aseg, aseg, cseg, b, vec);
}

// ---------------------------------------------------------------------------
// TRSML
// ---------------------------------------------------------------------------
// L's lower panels: panel I is rows 16 I .. 16 I + 15 of L, columns
// 0 .. 16 I + 15, row-major at a row stride of 16 I + 20 floats (a multiple of
// 4 whose quarter is odd: the 16 lanes' float4 reads of one column quad hit
// distinct banks), at panel_offset(I) = sum_{J<I} 16 (16 J + 20) floats.
__host__ __device__ constexpr int lpanel_ld(int I) { return kW * I + kW + 4; }
__host__ __device__ constexpr int lpanel_floats(int nblk) {
  return kW * (kW * nblk * (nblk - 1) / 2 + (kW + 4) * nblk);
}

// Stage L's lower panels (the diagonal blocks' upper halves come along,
// unused) and B's `cols` columns from c0, transposed (X[col * ldx + row]),
// by cp.async, zero past b; then publish them to the CTA.
__device__ __forceinline__ void trsml_stage(float* P, float* X, const float* L, const float* B, int b, int bc,
                                            int c0, int cols, int ldx, bool vec) {
  const int nblk = (b + kW - 1) / kW;
  for (int I = 0; I < nblk; ++I) {
    float* p = P + lpanel_floats(I);
    const int ld = lpanel_ld(I), r0 = kW * I, w = r0 + kW;
    if (vec) {  // b % 4 == 0 and a 16-byte aligned block: a quad is all in or all out
      const int q = w / 4;
      for (int e = threadIdx.x; e < kW * q; e += kSolveThreads) {
        const int r = e / q, k = 4 * (e % q);
        const bool ok = r0 + r < b && k < b;
        cp_async16(p + r * ld + k, ok ? L + (r0 + r) * b + k : L, ok);
      }
    } else {
      for (int e = threadIdx.x; e < kW * w; e += kSolveThreads) {
        const int r = e / w, k = e % w;
        const bool ok = r0 + r < b && k < b;
        cp_async4(p + r * ld + k, ok ? L + (r0 + r) * b + k : L, ok);
      }
    }
  }
  for (int e = threadIdx.x; e < b * cols; e += kSolveThreads) {
    const int row = e / cols, col = e % cols;
    cp_async4(X + col * ldx + row, B + row * bc + c0 + col, true);
  }
  cp_async_commit();
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();
}

// Block I's unit-lower substitution inside the half-warp, for each of its kN
// columns: lane j hands x_j = x - t to the later lanes by shuffle, lanes
// r > j add L[I0 + r][I0 + j] x_j into t, and x - t is taken last.  d is row
// I0 + r of L from column I0.
template <int kN>
__device__ __forceinline__ void unit_lower_block(float (&x)[kN], const float* d, int r, int w) {
  float l[kW];
#pragma unroll
  for (int q = 0; q < kW / 4; ++q) {
    const float4 v = *reinterpret_cast<const float4*>(d + 4 * q);
    l[4 * q] = v.x, l[4 * q + 1] = v.y, l[4 * q + 2] = v.z, l[4 * q + 3] = v.w;
  }
  float t[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) t[i] = 0.f;
#pragma unroll
  for (int j = 0; j < kW; ++j) {
    if (j < w) {
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        const float xj = __shfl_sync(0xffffffffu, x[i] - t[i], j, kW);
        if (r > j) t[i] = fmaf(l[j], xj, t[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kN; ++i) x[i] -= t[i];
}

// The column-split mapping: kColsPerHalfWarp columns a half-warp, 16 or 32
// a CTA; X + kCols * ldx is a zero column, which a half-warp past the CTA's
// last column computes on and never writes, so every shuffle runs on a
// converged warp.  A column never leaves its half-warp: no CTA barrier.
template <int kColsPerHalfWarp>
__device__ __forceinline__ void trsml_columns(const float* P, float* X, int b, int cols, int ldx) {
  constexpr int kCols = kHalfWarps * kColsPerHalfWarp;
  const int nblk = (b + kW - 1) / kW, hw = threadIdx.x / kW, r = threadIdx.x % kW;
  float* xc[kColsPerHalfWarp];
  bool own[kColsPerHalfWarp];
#pragma unroll
  for (int i = 0; i < kColsPerHalfWarp; ++i) {
    const int col = hw + kHalfWarps * i;
    own[i] = col < cols;
    xc[i] = X + (own[i] ? col : kCols) * ldx;
  }
  for (int I = 0; I < nblk; ++I) {
    const int I0 = I * kW, w = min(kW, b - I0);
    const float* lr = P + lpanel_floats(I) + r * lpanel_ld(I);  // row I0 + r of L
    // X_I -= L_{I,<I} X_{<I}: four solved rows of the column a shared load,
    // summed from zero in four chains (k mod 4), then subtracted once
    float x[kColsPerHalfWarp], s[kColsPerHalfWarp][4];
#pragma unroll
    for (int i = 0; i < kColsPerHalfWarp; ++i) {
      x[i] = r < w ? xc[i][I0 + r] : 0.f;
      s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
    }
    for (int k = 0; k < I0; k += 4) {
      const float4 l = *reinterpret_cast<const float4*>(lr + k);
#pragma unroll
      for (int i = 0; i < kColsPerHalfWarp; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(xc[i] + k);
        s[i][0] = fmaf(l.x, v.x, s[i][0]);
        s[i][1] = fmaf(l.y, v.y, s[i][1]);
        s[i][2] = fmaf(l.z, v.z, s[i][2]);
        s[i][3] = fmaf(l.w, v.w, s[i][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < kColsPerHalfWarp; ++i) x[i] -= (s[i][0] + s[i][1]) + (s[i][2] + s[i][3]);
    unit_lower_block(x, lr + I0, r, w);
#pragma unroll
    for (int i = 0; i < kColsPerHalfWarp; ++i)
      if (own[i] && r < w) xc[i][I0 + r] = x[i];
    __syncwarp();  // the column's new rows, before the next block reads them
  }
}

// kColsPerHalfWarp 1 or 2: 16 or 32 columns of B a CTA
template <int kColsPerHalfWarp>
__global__ void __launch_bounds__(kSolveThreads)
trsml_kernel(const __grid_constant__ Segs lseg, const __grid_constant__ Segs bseg, int b, int bc, int ldx,
             int vec) {
  constexpr int kCols = kHalfWarps * kColsPerHalfWarp;
  extern __shared__ __align__(16) float smem[];
  const int nblk = (b + kW - 1) / kW;
  const int splits = (bc + kCols - 1) / kCols;
  const int task = blockIdx.x / splits, c0 = (blockIdx.x % splits) * kCols;
  const int cols = min(kCols, bc - c0);
  const float* L = task_block(lseg, task, b, b);
  float* B = task_block(bseg, task, b, bc);
  float* P = smem;                       // panel I at P + lpanel_floats(I)
  float* X = smem + lpanel_floats(nblk);  // the CTA's columns of X, then a zero column
  for (int e = threadIdx.x; e < ldx; e += kSolveThreads) X[kCols * ldx + e] = 0.f;
  trsml_stage(P, X, L, B, b, bc, c0, cols, ldx, vec != 0);
  trsml_columns<kColsPerHalfWarp>(P, X, b, cols, ldx);
  __syncthreads();  // X solved: written back coalesced
  for (int e = threadIdx.x; e < b * cols; e += kSolveThreads) {
    const int row = e / cols, col = e % cols;
    B[row * bc + c0 + col] = X[col * ldx + row];
  }
}

// ---------------------------------------------------------------------------
// TRSM and TRSMUL: TRSML's mapping, with a division by the diagonal
// ---------------------------------------------------------------------------
// U's upper panels: panel I is rows 16 I .. 16 I + 15 of U, columns
// 16 I .. b - 1, row-major at a row stride of that width (at least 16: the
// diagonal block) rounded up to 4 with an odd quarter (lpanel_ld's rule),
// panel after panel; upanel_floats(b, I) floats precede panel I.
__host__ __device__ constexpr int upanel_ld(int b, int I) {
  return 4 * (((b - kW * I > kW ? b - kW * I : kW) + 3) / 4 | 1);
}
__host__ __device__ constexpr int upanel_floats(int b, int nblk) {
  int n = 0;
  for (int I = 0; I < nblk; ++I) n += kW * upanel_ld(b, I);
  return n;
}

// cp.async of U's upper panels, whole rows of their stride, zero past b (the
// diagonal blocks' lower halves come along, unused; no other part of U's
// strictly-lower triangle is read)
__device__ __forceinline__ void stage_upanels(float* P, const float* U, int b, bool vec) {
  const int nblk = (b + kW - 1) / kW;
  float* p = P;
  for (int I = 0; I < nblk; ++I) {
    const int ld = upanel_ld(b, I), r0 = kW * I;
    if (vec) {  // as trsml_stage
      const int q = ld / 4;
      for (int e = threadIdx.x; e < kW * q; e += kSolveThreads) {
        const int r = e / q, k = 4 * (e % q);
        const bool ok = r0 + r < b && r0 + k < b;
        cp_async16(p + r * ld + k, ok ? U + (r0 + r) * b + r0 + k : U, ok);
      }
    } else {
      for (int e = threadIdx.x; e < kW * ld; e += kSolveThreads) {
        const int r = e / ld, k = e % ld;
        const bool ok = r0 + r < b && r0 + k < b;
        cp_async4(p + r * ld + k, ok ? U + (r0 + r) * b + r0 + k : U, ok);
      }
    }
    p += kW * ld;
  }
}

// a / d rounded to nearest, given dinv = RN(1 / d): Markstein's correction of
// the quotient a dinv by its exact residual, which returns IEEE's quotient
// wherever that is a normal number or zero (a zero's sign aside), in three
// dependent operations.  The division a / d costs a reciprocal, its
// refinement and a range check every call, and takes its slow path for a zero
// dividend, which the zero vectors feed it: on the 128-step chain it made TRSM
// and TRSMUL 15-30 % slower, and TRSMUL at bc = 1 2.2x (scripts/
// solve_division.py, which also holds the two to the same bits).
__device__ __forceinline__ float div_rn(float a, float d, float dinv) {
  const float q = __fmul_rn(a, dinv);
  return __fmaf_rn(__fmaf_rn(-d, q, a), dinv, q);
}

// One 16-row block's substitution inside the half-warp, for each of its kN
// vectors, as unit_lower_block with a division: lane j hands x_j =
// (x_j - t_j) / T[j][j] (the reference's division, div_rn) to the lanes that
// need it by shuffle, and they add T[r][j] x_j into t, a sum kept apart from x
// that the caller starts.  Lower: j runs down the block, lanes r > j take it;
// kUpper: j runs up from the block's last row, lanes r < j.  d is lane r's
// row of the diagonal block (16 floats from the block's first column); w the
// block's rows.  kHeld keeps that row in 16 registers, as unit_lower_block
// does, else T[r][j] is read from shared memory at its step, as TRSMU reads U
// (off the chain).  Each kernel takes the faster on the card: TRSMUL holds it
// (read a step, it took more registers and ran longer); TRSM reads it (held,
// it spilled under the 64 registers that four CTAs an SM allow, and without
// that bound it ran longer).
template <int kN, bool kUpper, bool kHeld>
__device__ __forceinline__ void diag_block(float (&x)[kN], float (&t)[kN], const float* d, int r, int w) {
  float l[kW];
  if constexpr (kHeld) {
#pragma unroll
    for (int q = 0; q < kW / 4; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(d + 4 * q);
      l[4 * q] = v.x, l[4 * q + 1] = v.y, l[4 * q + 2] = v.z, l[4 * q + 3] = v.w;
    }
  }
  const float dg = r < w ? d[r] : 1.f, dinv = __frcp_rn(dg);
#pragma unroll
  for (int s = 0; s < kW; ++s) {
    const int j = kUpper ? kW - 1 - s : s;
    if (j < w) {
      const float lj = kHeld ? l[j] : d[j];
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        const float xj = __shfl_sync(0xffffffffu, div_rn(x[i] - t[i], dg, dinv), j, kW);
        if (kUpper ? r < j : r > j) t[i] = fmaf(lj, xj, t[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kN; ++i) x[i] = div_rn(x[i] - t[i], dg, dinv);
}

// The vectors of the half-warp: kPerHalfWarp of them, 16 or 32 a CTA, each
// contiguous at stride ldx in X (TRSMUL's columns of B held transposed, as
// TRSML's; TRSM's rows of B); X + kVecs * ldx is a zero vector, which a
// half-warp past the CTA's last vector computes on and never writes, so every
// shuffle runs on a converged warp.  A vector never leaves its half-warp: no
// CTA barrier.
template <int kPerHalfWarp>
struct HalfWarpVectors {
  static constexpr int kVecs = kHalfWarps * kPerHalfWarp;
  float* v[kPerHalfWarp];
  bool own[kPerHalfWarp];
  __device__ __forceinline__ HalfWarpVectors(float* X, int count, int ldx) {
    const int hw = threadIdx.x / kW;
#pragma unroll
    for (int i = 0; i < kPerHalfWarp; ++i) {
      const int vec = hw + kHalfWarps * i;
      own[i] = vec < count;
      v[i] = X + (own[i] ? vec : kVecs) * ldx;
    }
  }
};

// TRSM's forward substitution x = inv(L) x on every vector, by TRSML's 16-row
// blocks: lane r owns row I0 + r of block I, which first sums L_{I,<I} x_{<I}
// (a float4 of L's row and of x a step, four FMA chains a lane, k mod 4, from
// zero), then runs diag_block from that sum.
template <int kPerHalfWarp>
__device__ __forceinline__ void lower_vectors(const float* P, float* X, int b, int count, int ldx) {
  const HalfWarpVectors<kPerHalfWarp> hv(X, count, ldx);
  const int nblk = (b + kW - 1) / kW, r = threadIdx.x % kW;
  for (int I = 0; I < nblk; ++I) {
    const int I0 = I * kW, w = min(kW, b - I0);
    const float* lr = P + lpanel_floats(I) + r * lpanel_ld(I);  // row I0 + r of L
    float x[kPerHalfWarp], t[kPerHalfWarp], s[kPerHalfWarp][4];
#pragma unroll
    for (int i = 0; i < kPerHalfWarp; ++i) {
      x[i] = r < w ? hv.v[i][I0 + r] : 0.f;
      s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
    }
    for (int k = 0; k < I0; k += 4) {
      const float4 l = *reinterpret_cast<const float4*>(lr + k);
#pragma unroll
      for (int i = 0; i < kPerHalfWarp; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(hv.v[i] + k);
        s[i][0] = fmaf(l.x, v.x, s[i][0]);
        s[i][1] = fmaf(l.y, v.y, s[i][1]);
        s[i][2] = fmaf(l.z, v.z, s[i][2]);
        s[i][3] = fmaf(l.w, v.w, s[i][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < kPerHalfWarp; ++i) t[i] = (s[i][0] + s[i][1]) + (s[i][2] + s[i][3]);
    diag_block<kPerHalfWarp, false, false>(x, t, lr + I0, r, w);
#pragma unroll
    for (int i = 0; i < kPerHalfWarp; ++i)
      if (hv.own[i] && r < w) hv.v[i][I0 + r] = x[i];
    __syncwarp();  // the vector's new rows, before the next block reads them
  }
}

// TRSMUL's back substitution x = inv(U) x on every vector, by 16-row blocks
// from the last (the ragged one when b % 16 != 0) to the first: block I first
// sums U_{I,>I} x_{>I} (as lower_vectors, over rows I0 + 16 .. b - 1; the
// panels' and X's zero padding to a multiple of 4 close the last quad), then
// runs diag_block upward from that sum.
template <int kPerHalfWarp>
__device__ __forceinline__ void upper_vectors(const float* P, float* X, int b, int count, int ldx) {
  const HalfWarpVectors<kPerHalfWarp> hv(X, count, ldx);
  const int nblk = (b + kW - 1) / kW, r = threadIdx.x % kW;
  int off = upanel_floats(b, nblk);
  for (int I = nblk - 1; I >= 0; --I) {
    const int I0 = I * kW, w = min(kW, b - I0), ld = upanel_ld(b, I);
    off -= kW * ld;
    const float* ur = P + off + r * ld;  // row I0 + r of U, from column I0
    float x[kPerHalfWarp], t[kPerHalfWarp], s[kPerHalfWarp][4];
#pragma unroll
    for (int i = 0; i < kPerHalfWarp; ++i) {
      x[i] = r < w ? hv.v[i][I0 + r] : 0.f;
      s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
    }
    for (int k = kW; k < b - I0; k += 4) {
      const float4 u = *reinterpret_cast<const float4*>(ur + k);
#pragma unroll
      for (int i = 0; i < kPerHalfWarp; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(hv.v[i] + I0 + k);
        s[i][0] = fmaf(u.x, v.x, s[i][0]);
        s[i][1] = fmaf(u.y, v.y, s[i][1]);
        s[i][2] = fmaf(u.z, v.z, s[i][2]);
        s[i][3] = fmaf(u.w, v.w, s[i][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < kPerHalfWarp; ++i) t[i] = (s[i][0] + s[i][1]) + (s[i][2] + s[i][3]);
    diag_block<kPerHalfWarp, true, true>(x, t, ur, r, w);
#pragma unroll
    for (int i = 0; i < kPerHalfWarp; ++i)
      if (hv.own[i] && r < w) hv.v[i][I0 + r] = x[i];
    __syncwarp();
  }
}

// TRSMUL: columns c0 .. c0 + cols - 1 of the CTA's task (kColsPerHalfWarp 1
// or 2: 16 or 32 columns a CTA), held transposed as TRSML holds them, then the
// zero column; each column is zero from row b to the next multiple of 4, which
// the update's last quad reads.
template <int kColsPerHalfWarp>
__global__ void __launch_bounds__(kSolveThreads)
trsmul_kernel(const __grid_constant__ Segs useg, const __grid_constant__ Segs bseg, int b, int bc, int ldx,
              int vec) {
  constexpr int kCols = kHalfWarps * kColsPerHalfWarp;
  extern __shared__ __align__(16) float smem[];
  const int nblk = (b + kW - 1) / kW;
  const int splits = (bc + kCols - 1) / kCols;
  const int task = blockIdx.x / splits, c0 = (blockIdx.x % splits) * kCols;
  const int cols = min(kCols, bc - c0);
  const float* U = task_block(useg, task, b, b);
  float* B = task_block(bseg, task, b, bc);
  float* P = smem;                            // U's upper panels
  float* X = smem + upanel_floats(b, nblk);  // the CTA's columns of X, then a zero column
  const int pad = (b + 3) / 4 * 4 - b;
  for (int e = threadIdx.x; e < ldx; e += kSolveThreads) X[kCols * ldx + e] = 0.f;
  for (int e = threadIdx.x; e < kCols * pad; e += kSolveThreads) X[e / pad * ldx + b + e % pad] = 0.f;
  stage_upanels(P, U, b, vec != 0);
  for (int e = threadIdx.x; e < b * cols; e += kSolveThreads) {
    const int row = e / cols, col = e % cols;
    cp_async4(X + col * ldx + row, B + row * bc + c0 + col, true);
  }
  cp_async_commit();
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();
  upper_vectors<kColsPerHalfWarp>(P, X, b, cols, ldx);
  __syncthreads();  // X solved: written back coalesced
  for (int e = threadIdx.x; e < b * cols; e += kSolveThreads) {
    const int row = e / cols, col = e % cols;
    B[row * bc + c0 + col] = X[col * ldx + row];
  }
}

// TRSM: X = B inv(L)^T, L non-unit lower, B (b x b): row p of X solves
// L x = B[p]^T, so rows r0 .. r0 + rows - 1 of B (kRowsPerHalfWarp 1 or 2: 16
// or 32 a CTA) are staged as they lie, then the zero row, and each is TRSML's
// forward substitution with a division by L's diagonal.  At most 64 registers
// a thread, so four CTAs of 32 rows share an SM in a stacked launch, as their
// 56 KB of shared memory allow.
template <int kRowsPerHalfWarp>
__global__ void __launch_bounds__(kSolveThreads, 4)
trsm_kernel(const __grid_constant__ Segs lseg, const __grid_constant__ Segs bseg, int b, int ldx, int vec) {
  constexpr int kRows = kHalfWarps * kRowsPerHalfWarp;
  extern __shared__ __align__(16) float smem[];
  const int nblk = (b + kW - 1) / kW;
  const int splits = (b + kRows - 1) / kRows;
  const int task = blockIdx.x / splits, r0 = (blockIdx.x % splits) * kRows;
  const int rows = min(kRows, b - r0);
  const float* L = task_block(lseg, task, b, b);
  const float* B = task_block(bseg, task, b, b) + (long long)r0 * b;
  float* P = smem;                       // panel I at P + lpanel_floats(I)
  float* X = smem + lpanel_floats(nblk);  // the CTA's rows of B, then a zero row
  for (int e = threadIdx.x; e < ldx; e += kSolveThreads) X[kRows * ldx + e] = 0.f;
  if (vec) {  // b % 4 == 0 and a 16-byte aligned block
    const int q = b / 4;
    for (int e = threadIdx.x; e < rows * q; e += kSolveThreads) {
      const int row = e / q, k = 4 * (e % q);
      cp_async16(X + row * ldx + k, B + row * b + k, true);
    }
  } else {
    for (int e = threadIdx.x; e < rows * b; e += kSolveThreads) cp_async4(X + e / b * ldx + e % b, B + e, true);
  }
  // L's lower panels as TRSML stages them (no columns); its commit takes the
  // rows' copies too
  trsml_stage(P, X, L, nullptr, b, 0, 0, 0, ldx, vec != 0);
  lower_vectors<kRowsPerHalfWarp>(P, X, b, rows, ldx);
  __syncthreads();  // X solved: written back coalesced
  // B's address again rather than held through the solve: held, it spilled
  // under the 64-register bound
  float* out = task_block(bseg, task, b, b) + (long long)r0 * b;
  for (int e = threadIdx.x; e < rows * b; e += kSolveThreads) out[e] = X[e / b * ldx + e % b];
}

// ---------------------------------------------------------------------------
// GETRF
// ---------------------------------------------------------------------------
constexpr int kGetrfWarps = 16;
constexpr int kGetrfThreads = 32 * kGetrfWarps;
constexpr int kGR = kMaxB / kGetrfWarps;  // rows a thread holds: warp + 16 i
constexpr int kGC = kMaxB / 32;           // columns a thread holds: lane + 32 j
constexpr unsigned kFull = 0xffffffffu;

// Steps k = 32 kJ .. 32 kJ + kend - 1: the pivots whose column is register
// column kJ of lane k % 32.  Rows below 32 kJ and columns below 32 kJ are
// final, so their registers are left alone.  urow[k & 1] holds row k as
// step k begins; the step publishes row k + 1 into the other buffer.
template <int kJ>
__device__ __forceinline__ void getrf_steps(float (&a)[kGR][kGC], float (*urow)[kMaxB], int b, int kend) {
  constexpr int kFirst = 32 * kJ / kGetrfWarps;  // rows i < kFirst of every warp are final
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int kl = 0; kl < kend; ++kl) {
    const int k = 32 * kJ + kl;
    const float* u = urow[k & 1];
    const float piv = u[k];
    // column k below the pivot, divided once a row: lane i takes row
    // w + 16 i's entry from the owner lane, divides it, and hands it back
    float mine = 0.f;
#pragma unroll
    for (int i = kFirst; i < kGR; ++i) {
      const float v = __shfl_sync(kFull, a[i][kJ], kl);
      if (lane == i) mine = v;
    }
    const float lv = lane < kGR && w + kGetrfWarps * lane > k ? mine / piv : 0.f;
    float l[kGR], uk[kGC];
#pragma unroll
    for (int i = kFirst; i < kGR; ++i) {
      l[i] = __shfl_sync(kFull, lv, i);
      if (lane == kl && w + kGetrfWarps * i > k) a[i][kJ] = l[i];
    }
#pragma unroll
    for (int j = kJ; j < kGC; ++j) {
      const int c = lane + 32 * j;
      uk[j] = c > k ? u[c] : 0.f;
    }
    // a[i][j] -= l[i] u[j] for rows and columns past k (l and u are 0 elsewhere)
#pragma unroll
    for (int i = kFirst; i < kGR; ++i)
#pragma unroll
      for (int j = kJ; j < kGC; ++j) a[i][j] = fmaf(-l[i], uk[j], a[i][j]);
    const int k1 = k + 1;
    if (k1 < b && w == k1 % kGetrfWarps) {
      const int i1 = k1 / kGetrfWarps;
#pragma unroll
      for (int i = kFirst; i < kGR; ++i)
        if (i == i1)
#pragma unroll
          for (int j = 0; j < kGC; ++j) urow[k1 & 1][lane + 32 * j] = a[i][j];
    }
    __syncthreads();  // row k + 1 published; every thread done with row k's buffer
  }
}

__global__ void __launch_bounds__(kGetrfThreads)
getrf_kernel(const __grid_constant__ Segs aseg, int b) {
  __shared__ float urow[2][kMaxB];
  float* T = task_block(aseg, blockIdx.x, b, b);
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  float a[kGR][kGC];  // a[i][j] = T[w + 16 i][lane + 32 j]; zero outside the b x b tile
#pragma unroll
  for (int i = 0; i < kGR; ++i)
#pragma unroll
    for (int j = 0; j < kGC; ++j) {
      const int r = w + kGetrfWarps * i, c = lane + 32 * j;
      a[i][j] = r < b && c < b ? T[r * b + c] : 0.f;
    }
  if (w == 0)
#pragma unroll
    for (int j = 0; j < kGC; ++j) urow[0][lane + 32 * j] = a[0][j];
  __syncthreads();
  getrf_steps<0>(a, urow, b, min(32, b));
  if (b > 32) getrf_steps<1>(a, urow, b, min(32, b - 32));
  if (b > 64) getrf_steps<2>(a, urow, b, min(32, b - 64));
  if (b > 96) getrf_steps<3>(a, urow, b, b - 96);
#pragma unroll
  for (int i = 0; i < kGR; ++i)
#pragma unroll
    for (int j = 0; j < kGC; ++j) {
      const int r = w + kGetrfWarps * i, c = lane + 32 * j;
      if (r < b && c < b) T[r * b + c] = a[i][j];
    }
}

// ---------------------------------------------------------------------------
// POTRF
// ---------------------------------------------------------------------------
// A published column l of L, in the two orders its readers take it as
// float4s: lane-major (l[lane + 32 j] at 4 lane + j: a thread's columns) and
// row-major (l[w + 16 i] at kMaxB + 8 w + i: a warp's rows)
constexpr int kLFloats = 2 * kMaxB;

// Row k1 of s's owner (warp k1 % 16, register row k1 / 16) publishes column k1
// of L: c = a - s along its row (the columns of A - L L^T, s being symmetric),
// d = sqrt(c[k1]), and l = c / d below the pivot, d at it, 0 above, into lcol.
// Register columns j < kJ (columns below 32 kJ) are final and published as 0.
template <int kJ>
__device__ __forceinline__ void potrf_publish(const float (&a)[kGR][kGC], const float (&s)[kGR][kGC],
                                              float* lcol, int b, int k1) {
  constexpr int kFirst = 32 * kJ / kGetrfWarps;
  const int lane = threadIdx.x % 32, i1 = k1 / kGetrfWarps;
  float c[kGC];
#pragma unroll
  for (int j = 0; j < kGC; ++j) c[j] = 0.f;
#pragma unroll
  for (int i = kFirst; i < kGR; ++i)
    if (i == i1)
#pragma unroll
      for (int j = kJ; j < kGC; ++j) c[j] = a[i][j] - s[i][j];
  float cp = 0.f;
#pragma unroll
  for (int j = kJ; j < kGC; ++j)
    if (j == k1 / 32) cp = c[j];
  const float d = __fsqrt_rn(__shfl_sync(kFull, cp, k1 % 32)), dinv = __frcp_rn(d);
  float l[kGC];
#pragma unroll
  for (int j = 0; j < kGC; ++j) {
    const int col = lane + 32 * j;
    l[j] = j >= kJ && col > k1 && col < b ? div_rn(c[j], d, dinv) : (col == k1 ? d : 0.f);
    lcol[kMaxB + 8 * (col % kGetrfWarps) + col / kGetrfWarps] = l[j];
  }
  *reinterpret_cast<float4*>(lcol + 4 * lane) = make_float4(l[0], l[1], l[2], l[3]);
}

// Steps k = 32 kJ .. 32 kJ + kend - 1.  lcol[k & 1] holds column k of L as
// step k begins; the step publishes column k + 1 into the other buffer.
// Rows and columns below 32 kJ are final, so their registers are left alone.
template <int kJ>
__device__ __forceinline__ void potrf_steps(float (&a)[kGR][kGC], float (&s)[kGR][kGC], float (*lcol)[kLFloats],
                                            int b, int kend) {
  constexpr int kFirst = 32 * kJ / kGetrfWarps;  // rows i < kFirst of every warp are final
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int kl = 0; kl < kend; ++kl) {
    const int k = 32 * kJ + kl;
    // this thread's rows' and columns' l: three float4 loads
    const float* l = lcol[k & 1];
    const float4 r0 = *reinterpret_cast<const float4*>(l + kMaxB + 8 * w);
    const float4 r1 = *reinterpret_cast<const float4*>(l + kMaxB + 8 * w + 4);
    const float4 c0 = *reinterpret_cast<const float4*>(l + 4 * lane);
    const float li[kGR] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
    const float lj[kGC] = {c0.x, c0.y, c0.z, c0.w};
    // column k of L takes the registers of column k of A's transpose, which
    // no later step reads
    if (lane == kl)
#pragma unroll
      for (int i = kFirst; i < kGR; ++i) a[i][kJ] = li[i];
    // s += l l^T over rows and columns past 32 kJ (l is 0 above step k)
#pragma unroll
    for (int i = kFirst; i < kGR; ++i)
#pragma unroll
      for (int j = kJ; j < kGC; ++j) s[i][j] = fmaf(li[i], lj[j], s[i][j]);
    const int k1 = k + 1;
    if (k1 < b && w == k1 % kGetrfWarps) potrf_publish<kJ>(a, s, lcol[k1 & 1], b, k1);
    __syncthreads();  // column k + 1 published; every thread done with column k's buffer
  }
}

__global__ void __launch_bounds__(kGetrfThreads)
potrf_kernel(const __grid_constant__ Segs aseg, int b) {
  extern __shared__ float S[];  // the tile, row stride b | 1 (odd: conflict-free column reads)
  __shared__ __align__(16) float lcol[2][kLFloats];
  float* T = task_block(aseg, blockIdx.x, b, b);
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32, ld = b | 1;
  for (int r = w; r < b; r += kGetrfWarps)
    for (int c = lane; c < b; c += 32) S[r * ld + c] = T[r * b + c];
  __syncthreads();
  // a[i][j] = T[lane + 32 j][w + 16 i]: A's transpose, so the warp that owns
  // row r holds column r of A (the reference reads A's lower triangle); s[i][j]
  // = sum over finished columns m of L[w + 16 i][m] L[lane + 32 j][m]; zero
  // outside the b x b tile
  float a[kGR][kGC], s[kGR][kGC];
#pragma unroll
  for (int i = 0; i < kGR; ++i)
#pragma unroll
    for (int j = 0; j < kGC; ++j) {
      const int r = w + kGetrfWarps * i, c = lane + 32 * j;
      a[i][j] = r < b && c < b ? S[c * ld + r] : 0.f;
      s[i][j] = 0.f;
    }
  if (w == 0) potrf_publish<0>(a, s, lcol[0], b, 0);
  __syncthreads();
  potrf_steps<0>(a, s, lcol, b, min(32, b));
  if (b > 32) potrf_steps<1>(a, s, lcol, b, min(32, b - 32));
  if (b > 64) potrf_steps<2>(a, s, lcol, b, min(32, b - 64));
  if (b > 96) potrf_steps<3>(a, s, lcol, b, b - 96);
  // a[i][j] now holds L[w + 16 i][lane + 32 j] on and below the diagonal
#pragma unroll
  for (int i = 0; i < kGR; ++i)
#pragma unroll
    for (int j = 0; j < kGC; ++j) {
      const int r = w + kGetrfWarps * i, c = lane + 32 * j;
      if (r < b && c < b) T[r * b + c] = c <= r ? a[i][j] : 0.f;
    }
}

// ---------------------------------------------------------------------------
// Launch shapes
// ---------------------------------------------------------------------------
bool bad_edge(int e) { return e < 1 || e > kMaxB; }

bool bad_args(int n, int batch, int b) { return n < 1 || batch < 1 || batch > kMaxBatch || bad_edge(b); }

// X's row stride (TRSMU, TRSM) or column stride (TRSML, TRSMUL: X held
// transposed): a multiple of 4 (float4 loads) above b, never of 32 (the two
// half-warps of a warp read two rows or columns in distinct banks)
int x_stride(int b) {
  const int ld = (b + 3) / 4 * 4 + 4;
  return ld % 32 == 0 ? ld + 4 : ld;
}

using TrsmuKernel = void (*)(const Segs, const Segs, int, int, int);
using GemmnnKernel = void (*)(const Segs, const Segs, const Segs, int, int, int, int);
using TrsmlKernel = void (*)(const Segs, const Segs, int, int, int, int);

struct Launch {
  int ctas, threads, smem;  // CTAs a lane, threads a CTA, dynamic shared memory bytes
};

// TRSMU's launch for `rows` (16 or 32) rows of B a CTA; false if rows is neither
bool trsmu_launch(int rows, int n, int br, int b, Launch* out, TrsmuKernel* kernel) {
  if (rows != 16 && rows != 32) return false;
  *kernel = rows == 16 ? &trsmu_kernel<1> : &trsmu_kernel<2>;
  const int nblk = (b + kW - 1) / kW;
  *out = {n * ((br + rows - 1) / rows), kSolveThreads,
          (panel_floats(nblk) + (rows + 1) * x_stride(b)) * (int)sizeof(float)};
  return true;
}

// GEMMNN's launch for output tile `tile` (0: matrix-vector, q <= 7; else
// 32 or 64); false for any other
bool gemmnn_launch(int tile, int n, int m, int k, int q, Launch* out, GemmnnKernel* kernel) {
  GemmnnKernel kern;
  int threads;
  switch (tile) {
    case 0:
      if (q > kMvMaxQ) return false;
      kern = &gemmnn_kernel<0>;
      threads = kGemmnnThreads<0>;
      break;
    case 32:
      kern = &gemmnn_kernel<32>;
      threads = kGemmnnThreads<32>;
      break;
    case 64:
      kern = &gemmnn_kernel<64>;
      threads = kGemmnnThreads<64>;
      break;
    default:
      return false;
  }
  *kernel = kern;
  const int smem = tile == 0 ? 0 : kStages * slot_floats(tile, false) * (int)sizeof(float);
  *out = {n * gemmnn_pieces(tile, m, q), threads, smem};
  return true;
}

// TRSML's (upper: TRSMUL's) launch for `cols` (16 or 32) columns of B a CTA;
// false if cols is neither
bool column_launch(bool upper, int cols, int n, int b, int bc, Launch* out, TrsmlKernel* kernel) {
  if (cols != 16 && cols != 32) return false;
  if (upper) {
    *kernel = cols == 16 ? &trsmul_kernel<1> : &trsmul_kernel<2>;
  } else {
    *kernel = cols == 16 ? &trsml_kernel<1> : &trsml_kernel<2>;
  }
  const int nblk = (b + kW - 1) / kW, panels = upper ? upanel_floats(b, nblk) : lpanel_floats(nblk);
  *out = {n * ((bc + cols - 1) / cols), kSolveThreads, (panels + (cols + 1) * x_stride(b)) * (int)sizeof(float)};
  return true;
}

// TRSM's launch for `rows` (16 or 32) rows of B a CTA; false if rows is neither
bool trsm_launch(int rows, int n, int b, Launch* out, TrsmuKernel* kernel) {
  if (rows != 16 && rows != 32) return false;
  *kernel = rows == 16 ? &trsm_kernel<1> : &trsm_kernel<2>;
  *out = {n * ((b + rows - 1) / rows), kSolveThreads,
          (lpanel_floats((b + kW - 1) / kW) + (rows + 1) * x_stride(b)) * (int)sizeof(float)};
  return true;
}

// SYRK's and GEMM's launch for output tile `tile` (32 or 64); false for any other
bool abt_launch(int tile, int n, int b, Launch* out) {
  if (tile != 32 && tile != 64) return false;
  *out = {n * gemmnn_pieces(tile, b, b), tile == 32 ? kGemmnnThreads<32> : kGemmnnThreads<64>,
          kStages * slot_floats(tile, true) * (int)sizeof(float)};
  return true;
}

// One argument's Segs from the wrapper's table: nseg rows of (grid, nc, lane
// stride, first task), the firsts rising from 0 below n (every argument's
// table has the same); false on any other table.
bool read_segs(const long long* table, const int* idx, int nseg, int n, Segs* out) {
  if (table == nullptr || idx == nullptr || nseg < 1 || nseg > kMaxSeg || table[3] != 0) return false;
  out->idx = idx;
  for (int s = 0; s < kMaxSeg; ++s) {
    const long long* row = table + 4 * s;
    if (s < nseg && (row[0] == 0 || row[1] < 1 || row[2] < 0 || row[3] >= n || (s > 0 && row[3] <= row[-1])))
      return false;
    out->grid[s] = s < nseg ? reinterpret_cast<float*>(row[0]) : nullptr;
    out->nc[s] = s < nseg ? (int)row[1] : 0;
    out->lane[s] = s < nseg ? row[2] : 0;
    out->first[s] = s < nseg ? (int)row[3] : n;
  }
  return true;
}

// The tables of every argument of one launch (arity 1 to 3), read in turn.
bool read_all(int nseg, int n, std::initializer_list<std::pair<const long long*, const int*>> args, Segs* out) {
  for (const auto& a : args)
    if (!read_segs(a.first, a.second, nseg, n, out++)) return false;
  return true;
}

// Every segment of an argument 16-byte aligned: its grid and its lane stride.
bool aligned16(const Segs& s, int nseg) {
  for (int i = 0; i < nseg; ++i)
    if (reinterpret_cast<std::uintptr_t>(s.grid[i]) % 16 != 0 || s.lane[i] % 4 != 0) return false;
  return true;
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

// Each entry takes, per argument, its segment table (nseg rows of four
// 64-bit words: the grid's address, its block columns nc, its lane stride in
// elements (the size of one lane of a stacked grid; 0 when batch == 1) and the
// segment's first task) and the group's (n, 2) block indices, then the
// segment count nseg (1 .. kMaxSeg), the task count n, the lane count batch,
// the tile dimensions, the launch shape the wrapper chose and the stream.
int tile_trsmu(const long long* useg, const int* uidx, const long long* bseg, const int* bidx, int nseg, int n,
               int batch, int br, int b, int rows, void* stream) {
  Launch l;
  TrsmuKernel kernel;
  Segs s[2];
  if (bad_args(n, batch, b) || bad_edge(br) || !read_all(nseg, n, {{useg, uidx}, {bseg, bidx}}, s) ||
      !trsmu_launch(rows, n, br, b, &l, &kernel))
    return (int)cudaErrorInvalidValue;
  return launch_smem(kernel, l.ctas, batch, l.threads, l.smem, stream, s[0], s[1], br, b, x_stride(b));
}

int tile_gemmnn(const long long* aseg, const int* aidx, const long long* bseg, const int* bidx, const long long* cseg,
                const int* cidx, int nseg, int n, int batch, int m, int k, int q, int tile, void* stream) {
  Launch l;
  GemmnnKernel kernel;
  Segs s[3];
  if (bad_args(n, batch, m) || bad_edge(k) || bad_edge(q) ||
      !read_all(nseg, n, {{aseg, aidx}, {bseg, bidx}, {cseg, cidx}}, s) ||
      !gemmnn_launch(tile, n, m, k, q, &l, &kernel))
    return (int)cudaErrorInvalidValue;
  const int vec = aligned16(s[0], nseg) && aligned16(s[1], nseg) && aligned16(s[2], nseg) && k % 4 == 0 && q % 4 == 0;
  return launch_smem(kernel, l.ctas, batch, l.threads, l.smem, stream, s[0], s[1], s[2], m, k, q, vec);
}

int tile_trsml(const long long* lseg, const int* lidx, const long long* bseg, const int* bidx, int nseg, int n,
               int batch, int b, int bc, int cols, void* stream) {
  Launch l;
  TrsmlKernel kernel;
  Segs s[2];
  if (bad_args(n, batch, b) || bad_edge(bc) || !read_all(nseg, n, {{lseg, lidx}, {bseg, bidx}}, s) ||
      !column_launch(false, cols, n, b, bc, &l, &kernel))
    return (int)cudaErrorInvalidValue;
  const int vec = aligned16(s[0], nseg) && b % 4 == 0;
  return launch_smem(kernel, l.ctas, batch, l.threads, l.smem, stream, s[0], s[1], b, bc, x_stride(b), vec);
}

int tile_trsmul(const long long* useg, const int* uidx, const long long* bseg, const int* bidx, int nseg, int n,
                int batch, int b, int bc, int cols, void* stream) {
  Launch l;
  TrsmlKernel kernel;
  Segs s[2];
  if (bad_args(n, batch, b) || bad_edge(bc) || !read_all(nseg, n, {{useg, uidx}, {bseg, bidx}}, s) ||
      !column_launch(true, cols, n, b, bc, &l, &kernel))
    return (int)cudaErrorInvalidValue;
  const int vec = aligned16(s[0], nseg) && b % 4 == 0;
  return launch_smem(kernel, l.ctas, batch, l.threads, l.smem, stream, s[0], s[1], b, bc, x_stride(b), vec);
}

int tile_trsm(const long long* lseg, const int* lidx, const long long* bseg, const int* bidx, int nseg, int n,
              int batch, int b, int rows, void* stream) {
  Launch l;
  TrsmuKernel kernel;
  Segs s[2];
  if (bad_args(n, batch, b) || !read_all(nseg, n, {{lseg, lidx}, {bseg, bidx}}, s) ||
      !trsm_launch(rows, n, b, &l, &kernel))
    return (int)cudaErrorInvalidValue;
  const int vec = aligned16(s[0], nseg) && aligned16(s[1], nseg) && b % 4 == 0;
  return launch_smem(kernel, l.ctas, batch, l.threads, l.smem, stream, s[0], s[1], b, x_stride(b), vec);
}

int tile_syrk(const long long* aseg, const int* aidx, const long long* cseg, const int* cidx, int nseg, int n,
              int batch, int b, int tile, void* stream) {
  Launch l;
  Segs s[2];
  if (bad_args(n, batch, b) || !read_all(nseg, n, {{aseg, aidx}, {cseg, cidx}}, s) || !abt_launch(tile, n, b, &l))
    return (int)cudaErrorInvalidValue;
  const int vec = aligned16(s[0], nseg) && aligned16(s[1], nseg) && b % 4 == 0;
  return launch_smem(tile == 32 ? &syrk_kernel<32> : &syrk_kernel<64>, l.ctas, batch, l.threads, l.smem, stream,
                     s[0], s[1], b, vec);
}

int tile_gemm(const long long* aseg, const int* aidx, const long long* bseg, const int* bidx, const long long* cseg,
              const int* cidx, int nseg, int n, int batch, int b, int tile, void* stream) {
  Launch l;
  Segs s[3];
  if (bad_args(n, batch, b) || !read_all(nseg, n, {{aseg, aidx}, {bseg, bidx}, {cseg, cidx}}, s) ||
      !abt_launch(tile, n, b, &l))
    return (int)cudaErrorInvalidValue;
  const int vec = aligned16(s[0], nseg) && aligned16(s[1], nseg) && aligned16(s[2], nseg) && b % 4 == 0;
  return launch_smem(tile == 32 ? &gemm_kernel<32> : &gemm_kernel<64>, l.ctas, batch, l.threads, l.smem, stream,
                     s[0], s[1], s[2], b, vec);
}

int tile_getrf(const long long* aseg, const int* aidx, int nseg, int n, int batch, int b, void* stream) {
  Segs s[1];
  if (bad_args(n, batch, b) || !read_all(nseg, n, {{aseg, aidx}}, s)) return (int)cudaErrorInvalidValue;
  return launch_smem(getrf_kernel, n, batch, kGetrfThreads, 0, stream, s[0], b);
}

int tile_potrf(const long long* aseg, const int* aidx, int nseg, int n, int batch, int b, void* stream) {
  Segs s[1];
  if (bad_args(n, batch, b) || !read_all(nseg, n, {{aseg, aidx}}, s)) return (int)cudaErrorInvalidValue;
  return launch_smem(potrf_kernel, n, batch, kGetrfThreads, b * (b | 1) * (int)sizeof(float), stream, s[0], b);
}

}  // extern "C"
