// Hand-written Hopper (sm_90a) matrix product C = A B, on three routes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/tile_linalg.py
// (_matmul_kernel :473 / matmul :487, pallas_call :504): C = A B with an fp32
// accumulator over the K dimension, the result cast to A's dtype.  A is
// (M, K), B is (K, N), C is (M, N), all row-major and contiguous, fp32 or bf16
// (both inputs of one dtype).  The Pallas kernel's (bm, bn, bk) blocks are the
// TPU's tiling; these kernels keep their own tiles and mask their edges (the
// wrapper keeps the JAX divisibility contract on top).  The wrapper picks the
// route by shape with one pure function (tile_linalg.matmul_route):
//
//   wgmma   bf16, K and N multiples of 8, 16-byte aligned bases (TMA's rule)
//   tf32x3  fp32, any shape
//   simple  bf16 that the wgmma route refuses
//
// What bounds it on H100: at 4096^3 the product does 137 GFLOP on 100 MB
// (bf16) or 201 MB (fp32), far above either ridge: operations bound it.
//
// wgmma (matmul_wgmma_kernel): bf16 at 989 TFLOP/s is reachable only through
// wgmma (bound 0.139 ms at 4096^3; bytes 0.030 ms).  The design, as
// csrc/flash_attention_sm90.cu's, whose pieces it copies:
// - CTA: a 128 x 256 tile of C; 384 threads as three warpgroups.  Warpgroups
//   0 and 1 consume (64 rows each, the wgmma M) and raise their register limit
//   to 232 with setmaxnreg; warpgroup 2 produces and drops to 40: one thread
//   issues every TMA copy.
// - Ring: 3 stages of A's 128 x 64 tile (K-major, 16 KB) and B's 64 x 256
//   tile (32 KB), each stage with a full mbarrier (arrive.expect_tx by the
//   producer, completed by the TMA's byte count) and an empty one (arrived by
//   all 256 consumer threads).  A consumer keeps one wgmma group in flight:
//   it frees stage t - 1 once stage t's products are issued.  CTAs are
//   numbered down M first, so the CTAs in flight share B's column panels
//   (scripts/matmul_potrf_variants.py times 4 stages and CTAs numbered along
//   N first against this; 4 stages ran within 1 %).
// - Swizzle: every tile is stored as 64-column blocks of [rows][64] bf16, one
//   128-byte row each, with the 128-byte swizzle, on 1024-byte boundaries;
//   the tensor maps (CU_TENSOR_MAP_SWIZZLE_128B, box 64 x rows) and every
//   wgmma descriptor (layout type 1) encode the same one.
// - wgmma m64n256k16, fp32 accumulators (128 a thread).  A is K-major.  B is
//   (K, N) row-major, MN-major for wgmma: it is read through the descriptor's
//   transpose bit, as the flash kernel reads V (no transposed copy): leading
//   offset = the 8 KB between 64-column blocks, stride = the 8-row group's
//   1024 bytes, one k16 slice = 16 rows = 2048 bytes further.
// - Edges: TMA zero-fills rows past M, columns past N and K past its end; a
//   64-column block of B wholly past N is not loaded (its columns of C are
//   never stored, and a column of C reads only its column of B).
// - Epilogue: each thread rounds its fp32 pairs to bf16 once and stores them
//   (4 bytes a pair), masked at M and N.
//
// tf32x3 (matmul_tf32x3_kernel): fp32 in full fp32 FMAs is bound at 2.05 ms
// (67 TFLOP/s); torch.matmul reaches ~78 % of that.  On the tensor cores at
// near-fp32 accuracy (3xTF32, as tile_lu_sm90.cu's GEMMNN): each operand x
// splits into big = tf32(x) and small = tf32(x - big), rounded as cvt.rna
// does; the product is small*big + big*small + big*big on mma.sync.m16n8k8,
// and the bound is 3 x the FLOPs at 495 TFLOP/s TF32 (0.833 ms at 4096^3):
// - a 128 x 128 tile of C on 8 warps (2 x 4, each 64 x 32: 4 x 4 fragments);
// - A's rows and B's columns staged in 64-deep chunks by cp.async into a ring
//   of 3 slots (68 KB each), a commit group a chunk: two chunks load while
//   one computes, and one CTA barrier a chunk both publishes a chunk and frees
//   the slot before it (32-deep chunks in 4 slots ran slower on the card:
//   scripts/matmul_potrf_variants.py); 16-byte copies where every row is
//   16-byte aligned, 4-byte ones otherwise, zero fill past M, N and K;
// - the tensor cores' fp32 accumulation truncates (it aligns the products to
//   the largest addend), so the sum is kept apart from the mmas: every
//   kPromote-deep partial (three products a k8 step, from zero) is added into
//   an fp32 sum with __fadd_rn, rounded to nearest.  The depth is the route's
//   knob: scripts/matmul_potrf_variants.py times 8 and 16 against 32 and
//   prints each one's error against float64 beside torch.matmul's.  At
//   4096^3 all three stay below torch.matmul's fp32 error, 32 the furthest,
//   and 8 is the slowest.
//
// simple (matmul_simple_kernel): the first port's kernel, kept for the bf16
// shapes TMA cannot read: one CTA of 256 threads a 128 x 128 tile, 16-deep
// chunks staged in shared memory as fp32, an 8 x 8 register tile a thread,
// fp32 FMAs on upcast values (the CUDA-core rate).
//
// Every entry point returns 0 when the kernel launched, a CUDA error code when
// the launch failed, kEncodeError + the driver's CUresult when a tensor map
// could not be built, or kNoEncoder when the driver's encoder is missing; the
// Python wrapper raises on anything but 0.

#include <cuda.h>  // CUtensorMap and its enums (the encoder comes from the runtime's entry-point query)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kEncodeError = 10000;
constexpr int kNoEncoder = 20000;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// wgmma route: PTX of barriers, TMA and wgmma (as flash_attention_sm90.cu)
// ---------------------------------------------------------------------------
constexpr int kWgBM = 128, kWgBN = 256, kWgBK = 64;  // kWgBN: wgmma_n256_tb's N
constexpr int kWgStages = 3;
constexpr int kWgThreads = 384;  // warpgroups 0, 1 consume; 2 produces
constexpr int kWgConsumers = 256;
// registers a thread after setmaxnreg: the producer's and the consumers'
// (their sum over the CTA's 384 threads stays within its share of the file)
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kRowBytes = 128;                       // one swizzle-atom row: 64 bf16
constexpr int kABytes = kWgBM * kRowBytes;           // A's 128 x 64 tile
constexpr int kBBlockBytes = kWgBK * kRowBytes;      // one 64 x 64 block of B
constexpr int kBBytes = kWgBN / 64 * kBBlockBytes;   // B's 64 x 256 tile
constexpr int kWgSmem = 1024 + kWgStages * (kABytes + kBBytes) + 2 * kWgStages * 8;

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// returns once the barrier's phase of this parity has completed; a phase
// that has not completed after 2^35 cycles (over 10 s) can only be a
// deadlock, and traps, so that the launch fails instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 35)) __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wg_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory"); }

// keeps the compiler from moving reads or writes of a wgmma accumulator
// across the fence / wait around it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptor with the 128-byte swizzle (layout type 1);
// leading and stride byte offsets in bytes.  K-major tiles (A): the stride
// byte offset is the 8-row group's 1024 bytes (the leading one is unused).
// MN-major tiles (B): leading = the stride between 64-column blocks, stride =
// the 8-row group's 1024 bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lead, uint32_t stride) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lead >> 4) << 16) |
         (static_cast<uint64_t>(stride >> 4) << 32) | (1ull << 62);
}

// d += A B on one m64n256k16 step: bf16 inputs, fp32 accumulators (128 a
// thread); A from shared memory K-major, B from shared memory MN-major
// (transpose bit set)
__device__ __forceinline__ void wgmma_n256_tb(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__global__ void __launch_bounds__(kWgThreads, 1)
    matmul_wgmma_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                        __nv_bfloat16* C, int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  // every tile block on a 1024-byte boundary, where the 128-byte swizzle repeats
  uint8_t* sA = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sB = sA + kWgStages * kABytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(sB + kWgStages * kBBytes);
  uint64_t* empty = full + kWgStages;
  // consecutive CTAs walk down M: they share B's column panel
  const int m0 = blockIdx.x * kWgBM, n0 = blockIdx.y * kWgBN;
  const int nk = (K + kWgBK - 1) / kWgBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWgConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == 2 * 128) {
      const int nb = min(kWgBN / 64, (N - n0 + 63) / 64);  // B's 64-column blocks that reach into N
      const uint32_t bytes = kABytes + nb * kBBlockBytes;
      for (int t = 0; t < nk; ++t) {
        const int st = t % kWgStages;
        mbar_wait(&empty[st], ((t / kWgStages) & 1) ^ 1);  // the first round finds the stages free
        mbar_expect_tx(&full[st], bytes);
        tma_load_2d(sA + st * kABytes, &ta, &full[st], t * kWgBK, m0);
        for (int c = 0; c < nb; ++c)
          tma_load_2d(sB + st * kBBytes + c * kBBlockBytes, &tb, &full[st], n0 + 64 * c, t * kWgBK);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows m0 + 64 wg .. + 63 of the tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    float acc[kWgBN / 2];
#pragma unroll
    for (int i = 0; i < kWgBN / 2; ++i) acc[i] = 0.f;
    for (int t = 0; t < nk; ++t) {
      const int st = t % kWgStages;
      mbar_wait(&full[st], (t / kWgStages) & 1);
      const uint32_t a_addr = smem_u32(sA + st * kABytes) + wg * 64 * kRowBytes;
      const uint32_t b_addr = smem_u32(sB + st * kBBytes);
      fence_regs(acc);
      wg_fence();
      // k16 step c: 32 bytes further along A's 128-byte rows, 16 rows down B
#pragma unroll
      for (int c = 0; c < kWgBK / 16; ++c)
        wgmma_n256_tb(acc, sw128_desc(a_addr + c * 32, 16, 1024),
                      sw128_desc(b_addr + c * 16 * kRowBytes, kBBlockBytes, 1024));
      wg_commit();
      wg_wait<1>();  // stage t - 1's products are done: its buffers may be refilled
      fence_regs(acc);
      if (t > 0) mbar_arrive(&empty[(t - 1) % kWgStages]);
    }
    wg_wait<0>();
    fence_regs(acc);

    // epilogue: fragment element i of a thread is row r0 + 8 ((i / 2) % 2),
    // column 8 (i / 4) + cpair + i % 2 of the warpgroup's 64 x 256
    const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
    const int r0 = m0 + wg * 64 + warp * 16 + lane / 4;
    const int c0 = n0 + (lane % 4) * 2;
#pragma unroll
    for (int g = 0; g < kWgBN / 8; ++g)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h, c = c0 + 8 * g;
        if (r < M && c < N)  // N is even: a pair is all in or all out
          *reinterpret_cast<uint32_t*>(C + (long long)r * N + c) = pack_bf16(acc[4 * g + 2 * h], acc[4 * g + 2 * h + 1]);
      }
  }
}

// ---------------------------------------------------------------------------
// tf32x3 route: 3xTF32 on mma.sync, partials promoted into an fp32 sum
// ---------------------------------------------------------------------------
constexpr int kTcBM = 128, kTcBN = 128;
constexpr int kTcKC = 64;      // K chunk: one cp.async commit group, one ring slot
constexpr int kTcStages = 3;   // ring slots: chunks c + 1 and c + 2 load while chunk c computes
constexpr int kTcThreads = 256;
constexpr int kTcWarpsM = 2;   // 8 warps, 2 x 4, each 64 x 32 of the tile
constexpr int kTcFM = 4, kTcFN = 4;  // m16 x n8 fragments of a warp
// A's row stride in a slot: 4 (mod 8) words, so the fragment loads hit 32
// distinct banks, and 16-byte aligned rows for cp.async; B's: 8 (mod 16)
constexpr int kPromote = 32;  // the depth of a partial promoted into the sum
constexpr int kTcLdA = kTcKC + 4;
constexpr int kTcLdB = kTcBN + 8;
constexpr int kTcSlot = kTcBM * kTcLdA + kTcKC * kTcLdB;  // floats of one slot
constexpr int kTcSmem = kTcStages * kTcSlot * (int)sizeof(float);

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from zero,
// as cvt.rna.tf32.f32 does: half a TF32 ulp added to the magnitude's bits,
// the 13 low bits cleared (two integer ops at full rate)
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
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

// Stage K rows [k0, k0 + kTcKC) of the tile's operands into one ring slot:
// As[r][kk - k0] = A[m0 + r][kk] and Bs[kk - k0][c] = B[kk][n0 + c], zero past
// M, K and N
__device__ __forceinline__ void stage_chunk(float* As, float* Bs, const float* A, const float* B, int M, int N,
                                            int K, int m0, int n0, int k0, bool vec) {
  if (vec) {  // K % 4 == N % 4 == 0 and 16-byte aligned bases: a quad is all in or all out
    constexpr int qa = kTcKC / 4, qb = kTcBN / 4;
    for (int e = threadIdx.x; e < kTcBM * qa; e += kTcThreads) {
      const int r = e / qa, kk = 4 * (e % qa);
      const bool ok = m0 + r < M && k0 + kk < K;
      cp_async16(As + r * kTcLdA + kk, ok ? A + (long long)(m0 + r) * K + k0 + kk : A, ok);
    }
    for (int e = threadIdx.x; e < kTcKC * qb; e += kTcThreads) {
      const int kk = e / qb, c = 4 * (e % qb);
      const bool ok = k0 + kk < K && n0 + c < N;
      cp_async16(Bs + kk * kTcLdB + c, ok ? B + (long long)(k0 + kk) * N + n0 + c : B, ok);
    }
  } else {
    for (int e = threadIdx.x; e < kTcBM * kTcKC; e += kTcThreads) {
      const int r = e / kTcKC, kk = e % kTcKC;
      const bool ok = m0 + r < M && k0 + kk < K;
      cp_async4(As + r * kTcLdA + kk, ok ? A + (long long)(m0 + r) * K + k0 + kk : A, ok);
    }
    for (int e = threadIdx.x; e < kTcKC * kTcBN; e += kTcThreads) {
      const int kk = e / kTcBN, c = e % kTcBN;
      const bool ok = k0 + kk < K && n0 + c < N;
      cp_async4(Bs + kk * kTcLdB + c, ok ? B + (long long)(k0 + kk) * N + n0 + c : B, ok);
    }
  }
}

// sum += part, rounded to nearest
__device__ __forceinline__ void promote(float (&sum)[kTcFM][kTcFN][4], const float (&part)[kTcFM][kTcFN][4]) {
#pragma unroll
  for (int i = 0; i < kTcFM; ++i)
#pragma unroll
    for (int j = 0; j < kTcFN; ++j)
#pragma unroll
      for (int h = 0; h < 4; ++h) sum[i][j][h] = __fadd_rn(sum[i][j][h], part[i][j][h]);
}

__global__ void __launch_bounds__(kTcThreads, 1)
    matmul_tf32x3_kernel(const float* A, const float* B, float* C, int M, int N, int K, int vec) {
  extern __shared__ __align__(16) float smem[];  // kTcStages slots: As (kTcBM x kTcLdA), then Bs
  const int m0 = blockIdx.y * kTcBM, n0 = blockIdx.x * kTcBN;
  const int nchunks = (K + kTcKC - 1) / kTcKC;
  auto slot = [&](int ch) { return smem + ch % kTcStages * kTcSlot; };
  // chunks 0 .. kTcStages - 2 in flight before the first wait; every
  // iteration commits one group (empty past the last chunk), so chunk ch is
  // always kTcStages - 2 groups behind the newest
  for (int ch = 0; ch < kTcStages - 1; ++ch) {
    if (ch < nchunks) stage_chunk(slot(ch), slot(ch) + kTcBM * kTcLdA, A, B, M, N, K, m0, n0, ch * kTcKC, vec);
    cp_async_commit();
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wm0 = warp % kTcWarpsM * kTcFM * 16, wn0 = warp / kTcWarpsM * kTcFN * 8;
  // fragment (i, j) element h: row wm0 + 16 i + g + 8 (h / 2), column
  // wn0 + 8 j + 2 t + h % 2 of the tile.  acc holds the fp32 sum of A B so
  // far; part, the tensor cores' partial of the current kPromote-deep block
  float acc[kTcFM][kTcFN][4], part[kTcFM][kTcFN][4];
#pragma unroll
  for (int i = 0; i < kTcFM; ++i)
#pragma unroll
    for (int j = 0; j < kTcFN; ++j)
#pragma unroll
      for (int h = 0; h < 4; ++h) acc[i][j][h] = 0.f;
  for (int ch = 0; ch < nchunks; ++ch) {
    asm volatile("cp.async.wait_group %0;" ::"n"(kTcStages - 2) : "memory");
    __syncthreads();  // chunk ch has landed, and every warp is done with chunk ch - 1's slot
    const int next = ch + kTcStages - 1;  // into the slot chunk ch - 1 left
    if (next < nchunks)
      stage_chunk(slot(next), slot(next) + kTcBM * kTcLdA, A, B, M, N, K, m0, n0, next * kTcKC, vec);
    cp_async_commit();
    const float* As = slot(ch);
    const float* Bs = As + kTcBM * kTcLdA;
    const int steps = min(kTcKC, K - ch * kTcKC);  // zero fill pads the last chunk to a multiple of 8
#pragma unroll
    for (int kk = 0; kk < kTcKC; kk += 8) {
      if (kk >= steps) break;
      uint32_t ab[kTcFM][4], as[kTcFM][4], bb[kTcFN][2], bs[kTcFN][2];
#pragma unroll
      for (int i = 0; i < kTcFM; ++i) {
        const float* a = As + (wm0 + 16 * i + g) * kTcLdA + kk + t;
        split_tf32(a[0], ab[i][0], as[i][0]);
        split_tf32(a[8 * kTcLdA], ab[i][1], as[i][1]);
        split_tf32(a[4], ab[i][2], as[i][2]);
        split_tf32(a[8 * kTcLdA + 4], ab[i][3], as[i][3]);
      }
#pragma unroll
      for (int j = 0; j < kTcFN; ++j) {
        // B[kk + t][col] and B[kk + t + 4][col], col = wn0 + 8 j + g
        const float* bp = Bs + (kk + t) * kTcLdB + wn0 + 8 * j + g;
        split_tf32(bp[0], bb[j][0], bs[j][0]);
        split_tf32(bp[4 * kTcLdB], bb[j][1], bs[j][1]);
      }
      // term by term over the fragments: 16 independent products in flight;
      // a block's partial starts from its first term
      if (kk % kPromote == 0) {
#pragma unroll
        for (int i = 0; i < kTcFM; ++i)
#pragma unroll
          for (int j = 0; j < kTcFN; ++j) mma_tf32<true>(part[i][j], as[i], bb[j]);
      } else {
#pragma unroll
        for (int i = 0; i < kTcFM; ++i)
#pragma unroll
          for (int j = 0; j < kTcFN; ++j) mma_tf32(part[i][j], as[i], bb[j]);
      }
#pragma unroll
      for (int i = 0; i < kTcFM; ++i)
#pragma unroll
        for (int j = 0; j < kTcFN; ++j) mma_tf32(part[i][j], ab[i], bs[j]);
#pragma unroll
      for (int i = 0; i < kTcFM; ++i)
#pragma unroll
        for (int j = 0; j < kTcFN; ++j) mma_tf32(part[i][j], ab[i], bb[j]);
      if ((kk + 8) % kPromote == 0 || kk + 8 >= steps) promote(acc, part);
    }
  }
  // C = sum, stored as float2 pairs (two neighbouring columns of a fragment)
  // where every row is 16-byte aligned, masked at M and N
#pragma unroll
  for (int i = 0; i < kTcFM; ++i)
#pragma unroll
    for (int j = 0; j < kTcFN; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = m0 + wm0 + 16 * i + g + 8 * hh, c = n0 + wn0 + 8 * j + 2 * t;
        if (r >= M) continue;
        float* dst = C + (long long)r * N + c;
        if (vec) {  // N even: a pair is all in or all out
          if (c < N) *reinterpret_cast<float2*>(dst) = make_float2(acc[i][j][2 * hh], acc[i][j][2 * hh + 1]);
        } else {
          if (c < N) dst[0] = acc[i][j][2 * hh];
          if (c + 1 < N) dst[1] = acc[i][j][2 * hh + 1];
        }
      }
}

// ---------------------------------------------------------------------------
// simple route: fp32 FMAs on upcast bf16
// ---------------------------------------------------------------------------
constexpr int kBM = 128, kBN = 128, kBK = 16;
constexpr int kThreads = 256;
constexpr int kLdA = kBM + 4;  // padded, and a multiple of 4 floats for float4 reads

__global__ void __launch_bounds__(kThreads) matmul_simple_kernel(const __nv_bfloat16* A, const __nv_bfloat16* B,
                                                                 __nv_bfloat16* C, int M, int N, int K) {
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
      As[c][r] = gr < M && gc < K ? __bfloat162float(A[(long long)gr * K + gc]) : 0.f;
    }
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int r = e / kBN, c = e % kBN;
      const int gr = k0 + r, gc = n0 + c;
      Bs[r][c] = gr < K && gc < N ? __bfloat162float(B[(long long)gr * N + gc]) : 0.f;
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
      if (c < N) C[(long long)r * N + c] = __float2bfloat16(acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {  // the driver's cuTensorMapEncodeTiled, without linking libcuda
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// a (rows, cols) row-major bf16 matrix, read in boxes of 64 columns x box_rows
int encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// y_ctas: the grid's second dimension, at most 65535
bool bad_dims(int M, int N, int K, int y_ctas) { return M < 1 || N < 1 || K < 1 || y_ctas > 65535; }

}  // namespace

// bf16 on wgmma: K and N multiples of 8 and 16-byte aligned bases
extern "C" int matmul_wgmma(const void* a, const void* b, void* c, int M, int N, int K, void* stream) {
  if (bad_dims(M, N, K, (N + kWgBN - 1) / kWgBN) || K % 8 != 0 || N % 8 != 0 || !aligned16(a) || !aligned16(b) || !aligned16(c))
    return (int)cudaErrorInvalidValue;
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kNoEncoder;
  CUtensorMap ta, tb;
  int err = encode(fn, &ta, a, M, K, kWgBM);
  if (err == 0) err = encode(fn, &tb, b, K, N, kWgBK);
  if (err != 0) return err;
  // the limit is a per-device attribute: raised on every launch (above 48 KB
  // it must be asked for), so a launch on any device sees it
  const cudaError_t e =
      cudaFuncSetAttribute(matmul_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((M + kWgBM - 1) / kWgBM, (N + kWgBN - 1) / kWgBN);
  matmul_wgmma_kernel<<<grid, kWgThreads, kWgSmem, static_cast<cudaStream_t>(stream)>>>(
      ta, tb, static_cast<__nv_bfloat16*>(c), M, N, K);
  return (int)cudaGetLastError();
}

// fp32 in 3xTF32, any shape
extern "C" int matmul_tf32x3(const void* a, const void* b, void* c, int M, int N, int K, void* stream) {
  if (bad_dims(M, N, K, (M + kTcBM - 1) / kTcBM)) return (int)cudaErrorInvalidValue;
  const cudaError_t e =
      cudaFuncSetAttribute(matmul_tf32x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
  if (e != cudaSuccess) return (int)e;
  const int vec = aligned16(a) && aligned16(b) && aligned16(c) && K % 4 == 0 && N % 4 == 0;
  const dim3 grid((N + kTcBN - 1) / kTcBN, (M + kTcBM - 1) / kTcBM);
  matmul_tf32x3_kernel<<<grid, kTcThreads, kTcSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(c), M, N, K, vec);
  return (int)cudaGetLastError();
}

// bf16 in fp32 FMAs, any shape
extern "C" int matmul_simple(const void* a, const void* b, void* c, int M, int N, int K, void* stream) {
  if (bad_dims(M, N, K, (M + kBM - 1) / kBM)) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  matmul_simple_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(c),
      M, N, K);
  return (int)cudaGetLastError();
}
