// Hand-written Hopper (sm_90a) flash attention for bfloat16: TMA-fed,
// warp-specialised, with the two products on the tensor cores (wgmma).
//
// Replaces, for bf16 inputs with a head dimension D a multiple of 16 in
// 64..256, the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (_flash_kernel / flash_attention); csrc/flash_attention.cu stays the route
// for float32 and other head dimensions.  It computes what _flash_kernel
// computes: O = softmax(scale * Q K^T + mask) V with -inf masks (causal:
// kpos <= qpos; window w > 0: kpos > qpos - w), the running max m taken as
// 0 while a row has seen no unmasked key, alpha = 0 on a row's first
// unmasked tile, and 0 for a fully masked row (denominator 0).  Two roundings
// differ from the TPU kernel, both standard for tensor-core attention: the
// scale multiplies the fp32 scores (not q), and the probabilities P are
// rounded to bf16 before P V (their sum, the denominator, stays fp32).
//
// Layout: q (B, Hq, S, D), k and v (B, Hkv, S, D), o like q, each any
// (b, h, s) strides that are multiples of 16 bytes with D contiguous and a
// 16-byte aligned base (the wrapper copies anything else), so the model's
// (B, S, H, D) activations pass as transposed views.  Each is read and
// written through a 4-D TMA tensor map (D, S, H, B) built on the host and
// passed as a __grid_constant__ parameter; query head h reads KV head
// h / (Hq / Hkv), any group size (starcoder2-7b's is 9).
//
// What bounds it on H100: causal attention at starcoder2-7b's prefill shape
// (1, 36, 4, 4096, 128) does 155 GFLOP on 84 MB, so it is bound by
// operations: 0.156 ms at 989 TFLOP/s bf16, reachable only through wgmma.
// The design, for that:
// - CTA: a 128-row query tile of one (b, h); 384 threads as three
//   warpgroups.  Warpgroups 0 and 1 consume (64 query rows each, the wgmma
//   M) and raise their register limit from the entry's 168 to 232 with
//   setmaxnreg; warpgroup 2 produces and drops to 40: one thread issues
//   every TMA copy.
// - Ring: Q is loaded once; K and V tiles of BK keys stream through a
//   2-stage ring of separate K and V buffers, each with a full mbarrier
//   (arrive.expect_tx by the producer, completed by the TMA's byte count)
//   and an empty one (arrived by all 256 consumer threads), waited with
//   try_wait.parity.  So the next tiles load while the current ones are
//   multiplied, and a consumer starts Q K^T before V has landed.
//   BK = 128 for D <= 128 and 64 above, so Q + 2 (K + V) fits in shared
//   memory: 160 KB at D = 128, 144 KB at 192, 192 KB at 256.
// - Swizzle: every tile is stored as D / 64 column blocks of [rows][64]
//   bf16, one 128-byte row per key or query, with the 128-byte swizzle;
//   the tensor maps (CU_TENSOR_MAP_SWIZZLE_128B, box 64 x rows) and every
//   wgmma shared-memory descriptor (layout type 1) encode the same one.
//   The blocks start on 1024-byte boundaries, where the swizzle pattern
//   repeats.  D that is not a multiple of 64 is padded to the next one:
//   TMA fills the columns past D with zeros and clips them on the store.
// - S = Q K^T: wgmma m64n{BK}k16, both operands in shared memory, K-major
//   (the reduction over D is contiguous), D / 16 steps, fp32 accumulators.
// - Softmax on the accumulator fragment: a thread holds two rows of the
//   warpgroup's 64 (lane / 4 and lane / 4 + 8 of its warp's 16), so row
//   maxima and sums reduce over the quad by two shuffles; exp2 with
//   log2(e) folded into the scale; the denominator is kept per thread and
//   reduced once at the end.
// - O += P V: P is packed to bf16 in registers in the A-operand layout
//   (the accumulator fragment of one k16 slice is exactly that layout), V
//   is the shared-memory B operand read MN-major through wgmma's transpose
//   bit (no transposed copy), wgmma m64n{D}k16 into D / 2 fp32 registers a
//   thread.
// - Masks only on tiles that cross the diagonal, the window edge or S;
//   tiles that the masks leave empty for the whole CTA are never loaded
//   (the Pallas kernel's `needed`).  TMA zero-fills rows past S (a ragged
//   last tile); keys past S are masked.
// - Epilogue: O / l (0 where l = 0) to bf16, staged in the warpgroup's own
//   rows of the Q buffer in the same swizzled layout, one TMA store a
//   column block into o's strided view (rows past S are clipped).
// - Order: CTAs are numbered so that the query tiles with the most KV
//   tiles (under a causal mask, the last ones) start first and the short
//   ones fill the tail, with the heads of one (b, tile) adjacent, so the
//   query heads of a KV group re-read its K and V from L2.
//
// Every entry point returns 0 when the kernel launched, a CUDA error code
// when the launch failed, kEncodeError + the driver's CUresult when a tensor
// map could not be built, or kNoEncoder when the driver's encoder is missing;
// the Python wrapper raises on anything but 0.

#include <cuda.h>  // CUtensorMap and its enums (the encoder comes from the runtime's entry-point query)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;       // query rows of a CTA: two consumer warpgroups of 64
constexpr int kThreads = 384;  // warpgroups 0, 1 consume; 2 produces
constexpr int kConsumers = 256;
constexpr int kStages = 2;
constexpr int kRowBytes = 128;  // one swizzle-atom row: 64 bf16
constexpr int kEncodeError = 10000;
constexpr int kNoEncoder = 20000;

// ---- PTX: barriers, TMA, wgmma ------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0, int c1, int c2, int c3) {
  asm volatile("cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
               : "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory"); }

// keeps the compiler from moving reads or writes of a wgmma accumulator
// across the fence / wait around it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptor with the 128-byte swizzle (layout type 1);
// leading and stride byte offsets in bytes.  K-major tiles: the stride byte
// offset is the 8-row group's 1024 bytes (the leading one is unused).
// MN-major tiles (V): leading = the stride between 64-column blocks, stride
// = the 8-row group's 1024 bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lead, uint32_t stride) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lead >> 4) << 16) |
         (static_cast<uint64_t>(stride >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ float fast_exp2(float x) {  // ex2.approx: exp2(-inf) = +0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// wgmma m64nNk16, bf16 inputs, fp32 accumulators.  _ss: A and B from shared
// memory, both K-major; scale_d = 0 overwrites d.  _rs: A from registers
// (four .b32 of bf16 pairs in the accumulator's row/column order), B from
// shared memory MN-major (transpose bit set), accumulating into d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
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
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
  static_assert(N == 64 || N == 128, "score tile width");
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, scale_d);
  else wgmma_ss_n128(d, da, db, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  static_assert(N == 64 || N == 128 || N == 192 || N == 256, "padded head dimension");
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else if constexpr (N == 192) wgmma_rs_n192(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

// ---- the kernel -------------------------------------------------------------

struct Params {
  int B, Hq, Hkv, S, n_qt, causal, window;
  float scale_log2;  // scale * log2(e)
};

// DP: the head dimension padded to a multiple of 64; BK: keys of a KV tile
template <int DP, int BK>
__global__ void __launch_bounds__(kThreads, 1)
    flash_kernel_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                      const Params p) {
  constexpr int NC = DP / 64;  // 64-column blocks of a tile
  constexpr int kQBytes = kBQ * DP * 2, kKVBytes = BK * DP * 2;
  extern __shared__ uint8_t smem_raw[];
  // every tile block on a 1024-byte boundary, where the 128-byte swizzle repeats
  uint8_t* sQ = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sK = sQ + kQBytes;
  uint8_t* sV = sK + kStages * kKVBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + kStages * kKVBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;

  // the CTA's tile: the last query tiles (the longest under a causal mask)
  // first, the heads of one (b, tile) adjacent
  const int h = blockIdx.x % p.Hq;
  const int rest = blockIdx.x / p.Hq;
  const int b = rest % p.B;
  const int q0 = (p.n_qt - 1 - rest / p.B) * kBQ;
  const int hk = h / (p.Hq / p.Hkv);
  // the KV tiles the masks leave for rows q0 .. q0 + kBQ - 1 (at least one)
  const int k_end = p.causal ? min(q0 + kBQ, p.S) : p.S;
  const int t_begin = p.window > 0 ? max(0, q0 - p.window + 1) / BK : 0;
  const int n_tiles = (k_end + BK - 1) / BK - t_begin;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], kConsumers);
      mbar_init(&v_empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 2 * 128) {
      mbar_expect_tx(q_full, kQBytes);
#pragma unroll
      for (int c = 0; c < NC; ++c) tma_load(sQ + c * kBQ * kRowBytes, &tq, q_full, c * 64, q0, h, b);
      for (int n = 0; n < n_tiles; ++n) {
        const int st = n % kStages;
        const uint32_t parity = ((n / kStages) & 1) ^ 1;  // the first round finds the buffers free
        const int k0 = (t_begin + n) * BK;
        mbar_wait(&k_empty[st], parity);
        mbar_expect_tx(&k_full[st], kKVBytes);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          tma_load(sK + st * kKVBytes + c * BK * kRowBytes, &tk, &k_full[st], c * 64, k0, hk, b);
        mbar_wait(&v_empty[st], parity);
        mbar_expect_tx(&v_full[st], kKVBytes);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          tma_load(sV + st * kKVBytes + c * BK * kRowBytes, &tv, &v_full[st], c * 64, k0, hk, b);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
    const int r0 = warp * 16 + lane / 4;  // this thread's fragment rows: r0 and r0 + 8 of the 64
    const int cpair = (lane % 4) * 2;     // and columns cpair, cpair + 1 of every 8-column block
    const int qw = q0 + wg * 64;          // the warpgroup's first query row
    const int qpos0 = qw + r0;
    const uint32_t q_addr = smem_u32(sQ) + wg * 64 * kRowBytes;

    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    mbar_wait(q_full, 0);
    for (int n = 0; n < n_tiles; ++n) {
      const int st = n % kStages;
      const uint32_t parity = (n / kStages) & 1;
      const int k0 = (t_begin + n) * BK;
      const uint32_t k_addr = smem_u32(sK + st * kKVBytes), v_addr = smem_u32(sV + st * kKVBytes);

      // S = Q K^T over D / 16 steps of 16 (32 bytes within a 128-byte row)
      float s[BK / 2];
      mbar_wait(&k_full[st], parity);
      wg_fence();
#pragma unroll
      for (int c = 0; c < DP / 16; ++c)
        wgmma_ss<BK>(s, sw128_desc(q_addr + (c / 4) * kBQ * kRowBytes + (c % 4) * 32, 16, 1024),
                     sw128_desc(k_addr + (c / 4) * BK * kRowBytes + (c % 4) * 32, 16, 1024), c > 0);
      wg_commit();
      wg_wait_all();
      fence_regs(s);
      mbar_arrive(&k_empty[st]);

      // fragment element i: row r0 + 8 ((i / 2) % 2), key k0 + 8 (i / 4) + cpair + i % 2
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] *= p.scale_log2;
      const bool edge = k0 + BK > p.S || (p.causal && k0 + BK - 1 > qw) || (p.window > 0 && k0 <= qw + 63 - p.window);
      if (edge) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int kpos = k0 + (i / 4) * 8 + cpair + i % 2;
          const int qpos = qpos0 + ((i / 2) % 2) * 8;
          bool ok = kpos < p.S;
          if (p.causal) ok = ok && kpos <= qpos;
          if (p.window > 0) ok = ok && kpos > qpos - p.window;
          if (!ok) s[i] = -INFINITY;
        }
      }

      // online softmax (log2 domain), rows reduced over the quad
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
      float alpha[2], msafe[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_cur = fmaxf(m[r], mx[r]);
        msafe[r] = m_cur == -INFINITY ? 0.f : m_cur;
        alpha[r] = m[r] == -INFINITY ? 0.f : fast_exp2(m[r] - msafe[r]);
        m[r] = m_cur;
      }
      // P in bf16, as the A operand: slice c (keys 16c .. 16c + 15) is
      // elements 8c .. 8c + 7, .b32 j holding the pair 8c + 2j, 8c + 2j + 1
      uint32_t pa[BK / 16][4];
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int c = 0; c < BK / 16; ++c)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float e0 = fast_exp2(s[8 * c + 2 * j] - msafe[j % 2]);
          const float e1 = fast_exp2(s[8 * c + 2 * j + 1] - msafe[j % 2]);
          sum[j % 2] += e0 + e1;
          pa[c][j] = pack_bf16(e0, e1);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + sum[r];
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] *= alpha[(i / 2) % 2];

      // O += P V over BK / 16 slices of 16 keys (2048 bytes of V rows each)
      mbar_wait(&v_full[st], parity);
      wg_fence();
#pragma unroll
      for (int c = 0; c < BK / 16; ++c)
        wgmma_rs<DP>(o, pa[c], sw128_desc(v_addr + c * 16 * kRowBytes, BK * kRowBytes, 1024));
      wg_commit();
      wg_wait_all();
      fence_regs(o);
#pragma unroll
      for (int c = 0; c < BK / 16; ++c)
#pragma unroll
        for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(pa[c][j])::"memory");  // live until the wait
      mbar_arrive(&v_empty[st]);
    }

    // epilogue: O / l in bf16, staged swizzled in this warpgroup's Q rows
    // (its products are done), then stored by TMA
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = l[r] == 0.f ? 0.f : 1.f / l[r];
    }
    uint8_t* sO = sQ + wg * 64 * kRowBytes;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + half * 8;
        uint8_t* dst = sO + (i / 8) * kBQ * kRowBytes + r * kRowBytes + (((i % 8) ^ (r % 8)) * 16) + cpair * 2;
        *reinterpret_cast<uint32_t*>(dst) = pack_bf16(o[4 * i + 2 * half] * inv[half], o[4 * i + 2 * half + 1] * inv[half]);
      }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // the stores, visible to the TMA
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
    if (threadIdx.x % 128 == 0 && qw < p.S) {
#pragma unroll
      for (int c = 0; c < NC; ++c) tma_store(&to, sO + c * kBQ * kRowBytes, c * 64, qw, h, b);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
  }
}

// ---- host side ------------------------------------------------------------

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

// the (D, S, H, B) view of a (B, H, S, D) tensor with element strides
// st = (b, h, s), read or written in boxes of 64 columns x rows
int encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int D, int S, int H, int B, const long long* st,
           int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2, (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

template <int DP, int BK>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv, int S, int D,
           const long long* st, float scale, int causal, int window, cudaStream_t stream) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kNoEncoder;
  CUtensorMap tq, tk, tv, to;
  int err = encode(fn, &tq, q, D, S, Hq, B, st, kBQ);
  if (err == 0) err = encode(fn, &tk, k, D, S, Hkv, B, st + 3, BK);
  if (err == 0) err = encode(fn, &tv, v, D, S, Hkv, B, st + 6, BK);
  if (err == 0) err = encode(fn, &to, o, D, S, Hq, B, st + 9, 64);
  if (err != 0) return err;
  const int smem = 1024 + kBQ * DP * 2 + 2 * kStages * BK * DP * 2 + 8 * (1 + 4 * kStages);
  // the limit is a per-device attribute: raised on every launch (above 48 KB
  // it must be asked for), so a launch on any device sees it
  const cudaError_t e =
      cudaFuncSetAttribute(flash_kernel_sm90<DP, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const Params p{B, Hq, Hkv, S, (S + kBQ - 1) / kBQ, causal, window, scale * 1.4426950408889634f};
  const unsigned blocks = (unsigned)p.n_qt * B * Hq;
  flash_kernel_sm90<DP, BK><<<blocks, kThreads, smem, stream>>>(tq, tk, tv, to, p);
  return (int)cudaGetLastError();
}

bool aligned(const void* ptr, const long long* st) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && st[0] % 8 == 0 && st[1] % 8 == 0 && st[2] % 8 == 0 &&
         st[0] > 0 && st[1] > 0 && st[2] > 0;
}

}  // namespace

// strides: 12 element strides, (batch, head, position) of q, k, v and o in
// turn, each a positive multiple of 8 (16 bytes), with 16-byte aligned bases
extern "C" int flash_attention_sm90_bf16(const void* q, const void* k, const void* v, void* o, int B, int Hq,
                                         int Hkv, int S, int D, const long long* strides, float scale, int causal,
                                         int window, void* stream) {
  if (D < 64 || D > 256 || D % 16 != 0 || Hkv < 1 || Hq % Hkv != 0 || S < 1 || B < 1 ||
      !aligned(q, strides) || !aligned(k, strides + 3) || !aligned(v, strides + 6) || !aligned(o, strides + 9) ||
      (long long)((S + kBQ - 1) / kBQ) * B * Hq > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((D + 63) / 64) {
    case 1: return launch<64, 128>(q, k, v, o, B, Hq, Hkv, S, D, strides, scale, causal, window, s);
    case 2: return launch<128, 128>(q, k, v, o, B, Hq, Hkv, S, D, strides, scale, causal, window, s);
    case 3: return launch<192, 64>(q, k, v, o, B, Hq, Hkv, S, D, strides, scale, causal, window, s);
    default: return launch<256, 64>(q, k, v, o, B, Hq, Hkv, S, D, strides, scale, causal, window, s);
  }
}
