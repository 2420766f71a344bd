// Hand-written Hopper (sm_90a) causal / sliding-window GQA flash attention.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (_flash_kernel / flash_attention): O = softmax(scale * Q K^T + mask) V on
// (B, H, S, D) tensors, online softmax over KV tiles, fp32 scores, running
// max, denominator and accumulator, output in the input dtype.  It computes
// what _flash_kernel computes: q upcast to fp32 THEN scaled; masked scores
// are -inf (causal: kpos <= qpos; window w > 0: kpos > qpos - w); p =
// exp(s - m) with m taken as 0 while a row has seen no unmasked key; alpha =
// 0 on a row's first unmasked tile; a row whose denominator is 0 (fully
// masked) gives 0.
//
// Layout: q (B, Hq, S, D), k and v (B, Hkv, S, D), any (b, h, s) strides
// with D contiguous, so the model's (B, S, H, D) activations pass as
// transposed views without a copy; o likewise (the wrapper allocates it in
// q's memory layout).  GQA without a copy: query head h reads KV head
// h / (Hq / Hkv) (the group need not be a power of two: 36 / 4 = 9).
//
// One CTA per (query tile of kBQ rows, query head, batch), kThreads = 256
// threads as a 16 x 16 grid (ty, tx): thread (ty, tx) owns query rows
// ty * 4 + i (i < 4), the scores of those rows at keys tx + 16 j (j < 4) of
// the current KV tile, and the output columns tx + 16 j (j < NJ, NJ =
// ceil(D / 16)) of its rows.  A row's max and sum over the KV tile are
// reduced across the 16 threads of its half-warp with __shfl_xor_sync, and
// every one of them keeps the row's running max and denominator.  The CTA
// loops over exactly the KV tiles the masks leave (keys up to its last row
// when causal; from its first row's window start when windowed), the same
// pruning as the Pallas kernel's `needed` predicate on its own tiling.
// Rows and keys past S (a ragged last tile: the reduced models run S = 12)
// are masked: keys score -inf and read V as 0, rows are not written.
//
// Shared memory: the scaled Q tile (kBQ x D), one K-or-V tile (kBK x D; K
// for the scores, then V for the product, in the same buffer), both fp32
// with a padded row stride D + 1 (conflict-free column walks), and the
// probabilities P (kBQ x kBK, stride kBK + 1): (128 (D + 1) + 64 * 65) * 4
// bytes, 148 KB at D = 256, so the launcher raises the dynamic limit first.
//
// What bounds it on H100, and what the design does about it: causal
// attention at S = 4096, D = 128 does ~4 S^2 D / 2 FLOPs a head (155 GFLOP
// a starcoder2-7b layer, 36 heads) on ~3 MB of Q/K/V a head, so it is bound
// by operations, far above the card's ridge.  This first kernel runs them
// as fp32 FMAs on the CUDA cores out of shared memory (67 TFLOP/s peak, and
// about 2 FMAs per shared load in the score loop), not on the tensor cores
// (989 TFLOP/s bf16): the (S, S) scores never reach device memory, which
// is what the Pallas kernel keeps out of HBM too, but the FLOPs run at a
// small share of the bf16 peak.  wgmma over TMA-fed bf16 tiles is the
// follow-up (ROADMAP queue D).  expf, not __expf: the fp32 tolerance of
// the reference test is 2e-5.
//
// Every entry point returns cudaGetLastError() (0 = launched); the Python
// wrapper raises on anything else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;       // query rows of a CTA
constexpr int kBK = 64;       // keys of a KV tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kMaxD = 256;    // largest head dimension the kernel accepts

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

struct Strides {
  long long b, h, s;
};

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* q, const T* k, const T* v, T* o, int Hq, int Hkv, int S, int D, Strides qs,
             Strides ks, Strides vs, Strides os, float scale, int causal, int window) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* Qs = smem;               // kBQ x ld
  float* KVs = Qs + kBQ * ld;     // kBK x ld
  float* Ps = KVs + kBK * ld;     // kBQ x (kBK + 1)
  constexpr int ldp = kBK + 1;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  T* ob = o + b * os.b + h * os.h;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    Qs[r * ld + c] = q0 + r < S ? to_f32(qb[(q0 + r) * qs.s + c]) * scale : 0.f;
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  // KV tiles the masks leave for rows q0 .. q0 + kBQ - 1
  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_end = causal ? q_last + 1 : S;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / kBK * kBK : 0;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // Q written (first tile); the last tile's P V reads done
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e % D;
      KVs[r * ld + c] = k0 + r < S ? to_f32(kb[(k0 + r) * ks.s + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = KVs[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = kpos < S;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        if (!ok) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, 16));
      const float m_cur = fmaxf(m[i], mx);
      const float m_safe = m_cur == -INFINITY ? 0.f : m_cur;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_safe);  // masked: exp(-inf) = 0
        sum += p;
        Ps[(ty * 4 + i) * ldp + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off, 16);
      const float alpha = m[i] == -INFINITY ? 0.f : expf(m[i] - m_safe);
      l[i] = alpha * l[i] + sum;
      m[i] = m_cur;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // P written; the score loop's K reads done

    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e % D;
      KVs[r * ld + c] = k0 + r < S ? to_f32(vb[(k0 + r) * vs.s + c]) : 0.f;
    }
    __syncthreads();

    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * ldp + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tx + 16 * j;
        const float vv = d < D ? KVs[kk * ld + d] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += pv[i] * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) store(&ob[row * os.s + d], acc[i][j] * inv);
    }
  }
}

template <typename T, int NJ>
int launch(const T* q, const T* k, const T* v, T* o, int B, int Hq, int Hkv, int S, int D,
           const long long* st, float scale, int causal, int window, cudaStream_t stream) {
  const size_t smem = (size_t)(kBQ * (D + 1) + kBK * (D + 1) + kBQ * (kBK + 1)) * sizeof(float);
  // the limit is a per-device attribute: raise it on every launch (above 48 KB
  // it must be asked for), so a launch on any device sees it
  const cudaError_t err =
      cudaFuncSetAttribute(flash_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]}, vs{st[6], st[7], st[8]},
      os{st[9], st[10], st[11]};
  dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  flash_kernel<T, NJ><<<grid, kThreads, smem, stream>>>(q, k, v, o, Hq, Hkv, S, D, qs, ks, vs, os, scale,
                                                         causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv, int S, int D,
             const long long* st, float scale, int causal, int window, void* stream) {
  if (D < 1 || D > kMaxD || Hkv < 1 || Hq % Hkv != 0 || S < 1 || B < 1 || B > 65535 || Hq > 65535)
    return (int)cudaErrorInvalidValue;
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  T* oo = static_cast<T*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nj = (D + 15) / 16;
  if (nj <= 1) return launch<T, 1>(qq, kk, vv, oo, B, Hq, Hkv, S, D, st, scale, causal, window, s);
  if (nj <= 2) return launch<T, 2>(qq, kk, vv, oo, B, Hq, Hkv, S, D, st, scale, causal, window, s);
  if (nj <= 4) return launch<T, 4>(qq, kk, vv, oo, B, Hq, Hkv, S, D, st, scale, causal, window, s);
  if (nj <= 8) return launch<T, 8>(qq, kk, vv, oo, B, Hq, Hkv, S, D, st, scale, causal, window, s);
  if (nj <= 12) return launch<T, 12>(qq, kk, vv, oo, B, Hq, Hkv, S, D, st, scale, causal, window, s);
  return launch<T, 16>(qq, kk, vv, oo, B, Hq, Hkv, S, D, st, scale, causal, window, s);
}

}  // namespace

// strides: 12 element strides, (batch, head, position) of q, k, v and o in turn
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* o, int B, int Hq,
                                   int Hkv, int S, int D, const long long* strides, float scale,
                                   int causal, int window, void* stream) {
  return dispatch<float>(q, k, v, o, B, Hq, Hkv, S, D, strides, scale, causal, window, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* o, int B, int Hq,
                                    int Hkv, int S, int D, const long long* strides, float scale,
                                    int causal, int window, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, S, D, strides, scale, causal, window, stream);
}
