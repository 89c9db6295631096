// Flash attention for Hopper (sm_90a): the port of the TPU kernel
// `_attn_kernel` / `flash_attention_pallas` in `src/repro/kernels/attention.py`.
//
// What it computes (the same as the TPU kernel, not carried over block by
// block): q (B, Hq, Lq, D), k/v (B, Hkv, Lkv, D) -> out (B, Hq, Lq, D) in the
// IO dtype, softmax(q k^T / sqrt(D)) v with an online softmax over KV blocks
// of b_kv rows:
//   * s = q.k^T * scale in fp32; causal: column c is masked for query row r
//     (global position q_offset + r) when c > q_offset + r; masked scores are
//     NEG_INF = -1e30, as on the TPU;
//   * m_new = max(m, rowmax s), p = exp(s - m_new), alpha = exp(m - m_new),
//     l = l*alpha + rowsum p, acc = acc*alpha + round(p) . v, where round(p)
//     casts p to the IO dtype before the product (the TPU kernel's
//     `p.astype(v.dtype)`); m, l and acc are fp32;
//   * out = acc / max(l, 1e-30).
// GQA reads K/V head hq / (Hq/Hkv) directly: no KV copy.  Nothing is padded:
// KV columns >= Lkv are masked by length here (the reference's ops layer
// padded KV and hid the padding behind a causal offset, which is exact only
// for Lq == 1), and query rows >= Lq are computed on zeros and never stored.
// A causal CTA stops at the KV block holding its last row's diagonal: the
// blocks past it would add exp(-1e30 - m) = 0 to every sum.
//
// Design: one CTA of 256 threads (a 16 x 16 grid) per (b, hq, b_q query
// rows).  Thread (ty, tx) owns query rows ty + 16*i and, for each KV block,
// score columns tx + 16*j: the 16 threads of a row are one half-warp, so the
// row max and row sum are half-warp shuffles and m, l live in registers.
// The Q tile stays in shared memory; K and V tiles stream through a ring of
// `prefetch` shared-memory stages filled by 16-byte cp.async copies
// (zero-filled past Lkv); rows are padded by 16 bytes so the 16-byte K reads
// of a quarter-warp hit distinct banks.  p goes through a shared fp32 tile
// to the P.V product, whose fp32 accumulator (b_q x D) also lives in shared
// memory, each element owned by one thread.  D is a runtime value, a
// multiple of 8 (the launch and the wrapper reject any other).
//
// What bounds it on this card: at decode (Lq = 1) each KV element is used
// by Hq/Hkv query rows only, so the work is bound by reading K and V; at a
// long causal prefill it does ~D/2 FLOPs per loaded byte per query-block,
// bound by operations.  This first version runs its products as CUDA-core
// FMAs from shared memory (no tensor cores, no TMA): right, not fast.
//
// Built by kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound through the plain C entry point `attention_launch` with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;  // dynamic shared memory opt-in limit
constexpr float kNegInf = -1e30f;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// round a float to the IO dtype and back
template <typename T> __device__ __forceinline__ float round_io(float x) {
  return to_f<T>(from_f<T>(x));
}

// 16 bytes of T from shared memory, as floats
template <typename T> struct Vec16;
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* out) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};
template <> struct Vec16<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float* out) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    out[0] = f.x;
    out[1] = f.y;
    out[2] = f.z;
    out[3] = f.w;
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = valid ? 16 : 0;  // src-size 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most n commit groups are still in flight (n = stages - 1)
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n <= 0) {
    asm volatile("cp.async.wait_group 0;\n" ::);
  } else if (n == 1) {
    asm volatile("cp.async.wait_group 1;\n" ::);
  } else {
    asm volatile("cp.async.wait_group 2;\n" ::);
  }
}

// `rows` rows of D elements starting at global row r0 into shared memory
// with row stride ds; rows >= n are zero-filled.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* __restrict__ src, int rows, int r0,
                                          int n, int D, int ds) {
  constexpr int V = 16 / sizeof(T);
  const int cpr = D / V;
  for (int c = threadIdx.x; c < rows * cpr; c += kThreads) {
    const int r = c / cpr, dc = (c % cpr) * V;
    const bool ok = r0 + r < n;
    cp_async16(dst + r * ds + dc, ok ? src + (size_t)(r0 + r) * D + dc : src, ok);
  }
}

template <typename T> size_t smem_bytes(int bq, int bkv, int D, int stages) {
  constexpr int V = 16 / sizeof(T);
  const size_t row = (size_t)(D + V) * sizeof(T);
  const size_t acc_row = (size_t)(((D + 31) / 32) * 32 + 16);
  return (size_t)(bq + 2 * stages * bkv) * row + (size_t)bq * (bkv + 4) * 4 +
         (size_t)bq * acc_row * 4;
}

template <typename T, int BQ, int BKV>
__global__ void __launch_bounds__(kThreads)
    attn_kernel(const T* __restrict__ Q, const T* __restrict__ K, const T* __restrict__ V,
                T* __restrict__ O, int Hq, int Hkv, int Lq, int Lkv, int D, float scale,
                int causal, int q_offset, int stages) {
  constexpr int TQ = BQ / 16, TK = BKV / 16;
  constexpr int VEC = Vec16<T>::N;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ds = D + VEC;                        // Q/K/V row stride, 16 B pad
  constexpr int ps = BKV + 4;                    // P row stride (floats)
  const int as = ((D + 31) / 32) * 32 + 16;      // acc row stride (floats)
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* KVs = Qs + BQ * ds;
  float* Ps = reinterpret_cast<float*>(KVs + (size_t)stages * 2 * BKV * ds);
  float* Acc = Ps + BQ * ps;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const T* Qg = Q + (size_t)(b * Hq + h) * Lq * D;
  const T* Kg = K + (size_t)(b * Hkv + hk) * Lkv * D;
  const T* Vg = V + (size_t)(b * Hkv + hk) * Lkv * D;
  T* Og = O + (size_t)(b * Hq + h) * Lq * D;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  int nkv = (Lkv + BKV - 1) / BKV;
  if (causal) {
    const int last_row = q_offset + min(q0 + BQ, Lq) - 1;
    nkv = min(nkv, last_row / BKV + 1);
  }

  for (int e = tid; e < BQ * as; e += kThreads) Acc[e] = 0.f;
  float m[TQ], l[TQ], alpha[TQ];
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }

  // the Q tile joins the first commit group; stages-1 KV blocks in flight
  load_rows<T>(Qs, Qg, BQ, q0, Lq, D, ds);
  const int stage_elems = 2 * BKV * ds;
  for (int s = 0; s < stages - 1; ++s) {
    if (s < nkv) {
      T* st = KVs + s * stage_elems;
      load_rows<T>(st, Kg, BKV, s * BKV, Lkv, D, ds);
      load_rows<T>(st + BKV * ds, Vg, BKV, s * BKV, Lkv, D, ds);
    }
    cp_async_commit();
  }

  for (int t = 0; t < nkv; ++t) {
    const int nt = t + stages - 1;
    if (nt < nkv) {
      T* st = KVs + (nt % stages) * stage_elems;
      load_rows<T>(st, Kg, BKV, nt * BKV, Lkv, D, ds);
      load_rows<T>(st + BKV * ds, Vg, BKV, nt * BKV, Lkv, D, ds);
    }
    cp_async_commit();
    cp_async_wait(stages - 1);
    __syncthreads();

    const T* Ks = KVs + (t % stages) * stage_elems;
    const T* Vs = Ks + BKV * ds;
    const int kv0 = t * BKV;

    // s = q . k^T in fp32
    float s[TQ][TK];
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int j = 0; j < TK; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; d += VEC) {
      float kf[TK][VEC];
#pragma unroll
      for (int j = 0; j < TK; ++j) Vec16<T>::load(Ks + (tx + 16 * j) * ds + d, kf[j]);
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        float qf[VEC];
        Vec16<T>::load(Qs + (ty + 16 * i) * ds + d, qf);
#pragma unroll
        for (int j = 0; j < TK; ++j)
#pragma unroll
          for (int e = 0; e < VEC; ++e) s[i][j] = fmaf(qf[e], kf[j][e], s[i][j]);
      }
    }

    // scale, mask, online softmax; a row's 16 threads are one half-warp
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      const int row = q_offset + q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < TK; ++j) {
        const int col = kv0 + tx + 16 * j;
        float v = s[i][j] * scale;
        if (col >= Lkv || (causal && col > row)) v = kNegInf;
        s[i][j] = v;
        mx = fmaxf(mx, v);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < TK; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(ty + 16 * i) * ps + tx + 16 * j] = round_io<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha[i] + sum;
      m[i] = m_new;
    }
    __syncthreads();

    // acc = acc * alpha + round(p) . v, four output columns at a time
    for (int c0 = tx; c0 < D; c0 += 64) {
      float pv[TQ][4];
#pragma unroll
      for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) pv[i][c] = 0.f;
      for (int j = 0; j < BKV; ++j) {
        float v[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = c0 + 16 * c;
          v[c] = col < D ? to_f<T>(Vs[j * ds + col]) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < TQ; ++i) {
          const float p = Ps[(ty + 16 * i) * ps + j];
#pragma unroll
          for (int c = 0; c < 4; ++c) pv[i][c] = fmaf(p, v[c], pv[i][c]);
        }
      }
#pragma unroll
      for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = c0 + 16 * c;
          if (col < D) {
            float* a = Acc + (ty + 16 * i) * as + col;
            *a = *a * alpha[i] + pv[i][c];
          }
        }
    }
    __syncthreads();  // the stage and the P tile are refilled next
  }

  // out = acc / max(l, 1e-30); each thread reads only the acc it wrote
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Lq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    for (int col = tx; col < D; col += 16)
      Og[(size_t)r * D + col] = from_f<T>(Acc[(ty + 16 * i) * as + col] / den);
  }
}

template <typename T, int BQ, int BKV>
int launch(const void* Q, const void* K, const void* V, void* O, int B, int Hq, int Hkv, int Lq,
           int Lkv, int D, int causal, int q_offset, int stages, float scale,
           cudaStream_t stream) {
  auto kernel = attn_kernel<T, BQ, BKV>;
  static bool opted_in = false;  // one opt-in per instantiation
  if (!opted_in) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  const size_t smem = smem_bytes<T>(BQ, BKV, D, stages);
  if (smem > (size_t)kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((Lq + BQ - 1) / BQ, Hq, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(Q), static_cast<const T*>(K), static_cast<const T*>(V),
      static_cast<T*>(O), Hq, Hkv, Lq, Lkv, D, scale, causal, q_offset, stages);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BQ>
int launch_bkv(int bkv, const void* Q, const void* K, const void* V, void* O, int B, int Hq,
               int Hkv, int Lq, int Lkv, int D, int causal, int q_offset, int stages,
               float scale, cudaStream_t s) {
  switch (bkv) {
    case 16:
      return launch<T, BQ, 16>(Q, K, V, O, B, Hq, Hkv, Lq, Lkv, D, causal, q_offset, stages,
                               scale, s);
    case 32:
      return launch<T, BQ, 32>(Q, K, V, O, B, Hq, Hkv, Lq, Lkv, D, causal, q_offset, stages,
                               scale, s);
    case 64:
      return launch<T, BQ, 64>(Q, K, V, O, B, Hq, Hkv, Lq, Lkv, D, causal, q_offset, stages,
                               scale, s);
    case 128:
      return launch<T, BQ, 128>(Q, K, V, O, B, Hq, Hkv, Lq, Lkv, D, causal, q_offset, stages,
                                scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_bq(int bq, int bkv, const void* Q, const void* K, const void* V, void* O, int B,
              int Hq, int Hkv, int Lq, int Lkv, int D, int causal, int q_offset, int stages,
              float scale, cudaStream_t s) {
  switch (bq) {
    case 16:
      return launch_bkv<T, 16>(bkv, Q, K, V, O, B, Hq, Hkv, Lq, Lkv, D, causal, q_offset,
                               stages, scale, s);
    case 32:
      return launch_bkv<T, 32>(bkv, Q, K, V, O, B, Hq, Hkv, Lq, Lkv, D, causal, q_offset,
                               stages, scale, s);
    case 64:
      return launch_bkv<T, 64>(bkv, Q, K, V, O, B, Hq, Hkv, Lq, Lkv, D, causal, q_offset,
                               stages, scale, s);
    case 128:
      return launch_bkv<T, 128>(bkv, Q, K, V, O, B, Hq, Hkv, Lq, Lkv, D, causal, q_offset,
                                stages, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = bf16, 1 = fp32.  D must be a multiple of 8 and every pointer
// 16-byte aligned.  Returns cudaGetLastError() after the launch (0 =
// launched), or cudaErrorInvalidValue for arguments it does not take.
extern "C" int attention_launch(const void* Q, const void* K, const void* V, void* O, int B,
                                int Hq, int Hkv, int Lq, int Lkv, int D, int dtype, int b_q,
                                int b_kv, int causal, int q_offset, int prefetch, float scale,
                                void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || Lq <= 0 || Lkv <= 0 || D <= 0 || D % 8 ||
      prefetch < 1 || prefetch > 3 || B > 65535 || Hq > 65535 || (causal && q_offset < 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t align = reinterpret_cast<uintptr_t>(Q) | reinterpret_cast<uintptr_t>(K) |
                          reinterpret_cast<uintptr_t>(V) | reinterpret_cast<uintptr_t>(O);
  if (align % 16) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bq<__nv_bfloat16>(b_q, b_kv, Q, K, V, O, B, Hq, Hkv, Lq, Lkv, D, causal,
                                    q_offset, prefetch, scale, s);
  if (dtype == 1)
    return launch_bq<float>(b_q, b_kv, Q, K, V, O, B, Hq, Hkv, Lq, Lkv, D, causal, q_offset,
                            prefetch, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
